"""The big-genome regime on the port's ranks: size-aware routing and data-axis sharding.

The port's counterpart of ``scripts/bigmodel_study.py``.  Every genome's
memory footprint is classified against a per-card budget (host math,
``parallel/mesh.py::cnn_genome_cost`` and ``classify_genome_cost``) and each
size class routes to the mesh that fits it.  Where the reference forced
simulated host devices, a worker here is N ranks
(``scripts/torch_meshscale_study.py`` starts them).  The three promises:

1. **Factoring invariance**: small genomes on the wide-pop path give the
   same bits under the default mesh and under every operator-pinned
   ``--mesh`` factoring of the N ranks as one rank gives them.
2. **Over-budget evaluability**: a budget that classifies the study genome
   ``big`` (it fits only with the batch split over the data axis of all N
   ranks, one genome a program on ``(1, N)``) and one that classifies it
   ``micro`` (gradient accumulation, factor 2) both evaluate the whole
   population, the broker quiescent after the final gather.  On the port
   ``big`` is not bit-identical to the wide-pop path (each rank sums its
   share of the batch, and the all-reduce adds the shares: only the sum's
   grouping differs), so each genome is held within ``BIG_FLIPS``
   validation flips a fold of the wide-pop fitness; ``micro`` draws dropout
   per slice, so it is recorded, not gated.
3. **Classification is free**: the dispatch plane's per-job
   ``job_size_class`` is micro-timed.

The budgets come from the same integer math the evaluator classifies with,
so each class is exactly where the phase assumes (checked).

    python3 scripts/torch_bigmodel_study.py --tiny --ranks 2
    python3 scripts/torch_bigmodel_study.py --ranks 2        # ranks on the card(s)

Writes ``scripts/torch_bigmodel_study.json`` (with the card's name and power
limit).  Exits 1 when a promise fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_meshscale_study as ms  # noqa: E402  (rank spawning, phases)

from gentun_tpu_torch.parallel.mesh import (  # noqa: E402
    classify_genome_cost,
    cnn_genome_cost,
    job_size_class,
)

PARAMS = ms.PARAMS
POP_SIZE = ms.POP_SIZE
BIG_POP = 4        # the big/micro phases run one 1-wide program per genome
#: Largest per-genome |Δfitness| of the ``big`` route against the wide-pop
#: path, in validation flips a fold (one flip moves a fold's accuracy by
#: 1/fold size, and the fitness by that over kfold).
BIG_FLIPS = 2

# The study genome's footprint on the worker's data (digits upscaled to
# 28x28x1, 10 classes).
COST = cnn_genome_cost(PARAMS["nodes"], PARAMS["kernels_per_layer"], (28, 28, 1),
                       PARAMS["dense_units"], 10, PARAMS["compute_dtype"])


def budgets(n_ranks: int):
    """(big, micro) budgets for ``n_ranks``: ``big`` holds the params plus one
    rank's share of the batch, ``micro`` half of that share."""
    b = PARAMS["batch_size"]
    share = -(-b // n_ranks)
    return (COST.param_bytes + COST.act_bytes_per_example * share,
            COST.param_bytes + COST.act_bytes_per_example * -(-share // 2))


def _classifier_microbench(n_ranks: int, n_calls: int = 20000) -> dict:
    """Per-call cost of the dispatch plane's host-side classification."""
    wire = dict(PARAMS, input_shape=(28, 28, 1), n_classes=10,
                device_budget=budgets(n_ranks)[0])
    job_size_class(wire, n_ranks)  # warm
    t0 = time.perf_counter()
    for _ in range(n_calls):
        job_size_class(wire, n_ranks)
    return {"n_calls": n_calls,
            "per_call_us": round((time.perf_counter() - t0) / n_calls * 1e6, 3)}


def _phase(args, label, n_ranks, pop_size, mesh=None, device_budget=None) -> dict:
    params, _, _, _ = ms.workload(args)
    if device_budget is not None:
        params["device_budget"] = int(device_budget)
    phase = ms.run_phase(args, 1, n_ranks, label, pop_size=pop_size, mesh=mesh, params=params)
    phase.update(mesh_override=mesh, device_budget=device_budget,
                 all_evaluated=phase["evaluated"] >= 0 and None not in
                 phase["fitnesses"].values())
    return phase


def main(argv=None) -> dict:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2, help="the worker's rank count N (>= 2)")
    ap.add_argument("--backend", choices=("auto", "gloo", "nccl"), default="auto")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true", help="CPU ranks (implies --device cpu)")
    ap.add_argument("--acts", type=int, nargs="+", default=[1, 2, 3], choices=[1, 2, 3],
                    help="which of the three promises to check")
    ap.add_argument("--job-timeout", type=float, default=900.0)
    ap.add_argument("--workdir", default=os.path.join(REPO, "scripts", "logs"))
    ap.add_argument("--out", default=os.path.join(REPO, "scripts", "torch_bigmodel_study.json"))
    args = ap.parse_args(argv)
    args.cpu = args.tiny or args.device == "cpu"
    args.workload, args.capacity, args.warmup = "tiny", "auto", False
    if args.ranks < 2:
        raise SystemExit("--ranks must be >= 2: the big class needs a data axis")
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("torch_bigmodel_study: no CUDA device; pass --device cpu (or --tiny) "
                         "to run on the CPU")
    os.makedirs(args.workdir, exist_ok=True)
    n = args.ranks
    big_budget, micro_budget = budgets(n)
    out = {
        "config": {"params": {k: list(v) if isinstance(v, tuple) else v
                              for k, v in PARAMS.items()},
                   "pop_size": POP_SIZE, "pop_seed": ms.POP_SEED,
                   "n_examples": ms.N_EXAMPLES, "ranks": n,
                   "cost_model": {"param_bytes": COST.param_bytes,
                                  "act_bytes_per_example": COST.act_bytes_per_example},
                   "big_budget": big_budget, "micro_budget": micro_budget,
                   "big_flips_bound": BIG_FLIPS},
        "card": ms.bench_torch.card_line(args.cpu),
        "note": ("CPU ranks share the host's cores and ranks sharing one card time-slice it: "
                 "this verifies size-class ROUTING (bit-identity, evaluability, mesh shapes), "
                 "not memory relief or speed"),
    }
    failures = []
    for name, budget, want in (("big", big_budget, ("big", 1)),
                               ("micro", micro_budget, ("micro", 2))):
        got = classify_genome_cost(COST, PARAMS["batch_size"], n, budget)
        out[f"classify_{name}"] = list(got)
        if got != want:
            failures.append(f"classify({name}): expected {want}, got {got}")

    if 1 in args.acts:
        _factorings(args, n, out, failures)
    if 2 in args.acts:
        _over_budget(args, n, big_budget, micro_budget, out, failures)
    if 3 in args.acts:
        out["classifier"] = _classifier_microbench(n)
        if out["classifier"]["per_call_us"] > 200.0:
            failures.append("job_size_class per-call cost implausibly high")
    out["ok"] = not failures
    out["failures"] = failures
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(out, fh, indent=2)
    print(f"[bigmodel] wrote {args.out} ok={out['ok']}", flush=True)
    return out


def _factorings(args, n, out, failures) -> None:
    """Act 1: the default mesh and every ``--mesh`` factoring of the ``n``
    ranks against one rank, bit for bit."""
    print("[bigmodel] one rank, no budget ...", flush=True)
    one = _phase(args, "one_rank", 1, POP_SIZE)
    ours = one["fitnesses"]
    print(f"[bigmodel] default path (no --mesh, no budget), {n} ranks ...", flush=True)
    default_off = _phase(args, "default_off", n, POP_SIZE)
    out["baseline_off_bit_identical"] = default_off["fitnesses"] == ours
    if not out["baseline_off_bit_identical"]:
        failures.append(f"the default {n}-rank path diverges from one rank")
    out["one_rank"] = {k: v for k, v in one.items()}
    out["default_off"] = {k: v for k, v in default_off.items() if k != "fitnesses"}
    out["factorings"] = []
    for p in range(1, n + 1):
        if n % p:
            continue
        spec = f"{p}x{n // p}"
        print(f"[bigmodel] factoring --mesh {spec}, {n} ranks ...", flush=True)
        phase = _phase(args, f"mesh_{spec}", n, POP_SIZE, mesh=spec)
        phase["bit_identical_to_default"] = phase["fitnesses"] == ours
        if not phase["bit_identical_to_default"]:
            failures.append(f"--mesh {spec}: fitnesses diverge from one rank")
        del phase["fitnesses"]
        out["factorings"].append(phase)
        print(f"[bigmodel]   wall={phase['wall_s']}s "
              f"bit_identical={phase['bit_identical_to_default']}", flush=True)



def _over_budget(args, n, big_budget, micro_budget, out, failures) -> None:
    """Act 2: the ``big`` and ``micro`` budgets against the wide-pop path."""
    ref_small = _phase(args, "ref_small_pop", 1, BIG_POP)
    fold = ms.N_EXAMPLES // PARAMS["kfold"]
    bound = BIG_FLIPS / fold
    for name, budget in (("big", big_budget), ("micro", micro_budget)):
        print(f"[bigmodel] over-budget phase {name}: budget={budget} ranks={n} ...", flush=True)
        phase = _phase(args, name, n, BIG_POP, device_budget=budget)
        phase["quiescent"] = phase["outstanding_total"] == 0
        if not (phase["all_evaluated"] and phase["quiescent"]):
            failures.append(f"{name}: the over-budget population did not evaluate cleanly")
        deltas = [abs(phase["fitnesses"][g] - f) for g, f in ref_small["fitnesses"].items()]
        phase["max_abs_delta_vs_small_path"] = max(deltas)
        phase["bit_identical_to_small_path"] = max(deltas) == 0.0
        if name == "big":
            phase["delta_bound"] = bound
            if max(deltas) > bound:
                failures.append(f"big: a fitness moved {max(deltas)} from the wide-pop "
                                f"path, over {BIG_FLIPS} validation flips a fold ({bound})")
        del phase["fitnesses"]
        out[name] = phase
        print(f"[bigmodel]   wall={phase['wall_s']}s max|Δ|={phase['max_abs_delta_vs_small_path']} "
              f"quiescent={phase['quiescent']}", flush=True)
    del ref_small["fitnesses"]
    out["ref_small_pop"] = ref_small


if __name__ == "__main__":
    result = main()
    raise SystemExit(0 if result["ok"] else 1)
