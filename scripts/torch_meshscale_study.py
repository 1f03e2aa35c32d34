"""Host-level mesh worker scaling on the port: individuals/hour/host against ranks.

The port's counterpart of ``scripts/meshscale_study.py``.  A host-level
worker joins the fleet as ONE member and drives its ranks (one process per
card, ``torch.distributed``) through the ``(pop, data)`` mesh; with
``--capacity auto`` it derives its dispatch window from the mesh
(``parallel/mesh.py::host_worker_capacity``).  Where the reference forced
D simulated host devices, the port starts D ranks of one worker
(``python -m gentun_tpu_torch.distributed.worker --coordinator ...
--num-processes D --process-id r --backend ...``).  Three acts:

1. **Rank sweep** (``--ranks``, default 1 2 4 8): one D-rank worker per
   phase, the same population each time, recording the wall and
   individuals/hour/host.  The wall starts once the fleet has joined (the
   join is recorded apart) and, for ``config2``, after a warm-up
   population of other genomes.
2. **Bit-identity gate**: every phase's fitnesses must be EXACTLY the
   one-rank phase's, genome for genome (a genome's fitness does not depend
   on the pop row it trained in).  The study fails otherwise.
3. **Fleet consolidation**: one worker of the largest D against D one-rank
   workers on the same search: the same fitnesses, the broker quiescent
   (no outstanding job) after both.

Where the ranks run:

- ``--tiny`` / ``--device cpu``: CPU ranks over gloo, the reference's tiny
  schedule on 64 digits (the jobs name the CPU).  They share the host's
  cores, so this shows control-plane consolidation, not compute scaling.
- on the card (default): ``--workload config2`` is config #2's proxy cell at
  pop 20 (``--capacity 20``); the ranks take ``LOCAL_RANK = r`` and so card
  ``r % cards``.  With as many cards as ranks they run over NCCL, one rank
  a card (the pop axis's scaling); ranks that share a card run over gloo
  (``--backend`` overrides).

    python3 scripts/torch_meshscale_study.py --tiny --ranks 1 2
    python3 scripts/torch_meshscale_study.py --workload config2 --ranks 1 2 4 --capacity 20

Writes ``scripts/torch_meshscale_study.json`` (with the card's name and
power limit).  Each rank's log goes to ``--workdir`` (default
``scripts/logs/``).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402

# The reference's tiny-but-real schedule: small enough for the CPU, real
# enough that fitness is a trained accuracy.
PARAMS = dict(nodes=(3,), kernels_per_layer=(6,), kfold=2, epochs=(1,),
              learning_rate=(0.05,), batch_size=32, dense_units=16,
              compute_dtype="float32", seed=0)
POP_SIZE = 16      # one full derived window of an 8-rank host
POP_SEED = 11      # the master's genome draw touches no device: the same every phase
N_EXAMPLES = 64    # workers subsample their (deterministic) local dataset
RANK_SWEEP = (1, 2, 4, 8)
#: ``--workload config2``: config #2's proxy cell (bench_torch.PROXY) at pop 20.
CONFIG2 = dict(nodes=(3, 4, 5), kernels_per_layer=(32, 64, 128), kfold=2, epochs=(1,),
               learning_rate=(0.01,), batch_size=256, dense_units=256,
               compute_dtype="bfloat16", seed=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def workload(args):
    """(params, pop_size, dataset, n_examples) of ``args``' workload; the
    params name the CPU when the run was asked for it."""
    if args.workload == "config2":
        params, pop, dataset, n = dict(CONFIG2), 20, "cifar10", 10_000
    else:
        params, pop, dataset, n = dict(PARAMS), POP_SIZE, "mnist", N_EXAMPLES
    if args.cpu:
        params["mesh"] = "cpu"
    return params, pop, dataset, n


def backend_for(args, n_ranks: int) -> str:
    """NCCL when every rank has a card of its own, else gloo (``--backend``
    overrides)."""
    if args.backend != "auto":
        return args.backend
    if args.cpu:
        return "gloo"
    import torch

    return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"


def spawn_worker(args, port: int, n_ranks: int, worker_id: str, mesh=None, capacity=None,
                 first_card: int = 0):
    """One worker of ``n_ranks`` rank processes (a plain one-process worker
    for one rank); returns the processes, rank 0 first.  Rank r takes card
    ``first_card + r`` (modulo the cards there are)."""
    _, _, dataset, n = workload(args)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if args.cpu:
        env["OMP_NUM_THREADS"] = "1"  # the ranks share the host's cores
    base = [sys.executable, "-m", "gentun_tpu_torch.distributed.worker",
            "--host", "127.0.0.1", "--port", str(port),
            "--species", "genetic-cnn", "--dataset", dataset, "--n", str(n),
            "--capacity", str(capacity or args.capacity), "--worker-id", worker_id]
    if mesh is not None:
        base += ["--mesh", mesh]
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(n_ranks):
        argv = list(base)
        if n_ranks > 1:
            argv += ["--coordinator", coordinator, "--num-processes", str(n_ranks),
                     "--process-id", str(rank), "--backend", backend_for(args, n_ranks)]
        card = first_card + rank
        renv = dict(env, LOCAL_RANK=str(card))
        if n_ranks == 1 and not args.cpu:
            # A one-process worker runs on its current device: show it its card.
            import torch

            renv["CUDA_VISIBLE_DEVICES"] = str(card % max(torch.cuda.device_count(), 1))
        log = open(os.path.join(args.workdir, f"torch_meshscale_{worker_id}_r{rank}.log"), "w")
        procs.append(subprocess.Popen(argv, env=renv, cwd=REPO,
                                      stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def stop_workers(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()  # SIGTERM = orderly drain (worker.py's handler)
    for p in procs:
        try:
            p.wait(timeout=20.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10.0)


def ran_mesh(broker, ranks_per_worker: int, mesh=None):
    """``(capacity, pop, data)`` of the fleet that runs the phase: what its
    first worker advertised in its hello (the mesh it built, ``--mesh``
    included), else the ``--mesh`` override passed to it (or the default
    factoring) with the capacity derived from that."""
    from gentun_tpu_torch.parallel.mesh import host_worker_capacity, parse_mesh_spec

    for w in broker._ops_status()["workers"]:
        if w.get("mesh"):
            return w["capacity"], w["mesh"]["pop"], w["mesh"]["data"]
    if mesh is None:
        return host_worker_capacity(ranks_per_worker)
    pop_axis, data_axis = parse_mesh_spec(mesh)
    return host_worker_capacity(ranks_per_worker, pop_axis=pop_axis, data_axis=data_axis)


def run_phase(args, n_workers: int, ranks_per_worker: int, label: str, pop_size=None,
              mesh=None, params=None) -> dict:
    """One fitness sweep of a fresh population against a freshly started fleet."""
    from gentun_tpu_torch.distributed import DistributedPopulation
    from gentun_tpu_torch.individuals import GeneticCnnIndividual

    base, pop_n, _, _ = workload(args)
    pop = DistributedPopulation(
        GeneticCnnIndividual, size=pop_size or pop_n, seed=POP_SEED,
        additional_parameters=dict(params or base), port=0, job_timeout=args.job_timeout,
    )
    procs = []
    try:
        _, port = pop.broker_address
        t0 = time.monotonic()
        for i in range(n_workers):
            procs += spawn_worker(args, port, ranks_per_worker, f"{label}-w{i}", mesh=mesh,
                                  first_card=i * ranks_per_worker)
        while pop.broker.fleet_members() < n_workers:
            dead = [p.returncode for p in procs if p.poll() is not None]
            if dead or time.monotonic() - t0 > args.job_timeout:
                raise RuntimeError(f"{label}: the fleet did not join (exit codes {dead}; "
                                   f"logs in {args.workdir})")
            time.sleep(0.1)
        join_s = time.monotonic() - t0
        advertised = ran_mesh(pop.broker, ranks_per_worker, mesh)
        if args.warmup:
            # A population of other genomes first: the workers' first call
            # uploads the dataset and warms the allocator.
            DistributedPopulation(
                GeneticCnnIndividual, size=pop_size or pop_n, seed=POP_SEED + 1,
                additional_parameters=dict(params or base), broker=pop.broker,
                job_timeout=args.job_timeout,
            ).evaluate()
        t0 = time.monotonic()
        evaluated = pop.evaluate()
        wall = time.monotonic() - t0
        by_genome = {repr(ind.cache_key()[1]): ind.get_fitness() for ind in pop}
        outstanding = pop.broker.outstanding()
        cap, pop_ax, data_ax = advertised
        if args.capacity != "auto":
            cap = int(args.capacity)
        return {
            "label": label,
            "n_workers": n_workers,
            "devices_per_worker": ranks_per_worker,
            "backend": backend_for(args, ranks_per_worker) if ranks_per_worker > 1 else None,
            "derived_capacity": cap,
            "mesh": {"pop": pop_ax, "data": data_ax},
            "evaluated": evaluated,
            "join_s": round(join_s, 3),
            "warmup": bool(args.warmup),
            "wall_s": round(wall, 3),
            "individuals_per_hour_per_host": round(evaluated / wall * 3600.0, 1)
            if wall > 0 else None,
            "best_fitness": max(ind.get_fitness() for ind in pop),
            "fitnesses": by_genome,
            "outstanding_total": sum(outstanding.values()),
        }
    finally:
        stop_workers(procs)
        pop.close()


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, nargs="+", default=list(RANK_SWEEP),
                    help="rank counts of the sweep (the first is the yardstick)")
    ap.add_argument("--workload", choices=("tiny", "config2"), default="tiny",
                    help="the reference's tiny schedule, or config #2's proxy cell at pop 20")
    ap.add_argument("--capacity", default="auto",
                    help="the workers' --capacity ('auto' derives it from the ranks)")
    ap.add_argument("--backend", choices=("auto", "gloo", "nccl"), default="auto")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true", help="CPU ranks (implies --device cpu)")
    ap.add_argument("--no-e2e", action="store_true", help="leave out act 3")
    ap.add_argument("--warmup", action=argparse.BooleanOptionalAction, default=None,
                    help="evaluate a population of other genomes before the timed one "
                         "(default: on for config2, off for tiny)")
    ap.add_argument("--job-timeout", type=float, default=900.0)
    ap.add_argument("--workdir", default=os.path.join(REPO, "scripts", "logs"))
    ap.add_argument("--out", default=os.path.join(REPO, "scripts", "torch_meshscale_study.json"))
    args = ap.parse_args(argv)
    args.cpu = args.tiny or args.device == "cpu"
    if args.warmup is None:
        args.warmup = args.workload == "config2"
    return args


def main(argv=None) -> dict:
    import torch

    args = parse(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("torch_meshscale_study: no CUDA device; pass --device cpu (or --tiny) "
                         "to run on the CPU")
    os.makedirs(args.workdir, exist_ok=True)
    params, pop_size, dataset, n = workload(args)
    out = {
        "config": {"params": {k: list(v) if isinstance(v, tuple) else v
                              for k, v in params.items()},
                   "pop_size": pop_size, "pop_seed": POP_SEED, "n_examples": n,
                   "dataset": dataset, "capacity": args.capacity, "ranks": args.ranks},
        "card": bench_torch.card_line(args.cpu),
        "cards_visible": 0 if args.cpu else torch.cuda.device_count(),
        "note": ("CPU ranks share the host's cores and ranks sharing one card time-slice "
                 "it: those phases measure control-plane consolidation; one rank per card "
                 "(NCCL) measures the pop axis's scaling"),
        "sweep": [],
    }
    reference = None
    failures = []
    for d in args.ranks:
        print(f"[meshscale] sweep: 1 worker x {d} rank(s) ...", flush=True)
        phase = run_phase(args, n_workers=1, ranks_per_worker=d, label=f"mesh{d}")
        if reference is None:
            reference = phase
            phase["bit_identical_to_1dev"] = True
        else:
            phase["bit_identical_to_1dev"] = phase["fitnesses"] == reference["fitnesses"]
            if not phase["bit_identical_to_1dev"]:
                failures.append(f"{phase['label']}: fitnesses diverge from the "
                                f"{reference['devices_per_worker']}-rank phase")
        out["sweep"].append(phase)
        print(f"[meshscale]   cap={phase['derived_capacity']} "
              f"mesh={phase['mesh']['pop']}x{phase['mesh']['data']} "
              f"backend={phase['backend']} wall={phase['wall_s']}s "
              f"rate={phase['individuals_per_hour_per_host']}/hr/host "
              f"bit_identical={phase['bit_identical_to_1dev']}", flush=True)

    big = max(args.ranks)
    if not args.no_e2e and big > 1:
        # Fleet consolidation: ONE big-rank host member against `big`
        # one-rank members on the same population.
        print(f"[meshscale] e2e: {big} workers x 1 rank ...", flush=True)
        fleet = run_phase(args, n_workers=big, ranks_per_worker=1, label=f"fleet{big}x1")
        consolidated = next(p for p in out["sweep"] if p["devices_per_worker"] == big)
        keys = ("label", "n_workers", "devices_per_worker", "derived_capacity",
                "best_fitness", "outstanding_total", "wall_s")
        e2e = {
            "consolidated": {k: consolidated[k] for k in keys},
            "fleet": {k: fleet[k] for k in keys},
            "best_fitness_identical": fleet["best_fitness"] == consolidated["best_fitness"],
            "fitnesses_identical": fleet["fitnesses"] == consolidated["fitnesses"],
            "both_quiescent": (fleet["outstanding_total"] == 0
                               and consolidated["outstanding_total"] == 0),
        }
        if not (e2e["best_fitness_identical"] and e2e["fitnesses_identical"]):
            failures.append("e2e: consolidated vs fleet fitnesses differ")
        if not e2e["both_quiescent"]:
            failures.append("e2e: broker not quiescent after the final gather")
        out["e2e_one_host_replaces_fleet"] = e2e
    out["ok"] = not failures
    out["failures"] = failures
    # One full per-genome map (the yardstick's) keeps the gate auditable.
    for p in out["sweep"][1:]:
        del p["fitnesses"]
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump(out, fh, indent=2)
    print(f"[meshscale] wrote {args.out} ok={out['ok']}", flush=True)
    return out


if __name__ == "__main__":
    result = main()
    raise SystemExit(0 if result["ok"] else 1)
