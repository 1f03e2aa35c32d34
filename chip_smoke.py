#!/usr/bin/env python3
"""Drive the PyTorch port (gentun_tpu_torch) on one CUDA card, end to end.

Run from the root of the repository, with nothing to build first:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Device: the card's name, ``nvidia-smi``'s name and power limit, the torch
   and CUDA versions.  No CUDA device: exit 2.
2. CPU vs card in float32, with TF32 off for matmuls and convolutions and
   cuDNN kept to deterministic algorithms, as the port's executor sets them
   (``cnn.exact_numerics``; the process keeps torch's own flags outside
   it): the same CPU-drawn params and numpy inputs
   at the full width of config #2 give the same logits and the same grads of
   one train step, and a short cross-validation with dropout 0, run through
   the executor with torch's default flags around it, gives the same
   accuracies, each within the tolerance stated beside it.
3. The main path at full width: ``GeneticCnnModel.cross_validate_population``
   at config #2 (S=(3,4,5), filters (32,64,128), dense 256, pop 20, batch
   256, bf16) on synthetic CIFAR-shaped data (10,000 images, 10 classes)
   under the proxy schedule (kfold=2, epochs=(1,)): one warm-up call, one
   timed call, one call with telemetry spans on for the train/eval split.
   The mean proxy accuracy must be at least 0.5.
4. Purity on the card, in bf16, float32 and float64 (the float64 body keeps
   its float32 head and loss): the pop-20 batch against the same call again,
   against the same batch in reversed slot order (same shapes, other slots)
   and against three of its genomes trained alone (pop bucket 2, slot 0).
   The largest fitness differences are printed (a measurement, not a gate).
5. The GA entry point: ``Population(GeneticCnnIndividual)`` with
   ``GeneticAlgorithm.run(2)`` at config #1's shape (S=(3,5), filters
   (20,50), pop 10, 28×28×1) on synthetic MNIST-shaped data; every
   individual must get a finite fitness.

The line before the last carries ``{"kernels": [...]}``: the port has no
hand-written kernel yet, so the list is empty.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

NODES, FILTERS, DENSE, N_CLASSES = (3, 4, 5), (32, 64, 128), 256, 10
POP, N_DATA = 20, 10_000
PROXY = dict(
    nodes=NODES, kernels_per_layer=FILTERS, batch_size=256, dense_units=DENSE,
    compute_dtype="bfloat16", seed=0, kfold=2, epochs=(1,), learning_rate=(0.01,),
)
#: bf16 dense tensor-core peak of one H100 SXM (NVIDIA data sheet), only to
#: put the achieved rate in proportion; the card's power limit is printed.
H100_BF16_PEAK = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def synthetic_cifar(n: int, seed: int = 0):
    """CIFAR-10-shaped data: 10 class prototypes plus noise (32×32×3)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    x = protos[y] + 0.5 * rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    return x, y


def synthetic_mnist(n: int, seed: int = 1):
    """MNIST-shaped data: 10 class prototypes plus noise (28×28×1)."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    x = protos[y] + 0.5 * rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    return x, y


def random_population(nodes, pop: int, seed: int):
    from gentun_tpu_torch.genes import genetic_cnn_genome

    rng = np.random.default_rng(seed)
    spec = genetic_cnn_genome(nodes)
    return [spec.sample(rng) for _ in range(pop)]


def forward_flops_per_image() -> float:
    """Conv and dense multiply-adds ×2 for one image through the supergraph
    (every node conv runs whatever the masks say)."""
    h, w, c = 32, 32, 3
    flops = 0.0
    for k, f in zip(NODES, FILTERS):
        flops += 2.0 * h * w * 9 * c * f + k * 2.0 * h * w * 9 * f * f
        h, w, c = h // 2, w // 2, f
    return flops + 2.0 * h * w * c * DENSE + 2.0 * DENSE * N_CLASSES


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1] device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")
    log(f"[1] nvidia-smi: {smi}")
    return name, smi


def _max_rel(a, b) -> float:
    """max |a - b| over max |a| (the tolerance's unit)."""
    a, b = a.double(), b.double().to(a.device)
    return float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))


def phase_parity(torch, card):
    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.models.cnn import GeneticCnnModel, MaskedGeneticCnn
    from gentun_tpu_torch.ops.dag import stack_genome_masks

    def flags():
        return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.deterministic)

    outside = flags()
    with cnn.exact_numerics():
        inside = flags()
    check(inside == (False, False, True) and flags() == outside,
          "exact_numerics sets and restores the flags")
    log(f"[2] TF32 off inside the port's executor (cnn.exact_numerics): "
        f"torch.backends.cudnn.allow_tf32 = {inside[0]}, torch.backends.cuda.matmul.allow_tf32 = "
        f"{inside[1]}, torch.backends.cudnn.deterministic = {inside[2]}; outside it torch's "
        f"own {outside} stay")
    genomes = random_population(NODES, 4, seed=3)
    genomes[0] = {**genomes[0], "S_1": (0, 0, 0)}  # an empty stage: the pass-through
    hashes = cnn._genome_hashes(genomes)
    x_np, y_np = synthetic_cifar(32, seed=4)
    x = torch.from_numpy(np.ascontiguousarray(x_np.transpose(0, 3, 1, 2)))
    y = torch.from_numpy(y_np.astype(np.int64))
    cpu = torch.device("cpu")
    # (device, compute dtype): the float64 CPU run is the yardstick both
    # float32 runs are measured against.
    models = {}
    for dev, dtype in ((cpu, "float64"), (cpu, "float32"), (card, "float64"), (card, "float32")):
        models[dev, dtype] = MaskedGeneticCnn(NODES, FILTERS, 4, (32, 32, 3), DENSE, N_CLASSES,
                                              0.0, dtype, False, device=dev)
    init = cnn._init_population_params(models[cpu, "float32"], 1, 0, hashes)
    grads, logits = {}, {}
    for (dev, dtype), m in models.items():
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(init[name][0])
        masks = [{k: torch.as_tensor(v, device=dev) for k, v in st.items()}
                 for st in stack_genome_masks(genomes, NODES)]
        with cnn.exact_numerics():  # as the executor runs its folds
            out = m(x.to(dev), masks)
            logits[dev, dtype] = out.detach()
            loss = cnn._per_genome_loss(out, y.to(dev)).sum()
            grads[dev, dtype] = dict(zip([n for n, _ in m.named_parameters()],
                                         torch.autograd.grad(loss, list(m.parameters()))))
    # TF32 off, so both sides are IEEE float32; cuDNN's algorithms (it may take
    # Winograd or FFT for 3×3) and oneDNN's sum in different orders, ~1e-5
    # relative per layer through 14 layers.  1e-3 of the scale is a 10× margin.
    rel = _max_rel(logits[cpu, "float32"], logits[card, "float32"])
    log(f"[2] logits P=4 B=32 full width: max|Δ|/max|cpu| = {rel:.3e} (gate 1e-3)")
    check(rel <= 1e-3, "CPU vs card logits")
    # One train step's grads, two ways.  With a float64 body the card and
    # the CPU run the same backward up to summation order; the head and the
    # loss stay float32 by design (as in the reference), which puts ~1e-7
    # relative into the gradient entering the body, amplified ~20× by the
    # cancelling weight-gradient sums.  1e-5 of each leaf's norm catches any
    # wiring fault (a genome reading another's gradient, a layout slip),
    # which moves a leaf by O(1).  In float32 the grads are
    # ill-conditioned at this width: measured on a CPU against float64, they
    # sit up to 1.8e-3 of a leaf's norm away (ReLUs whose input lies near 0
    # switch side between orders; the first stages sum 8k-32k terms), so the
    # card's float32 grads are held to 1e-2 of each leaf's float64 norm.
    def leaf_err(a, b):
        return float((a.detach().cpu().double() - b.detach().cpu().double()).norm())

    worst64 = worst32 = (0.0, "")
    for name, g64 in grads[cpu, "float64"].items():
        rel64 = leaf_err(grads[card, "float64"][name], g64) / max(float(g64.norm()), 1e-300)
        rel32 = leaf_err(grads[card, "float32"][name], g64) / max(float(g64.norm()), 1e-300)
        cpu32 = leaf_err(grads[cpu, "float32"][name], g64) / max(float(g64.norm()), 1e-300)
        worst64 = max(worst64, (rel64, name))
        worst32 = max(worst32, (rel32, name, cpu32))
        check(rel64 <= 1e-5, f"float64 card vs CPU grads of {name}: {rel64:.3e} of the leaf's norm")
        check(rel32 <= 1e-2, f"float32 card grads of {name}: {rel32:.3e} of the float64 norm")
    log(f"[2] grads, float64 body, card vs CPU: worst leaf {worst64[1]} |Δ|/|g| = "
        f"{worst64[0]:.3e} (gate 1e-5)")
    log(f"[2] grads, float32 card vs float64: worst leaf {worst32[1]} |Δ|/|g| = {worst32[0]:.3e} "
        f"(gate 1e-2; the CPU's float32 on that leaf: {worst32[2]:.3e})")

    xs, ys = synthetic_cifar(512, seed=5)
    cfg = dict(PROXY, compute_dtype="float32", dropout_rate=0.0, batch_size=64)
    on_cpu = GeneticCnnModel.cross_validate_population(xs, ys, genomes, **cfg, mesh="cpu")
    on_card = GeneticCnnModel.cross_validate_population(xs, ys, genomes, **cfg, mesh="auto")
    diff = float(np.abs(on_cpu - on_card).max())
    # Same init and batches, no dropout: float32 order differences can flip a
    # validation sample whose top two logits nearly tie.  0.02 is 5 of the
    # 256 validation samples of a fold.
    log(f"[2] CV accs (4 steps/fold, dropout 0): cpu {np.round(on_cpu, 4).tolist()} "
        f"card {np.round(on_card, 4).tolist()} max|Δ| = {diff:.4f} (gate 0.02)")
    check(diff <= 0.02, "CPU vs card CV accuracies")


def phase_main(torch, x, y, genomes):
    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.telemetry import spans

    t0 = time.monotonic()
    warm_accs = GeneticCnnModel.cross_validate_population(x, y, genomes, **PROXY)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    accs = GeneticCnnModel.cross_validate_population(x, y, genomes, **PROXY)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    check(accs.shape == (POP,) and bool(np.isfinite(accs).all()), "finite proxy accuracies")
    mean = float(accs.mean())
    log(f"[3] proxy accs: {np.round(accs, 4).tolist()}")
    log(f"[3] mean proxy accuracy {mean:.4f} (gate >= 0.5)")
    check(mean >= 0.5, "mean proxy accuracy >= 0.5")

    spans.enable()
    try:
        with spans.capture() as recs:
            t1 = time.monotonic()
            GeneticCnnModel.cross_validate_population(x, y, genomes, **PROXY)
            traced = time.monotonic() - t1
    finally:
        spans.disable()
    train_s = sum(r["dur_s"] for r in recs if r.get("kind") == "train")
    eval_s = sum(r["dur_s"] for r in recs if r.get("kind") == "eval")

    fold = N_DATA // PROXY["kfold"]
    steps = (N_DATA - fold) // PROXY["batch_size"] * sum(PROXY["epochs"])
    _, n_val_padded = cnn._eval_batch_size(PROXY["batch_size"], fold)
    flops = POP * PROXY["kfold"] * forward_flops_per_image() * (
        steps * PROXY["batch_size"] * 3.0 + n_val_padded)
    result = {
        "wall_s": wall,
        "warmup_s": warm_s,
        "individuals_per_hour": POP / wall * 3600.0,
        "peak_mem_bytes": peak,
        "train_s": train_s,
        "eval_s": eval_s,
        "traced_wall_s": traced,
        "steps_per_fold": steps,
        "achieved_tflops": flops / wall / 1e12,
        "bf16_peak_share": flops / wall / H100_BF16_PEAK,
        "mean_acc": mean,
    }
    log(f"[3] timed call: {wall:.3f} s wall (warm-up call {warm_s:.3f} s), "
        f"{result['individuals_per_hour']:.1f} individuals/hour, peak memory "
        f"{peak / 2**30:.2f} GiB, {result['achieved_tflops']:.2f} TFLOP/s "
        f"({100 * result['bf16_peak_share']:.2f}% of the 989 TFLOP/s bf16 peak)")
    log(f"[3] spans on (device synchronised per span): train {train_s:.3f} s, "
        f"eval {eval_s:.3f} s, call {traced:.3f} s")
    return (warm_accs, accs), result


def phase_purity(x, y, genomes, bf16_calls):
    """How far the card lets a genome's fitness depend on its batch, three
    ways: the pop-20 batch called again (determinism), in reversed slot
    order (the same shapes, so the same library algorithms, every genome in
    another slot) and three genomes trained alone (pop bucket 2, slot 0:
    other shapes).  In the main path's bf16 (whose two calls phase 3 made),
    in float32 and in float64.  The wiring is the same in every dtype, so a
    gap that the float64 body does not show is the library's arithmetic, not
    a fault of the port."""
    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    picks = [3, 7, 11]
    rev = genomes[::-1]
    out = {}
    for dtype in ("bfloat16", "float32", "float64"):
        cfg = dict(PROXY, compute_dtype=dtype)
        t0 = time.monotonic()
        first, batch = bf16_calls if dtype == "bfloat16" else [
            GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg) for _ in range(2)]
        other_slots = GeneticCnnModel.cross_validate_population(x, y, rev, **cfg)[::-1]
        alone = [float(GeneticCnnModel.cross_validate_population(x, y, [genomes[i]], **cfg)[0])
                 for i in picks]
        repeat_diff = float(np.abs(batch - first).max())
        slot_diff = float(np.abs(batch - other_slots).max())
        alone_diff = max(abs(a - float(batch[i])) for a, i in zip(alone, picks))
        out[dtype] = {"repeat": repeat_diff, "other_slots": slot_diff, "alone": alone_diff}
        log(f"[4] purity {dtype} ({time.monotonic() - t0:.1f} s): pop-{POP} batch called twice: "
            f"max|Δfitness| = {repeat_diff:.6f}; vs the same batch in reversed slots: "
            f"max|Δfitness| = {slot_diff:.6f} over all {POP}")
        log(f"[4] purity {dtype}: slots {picks} of the pop-{POP} batch "
            f"{[round(float(batch[i]), 4) for i in picks]} vs alone (bucket 2, slot 0) "
            f"{[round(a, 4) for a in alone]}: max|Δfitness| = {alone_diff:.6f}")
    return out


def phase_ga():
    from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual, Population

    x, y = synthetic_mnist(2_000)
    params = dict(nodes=(3, 5), kernels_per_layer=(20, 50), kfold=2, epochs=(1,),
                  learning_rate=(0.01,), batch_size=128, seed=0)
    pop = Population(GeneticCnnIndividual, x_train=x, y_train=y, size=10, seed=0,
                     additional_parameters=params)
    t0 = time.monotonic()
    best = GeneticAlgorithm(pop, seed=0).run(2)
    wall = time.monotonic() - t0
    fits = [ind.get_fitness() for ind in pop]
    check(all(np.isfinite(fits)), "finite GA fitnesses")
    log(f"[5] GA 2 generations, pop 10, S=(3,5): {wall:.2f} s, best fitness "
        f"{best.get_fitness():.4f}, fitnesses {np.round(fits, 4).tolist()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import gentun_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 3
    t_start = time.monotonic()
    name, smi = phase_device(torch)
    phase_parity(torch, torch.device("cuda"))
    x, y = synthetic_cifar(N_DATA)
    genomes = random_population(NODES, POP, seed=2)
    bf16_calls, main_result = phase_main(torch, x, y, genomes)
    purity = phase_purity(x, y, genomes, bf16_calls)
    phase_ga()
    summary = {"main_path": main_result, "purity_max_abs_diff": purity,
               "card": smi, "total_s": time.monotonic() - t_start}
    log(f"[6] summary: {json.dumps(summary)}")
    print(smi)
    print(json.dumps({"kernels": []}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
