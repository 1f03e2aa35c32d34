"""Benchmark: CIFAR-10 Genetic-CNN fitness throughput of the PyTorch port on one CUDA card.

The port's counterpart of ``bench.py`` (which measures the JAX package and
stays as it is).  Prints ONE JSON line: {"metric", "value", "unit",
"vs_baseline", ...extras}, carrying the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them.

    python3 bench_torch.py

Workload: BASELINE config #2's shape, as ``bench.py`` builds it: S=(3,4,5),
filters (32,64,128), dense 256, a 20-individual population, CIFAR-10-shaped
synthetic data (10,000 images of 32×32×3, 10 classes), bf16, batch 256,
through ``GeneticCnnModel.cross_validate_population`` on the card.

- ``value``: individuals evaluated per hour per card on the proxy schedule
  (kfold=2, one epoch) at steady state: one warm-up call (the kernels'
  build and the dataset upload), then the median of 3 calls.
- ``vs_baseline``: value / 15.625, the north star's rate (20×50 = 1,000
  evaluations in under 2 h on 32 chips; BASELINE.md).
- ``full_schedule``: one call of the reference-default schedule (kfold=5,
  epochs (20,4,1), lr (1e-2,1e-3,1e-4)); ``GENTUN_BENCH_FULL=0`` skips it.
- ``mfu``: analytic conv+dense FLOPs (the supergraph runs every node conv
  whatever the masks say; elementwise work is not counted, so it is a lower
  bound) over the call's wall time, against an H100's bf16 dense peak of
  989.4e12 FLOP/s (``GENTUN_GPU_PEAK_FLOPS`` overrides it).
- ``accuracy``: the mean accuracy of both schedules, gated as ``bench.py``
  gates them: proxy > 0.5 (no JSON line and a non-zero exit otherwise),
  full > 0.9 (an ``error`` field; ``GENTUN_BENCH_STRICT=1`` also exits
  non-zero).  Nothing else is caught: a failed kernel build or launch, or
  running out of device memory, ends the run with a traceback and no line.

Without a CUDA device it exits non-zero and prints no JSON line.  It has no
comparison with earlier rounds: every ``BENCH_r*.json`` in the repository
is a TPU's.  ``chip_smoke.py`` phase 3 drives the same cell: both take its
configuration, data and genomes from here.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_INDIVIDUALS_PER_HOUR_PER_CHIP = 1000 / 2.0 / 32  # north star, BASELINE.md

#: bf16 dense tensor-core peak of one H100 SXM at its 700 W limit.
PEAK_FLOPS = float(os.environ.get("GENTUN_GPU_PEAK_FLOPS", 989.4e12))

NODES = (3, 4, 5)
FILTERS = (32, 64, 128)
INPUT_SHAPE = (32, 32, 3)
DENSE_UNITS = 256
N_CLASSES = 10
POP = 20
N_DATA = 10_000

COMMON = dict(
    nodes=NODES,
    kernels_per_layer=FILTERS,
    batch_size=256,
    dense_units=DENSE_UNITS,
    compute_dtype="bfloat16",
    seed=0,
)
PROXY = dict(COMMON, kfold=2, epochs=(1,), learning_rate=(0.01,))
FULL = dict(COMMON, kfold=5, epochs=(20, 4, 1), learning_rate=(1e-2, 1e-3, 1e-4))


def cifar_data(n: int = N_DATA):
    """``bench.py``'s data: 10 class prototypes plus noise (32×32×3)."""
    from gentun_tpu_torch.utils.datasets import synthetic_images

    x, y, _ = synthetic_images(n, INPUT_SHAPE, N_CLASSES, seed=0)
    return x, y


def random_population(nodes, pop: int, seed: int):
    from gentun_tpu_torch.genes import genetic_cnn_genome

    rng = np.random.default_rng(seed)
    spec = genetic_cnn_genome(tuple(nodes))
    return [spec.sample(rng) for _ in range(pop)]


def forward_flops_per_image(cfg: dict, input_shape=INPUT_SHAPE, n_classes=N_CLASSES) -> float:
    """Conv and dense multiply-adds ×2 for one image through the supergraph."""
    h, w, c = input_shape
    flops = 0.0
    for k, f in zip(cfg["nodes"], cfg["kernels_per_layer"]):
        flops += 2.0 * h * w * 9 * c * f + k * 2.0 * h * w * 9 * f * f
        h, w, c = h // 2, w // 2, f
    dense = cfg["dense_units"]
    return flops + 2.0 * (h * w * c) * dense + 2.0 * dense * n_classes


def schedule_flops(cfg: dict, pop: int, n_data: int, input_shape=INPUT_SHAPE,
                   n_classes=N_CLASSES) -> float:
    """Executed conv and dense FLOPs of one ``cross_validate_population`` call
    (the backward counted as twice the forward; padded eval rows included)."""
    from gentun_tpu_torch.models.cnn import _eval_batch_size

    fwd = forward_flops_per_image(cfg, input_shape, n_classes)
    kfold, batch = cfg["kfold"], cfg["batch_size"]
    fold_size = n_data // kfold
    n_tr = n_data - fold_size
    total_steps = sum(cfg["epochs"]) * max(n_tr // batch, 1)
    _, n_val_padded = _eval_batch_size(batch, fold_size)
    return pop * kfold * fwd * (total_steps * batch * 3.0 + n_val_padded)


def measure(x, y, cfg: dict, pop: int = POP, mesh="auto", reps: int = 3, warmup: bool = True):
    """Time ``cross_validate_population`` of ``pop`` random genomes under
    ``cfg`` on ``mesh``: one warm-up call when ``warmup``, then ``reps``
    calls, each ended by a device synchronise.  Returns the last call's
    accuracies, the median seconds and every call's seconds."""
    import torch

    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    genomes = random_population(cfg["nodes"], pop, seed=2)
    cuda = mesh in ("auto", None) or torch.device(mesh).type == "cuda"

    def call():
        t0 = time.monotonic()
        accs = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg, mesh=mesh)
        if cuda:
            torch.cuda.synchronize()
        return np.asarray(accs), time.monotonic() - t0

    warm_s = call()[1] if warmup else None
    runs = [call() for _ in range(reps)]
    seconds = [s for _, s in runs]
    return {"accs": runs[-1][0], "seconds": float(np.median(seconds)), "all_seconds": seconds,
            "warmup_seconds": warm_s}


def card_line(cpu: bool = False) -> str:
    """``nvidia-smi``'s name and power limit of the first card; "cpu" for a
    run that was asked for the CPU (it measures no card)."""
    if cpu:
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; this benchmark measures the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    x, y = cifar_data()
    proxy = measure(x, y, PROXY)
    value = POP / proxy["seconds"] * 3600.0
    accs = proxy["accs"]
    if not (np.isfinite(accs).all() and accs.mean() > 0.5):
        print(f"bench_torch: proxy accuracy {accs.mean():.4f} is not above the 0.5 gate "
              "(bench.py's band): throughput is meaningless if the model stopped learning",
              file=sys.stderr)
        return 1
    record = {
        "metric": "cifar10_individuals_per_hour_per_card",
        "value": round(value, 2),
        "unit": "individuals/hour/card",
        "vs_baseline": round(value / BASELINE_INDIVIDUALS_PER_HOUR_PER_CHIP, 3),
        "accuracy": {"proxy_mean": round(float(accs.mean()), 4), "chance": 1.0 / N_CLASSES},
        "config": {"pop": POP, "schedule": "proxy kfold=2 epochs=(1,)",
                   "proxy_wall_s": proxy["all_seconds"], "warmup_wall_s": proxy["warmup_seconds"]},
        "mfu": {"proxy": schedule_flops(PROXY, POP, N_DATA) / proxy["seconds"] / PEAK_FLOPS,
                "basis": "analytic conv+dense FLOPs (lower bound) over the call's wall",
                "peak_flops_per_card": PEAK_FLOPS},
        "device": {"name": torch.cuda.get_device_name(0), "nvidia_smi": card_line(),
                   "cards_used": 1, "torch": torch.__version__, "cuda": torch.version.cuda},
    }
    if os.environ.get("GENTUN_BENCH_FULL", "1") != "0":
        full = measure(x, y, FULL, reps=1, warmup=False)
        full_accs, full_s = full["accs"], full["seconds"]
        full_rate = POP / full_s * 3600.0
        record["mfu"]["value"] = schedule_flops(FULL, POP, N_DATA) / full_s / PEAK_FLOPS
        record["full_schedule"] = {
            "individuals_per_hour_per_card": round(full_rate, 2),
            "vs_baseline": round(full_rate / BASELINE_INDIVIDUALS_PER_HOUR_PER_CHIP, 3),
            "wall_s": round(full_s, 1),
            "schedule": "kfold=5 epochs=(20,4,1) lr=(1e-2,1e-3,1e-4)",
            "accuracy_mean": round(float(full_accs.mean()), 4),
        }
        if not (np.isfinite(full_accs).all() and full_accs.mean() > 0.9):
            # The proxy metric stands; the record says the full run failed its gate.
            record["full_schedule"]["error"] = (
                f"full-schedule accuracy {full_accs.mean():.4f} is not above the 0.9 gate "
                "(bench.py's band)")
            if os.environ.get("GENTUN_BENCH_STRICT") == "1":
                print(json.dumps(record))
                return 1
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
