"""Where a train step's device time goes, at config #2's full width, on one CUDA card.

    python3 -m gentun_tpu_torch.tools.profile_train_step

Builds the population-batched supergraph of config #2 (S=(3,4,5), filters
(32,64,128), dense 256, pop 20, batch 256, bf16, dropout 0.5) with the
port's own init, then, under the executor's precision setting
(``cnn.exact_numerics``):

- times 5 train steps and one eval batch with CUDA events (after 3 warm-up
  steps);
- traces the same steps with ``torch.profiler`` and prints the device
  kernels by total time, grouped (convolution, matmul, elementwise, pooling,
  reduction, copy, other) and one by one, with the device's busy share of the
  traced wall time.

Prints the numbers as one JSON line after the table.  Needs a CUDA
device; exits 2 without one.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

NODES, FILTERS, DENSE, N_CLASSES, BATCH = (3, 4, 5), (32, 64, 128), 256, 10, 256
POP, STEPS = 20, 5

#: Kernel-name patterns for the grouped totals, tried in order.
GROUPS = [
    ("convolution", re.compile(r"conv|cudnn|implicit|xmma|winograd|dgrad|wgrad|fprop|sm90", re.I)),
    ("matmul", re.compile(r"gemm|bmm|matmul|cutlass", re.I)),
    ("pooling", re.compile(r"pool", re.I)),
    ("reduction", re.compile(r"reduce|sum|norm|softmax|nll|cross_entropy|argmax", re.I)),
    ("copy", re.compile(r"copy|memcpy|memset|cat|index|gather|scatter", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|where|mul|add|relu|threshold|fill|rand|philox|bernoulli", re.I)),
]


def _group(name: str) -> str:
    for label, pat in GROUPS:
        if pat.search(name):
            return label
    return "other"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    from gentun_tpu_torch.genes import genetic_cnn_genome
    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.ops.dag import stack_genome_masks

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(2)
    spec = genetic_cnn_genome(NODES)
    genomes = [spec.sample(rng) for _ in range(POP)]
    hashes = cnn._genome_hashes(genomes)
    model = cnn.MaskedGeneticCnn(NODES, FILTERS, POP, (32, 32, 3), DENSE, N_CLASSES,
                                 0.5, "bfloat16", False, device=dev)
    init = cnn._init_population_params(model, 1, 0, hashes)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(init[name][0])
    masks = [{k: torch.as_tensor(v, device=dev) for k, v in st.items()}
             for st in stack_genome_masks(genomes, NODES)]
    x = torch.randn(5000, 3, 32, 32, device=dev)
    y = torch.randint(0, N_CLASSES, (5000,), device=dev)
    bufs = [torch.zeros_like(p) for p in model.parameters()]
    gens = cnn._dropout_generators(0, 0, hashes, dev)

    def step(i):
        idx = torch.randint(0, 5000, (BATCH,), device=dev, generator=None)
        cnn._train_step(model, masks, x, y, idx, gens, bufs, 0.01, 0.9, False)

    with cnn.exact_numerics():  # the executor's numerics, as a fitness run has them
        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(STEPS):
            step(i)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / STEPS

        val = torch.arange(1024, device=dev)
        vw = torch.ones(1024, device=dev)
        cnn._eval_fold(model, masks, x, y, val, vw, 1024)
        torch.cuda.synchronize()
        start.record()
        cnn._eval_fold(model, masks, x, y, val, vw, 1024)
        end.record()
        torch.cuda.synchronize()
        eval_ms = start.elapsed_time(end)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for i in range(STEPS):
                step(i)
            torch.cuda.synchronize()
            traced_ms = (time.monotonic() - t0) * 1e3
    # Raw kernel events, each (name, start, end) counted once; the busy time
    # is the union of their intervals, so overlap or a duplicated record can
    # never push it past the wall.
    spans = {
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        if "CUDA" in str(getattr(e, "device_type", ""))
    }
    kernels = {}
    for name, t0, t1 in spans:
        kernels[name] = kernels.get(name, 0.0) + (t1 - t0)
    busy_us, edge = 0.0, None
    for _, t0, t1 in sorted(spans, key=lambda s: s[1]):
        if edge is None or t0 > edge:
            busy_us += t1 - t0
            edge = t1
        elif t1 > edge:
            busy_us += t1 - edge
            edge = t1
    busy_ms = busy_us / 1e3
    groups = {}
    for name, us in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + us / 1e3 / STEPS
    kernel_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]

    print(f"card: {smi}")
    print(f"config #2 train step, pop {POP}, batch {BATCH}, bf16: {step_ms:.3f} ms/step "
          f"(CUDA events, {STEPS} steps); eval batch of 1024: {eval_ms:.3f} ms")
    print(f"traced {STEPS} steps: wall {traced_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(busy share {busy_ms / traced_ms:.3f}; kernel times summed {kernel_ms:.3f} ms, "
          f"{len(spans)} kernel launches)")
    print("per step, grouped:")
    for label, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {label:12s} {ms:9.3f} ms  {ms / max(kernel_ms / STEPS, 1e-9):6.1%}")
    print("top kernels (total over the traced steps):")
    for name, us in top:
        print(f"  {us / 1e3:9.3f} ms  [{_group(name)}] {name[:110]}")
    out = {
        "card": smi, "pop": POP, "steps": STEPS, "step_ms": step_ms,
        "eval_batch_1024_ms": eval_ms, "traced_wall_ms": traced_ms,
        "device_busy_ms": busy_ms, "kernel_ms_summed": kernel_ms, "launches": len(spans),
        "groups_ms_per_step": groups,
        "top_kernels_ms": {k: v / 1e3 for k, v in top},
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
