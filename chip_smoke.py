#!/usr/bin/env python3
"""Drive the PyTorch port (gentun_tpu_torch) on one CUDA card, end to end.

Run from the root of the repository:

    python3 chip_smoke.py

It first builds the port's CUDA kernels from ``gentun_tpu_torch/csrc/`` with
``nvcc`` into ``build/kernels/`` (an unchanged source is not rebuilt).  Then, in order; any failure exits non-zero and prints no
result:

1. Device: the card's name, ``nvidia-smi``'s name and power limit, the torch
   and CUDA versions.  No CUDA device: exit 2.
K. Kernels: both conv kernels (``pop_conv3x3_fwd``, also run as the input
   gradient, and ``pop_conv3x3_wgrad``) at every conv shape of config #2's
   train step (pop 20, batch 256) and eval forward (batch 1,024), in bf16
   and float32, at config #1's shapes, in float64 and at 600 slots of batch
   512 (more slots × splits than a grid's z axis takes), and both kernels
   (forward, input gradient, weight gradient) at the edge shapes of
   ``EDGE_SHAPES`` (rows that are not whole 16-byte chunks, C=1 and C=3
   with a shared input, F=20 and 50, partial tiles, 600 slots), each held
   against its plain PyTorch version on the same inputs within the
   tolerance stated in ``TOLERANCE``; each config #2 call's kernel, plain,
   cuDNN grouped-conv (the library yardstick, which the port never calls)
   and bound times, and the weight gradient's splits and partials' bytes.
   Then the kernels' purity witness, a gate: at each config #2 conv, as
   forward, input gradient and weight gradient, bf16 and float32, slots 0
   and 7 of an S=20 call give the same bits alone (S=1) and as slot 1 of an
   S=3 call.  Then the three stage-DAG kernels (``csrc/pop_dag.cu``:
   ``pop_dag_node_input``, ``pop_dag_stage_out`` with the 2×2 pool, and
   ``pop_dag_node_grad``) at every call of each stage of the same train step
   and eval forward, on random raw conv outputs with the masks of phase 3's
   genomes, bf16 and float32, each call bit for bit against its plain
   version (the eager chain's ops; at eval in slices of 256 images against
   the kernel's one call at 1,024), timed in bf16 beside its bound, the
   eager chain's time for each stage's same work (``chain_dag_ms``: ReLU
   and the selections once a node, as the model ran them before) and, for
   the pool, ``F.max_pool2d``; the edge cases (``phase_dag_edges``: a stage
   with has_active 0, isolated nodes, odd 7×9 images with inf and NaN, the
   exit conv's sum and pool-only forms, float64 once); the pool's window
   rule against ``F.max_pool2d`` (all-zero, tied and NaN windows: values,
   argmax and the routed gradient); and the whole stage function, a gate:
   the bits of autograd of the eager chain (output and every gradient), and
   slot 7 of S=20 alone.
L. Step 0's leaf check: one genome's grad leaves after one train step's
   backward in slot 0 of a P=2 and of the P=20 model, bf16 and float32,
   must be the same bits; the differing leaves are printed.
2. CPU vs card in float32, with TF32 off for matmuls as the port's
   executor sets it (``cnn.exact_numerics``; the process keeps torch's own
   flag outside it): the same CPU-drawn params and numpy inputs
   at the full width of config #2 give the same logits and the same grads of
   one train step, and a short cross-validation with dropout 0, run through
   the executor with torch's default flags around it, gives the same
   accuracies, each within the tolerance stated beside it.
3. The main path at full width: ``GeneticCnnModel.cross_validate_population``
   at config #2 (S=(3,4,5), filters (32,64,128), dense 256, pop 20, batch
   256, bf16) on synthetic CIFAR-shaped data (10,000 images, 10 classes)
   under the proxy schedule (kfold=2, epochs=(1,)): one warm-up call, one
   timed call, one call with telemetry spans on for the train/eval split.
   The mean proxy accuracy must be at least 0.5.  The launch counts of all
   five kernels (the two convs' and the three DAG kernels') are set to 0
   before these calls and read after; each must be > 0.
4. Purity on the card, a gate: in bf16 and float32 the pop-20 batch against
   the same call again, against the same batch in reversed slot order,
   against three of its genomes trained alone (pop bucket 2, slot 0) and
   against two calls of 10 genomes must agree exactly; float64 (its float32
   head and loss kept) checks one genome alone.
E. Executors at config #2's width: ``fold_parallel=True`` gives the pop-20
   batch's fitnesses bit for bit (bf16 and float32); ``train_and_score``
   and a warm-started CV call give finite accuracies.
5. The GA entry point: ``Population(GeneticCnnIndividual)`` with
   ``GeneticAlgorithm.run(2)`` at config #1's shape (S=(3,5), filters
   (20,50), pop 10, 28×28×1) on synthetic MNIST-shaped data; every
   individual must get a finite fitness.
A. The steady-state search at config #2's full width with ``warm_start``:
   ``AsyncEvolution`` over ``Population(size=8, seed=3)`` with two
   evaluations in flight (each one genome, the 2-slot pop bucket, on a
   worker thread), the fidelity ladder (kfold 2, epochs 1 then 2, eta 3)
   and a surrogate gate, telemetry spans, the lineage ledger and a run
   export on; ``run(16)`` with a ``Checkpointer``, then a fresh engine
   resumed from it to 22.  Each evaluation runs under its own library-conv
   counter (dispatch modes are thread-local).  Gates: finite completions
   and a mean rung-0 fitness above chance (0.1); both kernels launched and
   no library convolution; every rung-0 fitness equal to its slot in one
   batched call on the main thread (warm start off); one promotion's
   fitness equal to a main-thread replay (bank cleared, its rung-0 call,
   its rung-1 call); the resume starts at the checkpoint's count, reaches
   22 and keeps each rung's best; the exported run's train and eval spans
   come from two worker threads; ``build_info`` names torch, CUDA, the
   driver and the SM; two rung-0 genomes evaluated at once on two threads
   give the bits they give one after the other.  Prints the wall,
   evaluations per hour, completions per rung, the gate's admissions, the
   evaluations' walls per rung (and one genome's alone, with and without
   the counter), the two-genome pair's walls serial and threaded, peak
   memory and the lineage device-seconds against wall × 2; then both
   kernels at every conv shape of config #2 at P=2.
W. BASELINE config #4 with the port's worker processes on the card, as
   ``scripts/distributed_tpu_run.py`` sets it up, after the cache of the
   phases before is emptied.  W1: a master
   (``DistributedPopulation(GeneticCnnIndividual, size=20, seed=0)`` on
   config #2's proxy schedule, ``evaluate_retries=3``) and one
   ``python -m gentun_tpu_torch.distributed.worker --species genetic-cnn
   --dataset cifar10 --n 10000 --capacity 20`` process run
   ``RussianRouletteGA(...).run(3)``; then the same GA in this process on
   ``load_cifar10(n=10_000)``.  Gate: the same history and every fitness,
   bit for bit; the worker's kernel launches (logged at its exit) > 0.
   Prints each generation's wall both ways, the evaluated counts and
   individuals per hour against phase 3's.  A ``CompileService`` runs for
   the phase; W1's worker publishes the kernel library to it.  W2: two
   worker processes of capacity 10 (no prefetch), the second with an
   empty ``GENTUN_TORCH_CACHE_DIR``, run two generations.  Gates: the
   second fetched the library (its bytes equal, no ``nvcc`` in its log),
   both served jobs, the history equals W1's and every fitness equals
   W1's; the library fits the service's blob limit.  Prints the walls,
   the card's used memory with both alive and each worker's peak memory.
   W3: a ``GentunClient`` thread in this process, under the library-conv
   counter, serves a ``CanaryDaemon`` probe whose golden was sealed from
   W1's single-process fitness.  Gates: the probe equals its golden bit
   for bit, both kernels launched, no library convolution.  Every worker
   ends with ``SIGTERM`` (its drain) and must exit 0.
W4. The steady-state search over a broker (``AsyncEvolution`` picks its
   distributed evaluator): a master ``DistributedPopulation(GeneticCnnIndividual,
   size=8, seed=3)`` on config #2's proxy at full width with phase A's ladder
   (kfold 2, epochs 1 then 2, eta 3) and a ``SurrogateGate``, warm start off,
   served by one ``python -m gentun_tpu_torch.distributed.worker --species
   genetic-cnn --dataset cifar10 --n 10000 --capacity 20`` process; the
   in-flight target left to the fleet (capacity plus prefetch); ``run(24)``.
   Gates: 24 finite completions; every rung-0 result the worker returned
   equals, bit for bit, one batched ``cross_validate_population`` call of
   the same raw genomes in this process; one promotion's rung-1 result
   equals a replay here; the worker launched both kernels (its exit line);
   no job outstanding at the broker after the engine's cancellations; the
   worker exits 0 on ``SIGTERM``; the phase within ``W4_BOUND_S``.  Prints
   the wall, evaluations per hour against phase A's and phase 3's rates and
   the prediction, completions per rung, the windows the worker trained
   (jobs per group: one group a rung config) and the gate's admissions and
   rejections.
S. The compute-path studies (``scripts/torch_*.py``) on config #2's proxy
   cell at pop 20, phase 3's data and genomes, after phase W; under
   ``S_BOUND_S`` by its own clock.  S1: ``torch_mfu_study.decompose``, the
   call's fenced phases (host setup and indices, the cold dataset upload,
   the CPU init draw, the param upload, the momentum and generators, the
   index uploads, train, eval), ``mfu_train_only`` and
   ``mfu_overall_fenced``; gate: its accuracies equal phase 3's timed call
   bit for bit.  S2: ``entry_channel_pad`` 4 and 8 against unpadded
   (``torch_entry_pad_study.compare``: a warm-up and a timed call each),
   walls and MFU on the unpadded FLOPs; gate: each variant's mean accuracy
   in the bench's proxy band (``ACC_GATE``, 0.5: a padded entry conv draws
   other initial weights, fan-in over the padded channels, so its bits are
   another training's), its distance from unpadded printed.  S3: ``examples/torch_cifar10_genetic_cnn.py
   --generations 1``; gates: it returns, a finite best fitness, no library
   convolution (``conv_counter``).  S4: ``torch_tailgen_study`` at
   ``S_TAILGEN_GENERATIONS`` generations, speculative fill off and 16, each a
   master and a worker process; gate: one GA trajectory and best.  Both
   kernels must launch in S1-S3 and in S4's workers.  S5:
   ``scripts/torch_compile_cache_study.py`` in a process of its own, its
   temporary directories under ``build/chip_smoke/``: the kernel library's
   ``nvcc`` build against a fetch from a ``CompileService`` plus its load
   (act 1, seconds printed), three late joiners that prefetch and load
   (act 2; gate: no ``nvcc`` among them, host 0's bytes), and the service
   killed mid-search (act 3; gate: bit-identical to the service-free run,
   one degraded event).  ``python3 chip_smoke.py --phase-s`` runs phase S
   alone.
D. BASELINE config #5 at full width (S=(5,5,5), filters (64,128,256), dense
   512, 100 classes, pop 50, batch 256, bf16, the proxy schedule), as
   ``examples/torch_cifar100_deep.py`` runs it: ``RussianRouletteGA.run(1)``
   of ``Population(GeneticCnnIndividual)`` on ``load_cifar100(n=10_000)``
   (synthetic, 100 classes) with a ``Checkpointer``, telemetry spans on;
   the kernels' launch counts are set to 0 just before it and read just
   after.  Then the same run again from the checkpoint, and one timed
   pop-50 call of the GA's population with the cap known.  A dispatch mode
   that counts every aten op's convolutions runs over the GA and the
   resume only, so the timed call carries no hook.  Gates: 50 finite
   fitnesses with a mean above chance (0.01); both kernels launched in the
   GA and no library convolution run; the resume reports generation 1 and
   the same best genome; the timed call gives the GA's fitnesses bit for
   bit, and two genomes of the first program give the same bits again as a
   pop-2 batch.  Prints each program's wall and peak memory, whether
   ``_chunked_by_cap`` learned a cap (a CUDA OOM) and which, the timed
   call's wall, its train step and eval batch times (and the GA's), and
   the cost-calibration gauges.
K5. Both conv kernels at every conv shape of config #5's train step (bf16,
   batch 256) and eval forward (batch 1,024), at the slot count phase D's
   programs ran (its learned cap, else 50), each held against the plain
   version under ``TOLERANCE``, with kernel, plain, cuDNN grouped and bound
   times and the calls per step; and the DAG kernels at every call of each
   stage there, bit for bit: the eval rows run the kernel at the full
   batch of 1,024 and the plain version in slices of 256 images, each held
   against the same rows.
B. Config #5 under a ``device_budget`` that classifies it ``micro`` with
   factor 2 (``param_bytes + act_bytes_per_example·128``): two of phase D's
   genomes route one per call, unpadded, microbatch 2, with finite
   fitnesses and ``microbatch_steps_total`` counting; each genome's fitness
   is the same bits alone and routed beside the other; a budget of
   ``param_bytes`` raises ``ValueError``.
M. The ``(pop, data)`` mesh over ranks and the multi-host worker, after the
   cache of the phases before is emptied.  Each rank is a process of this
   script (``--rank``), one ``torch.distributed`` group; two ranks share the
   one card over gloo, named in the output.  M1: two ranks on a ``(2, 1)``
   mesh run config #2's pop-20 proxy call at full width (a first call, then
   a timed one); gate: every fitness equals phase 3's timed call bit for
   bit on both ranks, each rank launched both kernels.  Prints each rank's
   slots, warm wall, launches and peak memory, and individuals per hour
   against phase 3's.  With two cards or more, M1 and M2 run again over
   NCCL, one rank per card; with one, it prints that NCCL was not run and
   why.
   M2: two ranks on a ``(1, 2)`` mesh run phase B's config #5 pair under
   the budget that routes ``big`` over two ranks (one genome a program,
   batch 256 as 128 + 128), once with each step and all-reduce timed
   (synchronised) and once without; gates: the ``big`` class, accuracies
   within ``M2_ACC_BOUND`` of phase D's pop-2 call of the pair, the params
   the same bits on both ranks at every fold's eval, one all-reduce a step.
   Prints the ms a step, the all-reduce's bytes and ms, and the wall
   against phase B's one-process route of the same budget.  M3: a leader
   and a follower ``gentun_tpu_torch.distributed.worker`` process
   (``--coordinator``, ``--num-processes 2``, ``--backend gloo``,
   ``--capacity 20``) serve one generation of config #4's pop-20 master in
   this process; gates: the worker advertises 2 cards, every fitness equals
   phase W's single-process search, and once the leader is SIGKILLed the
   follower exits with 17 within ``M_KILL_BOUND_S``.  Prints phase M's own
   seconds.  Then ``[MK]``: both kernels at one rank's shapes in M1 (config
   #2, P=10, batch 256) and M2 (config #5, P=1, batch 128), as phase K.
6. A summary line of the run as JSON.

Wherever a phase gates on launches, every kernel of the library counts
(``pop_conv.LAUNCHES``, the one table ``pop_dag.LAUNCHES`` shares).  Then
the card's ``nvidia-smi`` name and power limit, the
``{"kernels": [...]}`` line (each of the five kernels' main-path launches,
error and per-train-step times at config #2 (the DAG kernels'
``library_ms`` null: no one library call computes them; the stage output's
``max_pool2d_ms`` beside it), under ``deep`` the same at config #5
with the launches of phase D's GA, under ``async`` at P=2 with phase A's
launches, under ``distributed`` phase W's launches, under
``async_distributed`` W4's worker's, under ``studies``
phase S's, under ``mesh`` and
``mesh_big`` each rank's launches in M1 and M2 with phase MK's times) and,
last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
try:
    # Config #2's proxy cell (configuration, data, genomes, FLOPs) is
    # defined once, in the benchmark, and driven here in phase 3.
    from bench_torch import DENSE_UNITS as DENSE
    from bench_torch import (FILTERS, N_CLASSES, N_DATA, NODES, POP, PROXY, cifar_data,
                             random_population, schedule_flops)
except ImportError:  # copied alone into a directory: main() refuses below
    pass
#: BASELINE config #5 as ``examples/torch_cifar100_deep.py`` runs it.
DEEP_NODES, DEEP_FILTERS, DEEP_DENSE, DEEP_CLASSES = (5, 5, 5), (64, 128, 256), 512, 100
DEEP_POP, DEEP_N = 50, 10_000
DEEP = dict(
    nodes=DEEP_NODES, kernels_per_layer=DEEP_FILTERS, kfold=2, epochs=(1,),
    learning_rate=(0.01,), batch_size=256, dense_units=DEEP_DENSE, compute_dtype="bfloat16",
    seed=0,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def synthetic(n: int, shape_hwc, seed: int):
    """Class prototypes plus noise, 10 classes (the port's ``synthetic_images``)."""
    from gentun_tpu_torch.utils.datasets import synthetic_images

    return synthetic_images(n, shape_hwc, 10, seed=seed)[:2]


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


def phase_build():
    """Build the port's CUDA kernels from the checkout's sources (nvcc for
    sm_90a into build/kernels/) and load them; a failed build raises."""
    from gentun_tpu_torch.ops import _build

    t0 = time.monotonic()
    path = _build.build()
    _build.library()
    log(f"[build] {path.relative_to(REPO)} in {time.monotonic() - t0:.1f} s "
        f"(sources: {', '.join(p.name for p in _build._sources())})")
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


#: Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA data
#: sheet, dense): the bf16 tensor-core rate, the float32 rate outside the
#: tensor cores (the kernels' float32 path is plain FMA), and the memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

#: Kernels' tolerance against the plain version on the same inputs, as a
#: share of the plain result's largest magnitude.  bf16: both sum in float32
#: and round once to bf16 (1 ulp = 2^-8 of a value), the forward's bias add
#: rounds once more; 1e-2 is about 2.5 ulps at the top of the scale, 2e-2
#: for the weight gradient, where cuDNN may round split partials.  float32:
#: the forward sums at most 1,152 products, the weight gradient up to 262,144
#: (stage 0) in 64 split partials, in other orders than cuDNN, which may also
#: take Winograd transforms for a 3×3 conv; 1e-4.  A wiring fault (a slot
#: reading another's data, a layout slip) moves a result by O(1).
TOLERANCE = {
    ("bfloat16", "fwd"): 1e-2, ("bfloat16", "dgrad"): 1e-2, ("bfloat16", "wgrad"): 2e-2,
    ("float32", "fwd"): 1e-4, ("float32", "dgrad"): 1e-4, ("float32", "wgrad"): 1e-4,
    ("float64", "fwd"): 1e-12, ("float64", "dgrad"): 1e-12, ("float64", "wgrad"): 1e-12,
}


def conv_layers(nodes, filters, hw: int, c_in: int):
    """(name, shared input, C, F, H=W, convs of that shape per forward) for
    each distinct conv of the supergraph; every node conv runs whatever the
    masks say."""
    out, h, c = [], hw, c_in
    for s, (k, f) in enumerate(zip(nodes, filters)):
        out.append((f"stage{s}_entry", s == 0, c, f, h, 1))
        out.append((f"stage{s}_node", False, f, f, h, k))
        h, c = h // 2, f
    return out


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of one ``fn()`` over ``reps`` launches after one
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def err_and_scale(a, r, chunk: int = 1 << 26):
    """(max |a - r|, max |r|) in float64, a chunk of elements at a time (an
    eval output of config #5 is 6.7 GB in bf16)."""
    a, r = a.reshape(-1), r.reshape(-1)
    err = scale = 0.0
    for i in range(0, a.numel(), chunk):
        ad, rd = a[i:i + chunk].double(), r[i:i + chunk].double()
        err = max(err, float((ad - rd).abs().max()))
        scale = max(scale, float(rd.abs().max()))
    return err, scale


def conv_case(torch, dtype: str, role: str, shared: bool, slots: int,
              c: int, f: int, b: int, h: int, timed: bool, width=None):
    """One kernel call against its plain version (and cuDNN's grouped conv
    as the library yardstick) on the card, on h×h images (h×width when
    ``width`` is given).  ``role`` is ``fwd``, ``dgrad`` (the forward kernel
    on dY with the turned weights) or ``wgrad``.  Returns the check's
    numbers; the phase fails if the error is over the tolerance."""
    import torch.nn.functional as F
    from gentun_tpu_torch.ops import pop_conv

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(slots * 1000 + c * 10 + f)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(dt)
    wd = h if width is None else width
    x = rnd(b, c, h, wd) if shared else rnd(b, slots * c, h, wd)
    w = (rnd(slots, f, c, 3, 3).float() / (9 * c) ** 0.5).to(dt)
    bias = rnd(slots, f)
    dy = rnd(b, slots * f, h, wd) if role != "fwd" else None  # drawn last: x, w, bias unchanged
    if role == "wgrad":  # a batch-mean loss's scale: dW and db of order 1
        dy = (dy.float() / (b * h * wd) ** 0.5).to(dt)
    lib_groups = 1 if shared else slots
    esize = x.element_size()
    flops = 2.0 * b * h * wd * 9 * c * f * slots
    if role == "fwd":
        kernel = lambda: pop_conv.pop_conv3x3_fwd(x, w, bias, shared)
        plain = lambda: pop_conv.pop_conv3x3_reference(x, w, bias, shared)
        library = lambda: F.conv2d(x, w.view(slots * f, c, 3, 3), bias.view(-1), padding=1,
                                   groups=lib_groups)
        nbytes = (x.numel() + w.numel() + bias.numel() + b * slots * f * h * wd) * esize
    elif role == "dgrad":
        turned = w.flip(-1, -2).transpose(1, 2).contiguous()
        kernel = lambda: pop_conv.pop_conv3x3_fwd(dy, turned, None)
        plain = lambda: pop_conv.pop_conv3x3_reference(dy, turned, None)
        library = lambda: torch.ops.aten.convolution_backward(
            dy, x, w.view(slots * f, c, 3, 3), None, [1, 1], [1, 1], [1, 1], False, [0, 0],
            slots, [True, False, False])[0]
        nbytes = (dy.numel() + w.numel() + x.numel()) * esize
    else:
        kernel = lambda: pop_conv.pop_conv3x3_wgrad(x, dy, w.shape, shared)
        plain = lambda: pop_conv.pop_conv3x3_wgrad_reference(x, dy, w.shape, shared)
        library = lambda: torch.ops.aten.convolution_backward(
            dy, x, w.view(slots * f, c, 3, 3), [slots * f], [1, 1], [1, 1], [1, 1],
            False, [0, 0], lib_groups, [False, True, True])[1:]
        flops += 1.0 * b * h * wd * f * slots
        nbytes = (x.numel() + dy.numel() + w.numel() + bias.numel()) * esize
        splits, _ = pop_conv.wgrad_split(b, h, wd, c, f, dt)
        # the float partials, written by the kernel and read by its second pass
        scratch = 2 * slots * splits * f * (9 * c + 1) * (8 if dtype == "float64" else 4)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version and the library in IEEE float32
    try:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if role == "wgrad" else [(got, want)]
        err, scale = (max(v) for v in zip(*(err_and_scale(a, r) for a, r in pairs)))
        del got, want, pairs
        tol = TOLERANCE[dtype, role]
        out = {"dtype": dtype, "role": role, "shape": [slots, c, f, b, h, wd, int(shared)],
               "max_abs_err": err, "rel_err": err / max(scale, 1e-300), "tol": tol}
        if role == "wgrad":
            out["splits"], out["scratch_bytes"] = splits, scratch
        if timed:
            out["ms"] = cuda_ms(torch, kernel)
            out["plain_ms"] = cuda_ms(torch, plain)
            out["library_ms"] = cuda_ms(torch, library)
            t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
            out["bound_ms"] = max(t_ops, t_bytes)
            out["bound_ops_ms"], out["bound_bytes_ms"] = t_ops, t_bytes
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    check(out["rel_err"] <= tol,
          f"{role} kernel vs plain, {dtype}, shape {out['shape']}: {out['rel_err']:.3e} > {tol}")
    return out


#: Edge shapes of the kernels, each held against the plain version in bf16
#: and float32, as the forward, (own input) the input gradient and the
#: weight gradient: (slots, C, F, B, H, W, shared input).
EDGE_SHAPES = [
    (4, 16, 24, 9, 7, 7, False),     # 7-wide rows: 14 bytes, not 16-byte chunks
    (3, 8, 8, 5, 5, 5, False),       # 5-wide rows
    (5, 1, 20, 7, 28, 28, True),     # C=1, shared input, F=20
    (5, 3, 32, 3, 32, 32, True),     # C=3, shared input
    (4, 20, 50, 6, 14, 14, False),   # F=50
    (4, 50, 20, 6, 14, 14, False),   # C=50, F=20
    (3, 64, 128, 3, 8, 8, False),    # 3 images of 8x8, fewer than a tile holds
    (3, 128, 64, 3, 8, 8, False),    # the same in chunks of 32 channels (C >= 128)
    (2, 32, 32, 2, 24, 24, False),   # 24 rows in tiles of 10: B·H·W not whole tiles
    (2, 136, 20, 3, 7, 7, False),    # C >= 128 on narrow rows, a partial last chunk
    (2, 8, 8, 1, 3, 300, False),     # rows wider than a tile
    (600, 8, 16, 8, 16, 16, False),  # 600 slots
]


def kernel_purity(torch):
    """The kernels' own purity witness: for each conv of config #2's train
    step, as the forward, (own input) as the input gradient and as the weight
    gradient, in bf16 and float32, slots 0 and 7 of an S=20 call run again
    alone (S=1) and as slot 1 of an S=3 call must give the same bits (the
    output, or dW and db).  Returns the rows; the phase fails on any
    difference."""
    from gentun_tpu_torch.ops import pop_conv

    dev, b, rows = torch.device("cuda"), 256, []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for name, shared, c, f, h, _ in conv_layers(NODES, FILTERS, 32, 3):
            for role in ("fwd", "wgrad") if shared else ("fwd", "dgrad", "wgrad"):
                cin, cout = (f, c) if role == "dgrad" else (c, f)
                g = torch.Generator(device=dev).manual_seed(cin * 1000 + cout)
                rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(dt)

                def operand():  # one slot's operands besides its input
                    if role == "wgrad":
                        return (rnd(b, cout, h, h),)  # dY
                    if role == "fwd":
                        return rnd(cout, cin, 3, 3), rnd(cout)  # weights, bias
                    return (rnd(cout, cin, 3, 3),)

                def run(xs, ops):
                    """The kernel on len(ops) slots; each slot's outputs."""
                    n, xin = len(ops), xs if shared else torch.cat(xs, 1)
                    if role == "wgrad":
                        dw, db = pop_conv.pop_conv3x3_wgrad(
                            xin, torch.cat([o[0] for o in ops], 1), (n, cout, cin, 3, 3), shared)
                        return [(dw[k], db[k]) for k in range(n)]
                    wt = torch.stack([o[0] for o in ops])
                    bias = torch.stack([o[1] for o in ops]) if role == "fwd" else None
                    y = pop_conv.pop_conv3x3_fwd(xin, wt, bias, shared).view(b, n, cout, h, h)
                    return [(y[:, k],) for k in range(n)]

                x = rnd(b, cin, h, h) if shared else [rnd(b, cin, h, h) for _ in range(POP)]
                ops = [operand() for _ in range(POP)]
                full = run(x, ops)
                differ = []
                for slot in (0, 7):
                    alone = run(x if shared else [x[slot]], [ops[slot]])[0]
                    x3 = x if shared else [rnd(b, cin, h, h), x[slot], rnd(b, cin, h, h)]
                    third = run(x3, [operand(), ops[slot], operand()])[1]
                    for what, got in ((f"slot {slot} alone", alone),
                                      (f"slot {slot} as slot 1 of 3", third)):
                        if not all(torch.equal(u, v) for u, v in zip(got, full[slot])):
                            differ.append(what)
                rows.append({"dtype": dtype, "role": role, "layer": name, "differ": differ})
                log(f"[K] purity {dtype:8s} {role:5s} {name:12s} C={cin:3d} F={cout:3d}: slots 0 "
                    f"and 7 of S={POP} vs alone (S=1) and as slot 1 of S=3: "
                    f"{'same bits' if not differ else 'DIFFER ' + ', '.join(differ)}")
                check(not differ, f"kernel purity, {dtype} {role} {name}: {differ}")
    return rows


# ---------------------------------------------------------------------------
# The stage-DAG kernels (csrc/pop_dag.cu): each call held bit for bit against
# its plain version (the eager chain's ops) on the same inputs.
# ---------------------------------------------------------------------------

DAG_SOURCE = "gentun_tpu_torch/csrc/pop_dag.cu"
DAG_KERNELS = ("pop_dag_node_input", "pop_dag_stage_out", "pop_dag_node_grad")
KERNELS = ("pop_conv3x3_fwd", "pop_conv3x3_wgrad", *DAG_KERNELS)
#: The DAG kernels do their arithmetic in float32 (float64 for float64) on
#: the CUDA cores: 67 TFLOP/s (NVIDIA H100 SXM data sheet, 700 W).
DAG_PEAK_FLOPS = 67e12


def new_per_step():
    """Per-step totals for every kernel of the library."""
    return {name: {} for name in KERNELS}


def same_bits(torch, a, b) -> bool:
    """The same values, NaN where the other has NaN (+0 and -0 alike)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    an, bn = a.isnan(), b.isnan()
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.equal(an, bn) and torch.equal(torch.where(an, zero, a), torch.where(bn, zero, b))


def stage_masks_of(torch, genomes, nodes, s):
    """Stage s's masks of the genomes as the stage function takes them, on the card."""
    from gentun_tpu_torch.ops.dag import stack_genome_masks
    from gentun_tpu_torch.ops.pop_dag import stage_masks

    return stage_masks(stack_genome_masks(genomes, nodes)[s], torch.device("cuda"))


def dag_stage_rows(torch, dtype, masks, b, f, h, w, exit_conv=False, timed=False,
                   forward_only=False, nonfinite=False, seed=0, plain_rows=None):
    """Every DAG kernel call of one stage (S = the masks' slots, k their
    nodes, F channels, h×w images, batch b) on random raw conv outputs:
    forward (node inputs, the stage output with the pool, or with
    ``exit_conv`` the sum and the pool-only form) and, unless
    ``forward_only``, backward (each node's and the entry's gradient from the
    pooled gradient and the successors' input gradients, or the full-size
    one after the exit conv).  Each call against its plain version, bit for
    bit: the phase fails otherwise.  With ``plain_rows``, the kernel runs
    once at the full batch and the plain version on slices of that many
    images, each slice held against the same rows of the kernel's output
    (every image is independent in each DAG function): the kernel keeps the
    main path's shape while the plain version's temporaries stay small.
    ``nonfinite`` puts inf and NaN among
    the inputs.  With ``timed``, the kernel's and the plain version's times
    (the plain version's over all slices),
    the bound (bytes at 3.35 TB/s or float32 operations at 67 TFLOP/s), and
    for a pooling call ``F.max_pool2d``'s time on the stage's full-size
    output.  Returns one row a call."""
    import torch.nn.functional as F
    from gentun_tpu_torch.ops import pop_dag as pd

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    k, slots = masks.k, masks.slots
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev,
                                     dtype=torch.float32).to(dt)
    full = (b, slots * f, h, w)
    y_entry, ys = rnd(*full), [rnd(*full) for _ in range(k)]
    if nonfinite:
        y_entry.view(-1)[::997] = float("inf")
        for i, y in enumerate(ys):
            y.view(-1)[i::991] = float("nan") if i % 2 else float("inf")
    n, es = y_entry.numel(), y_entry.element_size()
    npool = b * slots * f * (h // 2) * (w // 2)
    slices = [slice(a, a + (plain_rows or b)) for a in range(0, b, plain_rows or b)]
    cut = lambda ts, sl: [t[sl] for t in ts]
    # (kernel, label, kernel fn, plain fn of a batch slice, bytes, flops,
    # pooled input of a batch slice)
    calls = []

    def add(kernel, label, fn, plain, nbytes, flops, pooled=None):
        calls.append((kernel, label, fn, plain, nbytes, flops, pooled))

    for j in range(k):
        add("pop_dag_node_input", f"node_input j={j}",
            lambda j=j: pd.pop_dag_node_input(y_entry, ys, j, masks),
            lambda sl, j=j: pd.pop_dag_node_input_reference(y_entry[sl], cut(ys, sl), j, masks),
            (j + 2) * n * es, (2 + 4 * j) * n)
    y_exit = rnd(*full) if exit_conv else None
    if exit_conv:
        add("pop_dag_stage_out", "stage_out sum",
            lambda: pd.pop_dag_stage_out(y_entry, ys, masks, False),
            lambda sl: pd.pop_dag_stage_out_reference(y_entry[sl], cut(ys, sl), masks, False),
            (k + 2) * n * es, (4 * k + 4) * n)
        add("pop_dag_stage_out", "stage_out pool-only",
            lambda: pd.pop_dag_stage_out(y_exit, [], masks, True),
            lambda sl: pd.pop_dag_stage_out_reference(y_exit[sl], [], masks, True),
            n * es + npool * (es + 1), 2 * n, pooled=lambda sl: torch.relu(y_exit[sl]))
        gidx = pd.pop_dag_stage_out(y_exit, [], masks, True)[1]
    else:
        add("pop_dag_stage_out", "stage_out pool",
            lambda: pd.pop_dag_stage_out(y_entry, ys, masks, True),
            lambda sl: pd.pop_dag_stage_out_reference(y_entry[sl], cut(ys, sl), masks, True),
            (k + 1) * n * es + npool * (es + 1), (4 * k + 6) * n,
            pooled=lambda sl: pd.pop_dag_stage_out_reference(y_entry[sl], cut(ys, sl), masks,
                                                             False))
        gidx = pd.pop_dag_stage_out(y_entry, ys, masks, True)[1]
    if not forward_only:
        gz = rnd(*gidx.shape)
        d = [rnd(*full) for _ in range(k)]
        g_in = npool * (es + 1)
        if exit_conv:
            add("pop_dag_node_grad", "node_grad exit (plain, pooled g)",
                lambda: pd.pop_dag_node_grad(y_exit, gz, gidx, "plain", -1, d, masks),
                lambda sl: pd.pop_dag_node_grad_reference(y_exit[sl], gz[sl], gidx[sl], "plain", -1,
                                                          cut(d, sl), masks),
                2 * n * es + g_in, 4 * n)
            g, gi, g_in = rnd(*full), None, n * es
        else:
            g, gi = gz, gidx
        for i in range(k - 1, -1, -1):
            add("pop_dag_node_grad", f"node_grad node {i}",
                lambda i=i: pd.pop_dag_node_grad(ys[i], g, gi, "node", i, d, masks),
                lambda sl, i=i: pd.pop_dag_node_grad_reference(
                    ys[i][sl], g[sl], None if gi is None else gi[sl], "node", i, cut(d, sl), masks),
                (2 + k - 1 - i) * n * es + g_in, (5 + 3 * (k - 1 - i)) * n)
        mode = "entry" if k else "plain"
        add("pop_dag_node_grad", f"node_grad entry ({mode})",
            lambda: pd.pop_dag_node_grad(y_entry, g, gi, mode, -1, d, masks),
            lambda sl: pd.pop_dag_node_grad_reference(
                y_entry[sl], g[sl], None if gi is None else gi[sl], mode, -1, cut(d, sl), masks),
            (2 + k) * n * es + g_in, (3 + 3 * k) * n)
    rows = []
    tup = lambda out: out if isinstance(out, tuple) else (out,)
    for kernel, label, fn, plain, nbytes, flops, pooled in calls:
        got, same, err = tup(fn()), True, 0.0
        for sl in slices:
            for a, r in zip(got, tup(plain(sl))):
                if not same_bits(torch, a[sl], r):
                    same = False
                    err = max(err, err_and_scale(a[sl].float(), r.float())[0])
        del got
        row = {"kernel": kernel, "label": label, "dtype": dtype,
               "shape": [slots, k, f, b, h, w], "same_bits": same, "max_abs_err": err,
               "plain_rows": plain_rows or b}
        check(same, f"{kernel} ({label}) vs its plain version, {dtype}, S={slots} k={k} "
                    f"F={f} B={b} {h}x{w}: not the same bits (max abs err {err})")
        if timed:
            row["ms"] = cuda_ms(torch, fn)
            row["plain_ms"] = cuda_ms(torch, lambda: [plain(sl) for sl in slices])
            row["library_ms"] = None
            row["bound_bytes_ms"] = nbytes / PEAK_BYTES * 1e3
            row["bound_ops_ms"] = flops / DAG_PEAK_FLOPS * 1e3
            row["bound_ms"] = max(row["bound_bytes_ms"], row["bound_ops_ms"])
            if pooled is not None:
                xin = y_entry.new_empty(full)
                for sl in slices:
                    xin[sl] = pooled(sl)
                row["max_pool2d_ms"] = cuda_ms(torch, lambda: F.max_pool2d(xin, 2))
                del xin
        rows.append(row)
    return rows


def add_dag_per_step(tot, r):
    """Add one DAG row (one call a train step) to its kernel's totals."""
    for key in ("ms", "plain_ms", "bound_ms", "bound_ops_ms", "bound_bytes_ms"):
        tot[key] = tot.get(key, 0.0) + r[key]
    if "max_pool2d_ms" in r:
        tot["max_pool2d_ms"] = tot.get("max_pool2d_ms", 0.0) + r["max_pool2d_ms"]
    tot["bound_bytes_calls_ms"] = tot.get("bound_bytes_calls_ms", 0.0) + r["bound_ms"]
    tot["library_ms"] = None
    tot["max_abs_err"] = max(tot.get("max_abs_err", 0.0), r["max_abs_err"])
    tot["calls"] = tot.get("calls", 0) + 1


def step_dag(torch, tag, nodes, filters, slots, dtype, per_step=None, batch=256):
    """Every DAG kernel call of one train step (and in bf16 of one eval
    batch of 1,024, the plain version in slices of ``batch`` images) at each
    stage of the supergraph on 32×32 images, with the masks of
    ``random_population(nodes, slots, seed=2)`` (phase 3's genomes at
    config #2), held against the plain version; timed, summed per kernel
    into ``per_step`` and beside it the eager chain's time for the same
    work (:func:`chain_dag_ms`), when ``per_step`` is given."""
    genomes = random_population(nodes, slots, seed=2)
    rows, h = [], 32
    for s, (k, f) in enumerate(zip(nodes, filters)):
        masks = stage_masks_of(torch, genomes, nodes, s)
        stage = dag_stage_rows(torch, dtype, masks, batch, f, h, h, timed=per_step is not None,
                               seed=s)
        evals = []
        if dtype == "bfloat16":
            evals = dag_stage_rows(torch, dtype, masks, 1024, f, h, h, timed=True,
                                   forward_only=True, seed=10 + s, plain_rows=batch)
        for r, when in [(r, f"train B={batch}") for r in stage] + [(r, "eval B=1024") for r in evals]:
            r["stage"], r["per_step"] = s, 1 if when.startswith("train") else 0
            sliced = (f" (in slices of {r['plain_rows']})"
                      if r["plain_rows"] < r["shape"][3] else "")
            times = (f"; kernel {r['ms']:.3f} ms, plain{sliced} {r['plain_ms']:.3f}, bound "
                     f"{r['bound_ms']:.3f}" + (f", F.max_pool2d {r['max_pool2d_ms']:.3f}"
                                               if "max_pool2d_ms" in r else "")
                     if "ms" in r else "")
            log(f"[{tag}] dag {dtype:8s} stage{s} {r['label']:28s} S={slots} k={k} F={f} "
                f"{h}x{h} {when}: same bits{times}")
            if per_step is not None and r["per_step"]:
                add_dag_per_step(per_step[r["kernel"]], r)
        if per_step is not None:
            chain = chain_dag_ms(torch, dtype, masks, batch, f, h, h, seed=20 + s)
            log(f"[{tag}] dag {dtype:8s} stage{s} eager chain (train B={batch}): node inputs "
                f"{chain['pop_dag_node_input']:.3f} ms, stage output and F.max_pool2d "
                f"{chain['pop_dag_stage_out']:.3f} ms, autograd backward "
                f"{chain['pop_dag_node_grad']:.3f} ms")
            for kname, ms in chain.items():
                per_step[kname]["chain_ms"] = per_step[kname].get("chain_ms", 0.0) + ms
        rows += stage + evals
        h //= 2
    return rows


def chain_inputs(torch, y_entry, ys, masks):
    """The eager chain's node inputs from a stage's raw conv outputs, as the
    model ran them before the stage function (ReLU and the ``active``
    selection once a node, shared by every consumer): ``(a0, outs, inps)``,
    each ``(B, S, F, H, W)``."""
    import torch.nn.functional as F

    dt, k, pop = y_entry.dtype, masks.k, masks.slots
    b, _, hh, ww = y_entry.shape
    adj, entry, active = (m.to(dt) for m in masks[:3])
    sc = lambda v, t: v.view(1, -1, 1, 1, 1) * t
    a0 = F.relu(y_entry).reshape(b, pop, -1, hh, ww)
    outs, inps = [], []
    for j in range(k):
        inp = sc(entry[:, j], a0)
        for i in range(j):
            inp = inp + sc(adj[:, i, j], outs[i])
        inps.append(inp)
        outs.append(sc(active[:, j], F.relu(ys[j]).reshape(b, pop, -1, hh, ww)))
    return a0, outs, inps


def chain_merge(torch, a0, outs, masks):
    """The eager chain's stage output ``(B, S·F, H, W)`` from ``a0`` and the
    nodes' selected outputs, before the pool (and the exit conv)."""
    dt = a0.dtype
    exit_, has = masks.exit.to(dt), masks.has_active.to(dt)
    sc = lambda v, t: v.view(1, -1, 1, 1, 1) * t
    if outs:
        out = sc(exit_[:, 0], outs[0])
        for i in range(1, len(outs)):
            out = out + sc(exit_[:, i], outs[i])
        xs = sc(has, out) + sc(1.0 - has, a0)
    else:
        xs = a0
    b, _, _, hh, ww = a0.shape
    return xs.reshape(b, -1, hh, ww)


def chain_dag_ms(torch, dtype, masks, b, f, h, w, seed=0):
    """Device ms of the eager chain's ops that the DAG kernels replace, for
    one stage (S = the masks' slots, k their nodes, F channels, h×w images,
    batch b) on random raw conv outputs: ``{kernel: ms}``, the node inputs
    (:func:`chain_inputs`) for ``pop_dag_node_input``, the stage output and
    ``F.max_pool2d`` for ``pop_dag_stage_out``, and autograd's backward of
    both, from a pooled gradient and each node input's gradient, for
    ``pop_dag_node_grad``."""
    import torch.nn.functional as F

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev,
                                     dtype=torch.float32).to(dt)
    full = (b, masks.slots * f, h, w)
    leaves = [rnd(*full).requires_grad_() for _ in range(masks.k + 1)]
    out = {}
    with torch.no_grad():
        out["pop_dag_node_input"] = cuda_ms(
            torch, lambda: chain_inputs(torch, leaves[0], leaves[1:], masks))
        a0, outs, _ = chain_inputs(torch, leaves[0], leaves[1:], masks)
        out["pop_dag_stage_out"] = cuda_ms(
            torch, lambda: F.max_pool2d(chain_merge(torch, a0, outs, masks), 2))
        del a0, outs
    a0, outs, inps = chain_inputs(torch, leaves[0], leaves[1:], masks)
    z = F.max_pool2d(chain_merge(torch, a0, outs, masks), 2)
    del a0, outs
    roots, grads = [z], [rnd(*z.shape)]
    for inp in inps:
        roots.append(inp)
        grads.append(rnd(*inp.shape))
    out["pop_dag_node_grad"] = cuda_ms(
        torch, lambda: torch.autograd.grad(roots, leaves, grads, retain_graph=True))
    return out


def chain_stage(torch, x, masks, params, shared, exit_conv):
    """One stage as the model ran it before the stage function: the eager
    chain of torch ops around ``PopConv3x3Fn``, which autograd
    differentiates."""
    import torch.nn.functional as F
    from gentun_tpu_torch.ops.pop_conv import PopConv3x3Fn

    dt, k, pop, b = x.dtype, masks.k, masks.slots, x.shape[0]
    adj, entry, active = (m.to(dt) for m in masks[:3])
    sc = lambda v, t: v.view(1, -1, 1, 1, 1) * t
    a0 = F.relu(PopConv3x3Fn.apply(x, params[0], params[1], shared))
    hh, ww = a0.shape[-2:]
    a0 = a0.reshape(b, pop, -1, hh, ww)
    outs = []
    for j in range(k):
        inp = sc(entry[:, j], a0)
        for i in range(j):
            inp = inp + sc(adj[:, i, j], outs[i])
        h = F.relu(PopConv3x3Fn.apply(inp.reshape(b, -1, hh, ww), params[2 + 2 * j],
                                      params[3 + 2 * j]))
        outs.append(sc(active[:, j], h.reshape(b, pop, -1, hh, ww)))
    xs = chain_merge(torch, a0, outs, masks)
    if exit_conv:
        xs = F.relu(PopConv3x3Fn.apply(xs, params[-2], params[-1]))
    return F.max_pool2d(xs, 2)


def dag_stage_fn_checks(torch):
    """Gates of the whole stage on the card, bf16 and float32: (1) the stage
    function (the conv and DAG kernels) gives the bits of autograd of the
    eager chain, output and every gradient (config #2's stage 1 at P=4,
    B=64, and with the exit conv); (2) purity: slot 7 of an S=20 call gives
    the same output and gradients alone (S=1).  Returns the rows."""
    from gentun_tpu_torch.ops.pop_dag import DagMasks, pop_stage

    dev, rows = torch.device("cuda"), []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for slots, b, exit_conv in ((4, 64, False), (4, 16, True), (POP, 64, False)):
            k, c, f, h = NODES[1], FILTERS[0], FILTERS[1], 16
            gen = torch.Generator(device=dev).manual_seed(slots + int(exit_conv))
            rnd = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen, device=dev) * sd).to(dt)
            masks = stage_masks_of(torch, random_population(NODES, slots, seed=2), NODES, 1)
            x = rnd(b, slots * c, h, h).requires_grad_()
            params = [rnd(slots, f, c, 3, 3, sd=(9 * c) ** -0.5), rnd(slots, f, sd=0.1)]
            for _ in range(k + int(exit_conv)):
                params += [rnd(slots, f, f, 3, 3, sd=(9 * f) ** -0.5), rnd(slots, f, sd=0.1)]
            params = [p.requires_grad_() for p in params]
            z = pop_stage(x, masks, params)
            gz = rnd(*z.shape)
            grads = torch.autograd.grad(z, [x, *params], gz)
            if slots == POP:  # purity: slot 7 alone
                sl = 7
                x1 = x.detach().view(b, slots, c, h, h)[:, sl].contiguous().requires_grad_()
                m1 = DagMasks(*(m[sl:sl + 1].contiguous() for m in masks))
                p1 = [p.detach()[sl:sl + 1].contiguous().requires_grad_() for p in params]
                z1 = pop_stage(x1, m1, p1)
                g1 = torch.autograd.grad(z1, [x1, *p1], gz.view(b, slots, f, h // 2, h // 2)[:, sl]
                                         .contiguous())
                ok = (torch.equal(z1, z.view(b, slots, f, h // 2, h // 2)[:, sl])
                      and torch.equal(g1[0], grads[0].view(b, slots, c, h, h)[:, sl])
                      and all(torch.equal(a[0], full[sl]) for a, full in zip(g1[1:], grads[1:])))
                what = f"slot {sl} of S={slots} alone (S=1), output and every gradient"
            else:
                want = chain_stage(torch, x, masks, params, False, exit_conv)
                wgrads = torch.autograd.grad(want, [x, *params], gz)
                ok = torch.equal(z, want) and all(torch.equal(a, w) for a, w in zip(grads, wgrads))
                what = (f"stage function vs autograd of the eager chain, S={slots} B={b}"
                        f"{' with the exit conv' if exit_conv else ''}, output and every gradient")
            log(f"[K] dag {dtype:8s} {what}: {'same bits' if ok else 'DIFFER'}")
            rows.append({"dtype": dtype, "what": what, "same_bits": ok})
            check(ok, f"{dtype} {what}")
    return rows


def dag_pool_ties(torch):
    """The pool's window rule on the card against ``F.max_pool2d``: an
    all-zero window (negative inputs after ReLU), tied maxima, NaN, and an
    odd last row and column; the value, the argmax as ``F.max_pool2d``'s
    flat index, and the gradient routed to it, bit for bit, bf16 and float32,
    on the kernels' vector path (16 wide) and their one-element path (7
    wide).  Returns the rows."""
    import torch.nn.functional as F
    from gentun_tpu_torch.ops import pop_dag as pd

    dev, rows = torch.device("cuda"), []
    base = [[-1.0, -2.0, 2.0, 2.0, 1.0, 3.0, 1.0, float("nan")],
            [-3.0, -0.5, 2.0, 2.0, 3.0, 0.0, float("nan"), 2.0],
            [0.0, 0.0, 5.0, -1.0, 4.0, 4.0, 7.0, 7.0],
            [0.0, 0.0, -1.0, 5.0, 4.0, 4.0, 6.0, 7.0],
            [9.0, 8.0, 9.0, 8.0, 9.0, 8.0, 9.0, 8.0]]
    masks = pd.DagMasks(*(torch.zeros(shape, device=dev) for shape in ((1, 0, 0), (1, 0), (1, 0), (1, 0))),
                        torch.ones(1, device=dev))
    for dtype in ("bfloat16", "float32"):
        for width in (16, 7):
            rows_ = [(r * 2)[:width] for r in base]
            y = torch.tensor(rows_, device=dev).to(getattr(torch, dtype)).view(1, 1, 5, width)
            z, arg = pd.pop_dag_stage_out(y, [], masks, True)
            want, idx = F.max_pool2d(torch.relu(y), 2, return_indices=True)
            ho = torch.arange(z.shape[-2], device=dev).view(-1, 1)
            wo = torch.arange(z.shape[-1], device=dev).view(1, -1)
            flat = (2 * ho + arg[0, 0].long() // 2) * width + 2 * wo + arg[0, 0].long() % 2
            gz = torch.arange(1, z.numel() + 1, device=dev, dtype=torch.float32).to(y.dtype).view(z.shape)
            dy = pd.pop_dag_node_grad(y, gz, arg, "plain", -1, [], masks)
            yy = y.clone().requires_grad_()
            (g,) = torch.autograd.grad(F.max_pool2d(torch.relu(yy), 2), yy, gz)
            ok = same_bits(torch, z, want) and torch.equal(flat, idx[0, 0]) and same_bits(torch, dy, g)
            log(f"[K] dag pool rule {dtype} 5x{width} (all-zero, tied and NaN windows, odd edge) "
                f"vs F.max_pool2d: {'same values, argmax and gradient' if ok else 'DIFFER'}")
            rows.append({"dtype": dtype, "width": width, "same": ok})
            check(ok, f"the pool's window rule vs F.max_pool2d, {dtype}, 5x{width}")
    return rows


def phase_dag_edges(torch):
    """The DAG kernels at the edge cases, each call against its plain
    version bit for bit, bf16 and float32: a stage of 4 nodes whose slot 0
    decodes empty (has_active = 0), slot 1 with isolated nodes and slot 2 a
    full DAG, on odd 7×9 images (the one-element path and a floored pool)
    with inf and NaN among the inputs, with and without the exit conv, and
    on 8×16 (the vector path) with the exit conv, and without it with the
    plain version in slices of 2 of 5 images; float64 once; then the
    pool's window rule and the whole-stage gates.  Returns the rows."""
    t0 = time.monotonic()
    edges = [{"S_1": (0,) * 6}, {"S_1": (1, 0, 0, 0, 0, 0)}, {"S_1": (1,) * 6}]
    masks = stage_masks_of(torch, edges, (4,), 0)
    rows = []
    for dtype in ("bfloat16", "float32"):
        for exit_conv in (False, True):
            rows += dag_stage_rows(torch, dtype, masks, 5, 8, 7, 9, exit_conv=exit_conv,
                                   nonfinite=True, seed=21)
        rows += dag_stage_rows(torch, dtype, masks, 4, 16, 8, 16, exit_conv=True, seed=22)
        rows += dag_stage_rows(torch, dtype, masks, 5, 16, 8, 16, seed=24, plain_rows=2)
        log(f"[K] dag edges {dtype}: has_active 0, isolated nodes, a full DAG; 7x9 with inf and "
            f"NaN, with and without the exit conv; 8x16 with the exit conv; 8x16 B=5 held in "
            f"slices of 2 images: every call the plain version's bits")
    rows += dag_stage_rows(torch, "float64", masks, 3, 8, 8, 8, seed=23)
    log("[K] dag float64 S=3 k=4 F=8 8x8: every call the plain version's bits")
    rows += dag_pool_ties(torch)
    rows += dag_stage_fn_checks(torch)
    log(f"[K] dag edge cases and whole-stage gates took {time.monotonic() - t0:.1f} s")
    return rows


def add_per_step(tot, r, n):
    """Add ``n`` calls of row ``r`` to a kernel's per-step totals."""
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_ops_ms", "bound_bytes_ms"):
        tot[key] = tot.get(key, 0.0) + n * r[key]
    by = "bound_{}_calls_ms".format("bytes" if r["bound_bytes_ms"] >= r["bound_ops_ms"] else "ops")
    tot[by] = tot.get(by, 0.0) + n * r["bound_ms"]
    tot["max_abs_err"] = max(tot.get("max_abs_err", 0.0), r["max_abs_err"])
    tot["calls"] = tot.get("calls", 0) + n


def step_kernels(torch, tag, nodes, filters, slots, dtype, per_step=None, batch=256):
    """Every kernel call of one train step (``batch`` rows: forward, input
    gradient, weight gradient) at each conv shape of the supergraph on
    32×32×3 images, and in bf16 each eval forward (batch 1,024), timed and
    held against the plain version; with ``per_step`` (bf16) the train
    step's calls are summed into it per kernel.  Returns the rows."""
    rows = []
    for name, shared, c, f, h, n in conv_layers(nodes, filters, 32, 3):
        for role in ("fwd", "wgrad") if shared else ("fwd", "dgrad", "wgrad"):
            r = conv_case(torch, dtype, role, shared, slots, c, f, batch, h, timed=True)
            r["layer"], r["per_step"] = name, n
            rows.append(r)
            log(f"[{tag}] {dtype:8s} {role:5s} {name:12s} C={c:3d} F={f:3d} {h}x{h} B={batch} P={slots}: "
                f"err {r['rel_err']:.2e} (tol {r['tol']:.0e}); kernel {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.3f}, cuDNN grouped {r['library_ms']:.3f}, "
                f"bound {r['bound_ms']:.3f} ms (bytes {r['bound_bytes_ms']:.3f}, operations "
                f"{r['bound_ops_ms']:.3f}) x{n} per step"
                + (f"; {r['splits']} splits, partials {r['scratch_bytes'] / 1e6:.1f} MB "
                   f"written and read" if role == "wgrad" else ""))
            if per_step is not None:
                add_per_step(per_step["pop_conv3x3_wgrad" if role == "wgrad" else "pop_conv3x3_fwd"],
                             r, n)
        if dtype == "bfloat16":
            r = conv_case(torch, dtype, "fwd", shared, slots, c, f, 1024, h, timed=True)
            r["layer"], r["per_step"] = name, 0
            rows.append(r)
            log(f"[{tag}] bfloat16 fwd   {name:12s} eval B=1024 P={slots}: err {r['rel_err']:.2e}; "
                f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}, cuDNN grouped "
                f"{r['library_ms']:.3f}, bound {r['bound_ms']:.3f} ms x{n} per eval batch")
    rows += step_dag(torch, tag, nodes, filters, slots, dtype, per_step, batch)
    return rows


def log_per_step(tag, what, per_step):
    for kname, tot in per_step.items():
        library = ("no one library call" if tot["library_ms"] is None
                   else f"cuDNN {tot['library_ms']:.3f}")
        pool = (f", F.max_pool2d {tot['max_pool2d_ms']:.3f} ms for the pool"
                if "max_pool2d_ms" in tot else "")
        pool += (f", the eager chain {tot['chain_ms']:.3f} ms for the same work"
                 if "chain_ms" in tot else "")
        log(f"[{tag}] {kname} per {what} train step (bf16, {tot['calls']} calls): kernel "
            f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f}, {library}, "
            f"bound {tot['bound_ms']:.3f} ms ({tot.get('bound_bytes_calls_ms', 0.0):.3f} in calls "
            f"bound by bytes, {tot.get('bound_ops_calls_ms', 0.0):.3f} by operations){pool}; "
            f"max abs err {tot['max_abs_err']:.3e}")


def phase_kernels(torch):
    """Every kernel at every conv shape of config #2's train step (pop 20,
    batch 256) and eval forward (batch 1,024), in bf16 and float32, and at
    config #1's shapes (pop 10, batch 128, 28×28 and 14×14, channel counts
    that are not multiples of 16), each held against its plain version;
    float64 once; every role at ``EDGE_SHAPES``; then
    :func:`kernel_purity`.
    Returns per-step totals of the timed bf16 config #2 calls."""
    per_step = new_per_step()
    rows = step_kernels(torch, "K", NODES, FILTERS, POP, "bfloat16", per_step)
    rows += step_kernels(torch, "K", NODES, FILTERS, POP, "float32")
    for dtype in ("bfloat16", "float32"):
        for name, shared, c, f, h, _ in conv_layers((3, 5), (20, 50), 28, 1):
            for role in (("fwd", "wgrad") if shared else ("fwd", "dgrad", "wgrad")):
                r = conv_case(torch, dtype, role, shared, 10, c, f, 128, h, timed=False)
                rows.append(r)
                log(f"[K] config #1 {dtype} {role} {name} C={c} F={f} {h}x{h}: "
                    f"err {r['rel_err']:.2e} (tol {r['tol']:.0e})")
    for role in ("fwd", "dgrad", "wgrad"):
        r = conv_case(torch, "float64", role, False, 4, 64, 64, 64, 16, timed=False)
        rows.append(r)
        log(f"[K] float64 {role} C=64 F=64 16x16: err {r['rel_err']:.2e} (tol {r['tol']:.0e})")
    # 600 slots × 128 splits (batch 512 at 32×32) is more blocks than a grid's
    # z axis takes: the split index rides on x, so the launch must still go.
    r = conv_case(torch, "bfloat16", "wgrad", False, 600, 3, 4, 512, 32, timed=False)
    rows.append(r)
    log(f"[K] bfloat16 wgrad S=600 C=3 F=4 B=512 32x32 (600 x 128 splits): err "
        f"{r['rel_err']:.2e} (tol {r['tol']:.0e})")
    for dtype in ("bfloat16", "float32"):
        for slots, c, f, b, h, wd, shared in EDGE_SHAPES:
            for role in ("fwd", "wgrad") if shared else ("fwd", "dgrad", "wgrad"):
                r = conv_case(torch, dtype, role, shared, slots, c, f, b, h, False, width=wd)
                rows.append(r)
                log(f"[K] edge {dtype} {role} S={slots} C={c} F={f} B={b} {h}x{wd}"
                    f"{' shared' if shared else ''}: err {r['rel_err']:.2e} (tol {r['tol']:.0e})")
    rows.extend(kernel_purity(torch))
    rows.extend(phase_dag_edges(torch))
    log_per_step("K", "config #2", per_step)
    return per_step, rows


def phase_kernels_deep(torch, slots: int):
    """Both kernels at every conv shape of config #5's train step and eval
    forward (bf16), at ``slots`` (the width phase D's programs ran), each
    held against its plain version.  Returns per-step totals."""
    per_step = new_per_step()
    step_kernels(torch, "K5", DEEP_NODES, DEEP_FILTERS, slots, "bfloat16", per_step)
    log_per_step("K5", f"config #5 (P={slots})", per_step)
    return per_step


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
    check(inside == (outside[0], False, outside[2]) and flags() == outside,
          "exact_numerics turns matmul TF32 off, leaves cuDNN's flags and restores them")
    log(f"[2] TF32 off for matmuls inside the port's executor (cnn.exact_numerics): "
        f"torch.backends.cuda.matmul.allow_tf32 = {inside[1]}; the cuDNN flags it leaves "
        f"(the port calls no cuDNN conv) and torch's own {outside} outside it stay")
    genomes = random_population(NODES, 4, seed=3)
    genomes[0] = {**genomes[0], "S_1": (0, 0, 0)}  # an empty stage: the pass-through
    hashes = cnn._genome_hashes(genomes)
    x_np, y_np = synthetic(32, (32, 32, 3), seed=4)
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
    # TF32 off, so both sides are IEEE float32; the card's conv kernels and
    # the CPU's per-slot oneDNN convs sum in different orders, ~1e-5
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

    xs, ys = synthetic(512, (32, 32, 3), seed=5)
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


def grad_leaves_slot0(torch, x, y, genomes, pop: int, dtype: str):
    """Slot 0's grad leaves after one train step's backward at config #2's
    width: a model of ``pop`` slots holds ``genomes`` (padded by repeating the
    last), every slot starts from its genome's own init, the batch is the
    first 256 images, and dropout draws from the genome's own stream, as
    ``_train_step`` runs it inside the executor's numerics."""
    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.ops.dag import stack_genome_masks
    from gentun_tpu_torch.parallel.mesh import pad_population

    dev = torch.device("cuda")
    genomes, _ = pad_population(genomes, pop)
    hashes = cnn._genome_hashes(genomes)
    model = cnn.MaskedGeneticCnn(NODES, FILTERS, pop, (32, 32, 3), DENSE, N_CLASSES,
                                 0.5, dtype, False, device=dev)
    init = cnn._init_population_params(model, 1, 0, hashes)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(init[name][0])
    masks = [{k: torch.as_tensor(v, device=dev) for k, v in st.items()}
             for st in stack_genome_masks(genomes, NODES)]
    xb = torch.from_numpy(np.ascontiguousarray(x[:256].transpose(0, 3, 1, 2))).to(dev)
    yb = torch.from_numpy(y[:256].astype(np.int64)).to(dev)
    gens = cnn._dropout_generators(0, 0, hashes, dev)
    with cnn.exact_numerics():
        loss = cnn._per_genome_loss(model(xb, masks, dropout_gens=gens), yb).sum()
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return {n: g[0].detach().clone() for n, g in zip(names, grads)}


def phase_leaves(torch, x, y, genomes):
    """Which of slot 0's grad leaves depend on the pop width: one genome in
    slot 0 of a P=2 model and of the P=20 model (the batch's other genomes in
    the other slots), the same params, batch and dropout draws, in bf16 and
    float32; every leaf compared bit for bit.  Returns the differing names."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        small = grad_leaves_slot0(torch, x, y, genomes[:1], 2, dtype)
        wide = grad_leaves_slot0(torch, x, y, genomes, POP, dtype)
        differ = [n for n in small if not torch.equal(small[n], wide[n])]
        out[dtype] = differ
        log(f"[L] grad leaves of slot 0, P=2 vs P={POP}, {dtype}: {len(differ)} of "
            f"{len(small)} differ: {differ}")
        check(not differ, f"slot 0's {dtype} grad leaves depend on the pop width: {differ}")
    return out


def phase_main(torch, x, y, genomes):
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
    flops = schedule_flops(PROXY, POP, N_DATA)
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
        "bf16_peak_share": flops / wall / PEAK_FLOPS["bfloat16"],
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
    """A genome's fitness must not depend on the batch it trained in, four
    ways, each exactly 0 in bf16 and float32 or the run fails: the pop-20
    batch called again, the same batch in reversed slot order, three of its
    genomes trained alone (pop bucket 2, slot 0) and the batch evaluated as
    two calls of 10 genomes (pop bucket 16).  float64 (its float32 head and
    loss kept) checks one genome alone against the batch.  Returns the
    differences and each dtype's batch fitnesses."""
    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    picks = [3, 7, 11]
    half = POP // 2
    out, batches = {}, {}
    for dtype in ("bfloat16", "float32", "float64"):
        cfg = dict(PROXY, compute_dtype=dtype)
        run = lambda gs: GeneticCnnModel.cross_validate_population(x, y, gs, **cfg)
        t0 = time.monotonic()
        if dtype == "bfloat16":
            first, batch = bf16_calls
        elif dtype == "float32":
            first, batch = run(genomes), run(genomes)
        else:
            batch = run(genomes)
        batches[dtype] = batch
        diffs = {}
        if dtype != "float64":
            diffs["repeat"] = float(np.abs(batch - first).max())
            diffs["other_slots"] = float(np.abs(batch - run(genomes[::-1])[::-1]).max())
            split = np.concatenate([run(genomes[:half]), run(genomes[half:])])
            diffs["two_calls_of_10"] = float(np.abs(batch - split).max())
        alone = [float(run([genomes[i]])[0]) for i in (picks if dtype != "float64" else picks[:1])]
        diffs["alone"] = max(abs(a - float(batch[i])) for a, i in zip(alone, picks))
        out[dtype] = diffs
        log(f"[4] purity {dtype} ({time.monotonic() - t0:.1f} s), max|Δfitness| over the pop-{POP} "
            f"batch: {json.dumps(diffs)}; slots {picks[:len(alone)]} in the batch "
            f"{[round(float(batch[i]), 4) for i in picks[:len(alone)]]}, alone (bucket 2, slot 0) "
            f"{[round(a, 4) for a in alone]}")
        for what, d in diffs.items():
            check(d == 0.0, f"purity {dtype} {what}: max|Δfitness| = {d}")
    return out, batches


def phase_executors(x, y, genomes, batches):
    """The executors of this slice at config #2's width.  ``fold_parallel``
    (4 genomes, a pop-4 bucket) must give the same fitnesses, bit for bit,
    as the pop-20 batch of phases 3 and 4 gave them, in bf16 and float32;
    ``train_and_score``
    (train on the first 80% of the images, score on the rest) and a warm-started CV call must
    give finite accuracies."""
    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    picks = [0, 5, 10, 15]
    four = [genomes[i] for i in picks]
    out = {}
    for dtype in ("bfloat16", "float32"):
        t0 = time.monotonic()
        fused = GeneticCnnModel.cross_validate_population(
            x, y, four, **dict(PROXY, compute_dtype=dtype), fold_parallel=True)
        d = float(np.abs(fused - batches[dtype][picks]).max())
        out[f"fold_parallel_{dtype}"] = d
        log(f"[E] fold_parallel {dtype}, 4 genomes ({time.monotonic() - t0:.1f} s): "
            f"{np.round(fused, 4).tolist()} vs the pop-{POP} batch: max|Δ| = {d}")
        check(d == 0.0, f"fold_parallel {dtype} equals the pop-{POP} batch")
    t0 = time.monotonic()
    n_tr = len(x) * 4 // 5
    holdout = GeneticCnnModel.train_and_score(x[:n_tr], y[:n_tr], x[n_tr:], y[n_tr:], four, **PROXY)
    log(f"[E] train_and_score, 4 genomes, {n_tr:,} train / {len(x) - n_tr:,} test "
        f"({time.monotonic() - t0:.1f} s): {np.round(holdout, 4).tolist()}")
    check(holdout.shape == (4,) and bool(np.isfinite(holdout).all()), "finite holdout accuracies")
    cnn._WARM_BANK.clear()
    t0 = time.monotonic()
    cold = GeneticCnnModel.cross_validate_population(x, y, four[:2], **PROXY, warm_start=True)
    warm = GeneticCnnModel.cross_validate_population(x, y, four[:2], **PROXY, warm_start=True)
    log(f"[E] warm_start: first call {np.round(cold, 4).tolist()} banks {len(cnn._WARM_BANK)} "
        f"genomes; the second inherits them: {np.round(warm, 4).tolist()} "
        f"({time.monotonic() - t0:.1f} s)")
    check(len(cnn._WARM_BANK) == 2 and bool(np.isfinite(warm).all()), "warm-start bank")
    cnn._WARM_BANK.clear()
    out["holdout_mean"] = float(holdout.mean())
    return out


def phase_ga():
    from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual, Population

    x, y = synthetic(2_000, (28, 28, 1), seed=1)
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


#: Phase A: the steady-state search over config #2 at full width, each
#: evaluation one genome (the 2-slot pop bucket) on a worker thread.
ASYNC_LADDER = [{"kfold": 2, "epochs": (1,)}, {"kfold": 2, "epochs": (2,)}]
ASYNC_POP, ASYNC_FIRST, ASYNC_TOTAL = 8, 16, 22


def phase_async(torch, x, y, workdir: str):
    """``AsyncEvolution`` with its fidelity ladder and surrogate gate over
    config #2 at full width, two evaluations in flight on worker threads,
    the warm-start bank on, spans and the lineage ledger on, a checkpoint,
    then a fresh engine resumed from it (see the module docstring, phase
    A).  Returns the result and the phase's kernel launches."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from gentun_tpu_torch import (AsyncEvolution, FitnessSurrogate, GeneticCnnIndividual,
                                  Population, SurrogateGate)
    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.ops import pop_conv
    from gentun_tpu_torch.telemetry import buildinfo, export, lineage, traceviz
    from gentun_tpu_torch.utils import Checkpointer

    evals, lock = [], threading.Lock()

    class Counted(GeneticCnnIndividual):
        """Runs each evaluation under its own library-conv counter: dispatch
        modes are thread-local, so one entered on the main thread would
        see nothing a worker thread runs."""

        def evaluate(self):
            counter, t0 = conv_counter(), time.monotonic()
            with counter:
                fitness = super().evaluate()
            rung = [tuple(r["epochs"]) for r in ASYNC_LADDER].index(
                tuple(self.additional_parameters["epochs"]))
            with lock:
                evals.append({"genes": self.get_genes(), "rung": rung, "fitness": fitness,
                              "wall_s": time.monotonic() - t0,
                              "thread": threading.current_thread().name,
                              "convs": dict(counter.convs)})
            return fitness

    def join_workers():
        """Wait for evaluations a finished run left running (its budget was
        met with children in flight: their results are dropped, the pool's
        threads finish them and exit)."""
        for t in threading.enumerate():
            if t.name.startswith("gentun-async-eval"):
                t.join()

    config = dict(PROXY, warm_start=True)
    path = os.path.join(workdir, "async_checkpoint.json")
    run_path = os.path.join(workdir, "async_telemetry.jsonl")
    for stale in (path, run_path):
        if os.path.exists(stale):
            os.remove(stale)

    def engine():
        pop = Population(Counted, x_train=x, y_train=y, size=ASYNC_POP, seed=3,
                         additional_parameters=config)
        gate = SurrogateGate(FitnessSurrogate(min_train=6, refit_every=4), eta=2, min_window=4)
        return AsyncEvolution(pop, tournament_size=3, max_in_flight=2, seed=5, eta=3,
                              fidelity_ladder=ASYNC_LADDER, surrogate=gate, checkpoint_every=1)

    cnn._WARM_BANK.clear()
    lineage.reset_ledger()
    lineage.enable()
    export.start_run(run_path, label="phase A")
    torch.cuda.reset_peak_memory_stats()
    try:
        for k in pop_conv.LAUNCHES:
            pop_conv.LAUNCHES[k] = 0
        t0 = time.monotonic()
        first = engine()
        first.run(max_evaluations=ASYNC_FIRST, checkpointer=Checkpointer(path))
        join_workers()
        first_s = time.monotonic() - t0
        with open(path) as fh:
            saved = json.load(fh)
        resumed = engine()
        resumed.run(max_evaluations=ASYNC_TOTAL, checkpointer=Checkpointer(path))
        join_workers()
        wall = time.monotonic() - t0
        launches = dict(pop_conv.LAUNCHES)
    finally:
        summary = export.end_run()
        lineage.disable()
    device_s = lineage.get_ledger().total()
    peak = torch.cuda.max_memory_allocated()
    trace = traceviz.convert(run_path, run_path.replace(".jsonl", ".trace.json"))
    threads = {kind: {e["args"].get("thread") for e in trace["traceEvents"]
                      if e.get("ph") == "X" and e.get("name") == kind}
               for kind in ("train", "eval")}
    labels = buildinfo.build_info_labels()
    gate = resumed._surrogate
    per_rung = [sum(1 for h in resumed.history if h.get("rung") == r and h["fitness"] is not None)
                for r in range(len(ASYNC_LADDER))]
    done = list(evals)
    fits = [e["fitness"] for e in done]
    rung0 = [e for e in done if e["rung"] == 0]
    rung1 = [e for e in done if e["rung"] == 1]
    convs = {}
    for e in done:
        for k, n in e["convs"].items():
            convs[k] = convs.get(k, 0) + n
    result = {
        "first_wall_s": first_s, "wall_s": wall, "evaluations": len(done),
        "evaluations_per_hour": len(done) / wall * 3600.0,
        "completions": resumed.completed, "checkpoint_completions": saved["completed"],
        "completions_per_rung": per_rung, "surrogate_admitted": gate.admitted,
        "surrogate_rejected": gate.rejected,
        "rung0_eval_walls_s": [e["wall_s"] for e in rung0],
        "rung1_eval_walls_s": [e["wall_s"] for e in rung1],
        "peak_mem_bytes": peak, "lineage_device_s": device_s, "wall_x2_s": 2 * wall,
        "threads": sorted({e["thread"] for e in done}),
        "span_kinds": summary["spans"] if summary else {},
        "best_by_rung": {r: b.get_fitness() for r, b in resumed._best_by_rung.items()},
        "build_info": labels, "library_convs": convs, "launches": launches,
    }
    log(f"[A] AsyncEvolution over config #2 (S={NODES}, filters {FILTERS}, "
        f"{PROXY['compute_dtype']}, warm start), "
        f"ring {ASYNC_POP}, 2 in flight, ladder {ASYNC_LADDER}: {ASYNC_FIRST} completions in "
        f"{first_s:.3f} s, resumed from the checkpoint at {saved['completed']} to "
        f"{resumed.completed}; wall {wall:.3f} s, {len(done)} evaluations "
        f"({result['evaluations_per_hour']:.1f} evaluations/hour)")
    log(f"[A] completions per rung {per_rung}; surrogate admitted {gate.admitted}, rejected "
        f"{gate.rejected}; evaluations per thread "
        f"{ {t: sum(1 for e in done if e['thread'] == t) for t in result['threads']} }")
    for r, walls in enumerate((result["rung0_eval_walls_s"], result["rung1_eval_walls_s"])):
        if walls:
            log(f"[A] rung-{r} evaluations in the search (two threads, library-conv counter on): "
                f"{len(walls)}, wall median {np.median(walls):.3f} s, first {walls[0]:.3f} s, "
                f"min {min(walls):.3f} s, max {max(walls):.3f} s")
    log(f"[A] peak memory {peak / 2**30:.2f} GiB")
    log(f"[A] lineage device-seconds {device_s:.3f} s against wall x 2 = {2 * wall:.3f} s "
        f"(1.0 = two threads always both evaluating)")
    log(f"[A] kernel launches in the phase: {launches}; library convolution ops: "
        f"{convs or 'none'}; train/eval span threads {threads}; build_info {labels}")
    check(bool(done) and bool(np.isfinite(fits).all()), "finite async completions")
    mean0 = float(np.mean([e["fitness"] for e in rung0])) if rung0 else 0.0
    log(f"[A] mean rung-0 fitness {mean0:.4f} (chance 0.1) over {len(rung0)} evaluations")
    check(mean0 > 0.1, f"async rung-0 mean fitness above chance: {mean0}")
    for k, n in launches.items():
        check(n > 0, f"{k} launched in phase A")
    check(not convs, f"no library convolution on the worker threads: {convs}")
    check(resumed.completed == ASYNC_TOTAL and len(resumed.history) == ASYNC_TOTAL
          and resumed.history[:saved["completed"]] == saved["history"],
          "the resumed engine starts at the checkpoint's count and reaches the budget")
    for r, b in first._best_by_rung.items():
        check(resumed._best_by_rung[r].get_fitness() >= b.get_fitness(),
              f"the resumed engine's rung-{r} best is no worse than the first run's")
    check(all(len({t for t in names if t and t.startswith("gentun-async-eval")}) >= 2
              for names in threads.values()),
          f"train and eval spans from two distinct worker threads: {threads}")
    check(all(labels.get(k, "unknown") != "unknown" for k in ("torch", "cuda", "driver", "sm"))
          and not any(k.startswith("jax") for k in labels), f"build_info labels: {labels}")
    # (c) Purity across threads: every genome measured at rung 0 gets the
    # bits of its slot in one batched call on the main thread (no warm start).
    genomes = [e["genes"] for e in rung0]
    t0 = time.monotonic()
    batched = GeneticCnnModel.cross_validate_population(
        x, y, genomes, **dict(PROXY, **ASYNC_LADDER[0]))
    purity = float(np.abs(batched - np.array([e["fitness"] for e in rung0], np.float32)).max())
    log(f"[A] purity: {len(genomes)} rung-0 fitnesses of the two-thread search vs one batched "
        f"call of them on the main thread ({time.monotonic() - t0:.3f} s): max|Δfitness| = {purity}")
    check(purity == 0.0, f"async rung-0 fitnesses equal the batched call: {purity}")
    # (d) Warm start under concurrency: a promotion's fitness is the bits of
    # a main-thread replay (bank cleared, its rung-0 call, its rung-1 call).
    check(bool(rung1), "a genome was promoted to rung 1")
    promoted = rung1[0]

    def alone(overlay, counted):
        counter, t0 = conv_counter(), time.monotonic()
        with counter if counted else contextlib.nullcontext():
            fitness = GeneticCnnModel(x, y, promoted["genes"],
                                      **dict(config, **overlay)).cross_validate()
        return fitness, time.monotonic() - t0

    cnn._WARM_BANK.clear()
    _, counted_s = alone(ASYNC_LADDER[0], True)  # the hook's cost, one thread
    cnn._WARM_BANK.clear()
    (_, rung0_s), (replay, rung1_s) = (alone(overlay, False) for overlay in ASYNC_LADDER)
    cnn._WARM_BANK.clear()
    log(f"[A] the promoted genome alone on the main thread: rung 0 {counted_s:.3f} s with the "
        f"library-conv counter, {rung0_s:.3f} s without; rung 1 {rung1_s:.3f} s without")
    log(f"[A] warm start: promoted genome's rung-1 fitness {promoted['fitness']!r} in the search, "
        f"{replay!r} in a main-thread replay")
    check(replay == promoted["fitness"], "a promotion's warm start replays bit for bit")
    # Do two evaluation threads overlap at all?  Two rung-0 genomes, no
    # counter, no warm start: one after the other, then both at once.
    pair = [promoted["genes"], next(e["genes"] for e in rung0 if e["genes"] != promoted["genes"])]

    def timed(genes):
        t0 = time.monotonic()
        fitness = GeneticCnnModel(x, y, genes, **dict(PROXY, **ASYNC_LADDER[0])).cross_validate()
        return fitness, time.monotonic() - t0

    serial = [timed(g) for g in pair]
    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as pool:
        together = list(pool.map(timed, pair))
    together_s = time.monotonic() - t0
    serial_s = sum(w for _, w in serial)
    log(f"[A] two rung-0 evaluations, no counter: one after the other {serial_s:.3f} s "
        f"({serial[0][1]:.3f} + {serial[1][1]:.3f}), both at once on two threads "
        f"{together_s:.3f} s ({together_s / serial_s:.3f} of the serial wall)")
    check([f for f, _ in together] == [f for f, _ in serial],
          "two threads at once give each genome its bits alone")
    result.update(purity_max_abs_diff=purity, alone_rung0_counted_s=counted_s,
                  alone_rung0_s=rung0_s, alone_rung1_s=rung1_s, pair_serial_s=serial_s,
                  pair_threads_s=together_s)
    return result, launches


#: Phase W: BASELINE config #4 — a master, and worker processes on the card.
W_GENERATIONS, W2_GENERATIONS = 3, 2
#: Seconds a worker process may take to reach the broker (interpreter,
#: torch, the dataset, CUDA's context and the compile-cache prefetch).
W_JOIN_S = 300.0


def _worker(workdir: str, tag: str, port: int, capacity: int, url, env=None, extra=()):
    """Start ``python -m gentun_tpu_torch.distributed.worker`` as a process
    (never a fork of this one: it holds a CUDA context), with the compile
    service at ``url`` unless it is None; its output goes to
    ``<workdir>/worker_<tag>.log``."""
    path = os.path.join(workdir, f"worker_{tag}.log")
    cache = ["--compile-cache-url", url] if url else []
    with open(path, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gentun_tpu_torch.distributed.worker", "--port", str(port),
             "--species", "genetic-cnn", "--dataset", "cifar10", "--n", str(N_DATA),
             "--capacity", str(capacity), *cache, "--worker-id", f"w-{tag}", *extra],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, **(env or {})),
            stdout=fh, stderr=subprocess.STDOUT)
    return proc, path


def _await_fleet(pop, procs, n: int) -> float:
    """Wait until ``n`` workers are connected; fails if one exits first."""
    t0 = time.monotonic()
    while pop.broker.fleet_members() < n:
        for proc, path in procs:
            check(proc.poll() is None, f"worker exited before joining ({path})")
        check(time.monotonic() - t0 < W_JOIN_S, f"{n} worker(s) joined within {W_JOIN_S} s")
        time.sleep(0.2)
    return time.monotonic() - t0


def _drain(procs) -> None:
    """SIGTERM each worker, so that its graceful drain runs."""
    import signal

    for proc, _ in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)


def _kill(procs) -> None:
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _reap(procs):
    """Wait for drained workers (after their broker closed) and gate on their
    exit codes; returns each one's log text."""
    logs = []
    try:
        for proc, path in procs:
            rc = proc.wait(timeout=120)
            with open(path) as fh:
                logs.append(fh.read())
            check(rc == 0, f"worker exit code {rc} ({path}):\n{logs[-1][-3000:]}")
    finally:
        _kill(procs)
    return logs


def _worker_usage(text: str):
    """What a worker logged at its exit: its kernel launches and, once it
    used the card, its peak device memory (allocated and reserved)."""
    tail = text.rsplit(" job(s); ", 1)
    check(len(tail) == 2, "the worker logged its kernel launches at exit")
    return json.loads(tail[1].splitlines()[0])


def _search(ga):
    """A search's history without its walls, and every fitness it measured."""
    hist = [{k: r[k] for k in ("generation", "best_fitness", "best_genes", "evaluated")}
            for r in ga.history]
    return hist, {k: float(v).hex() for k, v in ga.population.fitness_cache.items()}


def _gpu_apps(torch):
    """``nvidia-smi``'s compute processes as it prints them, and the card's
    used bytes by ``cudaMemGetInfo`` (every process on it)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    free, total = torch.cuda.mem_get_info()
    return {"nvidia_smi": out.stdout.strip().splitlines(), "card_used_bytes": total - free}


def phase_workers(torch, workdir: str, single_rate: float):
    """BASELINE config #4 with the port's worker processes on the card (see
    the module docstring, phase W).  Returns the result and the launches of
    W1's worker and of W3's in-process client."""
    import threading

    from gentun_tpu_torch import GeneticCnnIndividual, Population, RussianRouletteGA
    from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient, JobBroker
    from gentun_tpu_torch.distributed import compile_service as cs
    from gentun_tpu_torch.ops import _build, pop_conv
    from gentun_tpu_torch.telemetry import lineage
    from gentun_tpu_torch.telemetry.canary import CanaryDaemon, GoldenSet
    from gentun_tpu_torch.utils.datasets import load_cifar10
    from gentun_tpu_torch.utils.fitness_store import fidelity_fingerprint

    os.makedirs(workdir, exist_ok=True)
    x, y, _ = load_cifar10(n=N_DATA)
    svc = cs.CompileService(port=0).start()
    result, w1, w2 = {}, [], []
    try:
        # W1: one worker process serves the master's search.
        t0 = time.monotonic()
        with DistributedPopulation(GeneticCnnIndividual, size=POP, seed=0,
                                   additional_parameters=dict(PROXY), host="127.0.0.1", port=0,
                                   evaluate_retries=3, job_timeout=900.0) as pop:
            w1.append(_worker(workdir, "w1", pop.broker_address[1], POP, svc.url))
            try:
                join_s = _await_fleet(pop, w1, 1)
                ga = RussianRouletteGA(pop, seed=0)
                t1 = time.monotonic()
                ga.run(W_GENERATIONS)
                dist_s = time.monotonic() - t1
                dist = _search(ga)
            finally:
                _drain(w1)
        w1_log, = _reap(w1)
        w1_usage = _worker_usage(w1_log)
        w1_launches = w1_usage["kernel_launches"]
        log(f"[W1] worker joined in {join_s:.1f} s (process start to connection); "
            f"{W_GENERATIONS} generations in {dist_s:.3f} s; phase {time.monotonic() - t0:.1f} s; "
            f"the worker's kernel launches {w1_launches}, peak memory allocated "
            f"{w1_usage.get('peak_memory_allocated', 0) / 2**30:.2f} GiB, reserved "
            f"{w1_usage.get('peak_memory_reserved', 0) / 2**30:.2f} GiB")
        for k, n in w1_launches.items():
            check(n > 0, f"{k} launched in W1's worker")
        t1 = time.monotonic()
        local_pop = Population(GeneticCnnIndividual, x_train=x, y_train=y, size=POP, seed=0,
                               additional_parameters=dict(PROXY))
        local_ga = RussianRouletteGA(local_pop, seed=0)
        local_ga.run(W_GENERATIONS)
        local_s = time.monotonic() - t1
        local = _search(local_ga)
        d_walls = [r["eval_wall_s"] for r in ga.history]
        l_walls = [r["eval_wall_s"] for r in local_ga.history]
        evaluated = sum(r["evaluated"] for r in ga.history)
        rates = {"distributed": evaluated / sum(d_walls) * 3600.0,
                 "single": evaluated / sum(l_walls) * 3600.0,
                 "distributed_steady": sum(r["evaluated"] for r in ga.history[1:])
                 / max(sum(d_walls[1:]), 1e-3) * 3600.0,
                 "phase3": single_rate}
        log(f"[W1] per-generation walls (evaluate), distributed {d_walls} s, single-process "
            f"{l_walls} s; evaluated {[r['evaluated'] for r in ga.history]}; individuals/hour "
            f"{json.dumps({k: round(v, 1) for k, v in rates.items()})}; single-process run "
            f"{local_s:.3f} s")
        retries = sum(r.get("evaluate_retries", 0) for r in ga.history)
        log(f"[W1] evaluate retries {retries} (a missed heartbeat or a failed job would retry)")
        check(dist == local, "W1: the distributed search equals the single-process search bit "
                             "for bit (history and every fitness)")
        log(f"[W1] history and all {len(local[1])} fitnesses equal bit for bit")
        result["W1"] = {"join_s": join_s, "walls_distributed_s": d_walls,
                        "walls_single_s": l_walls, "evaluated": evaluated, "rates": rates,
                        "retries": retries, "launches": w1_launches, "worker": w1_usage}

        # W2: two worker processes share the card; the second fetches the
        # kernel library from the compile service instead of building it.
        lib = _build.library_path()
        fp = cs.platform_fingerprint(probe_devices=True)
        names = svc.list_names(fp)
        check(lib.name in names, f"W1's worker published {lib.name} ({names})")
        size = lib.stat().st_size
        check(size <= cs._MAX_BLOB_BYTES, f"the library's {size} bytes fit the service's "
                                          f"{cs._MAX_BLOB_BYTES}-byte blob limit")
        cold = os.path.join(workdir, "w2_kernel_cache")
        if os.path.isdir(cold):
            import shutil

            shutil.rmtree(cold)
        os.makedirs(cold)
        t0 = time.monotonic()
        with DistributedPopulation(GeneticCnnIndividual, size=POP, seed=0,
                                   additional_parameters=dict(PROXY), host="127.0.0.1", port=0,
                                   evaluate_retries=3, job_timeout=900.0) as pop:
            port = pop.broker_address[1]
            w2.append(_worker(workdir, "w2a", port, POP // 2, svc.url,
                              extra=("--prefetch-depth", "0")))
            w2.append(_worker(workdir, "w2b", port, POP // 2, svc.url,
                              extra=("--prefetch-depth", "0"), env={"GENTUN_TORCH_CACHE_DIR": cold}))
            try:
                join2_s = _await_fleet(pop, w2, 2)
                ga2 = RussianRouletteGA(pop, seed=0)
                t1 = time.monotonic()
                ga2.run(W2_GENERATIONS)
                two_s = time.monotonic() - t1
                two = _search(ga2)
                apps = _gpu_apps(torch)
            finally:
                _drain(w2)
        logs = _reap(w2)
        fetched = os.path.join(cold, lib.name)
        check(os.path.exists(fetched) and open(fetched, "rb").read() == lib.read_bytes(),
              "W2: the second worker's library has the first's bytes")
        check("artifact(s) fetched" in logs[1] and "with nvcc" not in logs[1],
              "W2: the second worker fetched the library and did not run nvcc")
        served = [text.count(" done: fitness ") for text in logs]
        check(all(n > 0 for n in served), f"W2: both workers served jobs ({served})")
        check(two[0] == dist[0][:W2_GENERATIONS], "W2: the history equals W1's first generations")
        check(all(local[1][k] == v for k, v in two[1].items()),
              "W2: every fitness equals W1's for the same genome, bit for bit")
        w2_walls = [r["eval_wall_s"] for r in ga2.history]
        mem = {role: _worker_usage(text) for role, text in zip(("w2a", "w2b"), logs)}
        log(f"[W2] two workers joined in {join2_s:.1f} s; {W2_GENERATIONS} generations in "
            f"{two_s:.3f} s, walls {w2_walls} s (W1: {d_walls[:W2_GENERATIONS]} s); jobs served "
            f"{served}; {len(two[1])} fitnesses equal W1's; library {lib.name} "
            f"{size} bytes, fetched by the second worker; with both alive the card held "
            f"{apps['card_used_bytes'] / 2**30:.2f} GiB (this process "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved), nvidia-smi compute "
            f"apps {apps['nvidia_smi']}; workers at exit {json.dumps(mem)}; "
            f"phase {time.monotonic() - t0:.1f} s")
        result["W2"] = {"join_s": join2_s, "walls_s": w2_walls, "served": served,
                        "library_bytes": size, "workers": mem, "apps": apps,
                        "own_reserved_bytes": torch.cuda.memory_reserved()}
    finally:
        _kill(w1 + w2)
        svc.stop()

    # W3: a canary probe served by a client thread in this process, under
    # the library-conv counter (entered inside the thread).
    genes = local_pop[0].get_genes()
    golden_path = os.path.join(workdir, "canary_golden.json")
    if os.path.exists(golden_path):
        os.remove(golden_path)
    golden = local_pop[0].get_fitness()
    GoldenSet(golden_path).seal(GoldenSet.key("config4", fidelity_fingerprint(PROXY),
                                              lineage.genome_key(genes)), golden)
    broker = JobBroker(port=0).start()
    stop, counter = threading.Event(), conv_counter()
    client = GentunClient(GeneticCnnIndividual, x, y, port=broker.address[1], capacity=2,
                          heartbeat_interval=1.0, reconnect_delay=0.1)

    def serve():
        with counter:
            client.work(stop_event=stop)

    t = threading.Thread(target=serve, name="w3-client", daemon=True)
    t.start()
    canary = CanaryDaemon([f"127.0.0.1:{broker.address[1]}"],
                          [{"genes": genes, "additional_parameters": dict(PROXY)}],
                          space_key="config4", probe_interval=3600, probe_timeout=600,
                          golden_path=golden_path, serve_http=False)
    try:
        for k in pop_conv.LAUNCHES:
            pop_conv.LAUNCHES[k] = 0
        probe = canary.probe_once()
        w3_launches = dict(pop_conv.LAUNCHES)
    finally:
        canary.stop()
        stop.set()
        t.join(timeout=120)
        broker.stop()
    log(f"[W3] canary probe: {probe.get('result')}, fitness {probe.get('fitness')!r} vs golden "
        f"{golden!r}, e2e {probe.get('e2e_s')} s; launches {w3_launches}; library convs "
        f"{counter.convs}")
    check(probe.get("result") == "ok" and not probe.get("newly_sealed")
          and probe.get("fitness") == golden, f"W3: the probe equals its golden ({probe})")
    for k, n in w3_launches.items():
        check(n > 0, f"{k} launched for the canary probe")
    check(not counter.convs, f"W3: no library convolution ({counter.convs})")
    result["W3"] = {"probe": probe, "launches": w3_launches}
    return result, w1_launches, w3_launches, local[1]


#: Phase W4: the steady-state search over a broker and one worker process:
#: the completion budget, the phase's bound, and the predicted rate.
W4_TOTAL, W4_BOUND_S, W4_PREDICTED = 24, 120.0, "3,000-8,000 evaluations/hour"
#: Phase A's and phase 3's rates (my chip runs, "NVIDIA H100 80GB HBM3, 700.00 W").
A_RATE, P3_RATE = 1060.5, 16353.0


def phase_async_workers(torch, workdir: str):
    """``AsyncEvolution`` over a ``DistributedPopulation`` and one worker
    process (see the module docstring, phase W4).  Returns the result and
    the worker's kernel launches."""
    from gentun_tpu_torch import AsyncEvolution, FitnessSurrogate, GeneticCnnIndividual
    from gentun_tpu_torch import SurrogateGate
    from gentun_tpu_torch.distributed import DistributedPopulation
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.utils.datasets import load_cifar10

    os.makedirs(workdir, exist_ok=True)
    t_phase = time.monotonic()
    rung_of = {tuple(r["epochs"]): i for i, r in enumerate(ASYNC_LADDER)}
    sent, got, procs = {}, {}, []
    with DistributedPopulation(GeneticCnnIndividual, size=ASYNC_POP, seed=3,
                               additional_parameters=dict(PROXY), host="127.0.0.1", port=0,
                               evaluate_retries=3, job_timeout=900.0) as pop:
        submit, wait = pop.submit_individuals, pop.wait_any_results

        def submit_spy(individuals):
            ids = submit(individuals)
            for job, ind in zip(ids, individuals):
                sent[job] = (ind.get_genes(),
                             rung_of[tuple(ind.additional_parameters["epochs"])])
            return ids

        def wait_spy(job_ids, timeout=None):
            results, failures = wait(job_ids, timeout=timeout)
            got.update(results)
            return results, failures

        pop.submit_individuals, pop.wait_any_results = submit_spy, wait_spy
        procs.append(_worker(workdir, "w4", pop.broker_address[1], POP, None))
        try:
            join_s = _await_fleet(pop, procs, 1)
            gate = SurrogateGate(FitnessSurrogate(min_train=6, refit_every=4), eta=2,
                                 min_window=4)
            engine = AsyncEvolution(pop, tournament_size=3, seed=5, eta=3,
                                    fidelity_ladder=ASYNC_LADDER, surrogate=gate)
            t0 = time.monotonic()
            engine.run(max_evaluations=W4_TOTAL)
            wall = time.monotonic() - t0
            deadline = time.monotonic() + 60.0
            while sum(pop.broker.outstanding().values()) and time.monotonic() < deadline:
                time.sleep(0.1)  # a cancelled job's late result is dropped
            outstanding = pop.broker.outstanding()
        finally:
            _drain(procs)
    log_text, = _reap(procs)
    usage = _worker_usage(log_text)
    launches = usage["kernel_launches"]
    windows = [json.loads(line.rsplit(" group(s) of ", 1)[1])
               for line in log_text.splitlines() if " group(s) of " in line]
    done = [h for h in engine.history if h.get("fitness") is not None]
    per_rung = [sum(1 for h in done if h["rung"] == r) for r in range(len(ASYNC_LADDER))]
    rate = len(done) / wall * 3600.0
    log(f"[W4] AsyncEvolution over a broker and one worker process (--capacity {POP}): ring "
        f"{ASYNC_POP}, in-flight target {engine._cap} (the fleet's capacity plus prefetch), "
        f"ladder {ASYNC_LADDER}; worker joined in {join_s:.1f} s; {engine.completed} "
        f"completions in {wall:.3f} s: {rate:.1f} evaluations/hour (predicted {W4_PREDICTED}; "
        f"phase A {A_RATE}, phase 3 {P3_RATE} individuals/hour)")
    log(f"[W4] completions per rung {per_rung}; jobs trained {len(got)} of {len(sent)} "
        f"submitted; windows the worker trained (jobs per group) {windows}; surrogate "
        f"admitted {gate.admitted}, rejected {gate.rejected}; broker outstanding {outstanding}")
    log(f"[W4] the worker's kernel launches {launches}, peak memory allocated "
        f"{usage.get('peak_memory_allocated', 0) / 2**30:.2f} GiB")
    check(len(done) == W4_TOTAL and bool(np.isfinite([h["fitness"] for h in done]).all()),
          f"W4: {W4_TOTAL} finite completions")
    for k, n in launches.items():
        check(n > 0, f"{k} launched in W4's worker")
    check(not any(outstanding.values()), f"W4: no job outstanding at the end ({outstanding})")
    # Purity through the broker: every rung-0 result is the bits of one
    # batched call in this process on the worker's data (warm start off).
    x, y, _ = load_cifar10(n=N_DATA)
    rung0 = [(sent[j][0], f) for j, f in got.items() if sent[j][1] == 0]
    rung1 = [(sent[j][0], f) for j, f in got.items() if sent[j][1] == 1]
    batched = GeneticCnnModel.cross_validate_population(
        x, y, [g for g, _ in rung0], **dict(PROXY, **ASYNC_LADDER[0]))
    purity = float(np.abs(batched - np.array([f for _, f in rung0], np.float32)).max())
    log(f"[W4] purity: {len(rung0)} rung-0 results of the worker vs one batched call here: "
        f"max|Δfitness| = {purity}")
    check(purity == 0.0, f"W4: rung-0 results equal the batched call: {purity}")
    check(bool(rung1), "W4: a genome was promoted to rung 1 and trained")
    replay = GeneticCnnModel(x, y, rung1[0][0], **dict(PROXY, **ASYNC_LADDER[1])).cross_validate()
    log(f"[W4] promotion: the worker's rung-1 fitness {rung1[0][1]!r}, a replay here {replay!r}")
    check(replay == rung1[0][1], "W4: a promotion's rung-1 fitness replays bit for bit")
    phase_s = time.monotonic() - t_phase
    log(f"[W4] phase W4 took {phase_s:.1f} s (bound {W4_BOUND_S} s)")
    check(phase_s < W4_BOUND_S, f"phase W4 within {W4_BOUND_S} s")
    return {"join_s": join_s, "wall_s": wall, "completions": engine.completed,
            "evaluations_per_hour": rate, "completions_per_rung": per_rung,
            "windows": windows, "surrogate_admitted": gate.admitted,
            "surrogate_rejected": gate.rejected, "trained": len(got), "submitted": len(sent),
            "purity_max_abs_diff": purity, "launches": launches, "worker": usage,
            "phase_s": phase_s}, launches


#: Phase S: the compute-path studies (``scripts/torch_*.py``) at config #2.
S_PADS, S_TAILGEN_GENERATIONS, S_BOUND_S = (4, 8), 3, 150.0


def _load_study(name: str):
    """A module of ``scripts/`` (or, for the example, ``examples/``) by path."""
    import importlib.util

    folder = "examples" if name.startswith("torch_cifar10") else "scripts"
    spec = importlib.util.spec_from_file_location(f"study_{name}",
                                                  os.path.join(REPO, folder, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_studies(torch, main_accs, workdir: str):
    """The studies on the card at config #2 (see the module docstring, phase
    S).  Returns the phase's record, the kernels' launches in this process
    (S1-S3) and in S4's worker processes."""
    from gentun_tpu_torch.ops import pop_conv

    mfu, pad, tailgen = (_load_study(n) for n in (
        "torch_mfu_study", "torch_entry_pad_study", "torch_tailgen_study"))
    example = _load_study("torch_cifar10_genetic_cnn")
    t_phase = time.monotonic()
    x, y = cifar_data()
    genomes = random_population(NODES, POP, seed=2)
    for k in pop_conv.LAUNCHES:
        pop_conv.LAUNCHES[k] = 0
    result = {}

    # S1: the fenced decomposition of phase 3's call.
    ph = mfu.decompose(x, y, genomes, PROXY)
    accs = np.asarray(ph["accs"], np.float32)
    d = float(np.abs(accs - main_accs).max())
    rest = sum(ph[k] for k in ("host_setup_and_indices", "dataset_upload_cold",
                               "param_init_cpu_draw", "param_upload", "opt_init",
                               "segment_index_upload"))
    log("[S1] fenced decomposition of config #2's proxy call (pop 20): "
        + ", ".join(f"{k} {ph[k]:.4f} s" for k in mfu.PHASES))
    log(f"[S1] CPU init draw {ph['param_init_cpu_draw']:.4f} s, param upload "
        f"{ph['param_upload']:.4f} s; all but train and eval {rest:.4f} s (cold upload "
        f"included; a warm lookup {ph['dataset_lookup_warm']:.6f} s); mfu_train_only "
        f"{ph['mfu_train_only']!r}, mfu_overall_fenced {ph['mfu_overall_fenced']!r}; "
        f"accuracies vs phase 3's timed call: max|Δ| = {d}")
    check(d == 0.0, "S1: the decomposition's accuracies equal phase 3's timed call, bit for bit")
    result["S1"] = {k: ph[k] for k in (*mfu.PHASES, "mfu_train_only", "mfu_overall_fenced",
                                       "accs_mean", "train_flops", "eval_flops")}

    # S2: entry_channel_pad 4 and 8 against unpadded, MFU on the unpadded FLOPs.
    variants = pad.compare(x, y, PROXY, S_PADS, POP, "auto", reps=1, warmup=True,
                           useful=schedule_flops(PROXY, POP, N_DATA), n_cards=1)
    for name, v in variants.items():
        log(f"[S2] {name}: wall {v['wall_s']:.3f} s, {v['individuals_per_hour_per_chip']:.1f} "
            f"individuals/hour, mfu (unpadded FLOPs) {v['mfu_useful']:.4f}, mean accuracy "
            f"{v['accuracy_mean']:.4f} (Δ {v['accuracy_mean_delta_vs_unpadded']:+.4f}, max per "
            f"genome {v['max_abs_accuracy_delta_vs_unpadded']:.4f}; a padded entry conv "
            f"starts from other initial weights, so the gate is the bench's band)")
        check(v["accuracy_mean"] >= pad.ACC_GATE["proxy"],
              f"S2: {name}'s mean accuracy >= {pad.ACC_GATE['proxy']}")
    result["S2"] = {n: {k: v[k] for k in v if k != "accs"} for n, v in variants.items()}

    # S3: config #2's GA example, one generation, under the library-conv counter.
    counter, t0 = conv_counter(), time.monotonic()
    with counter:
        ex = example.main(["--generations", "1"])
    ex_s = time.monotonic() - t0
    log(f"[S3] examples/torch_cifar10_genetic_cnn.py --generations 1 ({ex_s:.1f} s): best "
        f"fitness {ex['best_fitness']:.4f}, history {[h['evaluated'] for h in ex['history']]} "
        f"evaluated; library convolutions {counter.convs}")
    check(np.isfinite(ex["best_fitness"]), "S3: a finite best fitness")
    check(not counter.convs, f"S3: no library convolution ({counter.convs})")
    result["S3"] = {"wall_s": ex_s, "best_fitness": ex["best_fitness"],
                    "throughput": ex["throughput"]}
    launches = dict(pop_conv.LAUNCHES)

    # S4: the tail-generation study, speculative fill off and 16.
    tdir = os.path.join(workdir, "tailgen")
    os.makedirs(tdir, exist_ok=True)
    t0 = time.monotonic()
    rc = tailgen.main(["--generations", str(S_TAILGEN_GENERATIONS), "--workdir", tdir,
                       "--out", os.path.join(tdir, "torch_tailgen_study.json")])
    with open(os.path.join(tdir, "torch_tailgen_study.json")) as fh:
        rec = json.load(fh)
    worker_launches = {k: 0 for k in launches}
    for name in rec["variants"]:
        with open(os.path.join(tdir, "logs", f"torch_tailgen_{name}_worker.log")) as fh:
            for k, n in _worker_usage(fh.read())["kernel_launches"].items():
                worker_launches[k] += n
    for name, v in rec["variants"].items():
        log(f"[S4] {name}: {S_TAILGEN_GENERATIONS} generations in {v['proxy_total_wall_s']} s "
            f"(with process starts {v['orchestrator_wall_s']} s), {v['evaluated_total']} trained, "
            f"best {v['best_fitness']:.4f}")
    log(f"[S4] trajectories identical: {rec['trajectories_identical']}; workers' kernel "
        f"launches {worker_launches} ({time.monotonic() - t0:.1f} s)")
    check(rc == 0 and rec["trajectories_identical"] and rec["best_fitness_identical"],
          "S4: both variants follow one GA trajectory with one best")
    result["S4"] = rec
    log(f"[S] kernel launches in this process (S1-S3): {launches}")
    for k in launches:
        check(launches[k] > 0 and worker_launches[k] > 0, f"{k} launched in phase S")
    result["phase_s"] = time.monotonic() - t_phase
    log(f"[S] phase S took {result['phase_s']:.1f} s (bound {S_BOUND_S} s)")
    check(result["phase_s"] < S_BOUND_S, f"phase S within {S_BOUND_S} s")
    return result, launches, worker_launches


#: Phase S5: the compile-cache study's three acts, bounded by its own clock.
S5_BOUND_S = 240.0


def phase_compile_cache(workdir: str):
    """``scripts/torch_compile_cache_study.py`` in a process of its own, its
    temporary directories under ``workdir`` (see the module docstring,
    phase S5).  Returns its record."""
    import shutil

    tmp = os.path.join(workdir, "s5_tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    out = os.path.join(workdir, "torch_compile_cache_study.json")
    if os.path.exists(out):
        os.remove(out)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_compile_cache_study.py"),
         "--out", out], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, TMPDIR=tmp),
        capture_output=True, text=True, timeout=S5_BOUND_S)
    wall = time.monotonic() - t0
    check(proc.returncode == 0, f"S5: the compile-cache study exits 0 ({proc.returncode}):\n"
                                f"{(proc.stdout + proc.stderr)[-3000:]}")
    with open(out) as fh:
        rec = json.load(fh)
    cold, storm, killed = rec["cold_join"], rec["recompile_storm_jax"], rec["service_killed"]
    log(f"[S5] cold join: nvcc build of the kernel library {cold['compile_s']} s against a "
        f"fetch {cold['fetch_s']} s + load {cold['cache_load_s']} s ({cold['speedup_x']}x); "
        f"storm: builds per host {storm['compiles_per_host']}; service killed mid-search: "
        f"bit-identical {killed['bit_identical_to_service_free_run']}, degraded events "
        f"{killed['degraded_events']}; {wall:.1f} s")
    check(storm["late_joiner_true_compiles"] == 0
          and all(n == 0 for h, n in storm["compiles_per_host"].items() if h != "host0"),
          "S5: the late joiners ran nvcc zero times")
    check(killed["bit_identical_to_service_free_run"] and killed["degraded_events"] == 1,
          "S5: the search with the service killed is bit-identical to the service-free run")
    shutil.rmtree(tmp, ignore_errors=True)
    rec["wall_s"] = wall
    return rec


def conv_counter():
    """A dispatch mode that counts every aten convolution op run inside it
    (the port's kernels are no aten op; a library conv would be one)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class ConvCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.convs = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if "conv" in name:
                self.convs[name] = self.convs.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    return ConvCounter()


def spy_programs(record, peaks=None):
    """Wrap ``GeneticCnnModel._cross_validate_population_one`` (one program
    of the batched trainer) so each call appends (genomes, config, seconds,
    accuracies or the exception's type) to ``record``, and with ``peaks``
    its peak device memory to ``peaks``; returns the undo."""
    import torch

    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    real = GeneticCnnModel.__dict__["_cross_validate_population_one"]

    def spy(cls, x, y, genomes, **cfg):
        if peaks is not None:
            torch.cuda.reset_peak_memory_stats()
        t0, out = time.monotonic(), "error"
        try:
            out = real.__func__(cls, x, y, genomes, **cfg)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            out = "OutOfMemoryError"
            raise
        finally:
            record.append((list(genomes), cfg, time.monotonic() - t0, out))
            if peaks is not None:
                peaks.append(torch.cuda.max_memory_allocated())
        return out

    GeneticCnnModel._cross_validate_population_one = classmethod(spy)
    return lambda: setattr(GeneticCnnModel, "_cross_validate_population_one", real)


def span_times(recs, eval_bs: int, n_val: int):
    """Train-step and eval-batch ms by program width from the executor's
    spans (they carry the width); an attempt that ran out of memory in eval
    leaves train spans only."""
    step_ms, eval_ms = {}, {}
    for width in sorted({r["attrs"]["pop"] for r in recs
                         if r.get("kind") in ("train", "eval") and "pop" in r.get("attrs", {})}):
        mine = [r for r in recs if r.get("attrs", {}).get("pop") == width]
        train = [r for r in mine if r.get("kind") == "train"]
        evals = [r for r in mine if r.get("kind") == "eval"]
        if train:
            step_ms[width] = 1e3 * sum(r["dur_s"] for r in train) / sum(
                r["attrs"]["steps"] for r in train)
        if evals:
            eval_ms[width] = 1e3 * sum(r["dur_s"] for r in evals) / (len(evals) * (n_val // eval_bs))
    return step_ms, eval_ms


def phase_deep(torch, workdir: str):
    """BASELINE config #5 through the port's GA entry point at full width
    (see the module docstring, phase D).  Returns the result, the GA's
    kernel launches, the learned pop cap (or None) and two genomes of the
    first program."""
    from gentun_tpu_torch import GeneticCnnIndividual, Population, RussianRouletteGA
    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.ops import pop_conv
    from gentun_tpu_torch.telemetry import spans
    from gentun_tpu_torch.telemetry.registry import get_registry
    from gentun_tpu_torch.utils import Checkpointer, EvalTimer
    from gentun_tpu_torch.utils.datasets import load_cifar100

    x, y, meta = load_cifar100(n=DEEP_N)
    log(f"[D] data: {meta['source']}, {len(x):,} images {x.shape[1:]}, "
        f"{int(y.max()) + 1} classes")
    path = os.path.join(workdir, "deep_checkpoint.json")
    if os.path.exists(path):
        os.remove(path)
    cap_key = cnn._oom_cap_key(cnn._normalize_config(x, y, dict(DEEP)))
    cnn._POP_PROGRAM_CAP.pop(cap_key, None)

    def search():
        pop = Population(GeneticCnnIndividual, x_train=x, y_train=y, size=DEEP_POP, seed=0,
                         additional_parameters=dict(DEEP))
        return RussianRouletteGA(pop, seed=0)

    programs, peaks, counter, timer = [], [], conv_counter(), EvalTimer()
    undo = spy_programs(programs, peaks)
    get_registry().reset()
    spans.enable()
    try:
        # The GA and its resume under the dispatch mode that counts library
        # convolutions (a Python hook on every aten op: their walls carry it).
        with spans.capture() as ga_recs, counter:
            for k in pop_conv.LAUNCHES:
                pop_conv.LAUNCHES[k] = 0
            with timer.measure(DEEP_POP, label="config #5, 1 generation"):
                ga = search()
                best = ga.run(1, checkpointer=Checkpointer(path))
            launches = dict(pop_conv.LAUNCHES)
            first_programs = len(programs)
            t0 = time.monotonic()
            resumed = search()
            best2 = resumed.run(1, checkpointer=Checkpointer(path))
            resume_s = time.monotonic() - t0
        # The cell's numbers: one pop-50 call of the GA's last population
        # with the cap known, without the dispatch mode.
        genes = [ind.get_genes() for ind in ga.population]
        timed_from = len(programs)
        with spans.capture() as recs:
            t0 = time.monotonic()
            again50 = GeneticCnnModel.cross_validate_population(x, y, genes, **DEEP)
            torch.cuda.synchronize()
            call_s = time.monotonic() - t0
    finally:
        spans.disable()
        undo()
    cap = cnn._POP_PROGRAM_CAP.get(cap_key)
    gauges = {f"{g['labels']['size_class']}/{g['labels']['source']}": g["value"]
              for g in get_registry().snapshot()["gauges"]
              if g["name"] == "genome_cost_calibration"}
    for i, ((genomes, cfg, secs, out), top) in enumerate(zip(programs, peaks)):
        part = "GA" if i < first_programs else ("resume" if i < timed_from else "timed call")
        log(f"[D] {part} program: {len(genomes)} genomes (pop_padding "
            f"{cfg.get('pop_padding', True)}), {secs:.3f} s, peak memory {top / 2**30:.2f} GiB, "
            f"{'CUDA out of memory' if isinstance(out, str) else 'done'}")
    fold = DEEP_N // DEEP["kfold"]
    eval_bs, n_val = cnn._eval_batch_size(DEEP["batch_size"], fold)
    step_ms, eval_ms = span_times(recs, eval_bs, n_val)
    ga_step_ms, ga_eval_ms = span_times(ga_recs, eval_bs, n_val)
    fits = np.array([ind.get_fitness() for ind in ga.population], dtype=np.float64)
    trained = sum(len(g) for g, _c, _s, o in programs[:first_programs] if not isinstance(o, str))
    timed_peak = max(peaks[timed_from:])
    result = {
        "ga_wall_s": timer.records[0]["wall_s"],
        "ga_trained": trained,
        "ga_individuals_per_hour": trained / timer.records[0]["wall_s"] * 3600.0,
        "resume_wall_s": resume_s,
        "call_wall_s": call_s,
        "call_individuals_per_hour": DEEP_POP / call_s * 3600.0,
        "programs": [(len(g), secs, top, "oom" if isinstance(o, str) else "ok")
                     for (g, _c, secs, o), top in zip(programs, peaks)],
        "peak_mem_bytes": max(peaks),
        "call_peak_mem_bytes": timed_peak,
        "learned_cap": cap,
        "step_ms_by_width": step_ms,
        "eval_batch_ms_by_width": eval_ms,
        "ga_step_ms_by_width": ga_step_ms,
        "ga_eval_batch_ms_by_width": ga_eval_ms,
        "fitness_mean": float(fits.mean()),
        "best_fitness": best.get_fitness(),
        "library_convs": counter.convs,
        "launches": launches,
        "calibration": gauges,
    }
    log(f"[D] GA 1 generation, pop {DEEP_POP}, S={DEEP_NODES}, filters {DEEP_FILTERS}: "
        f"{result['ga_wall_s']:.3f} s in {first_programs} programs (library-conv counter on), "
        f"{trained} genomes trained ({result['ga_individuals_per_hour']:.1f} individuals/hour); "
        f"peak memory {max(peaks) / 2**30:.2f} GiB; learned pop cap {cap} "
        f"({'a CUDA OOM split the population' if cap else 'no CUDA OOM'})")
    log(f"[D] kernel launches in the GA: {launches}")
    log(f"[D] timed pop-{DEEP_POP} call, cap known, counter off: {call_s:.3f} s "
        f"({result['call_individuals_per_hour']:.1f} individuals/hour), peak memory "
        f"{timed_peak / 2**30:.2f} GiB")
    for tag, steps_, evals_ in (("timed call", step_ms, eval_ms), ("GA", ga_step_ms, ga_eval_ms)):
        for width in sorted(steps_):
            ev = f"{evals_[width]:.3f} ms" if width in evals_ else "none finished"
            log(f"[D] {tag}, P={width}: train step {steps_[width]:.3f} ms, eval batch of "
                f"{eval_bs:,} {ev} (telemetry spans, device synchronised per span)")
    log(f"[D] fitnesses (mean {fits.mean():.4f}, chance 0.01): {np.round(fits, 4).tolist()}")
    log(f"[D] cost calibration gauges: {json.dumps(gauges)}")
    log(f"[D] library convolution ops in the GA and resume: {counter.convs or 'none'}")
    log(f"[D] resumed from the checkpoint: generation {resumed.generation}, best "
        f"{best2.get_fitness():.4f} vs {best.get_fitness():.4f} ({resume_s:.3f} s)")
    check(len(fits) == DEEP_POP and bool(np.isfinite(fits).all()), "50 finite config #5 fitnesses")
    check(fits.mean() > 1.0 / DEEP_CLASSES, "config #5 mean fitness above chance")
    for k, n in launches.items():
        check(n > 0, f"{k} launched in config #5's GA")
    check(not counter.convs, f"no library convolution in phase D: {counter.convs}")
    check(resumed.generation == 1 and best2.get_genes() == best.get_genes()
          and best2.get_fitness() == best.get_fitness(), "resume reports generation 1, same best")
    # Purity: the timed call re-measures the GA's population bit for bit,
    # and two genomes of the first finished program give the same bits as a
    # pop-2 batch (bucket 2).
    rerun = float(np.abs(np.asarray(again50, dtype=np.float64) - fits).max())
    done = next((g, o) for g, _c, _s, o in programs if not isinstance(o, str) and len(g) >= 2)
    pair = done[0][:2]
    again = GeneticCnnModel.cross_validate_population(x, y, pair, **DEEP)
    witness = float(np.abs(again - done[1][:2]).max())
    log(f"[D] purity: the timed call vs the GA's fitnesses: max|Δfitness| = {rerun}; 2 genomes "
        f"of a {len(done[0])}-genome program again as a pop-2 batch: max|Δfitness| = {witness}")
    check(rerun == 0.0, f"config #5 timed call re-measures the GA's fitnesses: {rerun}")
    check(witness == 0.0, f"config #5 purity at width {len(done[0])} vs 2: {witness}")
    result["purity_max_abs_diff"] = max(rerun, witness)
    return result, launches, (cap or DEEP_POP), (x, y, pair, again)


def phase_budget(torch, x, y, pair):
    """Config #5 under a ``micro`` budget (see the module docstring, phase B)."""
    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.parallel.mesh import cnn_genome_cost
    from gentun_tpu_torch.telemetry.registry import get_registry

    cost = cnn_genome_cost(DEEP_NODES, DEEP_FILTERS, (32, 32, 3), DEEP_DENSE, DEEP_CLASSES,
                           "bfloat16")
    budget = cost.param_bytes + cost.act_bytes_per_example * 128
    cls = cnn._genome_size_class(cnn._normalize_config(x, y, dict(DEEP, device_budget=budget)))
    log(f"[B] cost model: {cost.param_bytes:,} param bytes + {cost.act_bytes_per_example:,} "
        f"activation bytes an example; budget {budget:,} bytes → {cls}")
    check(cls == ("micro", 2), f"the budget classifies config #5 micro, factor 2: {cls}")
    reg = get_registry()
    steps0 = reg.counter("microbatch_steps_total").value
    programs = []
    undo = spy_programs(programs)
    try:
        t0 = time.monotonic()
        routed = GeneticCnnModel.cross_validate_population(x, y, pair, **DEEP, device_budget=budget)
        routed_s = time.monotonic() - t0
        alone = np.concatenate([
            GeneticCnnModel.cross_validate_population(x, y, [g], **DEEP, device_budget=budget)
            for g in pair])
    finally:
        undo()
    shapes = [(len(g), c.get("pop_padding"), c.get("microbatch")) for g, c, _s, _o in programs]
    steps = reg.counter("microbatch_steps_total").value - steps0
    witness = float(np.abs(routed - alone).max())
    log(f"[B] 2 genomes routed ({routed_s:.3f} s): programs (genomes, pop_padding, microbatch) "
        f"{shapes}; fitnesses {np.round(routed, 4).tolist()}; microbatch passes counted {steps:g}")
    log(f"[B] purity: each alone vs routed beside the other: max|Δfitness| = {witness}")
    check(shapes == [(1, False, 2)] * 4, f"micro route: one genome per program: {shapes}")
    check(bool(np.isfinite(routed).all()), "finite micro-route fitnesses")
    check(steps > 0, "microbatch_steps_total counts the micro route's passes")
    check(witness == 0.0, f"micro-route purity: {witness}")
    try:
        GeneticCnnModel.cross_validate_population(x, y, pair[:1], **DEEP,
                                                  device_budget=cost.param_bytes)
    except ValueError as e:
        log(f"[B] budget of param_bytes refused: {str(e)[:90]}...")
    else:
        check(False, "a budget of param_bytes raises ValueError")
    return {"budget": budget, "programs": shapes, "fitness": routed.tolist(),
            "microbatch_passes": steps, "purity_max_abs_diff": witness, "wall_s": routed_s}


#: Phase M: the (pop, data) mesh over ranks and the multi-host worker.
#: Seconds a rank cluster may take from spawn to exit, and the follower's
#: exit bound once its leader is SIGKILLed.
M_DEADLINE_S = 300.0
M_KILL_BOUND_S = 15.0
#: M2's bound on |Δ accuracy| against one process: bf16 training over 19
#: steps carries the all-reduce's other grouping of the batch's sums (the
#: dropout stream is the same); the reference holds its sharded CPU run to
#: 0.06, and the port's own CPU data-axis test to 2/192.
M2_ACC_BOUND = 0.06


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(mode: str, world: int, backend: str, workdir: str, extra=()):
    """Run ``world`` rank processes of this script (``--rank``), one group;
    each writes ``m_<mode>_<backend>_<rank>.json``.  Fails if a rank fails or
    outlives ``M_DEADLINE_S``; every rank is killed on the way out."""
    port, procs = _free_port(), []
    for r in range(world):
        path = os.path.join(workdir, f"m_{mode}_{backend}_{r}.log")
        if os.path.exists(path[:-4] + ".json"):  # an earlier run's
            os.remove(path[:-4] + ".json")
        with open(path, "w") as fh:
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", mode, str(r), str(world),
                 str(port), backend, workdir, *map(str, extra)],
                cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, LOCAL_RANK=str(r)),
                stdout=fh, stderr=subprocess.STDOUT), path))
    deadline = time.monotonic() + M_DEADLINE_S
    try:
        for proc, path in procs:
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            with open(path) as fh:
                text = fh.read()
            check(rc == 0, f"{mode} rank exit {rc} within {M_DEADLINE_S} s ({path}):\n"
                           f"{text[-3000:]}")
    finally:
        _kill(procs)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"m_{mode}_{backend}_{r}.json")) as fh:
            out.append(json.load(fh))
    return out


def _rank_m1(torch):
    """M1 on one rank: config #2's pop-20 proxy call over the world's mesh."""
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.ops import pop_conv
    from gentun_tpu_torch.telemetry.registry import get_registry

    x, y = cifar_data()
    genomes = random_population(NODES, POP, seed=2)
    t0 = time.monotonic()
    GeneticCnnModel.cross_validate_population(x, y, genomes, **PROXY)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    for k in pop_conv.LAUNCHES:
        pop_conv.LAUNCHES[k] = 0
    t0 = time.monotonic()
    accs = GeneticCnnModel.cross_validate_population(x, y, genomes, **PROXY)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    reg = get_registry()
    shape = [int(reg.gauge("mesh_pop_axis").value), int(reg.gauge("mesh_data_axis").value)]
    return {"accs": [float(a).hex() for a in accs], "wall_s": wall, "warm_s": warm_s,
            "mesh": shape, "slots": POP // shape[0], "launches": dict(pop_conv.LAUNCHES),
            "peak_memory_allocated": torch.cuda.max_memory_allocated()}


def _rank_m2(torch, budget: str, pair_path: str):
    """M2 on one rank: phase B's config #5 pair under a budget that routes
    ``big`` over the world, once instrumented (each step and all-reduce
    synchronised and timed, the params hashed at each fold's eval), once
    timed without instrumentation."""
    import hashlib

    import torch.distributed as dist

    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.ops import pop_conv
    from gentun_tpu_torch.utils.datasets import load_cifar100

    x, y, _ = load_cifar100(n=DEEP_N)
    with open(pair_path) as fh:
        pair = json.load(fh)
    cfg = dict(DEEP, device_budget=int(budget))
    klass = cnn._genome_size_class(cnn._normalize_config(x, y, cfg))
    steps, reduces, digests, in_step = [], [], [], [False]
    real = (cnn._train_step, dist.all_reduce, cnn._eval_fold)

    def step(*args, **kwargs):
        torch.cuda.synchronize()
        t0, in_step[0] = time.perf_counter(), True
        try:
            real[0](*args, **kwargs)
            torch.cuda.synchronize()
        finally:
            in_step[0] = False
        steps.append(time.perf_counter() - t0)

    def all_reduce(t, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real[1](t, *args, **kwargs)
        torch.cuda.synchronize()
        if in_step[0]:
            reduces.append((t.numel() * t.element_size(), time.perf_counter() - t0))
        return out

    def eval_fold(model, *args, **kwargs):
        h = hashlib.sha256()
        for _, p in model.named_parameters():
            h.update(p.detach().float().cpu().numpy().tobytes())
        digests.append(h.hexdigest())
        return real[2](model, *args, **kwargs)

    cnn._train_step, dist.all_reduce, cnn._eval_fold = step, all_reduce, eval_fold
    try:
        t0 = time.monotonic()
        first = GeneticCnnModel.cross_validate_population(x, y, pair, **cfg)
        torch.cuda.synchronize()
        instrumented_s = time.monotonic() - t0
    finally:
        cnn._train_step, dist.all_reduce, cnn._eval_fold = real
    torch.cuda.reset_peak_memory_stats()
    for k in pop_conv.LAUNCHES:
        pop_conv.LAUNCHES[k] = 0
    t0 = time.monotonic()
    accs = GeneticCnnModel.cross_validate_population(x, y, pair, **cfg)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {"class": list(klass), "accs": [float(a).hex() for a in accs],
            "instrumented_accs": [float(a).hex() for a in first], "wall_s": wall,
            "instrumented_s": instrumented_s, "step_s": steps, "allreduce": reduces,
            "fold_param_digests": digests, "launches": dict(pop_conv.LAUNCHES),
            "peak_memory_allocated": torch.cuda.max_memory_allocated()}


def rank_main(argv) -> int:
    """One rank of phase M (``chip_smoke.py --rank <m1|m2> RANK WORLD PORT
    BACKEND WORKDIR [ARGS]``): join the group, run the mode, write its JSON."""
    import torch

    from gentun_tpu_torch.parallel import multihost

    mode, rank, world, port, backend, workdir = argv[0], *map(int, argv[1:4]), *argv[4:6]
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend=backend)
    try:
        out = {"m1": _rank_m1, "m2": _rank_m2}[mode](torch, *argv[6:])
    finally:
        multihost.shutdown()
    out.update(rank=rank, device=str(torch.cuda.current_device()))
    with open(os.path.join(workdir, f"m_{mode}_{backend}_{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def phase_mesh(torch, workdir: str, main_accs, single_rate: float, pair, pair_accs,
               micro_wall_s: float, local_fitness):
    """Phase M (see the module docstring).  Returns the result and each
    rank's kernel launches in M1 and M2."""
    import signal

    from gentun_tpu_torch import GeneticCnnIndividual
    from gentun_tpu_torch.distributed import DistributedPopulation
    from gentun_tpu_torch.parallel.mesh import cnn_genome_cost

    t_phase = time.monotonic()
    os.makedirs(workdir, exist_ok=True)
    want = [float(a).hex() for a in main_accs]
    result = {}
    cards = torch.cuda.device_count()
    # M1: the pop axis at full width, two ranks on the one card over gloo
    # (and one rank per card over NCCL where there are two cards).
    backends = ["gloo"] + (["nccl"] if cards >= 2 else [])
    if cards < 2:
        log(f"[M] NCCL not run: {cards} CUDA card(s) here, and NCCL takes one card per "
            f"rank; the two ranks share card 0 over gloo")
    m1_launches = {}
    for backend in backends:
        t0 = time.monotonic()
        ranks = _run_ranks("m1", 2, backend, workdir)
        wall = max(r["wall_s"] for r in ranks)
        rate = POP / wall * 3600.0
        for r in ranks:
            log(f"[M1 {backend}] rank {r['rank']} (cuda:{r['device']}): mesh "
                f"{r['mesh'][0]}x{r['mesh'][1]}, {r['slots']} slots, warm call {r['wall_s']:.3f} s "
                f"(first {r['warm_s']:.3f} s), kernel launches {r['launches']}, peak memory "
                f"allocated {r['peak_memory_allocated'] / 2**30:.2f} GiB")
            check(r["mesh"] == [2, 1] and r["slots"] == POP // 2, f"M1 {backend}: a (2, 1) mesh")
            for k, n in r["launches"].items():
                check(n > 0, f"M1 {backend}: {k} launched on rank {r['rank']}")
            check(r["accs"] == want, f"M1 {backend}: rank {r['rank']}'s fitnesses equal phase "
                                     f"3's timed call bit for bit")
        log(f"[M1 {backend}] all {POP} fitnesses equal phase 3's on both ranks, bit for bit; "
            f"warm call {wall:.3f} s, {rate:.1f} individuals/hour (phase 3, one process: "
            f"{single_rate:.1f}); cluster {time.monotonic() - t0:.1f} s from spawn to exit")
        result[f"M1_{backend}"] = {"ranks": ranks, "wall_s": wall, "individuals_per_hour": rate,
                                   "phase3_individuals_per_hour": single_rate}
        if backend == "gloo":
            m1_launches = [r["launches"] for r in ranks]

    # M2: the data axis and the big class, phase B's pair on a (1, 2) mesh.
    cost = cnn_genome_cost(DEEP_NODES, DEEP_FILTERS, (32, 32, 3), DEEP_DENSE, DEEP_CLASSES,
                           "bfloat16")
    budget = cost.param_bytes + cost.act_bytes_per_example * 128
    pair_path = os.path.join(workdir, "m2_pair.json")
    with open(pair_path, "w") as fh:
        json.dump([{k: list(map(int, v)) for k, v in g.items()} for g in pair], fh)
    want2 = np.asarray(pair_accs, dtype=np.float64)
    for backend in backends:
        t0 = time.monotonic()
        ranks = _run_ranks("m2", 2, backend, workdir, (budget, pair_path))
        for r in ranks:
            accs = np.asarray([float.fromhex(a) for a in r["accs"]])
            steps = sorted(r["step_s"])
            red = r["allreduce"]
            per_step_bytes = red[0][0] if red else 0
            log(f"[M2 {backend}] rank {r['rank']} (cuda:{r['device']}): class {r['class']}, "
                f"fitnesses {np.round(accs, 4).tolist()} (one process: "
                f"{np.round(want2, 4).tolist()}), |Δ| max {float(np.abs(accs - want2).max()):.4f} "
                f"(bound {M2_ACC_BOUND}); instrumented call {r['instrumented_s']:.3f} s: "
                f"{len(steps)} steps, median {1e3 * steps[len(steps) // 2]:.3f} ms a step; "
                f"{len(red)} all-reduces of {per_step_bytes:,} bytes, median "
                f"{1e3 * sorted(t for _, t in red)[len(red) // 2]:.3f} ms; timed call "
                f"{r['wall_s']:.3f} s (one process, phase B's micro route of the same budget: "
                f"{micro_wall_s:.3f} s); launches {r['launches']}; peak memory allocated "
                f"{r['peak_memory_allocated'] / 2**30:.2f} GiB")
            check(r["class"] == ["big", 1], f"M2 {backend}: the budget routes big over 2 ranks: "
                                            f"{r['class']}")
            check(r["accs"] == r["instrumented_accs"],
                  f"M2 {backend}: the instrumented and timed calls agree")
            check(float(np.abs(accs - want2).max()) <= M2_ACC_BOUND,
                  f"M2 {backend}: accuracies within {M2_ACC_BOUND} of one process")
            check(len(red) == len(steps) > 0, f"M2 {backend}: one all-reduce per step")
            for k, n in r["launches"].items():
                check(n > 0, f"M2 {backend}: {k} launched on rank {r['rank']}")
        check(ranks[0]["fold_param_digests"] == ranks[1]["fold_param_digests"]
              and len(ranks[0]["fold_param_digests"]) == 2 * len(pair),
              f"M2 {backend}: params equal on both ranks after every fold")
        log(f"[M2 {backend}] params equal on both ranks at all "
            f"{len(ranks[0]['fold_param_digests'])} fold evals; cluster "
            f"{time.monotonic() - t0:.1f} s from spawn to exit")
        result[f"M2_{backend}"] = {"ranks": ranks, "budget": budget,
                                   "one_process_accs": list(map(float, pair_accs)),
                                   "one_process_micro_wall_s": micro_wall_s}
        if backend == "gloo":
            m2_launches = [r["launches"] for r in ranks]

    # M3: a leader and a follower worker process serve one generation of
    # config #4's shape on a (2, 1) mesh; then the leader is SIGKILLed.
    port = _free_port()
    procs = []
    t0 = time.monotonic()
    with DistributedPopulation(GeneticCnnIndividual, size=POP, seed=0,
                               additional_parameters=dict(PROXY), host="127.0.0.1", port=0,
                               evaluate_retries=3, job_timeout=900.0) as pop:
        for r in range(2):
            procs.append(_worker(workdir, f"m3_rank{r}", pop.broker_address[1], POP, None,
                                 env={"LOCAL_RANK": str(r)},
                                 extra=("--coordinator", f"127.0.0.1:{port}", "--num-processes",
                                        "2", "--process-id", str(r), "--backend", "gloo")))
        try:
            join_s = _await_fleet(pop, procs, 1)
            chips = pop.broker.fleet_chips()
            t1 = time.monotonic()
            pop.evaluate()
            eval_s = time.monotonic() - t1
            got = {k: float(v).hex() for k, v in pop.fitness_cache.items()}
            alive = procs[1][0].poll() is None
            procs[0][0].send_signal(signal.SIGKILL)
            t1 = time.monotonic()
            try:
                rc = procs[1][0].wait(timeout=M_KILL_BOUND_S + 30.0)
            except subprocess.TimeoutExpired:
                rc = None
            exit_s = time.monotonic() - t1
        finally:
            _kill(procs)
    with open(procs[1][1]) as fh:
        follower_log = fh.read()
    log(f"[M3] leader and follower joined in {join_s:.1f} s as one worker of {chips} cards; "
        f"one generation of {len(got)} genomes in {eval_s:.3f} s; leader SIGKILLed: follower "
        f"exit code {rc} after {exit_s:.2f} s (bound {M_KILL_BOUND_S} s)")
    check(chips == 2, f"M3: the worker advertises both ranks' cards ({chips})")
    check(bool(got) and all(local_fitness.get(k) == v for k, v in got.items()),
          "M3: every fitness equals the single-process search's, bit for bit")
    check(alive and rc == 17 and exit_s < M_KILL_BOUND_S,
          f"M3: the follower exits with 17 within {M_KILL_BOUND_S} s:\n{follower_log[-2000:]}")
    result["M3"] = {"join_s": join_s, "eval_s": eval_s, "fleet_chips": chips,
                    "follower_rc": rc, "follower_exit_s": exit_s}
    result["phase_s"] = time.monotonic() - t_phase
    log(f"[M] phase M took {result['phase_s']:.1f} s")
    return result, m1_launches, m2_launches


KERNEL_SOURCE = "gentun_tpu_torch/csrc/pop_conv3x3.cu"


def replaces(source: str):
    """``{kernel: file:line}`` from the source note's ``// replaces <kernel>:
    <file:line>`` lines: what each kernel stands in for in the JAX package."""
    out = {}
    with open(os.path.join(REPO, source)) as fh:
        for line in fh:
            if line.startswith("// replaces "):
                name, where = line[len("// replaces "):].split(":", 1)
                out[name.strip()] = where.strip()
    return out


def _bound_by(tot) -> str:
    return "bytes" if tot["bound_bytes_ms"] >= tot["bound_ops_ms"] else "operations"


def _pool(tot):
    """``F.max_pool2d``'s time for the pool the stage-output kernel fuses,
    where the kernel has one, and the eager chain's time for a DAG kernel's
    work (``chain_ms``), where it was timed."""
    return {key: tot[key] for key in ("max_pool2d_ms", "chain_ms") if key in tot}


def _sub(tot, extra):
    """A kernel's per-step numbers in a ``kernels`` sub-entry."""
    return {"max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": _bound_by(tot),
            "library_ms": tot["library_ms"], **_pool(tot), **extra}


def kernels_line(per_step, launches, deep_per_step, deep_launches, deep_slots,
                 async_per_step, async_launches, worker_launches, canary_launches,
                 mesh_launches, big_launches, mesh_per_step, big_per_step, studies_launches,
                 studies_worker_launches, async_worker_launches):
    """The ``{"kernels": [...]}`` record: each kernel's launches on the main
    path (phase 3) and, from phase K, its error against the plain version and
    its times summed over the calls of one config #2 train step (bf16); under
    ``deep`` the same for config #5 (the launches of phase D's GA, phase K5's
    times), under ``async`` for the steady-state search (phase A's launches,
    its P=2 times), under ``distributed`` the launches of phase W: W1's worker
    process over its search, and the in-process client serving W3's canary
    probe; under ``async_distributed`` W4's worker process over the
    steady-state search; under ``mesh`` and ``mesh_big`` each rank's launches in phase M
    (M1's timed call over the ``(2, 1)`` mesh, M2's over the ``(1, 2)``
    mesh) and the kernels' times at one rank's shapes there (phase MK); under
    ``studies`` the launches of phase S: S1-S3 in this process, and S4's
    worker processes over both variants."""
    where = {**replaces(KERNEL_SOURCE), **replaces(DAG_SOURCE)}
    out = []
    for name, tot in per_step.items():
        deep, asy = deep_per_step[name], async_per_step[name]
        out.append({
            "name": name, "route": "cuda",
            "source": DAG_SOURCE if name in DAG_KERNELS else KERNEL_SOURCE,
            "replaces": where[name], "launches": launches[name],
            "max_abs_err": tot["max_abs_err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": _bound_by(tot),
            "library_ms": tot["library_ms"], **_pool(tot),
            "per": f"config #2 train step, bf16, pop {POP}, batch 256: {tot['calls']} calls",
            "deep": {
                "launches": deep_launches[name], "max_abs_err": deep["max_abs_err"],
                "ms": deep["ms"], "plain_ms": deep["plain_ms"], "bound_ms": deep["bound_ms"],
                "bound_by": _bound_by(deep),
                "library_ms": deep["library_ms"], **_pool(deep),
                "per": f"config #5 train step, bf16, pop {deep_slots}, batch 256: "
                       f"{deep['calls']} calls",
            },
            "async": {
                "launches": async_launches[name], "max_abs_err": asy["max_abs_err"],
                "ms": asy["ms"], "plain_ms": asy["plain_ms"], "bound_ms": asy["bound_ms"],
                "bound_by": _bound_by(asy), "library_ms": asy["library_ms"], **_pool(asy),
                "per": f"config #2 train step, bf16, pop 2 (one genome an evaluation), "
                       f"batch 256: {asy['calls']} calls",
            },
            "distributed": {
                "launches": worker_launches[name], "canary_launches": canary_launches[name],
                "per": f"config #4: {W_GENERATIONS} generations of pop {POP} served by one "
                       f"worker process (capacity {POP}); the canary's one-genome probe",
            },
            "async_distributed": {
                "launches": async_worker_launches[name],
                "per": f"phase W4: AsyncEvolution over a broker, {W4_TOTAL} completions of a "
                       f"ring of {ASYNC_POP} on config #2's ladder, served by one worker "
                       f"process (capacity {POP})"},
            "studies": {
                "launches": studies_launches[name],
                "worker_launches": studies_worker_launches[name],
                "per": f"phase S at config #2, pop {POP}: S1's fenced decomposition, S2's "
                       f"three entry-pad variants (a warm-up and a timed call each), S3's "
                       f"one-generation GA example in this process; S4's tail-generation "
                       f"workers ({S_TAILGEN_GENERATIONS} generations, two variants)"},
            "mesh": _sub(mesh_per_step[name], {
                "launches_per_rank": [r[name] for r in mesh_launches],
                "per": f"phase M1: config #2 pop {POP} over a (2, 1) mesh of two ranks (gloo, "
                       f"one card), one timed call; times per train step of one rank, bf16, "
                       f"pop {POP // 2}, batch 256: {mesh_per_step[name]['calls']} calls"}),
            "mesh_big": _sub(big_per_step[name], {
                "launches_per_rank": [r[name] for r in big_launches],
                "per": f"phase M2: config #5's pair routed big over a (1, 2) mesh, one timed "
                       f"call; times per train step of one rank, bf16, pop 1, batch 128: "
                       f"{big_per_step[name]['calls']} calls"}),
        })
    return {"kernels": out}


def phase_m_main() -> int:
    """``python3 chip_smoke.py --phase-m``: phase M alone, with its inputs
    made here: phase 3's pop-20 call, two config #5 genomes (seed 7) with
    their one-process call and the one-process route of M2's budget, and
    config #4's pop-20 population evaluated in this process.  On a machine
    with two cards or more, M1 and M2 run over NCCL too."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from gentun_tpu_torch import GeneticCnnIndividual, Population
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.parallel.mesh import cnn_genome_cost
    from gentun_tpu_torch.utils.datasets import load_cifar10, load_cifar100

    phase_build()
    name, smi = phase_device(torch)
    x, y = cifar_data()
    genomes = random_population(NODES, POP, seed=2)
    GeneticCnnModel.cross_validate_population(x, y, genomes, **PROXY)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    main_accs = GeneticCnnModel.cross_validate_population(x, y, genomes, **PROXY)
    torch.cuda.synchronize()
    rate = POP / (time.monotonic() - t0) * 3600.0
    log(f"[M] one process, phase 3's call: {POP / rate * 3600.0:.3f} s, "
        f"{rate:.1f} individuals/hour")
    x5, y5, _ = load_cifar100(n=DEEP_N)
    pair = random_population(DEEP_NODES, 2, seed=7)
    pair_accs = GeneticCnnModel.cross_validate_population(x5, y5, pair, **DEEP)
    cost = cnn_genome_cost(DEEP_NODES, DEEP_FILTERS, (32, 32, 3), DEEP_DENSE, DEEP_CLASSES,
                           "bfloat16")
    budget = cost.param_bytes + cost.act_bytes_per_example * 128
    t0 = time.monotonic()
    GeneticCnnModel.cross_validate_population(x5, y5, pair, **DEEP, device_budget=budget)
    torch.cuda.synchronize()
    micro_s = time.monotonic() - t0
    xc, yc, _ = load_cifar10(n=N_DATA)
    local = Population(GeneticCnnIndividual, x_train=xc, y_train=yc, size=POP, seed=0,
                       additional_parameters=dict(PROXY))
    local.evaluate()
    local_fitness = {k: float(v).hex() for k, v in local.fitness_cache.items()}
    del x, y, x5, y5, xc, yc, local
    gc.collect()
    torch.cuda.empty_cache()
    mesh, _, _ = phase_mesh(torch, os.path.join(REPO, "build", "chip_smoke"), main_accs, rate,
                            pair, pair_accs, micro_s, local_fitness)
    log(f"[6] summary: {json.dumps(mesh, default=str)}")
    print(smi)
    return 0


def phase_s_main() -> int:
    """``python3 chip_smoke.py --phase-s``: phase S alone, with phase 3's
    call made here (a warm-up call, then the timed one S1 is held to)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    phase_build()
    name, smi = phase_device(torch)
    x, y = cifar_data()
    genomes = random_population(NODES, POP, seed=2)
    GeneticCnnModel.cross_validate_population(x, y, genomes, **PROXY)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    main_accs = GeneticCnnModel.cross_validate_population(x, y, genomes, **PROXY)
    torch.cuda.synchronize()
    log(f"[S] phase 3's call: {time.monotonic() - t0:.3f} s")
    del x, y
    studies, launches, worker_launches = phase_studies(
        torch, main_accs, os.path.join(REPO, "build", "chip_smoke"))
    studies["S5"] = phase_compile_cache(os.path.join(REPO, "build", "chip_smoke"))
    log(f"[6] summary: {json.dumps(studies, default=str)}")
    print(smi)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    try:
        import gentun_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 3
    from gentun_tpu_torch.ops import pop_conv

    t_start = time.monotonic()
    phase_build()
    name, smi = phase_device(torch)
    per_step, _ = phase_kernels(torch)
    x, y = cifar_data()
    genomes = random_population(NODES, POP, seed=2)
    leaves = phase_leaves(torch, x, y, genomes)
    phase_parity(torch, torch.device("cuda"))
    for k in pop_conv.LAUNCHES:
        pop_conv.LAUNCHES[k] = 0
    bf16_calls, main_result = phase_main(torch, x, y, genomes)
    main_accs = bf16_calls[1]
    launches = dict(pop_conv.LAUNCHES)
    log(f"[3] kernel launches in the three main-path calls: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the main path")
    purity, batches = phase_purity(x, y, genomes, bf16_calls)
    executors = phase_executors(x, y, genomes, batches)
    phase_ga()
    asynchronous, async_launches = phase_async(torch, x, y, os.path.join(REPO, "build", "chip_smoke"))
    async_per_step = new_per_step()
    step_kernels(torch, "A", NODES, FILTERS, 2, "bfloat16", async_per_step)
    log_per_step("A", "config #2 (P=2)", async_per_step)
    del x, y, genomes, bf16_calls, batches
    gc.collect()
    torch.cuda.empty_cache()
    workers, worker_launches, canary_launches, local_fitness = phase_workers(
        torch, os.path.join(REPO, "build", "chip_smoke"), main_result["individuals_per_hour"])
    gc.collect()
    torch.cuda.empty_cache()
    async_workers, async_worker_launches = phase_async_workers(
        torch, os.path.join(REPO, "build", "chip_smoke"))
    gc.collect()
    torch.cuda.empty_cache()
    studies, studies_launches, studies_worker_launches = phase_studies(
        torch, main_accs, os.path.join(REPO, "build", "chip_smoke"))
    studies["S5"] = phase_compile_cache(os.path.join(REPO, "build", "chip_smoke"))
    gc.collect()
    torch.cuda.empty_cache()
    deep, deep_launches, deep_slots, (x5, y5, pair, pair_accs) = phase_deep(
        torch, os.path.join(REPO, "build", "chip_smoke"))
    gc.collect()
    torch.cuda.empty_cache()
    deep_per_step = phase_kernels_deep(torch, deep_slots)
    budget = phase_budget(torch, x5, y5, pair)
    del x5, y5
    gc.collect()
    torch.cuda.empty_cache()
    mesh, mesh_launches, big_launches = phase_mesh(
        torch, os.path.join(REPO, "build", "chip_smoke"), main_accs,
        main_result["individuals_per_hour"], pair, pair_accs, budget["wall_s"], local_fitness)
    mesh_per_step = new_per_step()
    step_kernels(torch, "MK", NODES, FILTERS, POP // 2, "bfloat16", mesh_per_step)
    log_per_step("MK", f"config #2 (P={POP // 2}, an M1 rank's share)", mesh_per_step)
    big_per_step = new_per_step()
    step_kernels(torch, "MK", DEEP_NODES, DEEP_FILTERS, 1, "bfloat16", big_per_step, batch=128)
    log_per_step("MK", "config #5 (P=1, batch 128, an M2 rank's share)", big_per_step)
    summary = {"main_path": main_result, "launches": launches, "purity_max_abs_diff": purity,
               "differing_grad_leaves": leaves, "executors": executors, "deep": deep,
               "deep_launches": deep_launches, "budget": budget, "async": asynchronous,
               "workers": workers, "async_workers": async_workers, "studies": studies,
               "mesh": mesh,
               "card": smi, "total_s": time.monotonic() - t_start}
    log(f"[6] summary: {json.dumps(summary, default=str)}")
    print(smi)
    print(json.dumps(kernels_line(per_step, launches, deep_per_step, deep_launches, deep_slots,
                                  async_per_step, async_launches, worker_launches,
                                  canary_launches, mesh_launches, big_launches,
                                  mesh_per_step, big_per_step, studies_launches,
                                  studies_worker_launches, async_worker_launches)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        sys.exit(rank_main(sys.argv[sys.argv.index("--rank") + 1:]))
    if "--phase-s" in sys.argv:
        sys.exit(phase_s_main())
    sys.exit(phase_m_main() if "--phase-m" in sys.argv else main())
