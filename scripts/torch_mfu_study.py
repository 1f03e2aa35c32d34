"""Where does a config #2 call's time go on the card?  The fenced phase decomposition.

The port's counterpart of ``scripts/mfu_study.py``.  It decomposes one
``GeneticCnnModel.cross_validate_population`` call of the bench workload
(``bench_torch.py``'s config #2, pop 20) into its phases, with a
``torch.cuda.synchronize()`` fence at every phase boundary, and computes the
train-phase-only share of the card's bf16 peak (the number an analytic FLOP
model can fairly be compared with) beside the whole fenced call's.

The phases follow the port's own executor, step by step
(``models/cnn.py``: ``_cross_validate_population_one`` and
``_run_segmented``), calling its own helpers, so the decomposition trains
exactly what the executor trains and its accuracies are the same bits as a
plain ``cross_validate_population`` call of the same genomes (checked at the
end of every run: a mismatch exits non-zero):

- ``host_setup_and_indices``: config and data prep, the model and its masks
  on the device (``_prepare_population_setup``), the folds' host indices
  (``_cv_indices``, the reference's numpy RNG);
- ``dataset_upload_cold``: the permuted dataset to the device with the
  cache emptied (a search pays it once); ``dataset_lookup_warm``: the
  cache hit every later call of a search pays;
- ``param_init_cpu_draw``: every (fold, genome)'s initial params drawn on
  the CPU (``_init_population_params``); ``param_upload``: each fold's
  copy of them to the device; ``opt_init``: the zeroed momentum and the
  per-genome dropout generators;
- ``segment_index_upload``: each fold's batch indices to the device;
- ``train_segments``: the train steps, fenced at each segment's end;
- ``eval``: the weighted accuracy of each fold (its index upload included).

The first call builds the kernels and warms the allocator, the second is
measured.  A ``torch.profiler`` trace of one steady segment of the first
call (its second fold, the kernels built by then) goes to
``scripts/mfu_trace/torch/`` (``utils/profiling.py::trace``), and its
device busy share is recorded; the profiler's cost stays out of the
measured call.

    python3 scripts/torch_mfu_study.py                    # full schedule, on the card
    python3 scripts/torch_mfu_study.py --schedule proxy
    python3 scripts/torch_mfu_study.py --tiny             # CPU smoke

Writes ``scripts/torch_mfu_study.json`` with the card's name and power limit.
No CUDA device and no ``--device cpu``/``--tiny``: exit 2.  A CPU run
records no share of a peak (``null``): it measures no card.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402  (the bench workload IS the subject)

#: ``--tiny``: the CPU smoke cell (config #2's stages at narrow widths).
TINY = dict(bench_torch.COMMON, kernels_per_layer=(4, 4, 4), dense_units=16, batch_size=32,
            compute_dtype="float32", kfold=2, epochs=(1,), learning_rate=(0.01,))
TINY_POP, TINY_N = 4, 160
#: The fenced phases, in the order a call runs them.
PHASES = ("host_setup_and_indices", "dataset_upload_cold", "dataset_lookup_warm",
          "param_init_cpu_draw", "param_upload", "opt_init", "segment_index_upload",
          "train_segments", "eval", "total_fenced")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def busy_share(trace_dir: str, since_ns: int):
    """Device busy share of the newest trace in ``trace_dir`` written after
    ``since_ns``: the union of its kernel intervals over the span from the
    first kernel's start to the last one's end; None when it holds no
    kernel (a CPU run)."""
    paths = [p for p in glob.glob(os.path.join(trace_dir, "trace-*.json"))
             if int(p.rsplit("-", 1)[1].split(".")[0]) >= since_ns]
    if not paths:
        return None
    with open(max(paths)) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") == "kernel" and "ts" in e)
    if not spans:
        return None
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"kernels": len(spans), "window_us": spans[-1][1] - spans[0][0],
            "busy_share": busy / max(spans[-1][1] - spans[0][0], 1e-9)}


def decompose(x, y, genomes, config: dict, trace_dir=None) -> dict:
    """One fenced ``cross_validate_population`` of ``genomes`` under
    ``config`` (which names its device through ``mesh``); returns each
    phase's seconds, the accuracies, the FLOP counts and, on the card, the
    shares of its peak."""
    import torch

    from gentun_tpu_torch.models import cnn as M
    from gentun_tpu_torch.parallel import multihost
    from gentun_tpu_torch.utils.profiling import trace

    t_all0 = time.monotonic()
    phases = {}

    # -- 1: config/data prep, model and masks on the device, host indices
    t0 = time.monotonic()
    cfg = M._normalize_config(x, y, dict(config))
    xp, yp = M._prepare_data(x, y, cfg)
    device, mesh, genomes_p, n_real, masks, model, hashes = M._prepare_population_setup(
        cfg, genomes)
    kfold = cfg["kfold"]
    perm, batch_idx, val_idx, val_weight, steps_per_epoch, eval_bs = M._cv_indices(
        cfg, xp.shape[0])
    total_steps, batch_size = batch_idx.shape[1], batch_idx.shape[2]
    M._account_sharded_batch(cfg, mesh, batch_size, total_steps * kfold)
    masks, local, batch_idx, batch_rows = M._local_share(
        mesh, masks, hashes, batch_idx, cfg["microbatch"], device)
    _sync(device)
    phases["host_setup_and_indices"] = time.monotonic() - t0

    # -- 2: dataset upload, cold (cache emptied), then the warm lookup
    t0 = time.monotonic()
    with M._DATASET_LOCK:
        M._DATASET_CACHE.clear()
    x_dev, y_dev = M._device_dataset(x, y, xp, yp, perm, cfg, device)
    _sync(device)
    phases["dataset_upload_cold"] = time.monotonic() - t0
    t0 = time.monotonic()
    M._device_dataset(x, y, xp, yp, perm, cfg, device)
    phases["dataset_lookup_warm"] = time.monotonic() - t0

    # -- 3: initial params: the CPU draw (kept on the CPU on purpose: a CPU
    #    run and a card run start from the same weights)
    t0 = time.monotonic()
    params = M._init_population_params(model, kfold, cfg["seed"], local)
    phases["param_init_cpu_draw"] = time.monotonic() - t0

    # -- 4/5: _run_segmented, fenced per phase
    lr_at = M._lr_schedule(cfg["epochs"], cfg["learning_rate"], steps_per_epoch)
    bounds = M._segment_bounds(total_steps, cfg["segment_steps"])
    microbatch = int(cfg["microbatch"])
    dropout = cfg["dropout_rate"] > 0.0
    data_group = None if mesh is None else mesh.data_group
    named = dict(model.named_parameters())
    M._check_initial_params(named, params, kfold)
    # The steady-state trace window: one segment of the second fold (the
    # first of one), wherever the schedule has one.
    trace_fold = min(1, kfold - 1)
    trace_seg = max(0, min(2, len(bounds) - 1))
    t_upload = t_opt = t_idx = t_train = t_eval = 0.0
    accs, trace_info = [], None
    for f in range(kfold):
        t0 = time.monotonic()
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(params[name][f])
        _sync(device)
        t_upload += time.monotonic() - t0
        t0 = time.monotonic()
        momentum_bufs = [torch.zeros_like(p) for p in named.values()]
        gens = M._dropout_generators(cfg["seed"], f, local, device) if dropout else None
        _sync(device)
        t_opt += time.monotonic() - t0
        t0 = time.monotonic()
        bidx = torch.as_tensor(batch_idx[f], device=device)
        _sync(device)
        t_idx += time.monotonic() - t0
        with M.exact_numerics():
            for si, (s, e) in enumerate(bounds):
                tracing = trace_dir is not None and trace_info is None and (
                    f == trace_fold and si == trace_seg)
                since = time.time_ns()
                with trace(trace_dir or "", enabled=tracing):
                    t0 = time.monotonic()
                    for t in range(s, e):
                        M._train_step(
                            model, masks, x_dev, y_dev, bidx[t], gens, momentum_bufs,
                            lr_at(t), cfg["momentum"], cfg["nesterov"], microbatch,
                            batch_rows, data_group,
                        )
                    _sync(device)
                    t_train += time.monotonic() - t0
                if tracing:
                    trace_info = {"fold": f, "segment": [s, e],
                                  "dir": os.path.relpath(trace_dir, REPO),
                                  **(busy_share(trace_dir, since) or {})}
            t0 = time.monotonic()
            vi = torch.as_tensor(val_idx[f], device=device)
            vw = torch.as_tensor(val_weight[f], device=device)
            accs.append(M._eval_fold(model, masks, x_dev, y_dev, vi, vw, eval_bs, mesh))
            _sync(device)
            t_eval += time.monotonic() - t0
    out = torch.stack(accs).cpu()
    if mesh is not None:
        table = multihost.fetch(out, ranks=mesh.row_leaders, dim=1).astype(np.float32)
    else:
        table = out.numpy().astype(np.float32)
    fitness = table.mean(axis=0)[:n_real]
    phases["param_upload"] = t_upload
    phases["opt_init"] = t_opt
    phases["segment_index_upload"] = t_idx
    phases["train_segments"] = t_train
    phases["eval"] = t_eval
    phases["total_fenced"] = time.monotonic() - t_all0

    # Analytic FLOPs, split train vs eval as bench_torch.schedule_flops
    # splits them; the peak scales with the ranks that hold a card.
    pop_p = len(genomes_p)
    fwd = bench_torch.forward_flops_per_image(cfg, cfg["input_shape"], cfg["n_classes"])
    train_flops = pop_p * kfold * total_steps * batch_size * 3.0 * fwd
    eval_flops = pop_p * kfold * val_idx.shape[1] * fwd
    n_cards = multihost.process_count() if device.type == "cuda" else 0
    peak = bench_torch.PEAK_FLOPS * n_cards
    phases["train_flops"] = train_flops
    phases["eval_flops"] = eval_flops
    phases["n_cards"] = n_cards
    phases["mfu_train_only"] = train_flops / t_train / peak if peak else None
    phases["mfu_overall_fenced"] = ((train_flops + eval_flops) / phases["total_fenced"] / peak
                                    if peak else None)
    phases["accs_mean"] = float(fitness.mean())
    phases["accs"] = [float(a) for a in fitness]
    phases["steps_per_fold"] = total_steps
    phases["segments_per_fold"] = len(bounds)
    phases["trace"] = trace_info
    return phases


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--schedule", choices=("full", "proxy"), default="full",
                    help="bench_torch's FULL (the reference's default) or PROXY schedule")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true", help="CPU smoke shapes (implies --device cpu)")
    ap.add_argument("--out", default=os.path.join(REPO, "scripts", "torch_mfu_study.json"))
    args = ap.parse_args(argv)
    cpu = args.tiny or args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("torch_mfu_study: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    mesh = "cpu" if cpu else "auto"
    if args.tiny:
        from gentun_tpu_torch.utils.datasets import synthetic_images

        x, y, _ = synthetic_images(TINY_N, bench_torch.INPUT_SHAPE, bench_torch.N_CLASSES, seed=0)
        genomes = bench_torch.random_population(TINY["nodes"], TINY_POP, seed=2)
        config = dict(TINY, mesh=mesh)
    else:
        x, y = bench_torch.cifar_data()
        genomes = bench_torch.random_population(bench_torch.NODES, bench_torch.POP, seed=2)
        base = bench_torch.FULL if args.schedule == "full" else bench_torch.PROXY
        config = dict(base, mesh=mesh)
    trace_dir = os.path.join(REPO, "scripts", "mfu_trace", "torch")

    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    # The warm-up builds the kernels and warms the allocator on the proxy
    # schedule (the port compiles no program per shape, so a proxy call
    # warms what a full one would).
    print("warm-up...", flush=True)
    warm = decompose(x, y, genomes, dict(config, kfold=2, epochs=(1,), learning_rate=(0.01,)),
                     trace_dir=trace_dir)
    print("measuring (fenced)...", flush=True)
    phases = decompose(x, y, genomes, config)
    phases["trace"] = warm["trace"]
    t0 = time.monotonic()
    plain = GeneticCnnModel.cross_validate_population(x, y, genomes, **config)
    if not cpu:
        torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    same = bool(np.array_equal(np.asarray(plain, np.float32),
                               np.asarray(phases["accs"], np.float32)))
    # The phases lie flat beside the shares, as in the reference's record;
    # ``param_init`` (the reference's one phase) is the draw plus the upload.
    record = {
        **{k: phases[k] for k in PHASES},
        "param_init": phases["param_init_cpu_draw"] + phases["param_upload"],
        **{k: phases[k] for k in ("mfu_train_only", "mfu_overall_fenced", "accs_mean", "accs",
                                  "train_flops", "eval_flops", "n_cards", "steps_per_fold",
                                  "segments_per_fold", "trace")},
        "plain_call_s": plain_s,
        "accs_equal_plain_call": same,
        "workload": f"bench_torch {args.schedule.upper() if not args.tiny else 'TINY'} schedule, "
                    f"pop {len(genomes)}, config #2's stages",
        "config": {k: list(v) if isinstance(v, tuple) else v for k, v in config.items()},
        "card": bench_torch.card_line(cpu),
        "torch": torch.__version__,
    }
    for k in PHASES:
        print(f"  {k}: {record[k]:.4f}", flush=True)
    print(f"  mfu_train_only: {record['mfu_train_only']}  mfu_overall_fenced: "
          f"{record['mfu_overall_fenced']}  plain call {plain_s:.3f} s  "
          f"accuracies equal the plain call's: {same}", flush=True)
    with open(args.out, "w") as fh:
        json.dump(record, fh, indent=1)
    print(f"wrote {args.out}")
    if not same:
        print("torch_mfu_study: the decomposition's accuracies differ from the plain call's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
