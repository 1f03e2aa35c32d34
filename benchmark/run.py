"""Benchmark of gentun_tpu_torch, the PyTorch and CUDA port of gentun_tpu, on NVIDIA H100 cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``;
its configuration file, traffic mix, the driver the mix names and the
reader of each metric are found by name (``cell.py``).  The run makes its
inputs from ``--seed``, warms up every shape it uses (set-up), measures for
``--seconds``, then judges the window's answers against the plain reference
(``judge.py``) and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared with its limit (also the last lines of
standard error).

It exits non-zero and prints no result when no CUDA card is present or
fewer than the cell asks for, when the system cannot be imported from the
checkout, and when ``jax``, ``jaxlib``, ``flax`` or ``gentun_tpu`` is loaded
once the window has closed.  The system's kernel library is built into and
loaded from ``build/kernels`` of the checkout.
"""

from __future__ import annotations

import time

_T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: Top-level module names that may not be loaded, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "gentun_tpu")


def _process_start() -> float:
    """The process's start on the ``time.monotonic`` clock (to the kernel's
    clock tick); the module's import time where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age if 0.0 <= age < 3600.0 else _T_IMPORT
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def measure(workload: str, seed: int, seconds: float, trace: bool, device,
            process_start: float, manifest: str = None, base: str = None) -> dict:
    """One run of a cell on ``device``: the result object, unprinted.
    ``manifest`` and ``base`` name another manifest and parts directory
    (``cell.load``)."""
    import torch

    from benchmark import cell as cells
    from benchmark import devtrace, judge

    c = cells.load(workload, manifest, base or cells.HERE)
    device = torch.device(device)
    cache_dir = os.path.join(ROOT, "build", "kernels")
    run = c.driver().run(c, seed, seconds, trace, cache_dir, process_start, device)
    t_window = time.monotonic()
    metrics = {}
    for name, (entry, reader) in c.readers(trace).items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": entry["unit"]}
    peaks = [b for b in (run.peak_setup_bytes, run.peak_window_bytes) if b is not None]
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": c.chips, "memory_peak_bytes": max(peaks) if peaks else 0}
    result = {"correct": False, "attempted": run.individuals, "failed": 0, "metrics": metrics,
              "device": dev}
    if trace and run.timeline is not None:
        dev["busy_s"] = run.timeline.busy_s
        dev["window_s"] = run.timeline.window_s
        result["breakdown"] = devtrace.breakdown(run.timeline)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: {', '.join(found)} loaded by the window; "
                         "the port may not load JAX or the JAX package")
    if cuda:
        dev["power_limit"] = card_line()
        run.timeline = None
        torch.cuda.empty_cache()
    t_judge = time.monotonic()
    result["correct"], result["failed"], result["checks"] = judge.verdict(run, device)
    call_s = sorted(c.end - c.start for c in run.calls)
    print(f"timing: set-up {run.setup_s:.1f} s, window {run.window_s:.1f} s "
          f"({len(run.calls)} calls: first {run.calls[0].end - run.calls[0].start:.3f} s, "
          f"median {call_s[len(call_s) // 2]:.3f} s, last {run.calls[-1].end - run.calls[-1].start:.3f} s), "
          f"after the window {t_judge - t_window:.1f} s, "
          f"judge {time.monotonic() - t_judge:.1f} s", file=sys.stderr)
    return result


def main(argv=None) -> int:
    process_start = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)  # the benchmark's own files are imported as the package
    sys.path.insert(0, ROOT)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)

    import torch

    from benchmark import cell as cells

    chips = cells.load(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s), {have} present", file=sys.stderr)
        return 2
    import gentun_tpu_torch

    if not os.path.abspath(gentun_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"benchmark: gentun_tpu_torch imports from {gentun_tpu_torch.__file__}, "
              f"not from the checkout at {ROOT}", file=sys.stderr)
        return 2
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                     process_start)
    for name, check in result["checks"].items():
        print(f"check {name} = {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
