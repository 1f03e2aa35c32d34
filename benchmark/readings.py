"""The readings the limits of ``correct`` are set from, on the chip.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... [--control] [--faults half_batch ...]

For each seed it drives the cell's own driver, as a run with that seed
does, for as many calls as the judge samples genomes (``judged / pop``), and
compares them with the float32 reference as ``judge.py`` does: a sound run's
readings.  With ``--control`` it also puts the reference in float8 (one step
of precision below the configuration's bfloat16) in the system's place,
against the same float32 reference: the control's readings.  With
``--faults`` it drives the same calls again with each fault of
``faults.py`` planted underneath: each fault's readings.  One JSON line a
seed and variant, with every fitness.  The benchmark's own runs never run
the control or plant a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def read(workload: str, seed: int, device, control: bool = False, faults=(), out=None,
         manifest: str = None, base: str = None):
    """``{variant: numbers}`` of one seed: ``sound``, ``float8`` with
    ``control``, and each fault; each variant's record is also printed to
    ``out`` as a JSON line.  ``manifest`` and ``base`` as for ``cell.load``."""
    import torch

    from benchmark import cell as cells
    from benchmark import faults as planted
    from benchmark import judge

    c = cells.load(workload, manifest, base or cells.HERE)
    calls = -(-int(c.traffic["judged"]) // int(c.traffic["pop"]))
    cache_dir = os.path.join(ROOT, "build", "kernels")
    reference = {}  # (precision, call, slot) → fitness: the same genomes in every variant
    got = {}
    variants = [("sound", None)] + [(f, f) for f in faults]
    for variant, fault in variants:
        t0 = time.monotonic()
        with planted.planted(fault, int(c.config["n_classes"])) if fault else contextlib.nullcontext():
            run = c.driver().run(c, seed, float("inf"), False, cache_dir, t0, device, calls)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        pairs = judge.gaps(run, device, cache=reference)
        got[variant] = judge.numbers(pairs)
        rec = {"workload": workload, "seed": seed, "variant": variant, **got[variant],
               "answer": pairs["answer"], "reference": pairs["reference"],
               "call_s": [call.end - call.start for call in run.calls]}
        if control and fault is None:
            low = judge.gaps(run, device, "float8", cache=reference)["reference"]
            got["float8"] = judge.numbers({"answer": low, "reference": pairs["reference"]})
            rec["float8"], rec["float8_numbers"] = low, got["float8"]
        rec["seconds"] = time.monotonic() - t0
        if out is not None:
            print(json.dumps(rec), file=out, flush=True)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    import torch

    for seed in args.seeds:
        read(args.workload, seed, torch.device("cuda"), args.control, args.faults, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
