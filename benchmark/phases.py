"""The system's phases, as its spans and profiler ranges show them.

With its telemetry spans on, the system opens a ``gentun.<kind>`` range in
the profile for each span (``cv_call``, ``setup``, ``init_draw``,
``upload``, ``fold_load``, ``train``, ``eval``, ``fetch``) and for each
phase of a train step (``forward``, ``backward``, ``update``), and each
``train`` span carries its steps' ``forward_s``, ``backward_s`` and
``update_s``.  From a finished profile this module gives:

- :func:`phase_gaps`: the device's idle seconds and gaps in the window
  (``devtrace.py``'s: the marked calls' span, idle where no device interval
  runs), every gap labelled by the innermost ``gentun.*`` range that holds
  its midpoint, matched by time on any thread (autograd launches the
  backward from a thread of its own), ``outside`` where none does;
- :func:`phase_launches`: the device's kernels, copies and sets by the
  innermost ``gentun.*`` range at the start of their launching call, the
  host's CUDA runtime or driver event of the same correlation id on any
  thread; :func:`train_launches`: those inside ``gentun.train`` ranges,
  and the steps, one ``gentun.update`` range each.

Run as ``python3 -m benchmark.phases --workload <cell> --seed <n> --seconds
<s>`` from the root of a checkout, it makes the traced run ``run.py --trace
1`` makes, prints its result line unchanged, and then one more line:
``idle_phases`` (``[label (xgaps), seconds]``, most seconds first),
``idle_s``, ``launches_per_step`` and ``launches_by_phase``.
"""

from __future__ import annotations

import bisect
import json
import sys
from typing import Dict, List, Optional, Tuple

from . import devtrace

PREFIX = "gentun."
OUTSIDE = "outside"
#: The ``train`` range and the step phases nested in it.
TRAIN = ("train", "forward", "backward", "update")


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def _ranges(events) -> List[Tuple[int, int, str]]:
    """The host's ``gentun.*`` ranges as (start, end, kind), outer first
    where two start together."""
    out = [(e.start_ns(), e.end_ns(), e.name()[len(PREFIX):]) for e in events
           if e.name().startswith(PREFIX) and not _is_device(e)]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _idle(events) -> List[Tuple[int, int]]:
    """The device's idle intervals in the marked calls' window, in order,
    as ``devtrace.reduce`` finds them."""
    marks, device = [], []
    for e in events:
        if devtrace._annotation(e):
            if e.name() == devtrace.MARK and not _is_device(e):
                marks.append((e.start_ns(), e.end_ns()))
        elif _is_device(e):
            device.append((e.start_ns(), e.end_ns()))
    if not marks:
        return []
    lo, hi = min(m[0] for m in marks), max(m[1] for m in marks)
    idle, edge = [], lo
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in device):
        if end <= start:
            continue
        if start > edge:
            idle.append((edge, start))
        edge = max(edge, end)
    if hi > edge:
        idle.append((edge, hi))
    return idle


def _innermost(ranges, points) -> List[str]:
    """The kind of the innermost range (the latest to start) that holds each
    of ``points``, given in order, or ``outside``: one sweep, keeping the
    ranges open at the current point on a stack."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else OUTSIDE)
    return out


def phase_gaps(events) -> Dict[str, Tuple[int, float]]:
    """Idle gaps and seconds by the innermost ``gentun.*`` range at each
    gap's midpoint: ``{kind or "outside": (count, seconds)}``."""
    gaps = _idle(events)
    out: Dict[str, Tuple[int, float]] = {}
    for (a, b), label in zip(gaps, _innermost(_ranges(events), [(a + b) // 2 for a, b in gaps])):
        n, s = out.get(label, (0, 0.0))
        out[label] = (n + 1, s + (b - a) * 1e-9)
    return out


def _launching(e) -> bool:
    """Is ``e`` a CUDA runtime (``cuda*``) or driver (``cu*``) call on the
    host, what launches device work?  By name: torch 2.11's events carry no
    activity type, and a torch operator's correlation id may equal a
    runtime call's."""
    return e.name().startswith("cu") and not _is_device(e)


def phase_launches(events) -> Dict[str, int]:
    """The device's kernels, copies and sets by the innermost ``gentun.*``
    range at the start of their launching call (the host's runtime or
    driver event of the same correlation id, on any thread)."""
    calls = {e.correlation_id(): e.start_ns() for e in events if _launching(e)}
    starts = sorted(calls[e.correlation_id()] for e in events
                    if _is_device(e) and not devtrace._annotation(e) and e.correlation_id() in calls)
    out: Dict[str, int] = {}
    for label in _innermost(_ranges(events), starts):
        out[label] = out.get(label, 0) + 1
    return out


def train_launches(events) -> Tuple[int, int]:
    """(device operations launched inside ``gentun.train`` ranges, steps):
    those of the train step's phases and of the train range's own time; the
    steps are the ``gentun.update`` ranges."""
    launches = phase_launches(events)
    steps = sum(kind == "update" for _, _, kind in _ranges(events))
    return sum(launches.get(k, 0) for k in TRAIN), steps


def step_ms(run, phase: str) -> Optional[float]:
    """Milliseconds a train step spends in ``phase`` (host clock): the
    ``train`` spans' ``<phase>_s`` over the steps of the spans that carry
    it; None where none does."""
    key = phase + "_s"
    spans = [r for c in run.calls for r in c.spans
             if r.get("kind") == "train" and key in r.get("attrs", {})]
    steps = sum(int(r["attrs"]["steps"]) for r in spans)
    if steps == 0:
        return None
    return 1000.0 * sum(r["attrs"][key] for r in spans) / steps


def view(prof) -> dict:
    """What this module reads from a finished profile, as one JSON object."""
    events = prof.profiler.kineto_results.events()
    gaps = phase_gaps(events)
    launches, steps = train_launches(events)
    by_phase = phase_launches(events)
    return {"idle_phases": [[f"{k} (x{c})", s]
                            for k, (c, s) in sorted(gaps.items(), key=lambda kv: -kv[1][1])],
            "idle_s": sum(s for _, s in gaps.values()),
            "train_launches": launches, "steps": steps,
            "launches_per_step": launches / steps if steps else None,
            "launches_by_phase": by_phase}


def main(argv=None) -> int:
    from . import run

    argv = list(sys.argv[1:] if argv is None else argv)
    kept = []
    reduce = devtrace.reduce

    def reduce_and_view(prof):  # the driver reduces its profile here, once
        kept.append(view(prof))
        return reduce(prof)

    devtrace.reduce = reduce_and_view
    try:
        rc = run.main(argv + ["--trace", "1"])
    finally:
        devtrace.reduce = reduce
    if rc == 0 and kept:
        print(json.dumps(kept[-1]))
    return rc


if __name__ == "__main__":
    sys.exit(main())
