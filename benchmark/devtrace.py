"""The device's timeline from ``torch.profiler``, reduced to what the metrics read.

A traced run profiles every call of its window (CPU and CUDA activity,
without shapes, stacks or memory) and wraps each call in a
``record_function`` range named :data:`MARK`, so the window in the
profiler's clock is the first range's start to the last one's end.  The
reduction keeps:

- ``busy_s``: the union of every device interval (kernels, copies, sets) in
  the window, so overlap can never push it past the window;
- ``device_s``: device seconds by operation name;
- ``gaps``: the device's idle intervals in the window, each labelled by what
  the host thread that ran the calls was doing at its middle (the innermost
  profiled host range there: a torch operator, a CUDA runtime call, or the
  Python between them).
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

MARK = "benchmark.call"
#: Idle intervals shorter than this are counted as idle but not labelled.
LABEL_MIN_S = 5e-6


@dataclass
class Timeline:
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)
    gaps: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # label → (count, seconds)

    def seconds_matching(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.device_s.items() if rx.search(name))


def _annotation(e) -> bool:
    """Is ``e`` a ``record_function`` range (on the host or mirrored on the device)?"""
    flag = getattr(e, "is_user_annotation", None)
    kind = getattr(e, "activity_type", None)
    return (e.name() == MARK or bool(flag and flag())
            or (kind is not None and "annotation" in str(kind())))


def profiler():
    """A ``torch.profiler.profile`` for a traced window."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=False,
                   profile_memory=False, with_stack=False)


def reduce(prof) -> Optional[Timeline]:
    """The :class:`Timeline` of a finished profile; None when it holds no
    marked call."""
    events = prof.profiler.kineto_results.events()
    host, device, marks = [], [], []
    for e in events:
        start, end = e.start_ns(), e.end_ns()
        if _annotation(e):
            if e.name() == MARK and "CUDA" not in str(e.device_type()):
                marks.append((start, end, e.start_thread_id()))
            continue  # a range the profiler mirrors on the device is no device work
        if "CUDA" in str(e.device_type()):
            device.append((start, end, e.name()))
        else:
            host.append((start, end, e.start_thread_id(), e.name()))
    if not marks:
        return None
    lo, hi = min(m[0] for m in marks), max(m[1] for m in marks)
    thread = marks[0][2]
    device_s: Dict[str, float] = {}
    clipped = []
    for start, end, name in device:
        start, end = max(start, lo), min(end, hi)
        if end > start:
            clipped.append((start, end))
            device_s[name] = device_s.get(name, 0.0) + (end - start) * 1e-9
    clipped.sort()
    merged: List[List[int]] = []
    for start, end in clipped:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged)
    idle, edge = [], lo
    for start, end in merged:
        if start > edge:
            idle.append((edge, start))
        edge = max(edge, end)
    if hi > edge:
        idle.append((edge, hi))
    ranges = sorted((s, e, name) for s, e, t, name in host if t == thread)
    starts = [r[0] for r in ranges]
    gaps: Dict[str, Tuple[int, float]] = {}
    for a, b in idle:
        if (b - a) * 1e-9 < LABEL_MIN_S:
            continue
        label = _innermost(ranges, starts, (a + b) // 2)
        n, s = gaps.get(label, (0, 0.0))
        gaps[label] = (n + 1, s + (b - a) * 1e-9)
    return Timeline(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9, device_s=device_s, gaps=gaps)


def _innermost(ranges, starts, t: int, lookback: int = 512) -> str:
    """The name of the latest-starting host range that contains ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - lookback, -1), -1):
        if ranges[j][1] >= t:
            return ranges[j][2]
    return "python (no profiled host range)"


def short_name(name: str) -> str:
    """An operation's name without its template arguments and parameter list."""
    out, depth = [], 0
    for ch in name.replace("(anonymous namespace)::", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    short = "".join(out).split("(")[0].strip()
    return short.removeprefix("void ").strip() or name[:80]


def breakdown(tl: Timeline, n: int = 10) -> Dict[str, List[list]]:
    """The device operations that took most time and the idle gaps by what
    the host was doing, at most ``n`` of each, seconds as measured."""
    ops: Dict[str, float] = {}
    for name, s in tl.device_s.items():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(tl.gaps.items(), key=lambda kv: -kv[1][1])[:n]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[f"{k} (x{c})", s] for k, (c, s) in gaps]}
