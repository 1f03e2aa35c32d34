"""Tracing and timing hooks for the fitness hot path.

The counterpart of the JAX package's ``utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``chrome://tracing``, Perfetto, TensorBoard's profile
  plugin) of the work inside it under ``logdir``;
- :class:`EvalTimer`: per-evaluation wall and throughput records, the
  source of the north-star metric (individuals/hour/card) at finer grain
  than the per-generation log.  Each ``measure()`` block also emits an
  ``eval_timer`` span into the active telemetry run (when tracing is on);
- :func:`profiler_range`: a ``gentun.<kind>`` ``record_function`` range
  while a ``torch.profiler`` runs, else None.  Importing this module
  installs it as the span system's range hook (``telemetry/spans.py``),
  so every enabled span shows in a profile as a range of its name, on the
  same Unix-epoch clock as the span's ``t_wall``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, List

import torch

from ..telemetry import spans as _tele

__all__ = ["trace", "EvalTimer", "profiler_range"]

logger = logging.getLogger("gentun_tpu_torch")


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """``with trace('/tmp/tb'): population.evaluate()`` → a Chrome trace in
    ``logdir`` (``trace-<pid>-<ns>.json``).

    Records the host's operators and, where a CUDA device is present, the
    device's kernels.  A no-op when ``enabled`` is false, so call sites can
    leave the hook in place.
    """
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def profiler_range(kind: str):
    """The ``gentun.<kind>`` range of a span or a train-step phase while a
    profiler runs; None otherwise, so nothing is opened outside a profile."""
    if not torch._C._autograd._profiler_enabled():  # this thread's profiler state
        return None
    return torch.profiler.record_function("gentun." + kind)


_tele.set_range_hook(profiler_range)


class EvalTimer:
    """Accumulates per-evaluation timings; reports the north-star metric."""

    def __init__(self, n_chips: int = 1):
        self.n_chips = max(1, int(n_chips))
        self.records: List[Dict[str, Any]] = []

    @contextlib.contextmanager
    def measure(self, n_individuals: int, label: str = ""):
        t0 = time.monotonic()
        yield
        elapsed = max(time.monotonic() - t0, 1e-9)
        rec = {
            "label": label,
            "individuals": int(n_individuals),
            "wall_s": round(elapsed, 4),
            "individuals_per_hour_per_chip": round(
                n_individuals / (elapsed / 3600.0) / self.n_chips, 2
            ),
        }
        self.records.append(rec)
        _tele.record_span(
            "eval_timer", t0, elapsed,
            attrs={"label": label, "individuals": int(n_individuals)},
        )
        logger.info("eval %s", json.dumps(rec))

    @property
    def total_individuals(self) -> int:
        return sum(r["individuals"] for r in self.records)

    def summary(self) -> Dict[str, Any]:
        wall = max(sum(r["wall_s"] for r in self.records), 1e-9)
        n = self.total_individuals
        return {
            "individuals": n,
            "wall_s": round(wall, 3),
            "individuals_per_hour_per_chip": round(n / (wall / 3600.0) / self.n_chips, 2),
        }
