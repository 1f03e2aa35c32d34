"""RunTelemetry: the per-run ``telemetry.jsonl`` artifact + final summary.

One :class:`RunTelemetry` per search run.  It is the process-wide span
sink while installed: every finished span/event — master-side directly,
worker-side via the ``spans`` field of ``result`` frames (see
``broker._on_result`` → :func:`gentun_tpu_torch.telemetry.spans.ingest`) — is
appended to the JSONL file as it arrives, and the raw durations are kept
per span kind so :meth:`summary` reports *exact* p50/p95/p99 (the
registry histograms are the bucketed always-on estimate; the run summary
does better because it has the run's full duration list).

Artifact schema (one JSON object per line):

- ``{"type": "run_start", ...}``   — first line: pid, wall time, label
- ``{"type": "span", ...}``        — see ``spans.py`` record fields
- ``{"type": "event", ...}``       — structured events (fault injections)
- ``{"type": "summary", ...}``     — last line: per-kind percentiles,
  counter totals and gauge values from the metrics registry snapshot

Usage::

    with RunTelemetry("out/telemetry.jsonl") as run:
        ga.run(generations)
    print(run.summary()["spans"]["evaluate"]["p95"])
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import lineage as _lineage
from . import spans as _spans
from .registry import get_registry

__all__ = ["RunTelemetry", "start_run", "active_run", "end_run"]


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Exact linear-interpolated percentile of a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class RunTelemetry:
    """Streaming JSONL writer + in-memory span aggregator for one run.

    Thread-safe: the master thread, the broker loop thread (ingesting
    worker reports), and any in-process worker threads all call
    :meth:`record` concurrently.
    """

    def __init__(self, path: str, label: Optional[str] = None, registry=None):
        self.path = str(path)
        self.label = label
        self._registry = registry or get_registry()
        self._lock = threading.Lock()
        self._fh = None
        self._durations: Dict[str, List[float]] = {}
        self._event_counts: Dict[str, int] = {}
        self._n_spans = 0
        self._closed = False
        self._installed = False
        self._t0 = time.monotonic()

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "RunTelemetry":
        """Open the artifact, become the process sink, enable tracing."""
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        with self._lock:
            self._fh = open(self.path, "w", encoding="utf-8")
        self._write({"type": "run_start", "t_wall": time.time(),
                     "pid": os.getpid(), "label": self.label})
        _spans.set_run_sink(self)
        _spans.enable()
        self._installed = True
        return self

    def close(self) -> Dict[str, Any]:
        """Write the summary line, release the sink, return the summary."""
        if self._closed:
            return self.summary()
        self._closed = True
        summ = self.summary()
        self._write({"type": "summary", **summ})
        if self._installed:
            _spans.set_run_sink(None)
            # The flight recorder (ops plane) may still be consuming
            # records; only stop collection when this run was the last
            # sink — the mirror of flight.disable()'s has_run_sink check.
            if not _spans.has_flight_sink():
                _spans.disable()
            self._installed = False
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        return summ

    def __enter__(self) -> "RunTelemetry":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- record path -------------------------------------------------------

    def _write(self, rec: Dict[str, Any]) -> None:
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")
                self._fh.flush()

    def record(self, rec: Dict[str, Any]) -> None:
        """Sink entry point (spans module calls this for every record)."""
        kind = rec.get("kind")
        if rec.get("type") == "span" and kind is not None:
            with self._lock:
                self._durations.setdefault(kind, []).append(float(rec.get("dur_s", 0.0)))
                self._n_spans += 1
        elif rec.get("type") == "event":
            name = str(rec.get("name"))
            with self._lock:
                self._event_counts[name] = self._event_counts.get(name, 0) + 1
        self._write(rec)

    def ingest(self, records) -> None:
        """Merge a worker's shipped span records into this run (also
        re-observes their durations into the local registry histograms
        — see spans.ingest)."""
        _spans.ingest(records)

    # -- read side ---------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            durations = {k: sorted(v) for k, v in self._durations.items()}
            events = dict(self._event_counts)
            n_spans = self._n_spans
        span_summ = {}
        for kind, vals in sorted(durations.items()):
            span_summ[kind] = {
                "count": len(vals),
                "total_s": sum(vals),
                "p50": _percentile(vals, 0.50),
                "p95": _percentile(vals, 0.95),
                "p99": _percentile(vals, 0.99),
            }
        snap = self._registry.snapshot()
        out = {
            "label": self.label,
            "wall_s": time.monotonic() - self._t0,
            "n_spans": n_spans,
            "spans": span_summ,
            "events": events,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
        }
        if _lineage.enabled():
            # Chip-hour cost table (docs/OBSERVABILITY.md "Search
            # forensics"): measured device-seconds per rung/session/worker
            # from the forensics ledger — the run's cost accounting,
            # derived from per-genome device spans rather than estimated
            # from analytic schedule costs.
            ledger = _lineage.get_ledger()
            out["cost"] = {
                "device_s_total": ledger.total(),
                "cost_s_by_rung": {str(k): v for k, v in
                                   sorted(ledger.by_rung().items())},
                "cost_s_by_session": {k: v for k, v in
                                      sorted(ledger.by_session().items())},
                "cost_s_by_worker": {k: v for k, v in
                                     sorted(ledger.by_worker().items())},
            }
        return out


# -- module-level active run (what production hook sites look up) ----------

_active: Optional[RunTelemetry] = None
_active_lock = threading.Lock()


def start_run(path: str, label: Optional[str] = None) -> RunTelemetry:
    """Create + install the process-wide run; closes any previous one."""
    global _active
    with _active_lock:
        if _active is not None:
            _active.close()
        _active = RunTelemetry(path, label=label).install()
        return _active


def active_run() -> Optional[RunTelemetry]:
    return _active


def end_run() -> Optional[Dict[str, Any]]:
    """Close the active run and return its summary (None if no run)."""
    global _active
    with _active_lock:
        if _active is None:
            return None
        summ = _active.close()
        _active = None
        return summ
