"""Flight recorder: a bounded ring of the last N span/event records.

Crash forensics for long runs.  ``telemetry.jsonl`` (export.py) is the
full flight log you opt into per run; the flight recorder is the cheap
always-on black box — a ``deque(maxlen=N)`` of the same record dicts,
kept in memory and dumped to ``flight.jsonl`` only when something goes
wrong (SIGTERM, unhandled exception) or when an operator asks
(``GET /debugz/flight`` on the ops server).

"Always-on" means: enabling it (``flight.enable()``, or implicitly via
``start_ops_server``) turns span *collection* on (``spans.enable()``)
and installs the ring as an extra sink, WITHOUT requiring a
``RunTelemetry`` artifact — telemetry export stays otherwise off.  The
per-record cost is one deque append under a lock; the bit-identity
guarantee holds because span collection itself never touches RNG state
(asserted by ``tests/test_telemetry.py``).

Dump triggers:

- ``SIGTERM`` — dump, then chain to the previously installed handler
  (or re-raise the default die).  Installed only from the main thread
  (``signal.signal`` raises elsewhere); worker threads still get the
  excepthook.
- unhandled exception — ``sys.excepthook`` wrapper dumps, then chains.
- explicit :meth:`FlightRecorder.dump` / ``/debugz/flight``.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import spans as _spans

__all__ = ["FlightRecorder", "enable", "disable", "active", "DEFAULT_CAPACITY"]

#: Ring size: at master span rates (a handful of records per generation
#: plus per-job broker spans) 2048 records cover the last several
#: generations of even a large fleet — enough tail to reconstruct what
#: the run was doing when it died, at <10 MB worst case.
DEFAULT_CAPACITY = 2048

_active: Optional["FlightRecorder"] = None
_hooks_installed = False
_prev_excepthook = None
_prev_sigterm = None


class FlightRecorder:
    """Thread-safe bounded ring of telemetry record dicts."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 path: str = "flight.jsonl"):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.path = path
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._total = 0
        self._t_start = time.time()

    def record(self, rec: Dict[str, Any]) -> None:
        """Append one record (called from spans._emit on every finished
        span/event while the recorder is installed)."""
        with self._lock:
            self._ring.append(rec)
            self._total += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total(self) -> int:
        """Records ever seen (total - len = records the ring dropped)."""
        with self._lock:
            return self._total

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def render_jsonl(self, reason: str = "request") -> str:
        """Header line + one record per line (same schema as
        ``telemetry.jsonl`` minus the summary)."""
        with self._lock:
            records = list(self._ring)
            total = self._total
        head = {
            "type": "flight",
            "reason": reason,
            "t_wall": time.time(),
            "pid": os.getpid(),
            "capacity": self.capacity,
            "recorded": len(records),
            "dropped": total - len(records),
        }
        lines = [json.dumps(head, separators=(",", ":"), default=str)]
        lines.extend(
            json.dumps(r, separators=(",", ":"), default=str) for r in records)
        return "\n".join(lines) + "\n"

    def dump(self, path: Optional[str] = None, reason: str = "request") -> str:
        """Write the ring to ``path`` (default: ctor path).  Returns the
        path written.  Overwrites — the newest dump is the one that
        matters after a crash."""
        out = path or self.path
        data = self.render_jsonl(reason=reason)
        with open(out, "w", encoding="utf-8") as fh:
            fh.write(data)
            fh.flush()
        return out


def active() -> Optional[FlightRecorder]:
    return _active


def enable(path: str = "flight.jsonl",
           capacity: int = DEFAULT_CAPACITY) -> FlightRecorder:
    """Install a flight recorder: enables span collection, routes every
    record through the ring, and arms the SIGTERM/excepthook dumpers.
    Idempotent-ish: a second call replaces the active recorder."""
    global _active
    rec = FlightRecorder(capacity=capacity, path=path)
    _active = rec
    _spans.set_flight_sink(rec)
    _spans.enable()
    _install_hooks()
    return rec


def disable() -> None:
    """Detach the recorder.  Span collection stays enabled only if a run
    sink (RunTelemetry) is still installed — the recorder was the only
    consumer otherwise, so collecting would be pure overhead."""
    global _active
    _active = None
    _spans.set_flight_sink(None)
    if not _spans.has_run_sink():
        _spans.disable()


def _dump_active(reason: str) -> Optional[str]:
    rec = _active
    if rec is None:
        return None
    try:
        return rec.dump(reason=reason)
    except Exception:  # pragma: no cover - a dying process must still die
        return None


def _excepthook(exc_type, exc, tb):
    rec = _active
    if rec is not None:
        rec.record({
            "type": "event",
            "name": "unhandled_exception",
            "t_wall": time.time(),
            "pid": os.getpid(),
            "data": {"exc_type": exc_type.__name__, "exc": str(exc)},
        })
    _dump_active("unhandled_exception")
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def _sigterm_handler(signum, frame):
    _dump_active("sigterm")
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
    else:
        # Restore the default disposition and re-deliver so the process
        # still dies with the conventional SIGTERM exit status.
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _install_hooks() -> None:
    """Chain our dumpers in front of whatever is installed.  Once per
    process; the handlers are no-ops while no recorder is active, so
    disable() doesn't need to unwind them."""
    global _hooks_installed, _prev_excepthook, _prev_sigterm
    if _hooks_installed:
        return
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    try:
        _prev_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _sigterm_handler)
    except ValueError:
        # Not the main thread (e.g. ops server started from a worker
        # thread): excepthook still armed, signal dump unavailable.
        _prev_sigterm = None
    _hooks_installed = True
