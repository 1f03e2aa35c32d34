"""Span-based tracing with cross-process trace propagation.

A *span* is a named, monotonic-clock-timed interval with a
``trace_id``/``span_id``/``parent_id`` identity.  The GA master opens a
``generation`` span; the trace context it creates rides the job payload
over the wire (``distributed/protocol.py``), the worker re-attaches it
(:func:`attach`), and the worker's ``train``/``eval`` spans come back in
the ``result`` frame carrying the *same* ``trace_id`` — so one run is one
trace, stitched across processes.

Disabled is the default and the fast path: every instrumentation site
guards on :func:`enabled` (one global bool read) and :func:`span` returns
a shared no-op singleton — no dict, no object, no contextvar churn.  The
production code paths are byte-identical in behaviour when telemetry is
off; nothing here touches RNG state either way.

Routing: finished span records go to the innermost active sink —
a :func:`capture` list (used by workers to ship spans home in the result
frame) if one is installed in the current context, else the process-wide
run sink (``export.RunTelemetry``).  Span durations are additionally
observed into the ``span_seconds{kind=...}`` histogram of the global
metrics registry.

Profiler ranges: a tracing module may install a range hook
(:func:`set_range_hook`, ``utils/profiling.py`` does so for
``torch.profiler``).  While spans are enabled, each span opens
``hook(kind)``, when it returns a context manager, just after its clocks
start and closes it just before they stop, so the span shows in a profile
as a range of its own, inside the span's times.  This module itself
imports no torch.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .registry import get_registry

__all__ = [
    "enabled",
    "enable",
    "disable",
    "span",
    "record_span",
    "record_event",
    "current_context",
    "attach",
    "capture",
    "capturing",
    "emit_record",
    "set_run_sink",
    "has_run_sink",
    "set_flight_sink",
    "has_flight_sink",
    "set_range_hook",
]

# Module-level switch.  A plain bool read is the entire disabled-path cost
# at every instrumentation site.
_ENABLED = False

# (trace_id, span_id) of the innermost live span in this context.
_CTX: contextvars.ContextVar[Optional[Tuple[str, str]]] = contextvars.ContextVar(
    "gentun_tpu_torch_trace", default=None)

# Innermost capture list, if any (worker-side shipping).  Falls back to
# the process-wide run sink below.
_CAPTURE: contextvars.ContextVar[Optional[List[Dict[str, Any]]]] = contextvars.ContextVar(
    "gentun_tpu_torch_capture", default=None)

# The active RunTelemetry (export.py installs/uninstalls it).  Guarded by
# a lock only on mutation; the read is a plain attribute load.
_run_sink = None
_sink_lock = threading.Lock()

# The active flight recorder ring (telemetry/flight.py), fed a copy of
# EVERY record regardless of capture/run-sink routing — the black box
# must see worker-side captured spans too.  One attribute load when off.
_flight_sink = None

# ``kind -> context manager or None``: the profiler range a span opens
# (set_range_hook).  One attribute load a span when none is installed.
_range_hook = None


def enabled() -> bool:
    """The one guard every instrumentation site checks."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def set_run_sink(sink) -> None:
    """Install (or clear, with None) the process-wide record sink.  The
    sink needs one method: ``record(dict)`` (thread-safe)."""
    global _run_sink
    with _sink_lock:
        _run_sink = sink


def has_run_sink() -> bool:
    return _run_sink is not None


def has_flight_sink() -> bool:
    return _flight_sink is not None


def set_flight_sink(sink) -> None:
    """Install (or clear) the flight-recorder ring.  Managed by
    ``telemetry/flight.py``; unlike the run sink it is NOT bypassed by
    :class:`capture` — the ring sees every record this process emits."""
    global _flight_sink
    with _sink_lock:
        _flight_sink = sink


def set_range_hook(hook) -> None:
    """Install (or clear, with None) the hook an enabled span calls with its
    kind on entry; a context manager it returns is entered there and exited
    when the span ends."""
    global _range_hook
    _range_hook = hook


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def _emit(rec: Dict[str, Any], dur_kind: Optional[Tuple[float, str]] = None) -> None:
    """Route a record to the innermost capture list or the run sink.

    ``dur_kind`` carries (duration, kind) for span records; the
    ``span_seconds`` histogram is observed here ONLY when the record goes
    to a sink directly — captured records are observed at :func:`ingest`
    on the master instead, so in-process workers (which share this
    registry) don't double-count.
    """
    fl = _flight_sink
    if fl is not None:
        fl.record(rec)
    cap = _CAPTURE.get()
    if cap is not None:
        cap.append(rec)
        return
    if dur_kind is not None:
        _observe_span_seconds(dur_kind[1], dur_kind[0], rec)
    sink = _run_sink
    if sink is not None:
        sink.record(rec)


def _observe_span_seconds(kind: str, dur: float, rec: Dict[str, Any]) -> None:
    """Observe a span duration, adding a ``session`` label only when the
    span carries one (multi-tenant runs) — single-tenant series keep their
    pre-session label set, same pattern as the straggler counters."""
    attrs = rec.get("attrs")
    sess = attrs.get("session") if attrs else None
    if sess is None:
        get_registry().histogram("span_seconds", kind=kind).observe(dur)
    else:
        get_registry().histogram("span_seconds", kind=kind, session=str(sess)).observe(dur)


class _NoopSpan:
    """Shared do-nothing context manager: the disabled-path return value
    of :func:`span`.  A singleton — ``span(...) is span(...)`` when
    disabled, which the tests assert as the no-allocation guarantee."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("kind", "attrs", "trace_id", "span_id", "parent_id",
                 "_token", "_t0", "_wall0", "_range")

    def __init__(self, kind: str, attrs: Optional[Dict[str, Any]]):
        self.kind = kind
        self.attrs = dict(attrs) if attrs else {}
        parent = _CTX.get()
        if parent is None:
            self.trace_id = _new_id()
            self.parent_id = None
        else:
            self.trace_id, self.parent_id = parent
        self.span_id = _new_id()
        self._token = None
        self._t0 = 0.0
        self._wall0 = 0.0
        self._range = None

    def set(self, **attrs: Any) -> None:
        """Attach attributes after entry (e.g. a result count)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self._token = _CTX.set((self.trace_id, self.span_id))
        self._wall0 = time.time()
        self._t0 = time.monotonic()
        hook = _range_hook
        if hook is not None:
            self._range = hook(self.kind)
            if self._range is not None:
                self._range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        dur = time.monotonic() - self._t0
        _CTX.reset(self._token)
        rec = {
            "type": "span",
            "kind": self.kind,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_wall": self._wall0,
            "dur_s": dur,
            "pid": os.getpid(),
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        _emit(rec, dur_kind=(dur, self.kind))
        return False


def span(kind: str, attrs: Optional[Dict[str, Any]] = None):
    """Open a span context manager; the no-op singleton when disabled.

    ``attrs`` is an optional dict parameter rather than ``**kwargs`` so
    the disabled path allocates nothing at the call site.
    """
    if not _ENABLED:
        return _NOOP
    return _Span(kind, attrs)


def record_span(kind: str, start_monotonic: float, dur_s: float,
                trace: Optional[Dict[str, str]] = None,
                attrs: Optional[Dict[str, Any]] = None) -> None:
    """Record a span measured externally (the broker times queue-wait with
    raw monotonic stamps because submit and dispatch happen in different
    callbacks — there is no ``with`` block to wrap)."""
    if not _ENABLED:
        return
    if trace:
        trace_id = trace.get("trace_id") or _new_id()
        parent_id = trace.get("span_id")
    else:
        ctx = _CTX.get()
        trace_id, parent_id = (ctx if ctx else (_new_id(), None))
    rec = {
        "type": "span",
        "kind": kind,
        "trace_id": trace_id,
        "span_id": _new_id(),
        "parent_id": parent_id,
        "t_wall": time.time() - (time.monotonic() - start_monotonic),
        "dur_s": dur_s,
        "pid": os.getpid(),
    }
    if attrs:
        rec["attrs"] = attrs
    _emit(rec, dur_kind=(dur_s, kind))


def record_event(name: str, data: Optional[Dict[str, Any]] = None) -> None:
    """Record a point-in-time structured event (fault injections)."""
    if not _ENABLED:
        return
    ctx = _CTX.get()
    rec: Dict[str, Any] = {
        "type": "event",
        "name": name,
        "t_wall": time.time(),
        "pid": os.getpid(),
    }
    if ctx is not None:
        rec["trace_id"], rec["parent_id"] = ctx
    if data:
        rec["data"] = data
    _emit(rec)


def current_context() -> Optional[Dict[str, str]]:
    """The wire form of the innermost span identity — what the master
    injects into job payloads.  None when no span is live (or disabled)."""
    if not _ENABLED:
        return None
    ctx = _CTX.get()
    if ctx is None:
        return None
    return {"trace_id": ctx[0], "span_id": ctx[1]}


def capturing() -> bool:
    """Whether a :class:`capture` sink is active in this context — i.e.
    records emitted here will be shipped to (and accounted by) a remote
    master rather than landing locally.  The lineage cost ledger uses
    this to avoid double-counting in-process workers."""
    return _CAPTURE.get() is not None


def emit_record(rec: Dict[str, Any]) -> None:
    """Route an externally built record (a lineage ledger entry) through
    the standard sinks — flight ring, innermost capture list, else the
    run sink — with no histogram side effects.  Callers guard on
    :func:`enabled`; this is the raw-routing twin of :func:`record_event`
    for records whose schema the caller owns."""
    _emit(rec)


class attach:
    """Adopt a remote trace context so local spans parent under it.

    Worker-side: ``with attach(job.get("trace")): ...`` makes every span
    opened inside carry the master's ``trace_id`` with the master-side
    span as parent.  A None/empty context is a no-op (jobs from a
    telemetry-disabled master)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[Dict[str, str]]):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        if self._ctx and self._ctx.get("trace_id"):
            self._token = _CTX.set(
                (self._ctx["trace_id"], self._ctx.get("span_id") or _new_id()))
        return self

    def __exit__(self, *exc):
        if self._token is not None:
            _CTX.reset(self._token)
        return False


class capture:
    """Divert span/event records in this context into a list instead of
    the run sink — how a worker collects the spans it ships back in the
    ``result`` frame (and how in-process workers avoid double-writing the
    master's artifact)."""

    __slots__ = ("records", "_token")

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._token = None

    def __enter__(self) -> List[Dict[str, Any]]:
        self._token = _CAPTURE.set(self.records)
        return self.records

    def __exit__(self, *exc):
        _CAPTURE.reset(self._token)
        return False


def ingest(records) -> None:
    """Feed externally produced span records (a worker's shipped list)
    into the active sink, re-observing their durations locally so the
    master's histograms cover worker time too."""
    if not _ENABLED or not records:
        return
    for rec in records:
        if not isinstance(rec, dict):
            continue
        if rec.get("type") == "span" and "dur_s" in rec and "kind" in rec:
            _observe_span_seconds(rec["kind"], rec["dur_s"], rec)
        _emit(rec)


# Subprocess workers opt in via environment: the master can't reach into
# their interpreter, so `GENTUN_TPU_TELEMETRY=1` (or the worker CLI's
# --telemetry flag) enables collection there.
if os.environ.get("GENTUN_TPU_TELEMETRY", "").lower() in ("1", "true", "on"):
    enable()
