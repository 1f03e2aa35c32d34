"""Liveness plane: heartbeat registry, status providers, stall watchdog.

The telemetry plane (registry/spans/export) records *what happened*;
this module answers *"is the search healthy right now?"* for the ops
endpoints (``ops_server.py``).  Three pieces:

- a **heartbeat registry** the long-running loops beat into (master
  engine loop, broker poll loop, worker consume/evaluate loops).  A
  source registered with a ``timeout`` *gates* ``/healthz``: silence
  longer than the timeout flips it to 503.  A source registered without
  one is advisory — shown in ``/statusz``, never a 503.
- **status providers** — named callables (broker fleet snapshot, engine
  progress) polled lazily when ``/statusz`` is scraped.  Registration is
  a dict write; nothing is called until someone asks.
- :class:`StallWatchdog` — flags any dispatched job in flight longer
  than ``max(floor_s, k × rolling-p95(dispatch RTT))``, bumps the
  ``stragglers_detected_total`` counter, emits a ``straggler_detected``
  telemetry event, and (opt-in) invokes a requeue hook.  Flagged jobs
  also gate ``/healthz``.

Same contract as ``spans.py``: **off by default**, and the off path is
one module-level bool read (:func:`beat` returns immediately).  Nothing
here touches RNG state, so enabling the plane cannot perturb a search
trajectory.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import spans as _spans
from .registry import get_registry

__all__ = [
    "enabled",
    "enable",
    "disable",
    "beat",
    "register_source",
    "unregister_source",
    "heartbeats",
    "register_status_provider",
    "unregister_status_provider",
    "register_engine_status",
    "unregister_engine_status",
    "status_snapshot",
    "register_watchdog",
    "unregister_watchdog",
    "check_health",
    "reset",
    "StallWatchdog",
]

# Module-level switch, mirroring spans._ENABLED: one bool read is the
# entire disabled-path cost of every beat() call site.
_ENABLED = False

_lock = threading.Lock()
# name -> [last_beat_monotonic | None, timeout_s | None]
_sources: Dict[str, List[Optional[float]]] = {}
# name -> zero-arg callable returning a JSON-native snapshot
_providers: Dict[str, Callable[[], Any]] = {}
# Watchdogs whose flagged stragglers gate /healthz (brokers register
# theirs on start(), unregister on stop()).
_watchdogs: List["StallWatchdog"] = []
# session -> engine snapshot callable.  A keyed registry instead of the
# last-wins "engine" provider slot: two engines sharing a broker (multi-
# tenant sessions) each get a row in /statusz instead of overwriting
# each other.
_engines: Dict[str, Callable[[], Any]] = {}


def enabled() -> bool:
    """The one guard every beat site checks."""
    return _ENABLED


def enable() -> None:
    """Turn the plane on.  Every known source gets a fresh stamp: beats
    only flow while enabled, so ages accrued before this moment are
    meaningless and must not trip an instant 503."""
    global _ENABLED
    now = time.monotonic()
    with _lock:
        for src in _sources.values():
            src[0] = now
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop every source, provider, and watchdog (tests)."""
    with _lock:
        _sources.clear()
        _providers.clear()
        _engines.clear()
        del _watchdogs[:]


def beat(name: str) -> None:
    """Stamp ``name``'s heartbeat.  No-op (one bool read) when disabled.

    Unknown names auto-register as advisory sources so a loop can beat
    before anyone declared it — gating requires an explicit
    :func:`register_source` with a timeout.
    """
    if not _ENABLED:
        return
    now = time.monotonic()
    with _lock:
        src = _sources.get(name)
        if src is None:
            _sources[name] = [now, None]
        else:
            src[0] = now


def register_source(name: str, timeout: Optional[float] = None) -> None:
    """Declare a heartbeat source.  ``timeout`` seconds of silence flips
    ``/healthz`` to 503; ``timeout=None`` makes it advisory (statusz
    only).  Registration stamps an initial beat so a freshly registered
    source is not instantly stale."""
    now = time.monotonic()
    with _lock:
        _sources[name] = [now, timeout]


def unregister_source(name: str) -> None:
    with _lock:
        _sources.pop(name, None)


def heartbeats() -> Dict[str, Dict[str, Any]]:
    """Per-source {age_s, timeout_s, stale} snapshot."""
    now = time.monotonic()
    with _lock:
        items = {k: (v[0], v[1]) for k, v in _sources.items()}
    out: Dict[str, Dict[str, Any]] = {}
    for name, (last, timeout) in sorted(items.items()):
        age = None if last is None else now - last
        stale = timeout is not None and age is not None and age > timeout
        out[name] = {
            "age_s": None if age is None else round(age, 3),
            "timeout_s": timeout,
            "stale": stale,
        }
    return out


def register_status_provider(name: str, fn: Callable[[], Any]) -> None:
    """Install a named snapshot callable for ``/statusz``.  Last-wins on
    name collision (a re-started broker re-claims "fleet")."""
    with _lock:
        _providers[name] = fn


def unregister_status_provider(name: str, fn: Optional[Callable[[], Any]] = None) -> None:
    """Remove a provider.  With ``fn``, removal is identity-checked so a
    stopped broker cannot evict the provider of the one that replaced it."""
    with _lock:
        if fn is None or _providers.get(name) is fn:
            _providers.pop(name, None)


def register_engine_status(session: str, fn: Callable[[], Any]) -> None:
    """Install an ENGINE snapshot callable, keyed by its search session.

    The old contract — ``register_status_provider("engine", fn)`` — was
    last-wins: two engines sharing a broker (multi-tenant sessions)
    silently overwrote each other and ``/statusz`` showed whichever
    registered second.  Engines now register here instead; the combined
    ``engine`` provider renders ONE engine as the same flat snapshot as
    before (plus a ``session`` key) and several as
    ``{"mode": "multi", "sessions": {session: snapshot}}``.
    """
    with _lock:
        _engines[str(session)] = fn
        _providers["engine"] = _engine_status


def unregister_engine_status(session: str, fn: Optional[Callable[[], Any]] = None) -> None:
    """Remove one engine's snapshot (identity-checked like
    :func:`unregister_status_provider`); the combined provider goes with
    the last engine."""
    with _lock:
        if fn is None or _engines.get(str(session)) is fn:
            _engines.pop(str(session), None)
        if not _engines and _providers.get("engine") is _engine_status:
            _providers.pop("engine", None)


def _engine_status() -> Any:
    """The combined ``engine`` /statusz block over every registered
    engine.  A snapshot callable that raises contributes its error string,
    same contract as :func:`status_snapshot`."""
    with _lock:
        engines = dict(_engines)

    def _snap(fn: Callable[[], Any]) -> Any:
        try:
            return fn()
        except Exception as e:  # pragma: no cover - defensive
            return {"error": f"{type(e).__name__}: {e}"}

    if len(engines) == 1:
        (sid, fn), = engines.items()
        snap = _snap(fn)
        if isinstance(snap, dict):
            snap.setdefault("session", sid)
        return snap
    return {"mode": "multi",
            "sessions": {sid: _snap(fn) for sid, fn in sorted(engines.items())}}


def status_snapshot() -> Dict[str, Any]:
    """Poll every provider; a provider that raises contributes its error
    string instead of taking down the whole statusz page."""
    with _lock:
        providers = dict(_providers)
    out: Dict[str, Any] = {}
    for name, fn in sorted(providers.items()):
        try:
            out[name] = fn()
        except Exception as e:  # pragma: no cover - defensive
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


def register_watchdog(wd: "StallWatchdog") -> None:
    with _lock:
        if wd not in _watchdogs:
            _watchdogs.append(wd)


def unregister_watchdog(wd: "StallWatchdog") -> None:
    with _lock:
        try:
            _watchdogs.remove(wd)
        except ValueError:
            pass


def check_health() -> Tuple[bool, List[str]]:
    """(healthy, reasons).  Unhealthy iff a *gating* heartbeat source is
    stale or any registered watchdog currently flags a straggler.  Both
    conditions self-clear (a beat arrives; the job completes or is
    requeued), so recovery needs no operator action."""
    reasons: List[str] = []
    for name, info in heartbeats().items():
        if info["stale"]:
            reasons.append(
                f"heartbeat '{name}' stale: {info['age_s']}s > {info['timeout_s']}s")
    with _lock:
        dogs = list(_watchdogs)
    for wd in dogs:
        wd.check()  # flag anything newly over threshold before reporting
        for s in wd.stragglers():
            reasons.append(
                "straggler job %s on worker %s: in flight %.1fs > %.1fs threshold"
                % (s["job_id"], s["worker_id"], s["age_s"], s["threshold_s"]))
    return (not reasons), reasons


class StallWatchdog:
    """Flags jobs in flight longer than ``max(floor_s, k × p95(RTT))``.

    The broker feeds it from its loop thread (``job_started`` at
    dispatch, ``job_finished`` at result-accept, ``job_removed`` on
    requeue/cancel/fail) and drives :meth:`check` from a periodic task;
    the healthz handler may call :meth:`check`/:meth:`stragglers` from
    HTTP threads — every method takes the instance lock.

    The RTT window is a bounded deque kept here (not read back out of
    the registry histogram) so the threshold adapts to the live run and
    costs O(window) only on ``check``.  Until ``min_samples`` RTTs have
    been seen the threshold is just ``floor_s`` — early in a run the p95
    of two samples says nothing.

    ``on_straggler`` (opt-in) is called once per newly flagged job with
    the straggler info dict — the broker uses it to requeue
    (``straggler_requeue=True``).  A job is flagged at most once per
    dispatch; finishing or being removed clears the flag (and heals
    ``/healthz``).
    """

    def __init__(self, floor_s: float = 30.0, k: float = 4.0,
                 window: int = 256, min_samples: int = 8,
                 on_straggler: Optional[Callable[[Dict[str, Any]], None]] = None):
        if floor_s <= 0:
            raise ValueError(f"floor_s must be positive, got {floor_s}")
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        self.floor_s = float(floor_s)
        self.k = float(k)
        self.min_samples = int(min_samples)
        self.on_straggler = on_straggler
        self._lock = threading.Lock()
        self._rtts: deque = deque(maxlen=int(window))
        # job_id -> (t0, worker, session | None)
        self._inflight: Dict[str, Tuple[float, str, Optional[str]]] = {}
        self._flagged: Dict[str, Dict[str, Any]] = {}
        self.detected_total = 0

    def job_started(self, job_id: str, worker_id: str,
                    session: Optional[str] = None) -> None:
        """``session`` (multi-tenant brokers) rides into the straggler
        info/event and labels ``stragglers_detected_total``; ``None`` (the
        single-tenant default) keeps the metric series unchanged."""
        with self._lock:
            self._inflight[str(job_id)] = (
                time.monotonic(), str(worker_id),
                None if session is None else str(session))

    def job_finished(self, job_id: str) -> None:
        """Result accepted: record the RTT sample and clear any flag."""
        with self._lock:
            entry = self._inflight.pop(str(job_id), None)
            if entry is not None:
                self._rtts.append(time.monotonic() - entry[0])
            self._flagged.pop(str(job_id), None)

    def job_removed(self, job_id: str) -> None:
        """Requeue/cancel/fail: forget the job WITHOUT taking an RTT
        sample (a requeued job's elapsed time is not a round trip)."""
        with self._lock:
            self._inflight.pop(str(job_id), None)
            self._flagged.pop(str(job_id), None)

    def threshold(self) -> float:
        """Current flagging threshold: ``max(floor_s, k × p95(RTT))``."""
        with self._lock:
            return self._threshold_locked()

    def _threshold_locked(self) -> float:
        n = len(self._rtts)
        if n < self.min_samples:
            return self.floor_s
        ordered = sorted(self._rtts)
        p95 = ordered[min(n - 1, int(0.95 * n))]
        return max(self.floor_s, self.k * p95)

    def check(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Flag every job over threshold that is not already flagged.
        Returns the NEWLY flagged stragglers (possibly empty) after
        bumping ``stragglers_detected_total`` and emitting a
        ``straggler_detected`` telemetry event for each."""
        t = time.monotonic() if now is None else now
        newly: List[Dict[str, Any]] = []
        with self._lock:
            thr = self._threshold_locked()
            for job_id, (t0, worker_id, session) in self._inflight.items():
                age = t - t0
                if age > thr and job_id not in self._flagged:
                    info = {
                        "job_id": job_id,
                        "worker_id": worker_id,
                        "age_s": round(age, 3),
                        "threshold_s": round(thr, 3),
                    }
                    if session is not None:
                        info["session"] = session
                    self._flagged[job_id] = info
                    self.detected_total += 1
                    newly.append(info)
        for info in newly:
            labels = {"worker": info["worker_id"]}
            if "session" in info:
                labels["session"] = info["session"]
            get_registry().counter("stragglers_detected_total", **labels).inc()
            _spans.record_event("straggler_detected", dict(info))
            if self.on_straggler is not None:
                try:
                    self.on_straggler(dict(info))
                except Exception:  # pragma: no cover - hook must not kill check
                    pass
        return newly

    def stragglers(self) -> List[Dict[str, Any]]:
        """Currently flagged jobs, ages refreshed."""
        now = time.monotonic()
        with self._lock:
            out = []
            for job_id, info in self._flagged.items():
                entry = self._inflight.get(job_id)
                d = dict(info)
                if entry is not None:
                    d["age_s"] = round(now - entry[0], 3)
                out.append(d)
            return out

    def in_flight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def clear(self) -> None:
        with self._lock:
            self._inflight.clear()
            self._flagged.clear()
            self._rtts.clear()
