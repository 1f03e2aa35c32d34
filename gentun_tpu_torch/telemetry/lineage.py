"""Search forensics: per-genome lineage ledger + chip-hour cost accounting.

Two planes in one module, both off by default behind the same contract as
``spans.py`` (one module-level bool read per site, nothing touches RNG
state, bit-identical trajectories when off — docs/OBSERVABILITY.md
"Search forensics"):

- the **lineage ledger** — an event-sourced record of every genome's life:
  :func:`record` emits ``{"type": "lineage", "event": ..., "genome": ...}``
  records through the standard span sinks (flight ring, worker capture
  list, run JSONL), so a run's ``telemetry.jsonl`` doubles as the ledger.
  Event taxonomy (emitters in parentheses):

  ========================  ====================================================
  ``born``                  genome created — ``parents`` (genome keys),
                            ``op`` (``spawn``/``reproduce``) and ``genes``
                            (the genome itself, so the ledger doubles as a
                            surrogate training set — ``gentun_trace.py
                            dataset``) (both engines, populations)
  ``gate_rejected``         bred child vetoed by the surrogate rung −1
                            before dispatch — ``score`` (async engine,
                            ``surrogate.py``)
  ``dispatched``            job handed to a worker at a rung (broker)
  ``completed``             fitness landed — ``fitness``, ``rung``, ``cached``
                            (async engine)
  ``failed``                terminal evaluation failure (async engine)
  ``cache_hit``             fitness served without training — ``source`` is
                            ``local`` or ``service`` (async engine,
                            ``ServiceBackedCache``)
  ``follower_attach``       duplicate submission attached to an in-flight
                            evaluation instead of dispatching (async engine)
  ``promoted``              ASHA rung promotion — ``from_rung``, ``to_rung``
                            (fidelity ladder)
  ``evicted``               aged out of the steady-state ring (async engine)
  ``quarantined``           poisoned for a session after repeated terminal
                            failures (sessions)
  ``requeued``              dispatched job returned to the queue (worker loss,
                            drain, straggler speculation, transient failure)
                            (broker)
  ``warm_started``          slot inherited banked lower-rung weights
                            (``models/cnn`` weight bank)
  ========================  ====================================================

- the **cost ledger** (:class:`CostLedger`) — every device-second measured
  by per-genome ``device`` spans attributed to a
  ``(session, genome, rung, worker)`` cell, with by-rung/by-session/
  by-worker rollups, a ``device_seconds_total{rung}`` counter, and a
  ``cost`` status provider on ``/statusz``.  Workers emit the device spans
  inside their capture sink (:func:`emit_device`), ship them home in the
  result frame, and the broker attributes them on ingest
  (:func:`observe_records`); local (no-broker) evaluation attributes
  directly.  Both paths bill the same spans, never both.

The forensics plane rides the telemetry plane: :func:`enable` requires
``spans.enable()`` (or a ``RunTelemetry`` install) for the records to
land anywhere, and the master advertises forensics to workers by stamping
``fz: 1`` into the propagated trace context so the per-job device spans
are only produced when someone is accounting for them.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import health as _health
from . import spans as _spans
from .registry import get_registry

__all__ = [
    "enabled",
    "enable",
    "disable",
    "record",
    "genome_key",
    "CostLedger",
    "get_ledger",
    "reset_ledger",
    "emit_device",
    "observe_records",
    "forensic_context",
    "wants_device_spans",
]

# Module-level switch, mirroring spans._ENABLED: one bool read is the
# entire disabled-path cost of every lineage site.
_ENABLED = False

# genome_key runs once per submitted job on the broker's dispatch path; a
# shared encoder instance skips the per-call JSONEncoder construction that
# custom separators force on json.dumps.  Byte-identical output, so the
# hash — the identity everything keys on — is unchanged.
_canon_encode = json.JSONEncoder(sort_keys=True, separators=(",", ":")).encode


def enabled() -> bool:
    """The one guard every lineage/cost site checks."""
    return _ENABLED


def enable() -> None:
    """Turn the forensics plane on and expose the cost ledger on
    ``/statusz`` (provider name ``cost``)."""
    global _ENABLED
    _ENABLED = True
    _health.register_status_provider("cost", _cost_status)


def disable() -> None:
    global _ENABLED
    _ENABLED = False
    _health.unregister_status_provider("cost", _cost_status)


def genome_key(genes: Any) -> str:
    """Content address for a genome — the identity every lineage event and
    cost cell keys on.

    64-bit blake2b over the canonical (sorted-key) JSON of the genes, the
    same hash family and width as ``utils/fitness_store.key_digest``.
    Genes that don't survive JSON fall back to ``repr`` so the identity
    still sticks to the exact value.  (Canonical home of the hash the
    session quarantine table re-exports as ``sessions.genome_key``.)
    """
    try:
        blob = _canon_encode(genes)
    except (TypeError, ValueError):
        blob = repr(genes)
    return hashlib.blake2b(blob.encode("utf-8"), digest_size=8).hexdigest()


def record(event: str, genome: Optional[str], **fields: Any) -> None:
    """Emit one lineage ledger entry.  No-op (one bool read) when the
    plane is off.  ``fields`` with value None are dropped so optional
    dimensions (session, worker) never pad the JSONL."""
    if not _ENABLED:
        return
    rec: Dict[str, Any] = {
        "type": "lineage",
        "event": event,
        "genome": genome,
        "t_wall": time.time(),
        "pid": os.getpid(),
    }
    for k, v in fields.items():
        if v is not None:
            rec[k] = v
    _spans.emit_record(rec)


# -- chip-hour cost accounting ---------------------------------------------


class CostLedger:
    """Device-seconds attributed to ``(session, genome, rung, worker)``.

    Fed by :func:`emit_device` (local evaluation) and
    :func:`observe_records` (worker-shipped device spans, attributed
    broker-side).  Written from broker-loop and evaluation threads, read
    as snapshots from HTTP/status threads — every method takes the lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # (session, genome, rung, worker) -> seconds
        self._cells: Dict[tuple, float] = {}

    def add(self, seconds: float, session: Optional[str] = None,
            genome: Optional[str] = None, rung: Any = 0,
            worker: Optional[str] = None) -> None:
        key = (str(session) if session else "default",
               str(genome) if genome else "?",
               int(rung or 0),
               str(worker) if worker else "local")
        s = float(seconds)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + s
        get_registry().counter("device_seconds_total", rung=str(key[2])).inc(s)

    def _rollup(self, idx: int) -> Dict[Any, float]:
        with self._lock:
            out: Dict[Any, float] = {}
            for key, s in self._cells.items():
                out[key[idx]] = out.get(key[idx], 0.0) + s
            return out

    def by_session(self) -> Dict[str, float]:
        return self._rollup(0)

    def by_genome(self) -> Dict[str, float]:
        return self._rollup(1)

    def by_rung(self) -> Dict[int, float]:
        return self._rollup(2)

    def by_worker(self) -> Dict[str, float]:
        return self._rollup(3)

    def total(self) -> float:
        with self._lock:
            return sum(self._cells.values())

    def cells(self) -> List[Dict[str, Any]]:
        """Every attribution cell as a JSON-native row (artifacts)."""
        with self._lock:
            items = sorted(self._cells.items())
        return [{"session": k[0], "genome": k[1], "rung": k[2],
                 "worker": k[3], "device_s": v} for k, v in items]

    def snapshot(self) -> Dict[str, Any]:
        """The ``/statusz`` ``cost`` block: totals and rollups, never the
        (unbounded) per-genome cells."""
        with self._lock:
            n_genomes = len({k[1] for k in self._cells})
        return {
            "device_s_total": round(self.total(), 6),
            "by_rung": {str(k): round(v, 6)
                        for k, v in sorted(self.by_rung().items())},
            "by_session": {k: round(v, 6)
                           for k, v in sorted(self.by_session().items())},
            "by_worker": {k: round(v, 6)
                          for k, v in sorted(self.by_worker().items())},
            "genomes": n_genomes,
        }

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()


_LEDGER = CostLedger()


def get_ledger() -> CostLedger:
    """The process-wide cost ledger."""
    return _LEDGER


def reset_ledger() -> None:
    """Drop every attribution cell (tests, fresh studies)."""
    _LEDGER.reset()


def _cost_status() -> Dict[str, Any]:
    return _LEDGER.snapshot()


def emit_device(dur_s: float, genome: Optional[str], rung: Any = 0,
                session: Optional[str] = None, worker: Optional[str] = None,
                job: Optional[str] = None,
                start_monotonic: Optional[float] = None) -> None:
    """Emit one per-genome ``device`` span record and attribute it.

    Inside a worker's capture sink the record ships home in the result
    frame and the broker attributes it (:func:`observe_records`); outside
    one (local evaluation on the master) the ledger is charged directly.
    Exactly one of the two paths bills each span.

    Unlike :func:`record` this does NOT check :func:`enabled` — the
    caller guards (locally with :func:`enabled`, or worker-side with
    :func:`wants_device_spans`, where the MASTER's plane is the one that
    is on).
    """
    attrs: Dict[str, Any] = {"genome": genome, "rung": int(rung or 0)}
    if session is not None:
        attrs["session"] = session
    if worker is not None:
        attrs["worker"] = worker
    if job is not None:
        attrs["job"] = job
    t0 = time.monotonic() - dur_s if start_monotonic is None else start_monotonic
    shipped = _spans.capturing()
    _spans.record_span("device", t0, dur_s, attrs=attrs)
    if not shipped:
        _LEDGER.add(dur_s, session=session, genome=genome, rung=rung,
                    worker=worker)


def observe_records(records, worker: Optional[str] = None) -> None:
    """Attribute the ``device`` spans of a worker's shipped record list to
    the cost ledger (called broker-side at result ingest, AFTER the
    duplicate-result guard, so redelivered frames never double-bill)."""
    if not _ENABLED or not records:
        return
    for rec in records:
        if (isinstance(rec, dict) and rec.get("type") == "span"
                and rec.get("kind") == "device"):
            a = rec.get("attrs") or {}
            _LEDGER.add(rec.get("dur_s", 0.0), session=a.get("session"),
                        genome=a.get("genome"), rung=a.get("rung", 0),
                        worker=a.get("worker") or worker)


# -- cross-process advertisement -------------------------------------------
#
# Workers must not pay per-job span emission for a master nobody is
# accounting: the master stamps `fz: 1` into the trace context it already
# propagates (protocol-transparent — old workers ignore the key, old
# masters never send it), and the worker checks it before emitting.


def forensic_context(ctx: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Stamp the forensics flag into a wire trace context when the plane
    is on.  Returns ``ctx`` unchanged (possibly None) when off — the wire
    stays byte-identical to a forensics-less run."""
    if _ENABLED and ctx is not None:
        ctx = dict(ctx)
        ctx["fz"] = 1
    return ctx


def wants_device_spans(ctx: Optional[Dict[str, Any]]) -> bool:
    """Worker-side check: did the master ask for per-job device spans?"""
    return bool(ctx and ctx.get("fz"))
