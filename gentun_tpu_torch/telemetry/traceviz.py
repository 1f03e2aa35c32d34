"""Offline converter: run ``telemetry.jsonl`` → Chrome ``trace_event`` JSON.

The run artifact (``export.RunTelemetry``) already contains everything a
timeline needs — master spans, broker spans, every worker's shipped spans
(tagged ``src`` by the worker), per-genome ``device`` spans, and lineage
ledger entries — but as flat JSONL.  :func:`to_trace_events` reshapes it
into the `Chrome trace_event format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
(the ``{"traceEvents": [...]}`` object form), loadable in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``:

- one **process track per emitting process**: ``master`` (the search
  engine), ``broker`` (dispatch/queue spans), and one per worker ``src``.
  The pids are synthetic and stable: master=1, broker=2, workers from 3 in
  sorted-name order — in-process fleets share one OS pid, so the OS pid on
  the records cannot be the track key.
- one **thread track per span kind** within a process, except ``device``
  spans, which land on a per-rung track (tid ``1000 + rung``) so the
  chip-hour attribution reads directly off the timeline.
- **flow arrows** stitching each propagated trace (``trace_id``) across
  processes: dispatch on the broker → evaluate on the worker → result
  ingest, drawn start-to-finish in span start order.  Flow ``id`` is the
  chain's first span's ``span_id`` (span ids are unique, so flows never
  collide).
- **instant events** for the lineage ledger (``born``, ``promoted``,
  ``evicted``, …) and structured events (fault injections) on the track of
  the process that emitted them.

Timestamps are wall-clock microseconds normalized so the earliest record
sits at ts=0 — Perfetto needs non-negative, same-epoch stamps, and the
JSONL's ``t_wall`` (span START wall time) provides exactly that.

Offline and stdlib-only by design: nothing here runs during a search, so
a forensics pass costs the search nothing.  CLI: ``scripts/gentun_trace.py
convert run/telemetry.jsonl trace.json``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["load_jsonl", "to_trace_events", "convert"]

#: span kinds emitted by the broker loop (no ``src`` on the record, but
#: they are dispatch-plane time, not engine time)
BROKER_KINDS = frozenset({"queue_wait", "job", "dispatch_rtt"})

#: tid offset for per-rung device tracks (rung r → tid 1000+r)
DEVICE_TID_BASE = 1000

_MASTER_PID = 1
_BROKER_PID = 2
_FIRST_WORKER_PID = 3

#: instant/metadata records that carry a wall stamp worth normalizing on
_TIMED_TYPES = frozenset({"span", "event", "lineage"})


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read one run artifact (or lineage ledger) — one JSON object per
    line, bad lines skipped (a crashed run may truncate the tail)."""
    records: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def _process_key(rec: Dict[str, Any]) -> str:
    """Which track a record belongs to: the worker that shipped it, the
    broker for dispatch-plane kinds, the master otherwise."""
    src = rec.get("src")
    if src is not None:
        return str(src)
    if rec.get("type") == "span" and rec.get("kind") in BROKER_KINDS:
        return "broker"
    return "master"


def _pid_map(records: Iterable[Dict[str, Any]]) -> Dict[str, int]:
    """Stable synthetic pids: master=1, broker=2, workers from 3 in
    sorted order — same input, same mapping, every time."""
    keys = {_process_key(rec) for rec in records}
    pids = {}
    if "master" in keys:
        pids["master"] = _MASTER_PID
    if "broker" in keys:
        pids["broker"] = _BROKER_PID
    workers = sorted(k for k in keys if k not in ("master", "broker"))
    for i, k in enumerate(workers):
        pids[k] = _FIRST_WORKER_PID + i
    return pids


def _t0_wall(records: Iterable[Dict[str, Any]]) -> float:
    stamps = [rec["t_wall"] for rec in records
              if rec.get("type") in _TIMED_TYPES
              and isinstance(rec.get("t_wall"), (int, float))]
    return min(stamps) if stamps else 0.0


def _us(t_wall: float, t0: float) -> int:
    return max(0, int(round((t_wall - t0) * 1e6)))


def to_trace_events(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Convert loaded JSONL records to a trace_event object.

    Returns ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` —
    ``json.dump`` it to a file and load that file in Perfetto.
    """
    pids = _pid_map(records)
    t0 = _t0_wall(records)
    events: List[Dict[str, Any]] = []

    # Metadata: name every process track.
    for name, pid in sorted(pids.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": name}})

    # Thread tracks: one per (process, span kind), allocated in first-seen
    # deterministic order; device spans get per-rung tracks instead.
    tids: Dict[Tuple[int, str], int] = {}
    next_tid: Dict[int, int] = {}
    device_rungs: set = set()

    def _tid(pid: int, kind: str) -> int:
        key = (pid, kind)
        if key not in tids:
            next_tid[pid] = next_tid.get(pid, 0) + 1
            tids[key] = next_tid[pid]
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tids[key], "args": {"name": kind}})
        return tids[key]

    # trace_id → [(ts_us, pid, tid, span_id)] for the flow pass.
    chains: Dict[str, List[Tuple[int, int, int, str]]] = {}

    for rec in records:
        rtype = rec.get("type")
        if rtype == "span":
            kind = str(rec.get("kind"))
            pid = pids[_process_key(rec)]
            attrs = rec.get("attrs") or {}
            if kind == "device":
                rung = int(attrs.get("rung", 0) or 0)
                tid = DEVICE_TID_BASE + rung
                if (pid, rung) not in device_rungs:
                    device_rungs.add((pid, rung))
                    events.append({
                        "ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": f"device rung {rung}"}})
            else:
                tid = _tid(pid, kind)
            ts = _us(rec.get("t_wall", t0), t0)
            args: Dict[str, Any] = dict(attrs)
            for k in ("trace_id", "span_id", "error"):
                if rec.get(k) is not None:
                    args[k] = rec[k]
            events.append({
                "ph": "X", "name": kind, "cat": "span",
                "pid": pid, "tid": tid, "ts": ts,
                "dur": max(0, int(round(float(rec.get("dur_s", 0.0)) * 1e6))),
                "args": args,
            })
            trace_id = rec.get("trace_id")
            span_id = rec.get("span_id")
            if trace_id and span_id:
                chains.setdefault(str(trace_id), []).append(
                    (ts, pid, tid, str(span_id)))
        elif rtype == "lineage":
            pid = pids[_process_key(rec)]
            tid = _tid(pid, "lineage")
            args = {k: v for k, v in rec.items()
                    if k not in ("type", "t_wall", "pid")}
            events.append({
                "ph": "i", "s": "t", "name": str(rec.get("event")),
                "cat": "lineage", "pid": pid, "tid": tid,
                "ts": _us(rec.get("t_wall", t0), t0), "args": args,
            })
        elif rtype == "event":
            pid = pids[_process_key(rec)]
            tid = _tid(pid, "events")
            args = {k: v for k, v in rec.items()
                    if k not in ("type", "t_wall", "pid")}
            events.append({
                "ph": "i", "s": "t", "name": str(rec.get("name")),
                "cat": "event", "pid": pid, "tid": tid,
                "ts": _us(rec.get("t_wall", t0), t0), "args": args,
            })

    # Flow arrows: a propagated trace that touched more than one process
    # becomes a start→(step…)→finish chain in span start order.  Flow id =
    # the chain's first span_id, so ids are unique across flows and every
    # flow id IS a span id (the forensics tests key on that).
    for trace_id, chain in sorted(chains.items()):
        if len({pid for _, pid, _, _ in chain}) < 2:
            continue
        chain.sort()
        flow_id = chain[0][3]
        for i, (ts, pid, tid, _sid) in enumerate(chain):
            ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
            ev = {"ph": ph, "id": flow_id, "name": "dispatch",
                  "cat": "flow", "pid": pid, "tid": tid, "ts": ts}
            if ph == "f":
                ev["bp"] = "e"
            events.append(ev)

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def convert(in_path: str, out_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a run's JSONL and write the Perfetto-loadable trace JSON.
    Returns the trace object (also when ``out_path`` is None)."""
    trace = to_trace_events(load_jsonl(in_path))
    if out_path is not None:
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(trace, fh, separators=(",", ":"))
    return trace
