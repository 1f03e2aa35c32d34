"""Crash-safe dispatch journal: the broker's write-ahead record of truth.

Crash safety makes :class:`~.broker.JobBroker` restartable without losing a
search.  Nearly all dispatch state was already re-derivable — checkpoint
schema v4 holds the population, the lineage ledger holds genome history,
and the wire fast path's ``JobWire`` payloads are deterministic re-encodes — but the
broker's *routing* state (which sessions exist, which jobs are open,
which were dispatched and to whom, which results are parked undelivered)
lived only in the loop thread's dicts.  This module persists exactly that
state as an append-only JSONL journal with a periodic compacted snapshot,
so ``JobBroker(journal_path=...)`` replays to the pre-crash dispatch
picture and requeues every in-flight job through the existing
at-least-once path.

Design constraints, in order:

1. **Hot-path cost ≤ 2% of per-job dispatch cost** (gated by
   ``scripts/broker_throughput.py::run_journal_gate``).  The per-dispatch
   record is a pre-formatted ``%``-string append onto an in-memory list —
   no dict build, no ``json.dumps`` — and fsync is *batched*: a periodic
   flusher (the broker loop's journal task) does one
   ``writelines+flush+fsync`` per interval, never per record.  A large
   buffer triggers an inline non-fsync drain purely to bound memory.
2. **Torn tails must never poison replay.**  A crash (or the
   ``journal_io_error`` fault) can leave a partial final line.  Replay
   discards a torn LAST record loudly (log + ``journal_torn_tail_total``)
   and keeps everything before it; a corrupt record anywhere *else* in
   the file raises :class:`JournalCorruptError` — that is real damage,
   not a crash artifact, and silently skipping it could resurrect a
   completed job.
3. **Newer schemas are refused loudly** (:data:`JOURNAL_SCHEMA` fence):
   an old broker replaying a newer journal raises
   :class:`JournalSchemaError` instead of guessing at records it does not
   understand.

Record grammar (one JSON object per line, single-char ``t`` type tag)::

    meta {schema, boot, epoch}      first record of every broker boot
    so   {sid, w, q, r}             session open/attach (weight, quota, remote)
    sc   {sid}                      session closed
    sub  {j, sid, gk, p}            job submitted (full payload: re-warms the
                                    fragment cache + rebuilds exact wire bytes)
    d    {j}                        job dispatched to a worker (hot path)
    c    {j, f, pk}                 job completed (fitness; pk=1 if the result
                                    was parked in the session's undelivered
                                    queue rather than delivered)
    fl   {sid}                      a re-attached owner drained the session's
                                    undelivered queue (clears parked results)
    x    {j, r}                     job terminally failed
    q    {j}                        job requeued (informational — replay
                                    treats any sub without c/x as open)
    cx   {js}                       jobs cancelled (list)
    g    {sid, gk}                  genome quarantined for a session

Replay folds ``snapshot ∘ tail``: the compacted snapshot (written
atomically to ``<path>.snap`` via tmp+rename) captures the folded state
at compaction time; the journal is then truncated and re-seeded with a
fresh ``meta``.  Compaction replays the journal's *own* file offline —
there is no second live mirror of broker state to keep consistent.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry.registry import get_registry as _get_registry

__all__ = [
    "JOURNAL_SCHEMA",
    "JournalError",
    "JournalCorruptError",
    "JournalSchemaError",
    "ReplayState",
    "DispatchJournal",
    "replay_file",
]

logger = logging.getLogger("gentun_tpu_torch.distributed")

#: Journal format version.  Bump on any record-grammar change; replay
#: refuses schemas NEWER than this loudly (fence), and accepts older ones
#: (all fields are optional-with-defaults, the protocol.py convention).
JOURNAL_SCHEMA = 1

#: Record types, for the ``journal_records_total{type}`` counter family.
RECORD_TYPES = ("meta", "so", "sc", "sub", "d", "c", "fl", "x", "q", "cx", "g")

#: Ids safe to splice into a hand-built record verbatim.  Broker-minted
#: ids (uuid hex) always match; anything else — job/session ids are
#: caller- and wire-provided arbitrary strings — takes the ``json.dumps``
#: path below so a quote, backslash, or newline can never tear a journal
#: line (or forge extra records).
_PLAIN_ID = re.compile(r"[A-Za-z0-9_.\-]*\Z").match


def _jid(s: str) -> str:
    """JSON-quote an id for a hand-built record (see :data:`_PLAIN_ID`)."""
    return '"%s"' % s if _PLAIN_ID(s) else json.dumps(s)


def _jfloat(f: float) -> str:
    """JSON-format a fitness.  ``repr`` of a non-finite float is bare
    ``nan``/``inf``, which ``json.loads`` rejects — so non-finite values
    are journaled as quoted strings and restored to float on replay."""
    return repr(f) if math.isfinite(f) else '"%s"' % repr(f)


def _unjfloat(f: Any) -> Any:
    """Inverse of :func:`_jfloat` for replayed ``c`` records."""
    return float(f) if isinstance(f, str) else f


class JournalError(RuntimeError):
    """Base class for journal replay failures."""


class JournalCorruptError(JournalError):
    """A record *before* the final line failed to parse — real corruption,
    not a crash-torn tail.  Replay refuses to guess."""


class JournalSchemaError(JournalError):
    """The journal (or snapshot) was written by a NEWER broker than this
    one.  Refused loudly: silently replaying records this version does not
    understand could drop or resurrect jobs."""


class ReplayState:
    """The folded journal: everything a restarted broker needs to re-adopt
    its pre-crash dispatch state.

    ``sessions`` maps sid -> ``{w, q, r, closed, quarantine, parked}``
    (weight, max_in_flight, remote flag, closed flag, quarantined genome
    keys, parked undelivered result frames).  ``jobs`` maps open job_id ->
    ``{sid, gk, p, d}`` (session, genome key, full payload, dispatched
    flag).  Every open job is *suspect* after a crash — the broker
    requeues all of them through the at-least-once path regardless of the
    dispatched flag (the flag only feeds the requeued-vs-queued books).
    """

    __slots__ = ("schema", "boot_id", "epoch", "sessions", "jobs",
                 "records", "torn_tail")

    def __init__(self) -> None:
        self.schema = JOURNAL_SCHEMA
        self.boot_id: Optional[str] = None
        self.epoch = 0
        self.sessions: Dict[str, Dict[str, Any]] = {}
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self.records: Dict[str, int] = {}
        self.torn_tail = False

    # -- folding -----------------------------------------------------------

    def _session(self, sid: str) -> Dict[str, Any]:
        sess = self.sessions.get(sid)
        if sess is None:
            sess = self.sessions[sid] = {
                "w": 1.0, "q": None, "r": False, "closed": False,
                "quarantine": set(), "parked": [],
            }
        return sess

    def apply(self, rec: Dict[str, Any]) -> None:
        """Fold one journal record into the state.  Unknown types are
        ignored (an OLDER journal can never contain them thanks to the
        schema fence; a same-schema unknown type would be a bug we prefer
        to survive)."""
        t = rec.get("t")
        self.records[t] = self.records.get(t, 0) + 1
        if t == "meta":
            schema = int(rec.get("schema", 1))
            if schema > JOURNAL_SCHEMA:
                raise JournalSchemaError(
                    f"journal schema {schema} is newer than this broker's "
                    f"{JOURNAL_SCHEMA}; refusing to replay")
            self.schema = schema
            self.boot_id = rec.get("boot")
            self.epoch = int(rec.get("epoch", self.epoch or 1))
        elif t == "so":
            sess = self._session(str(rec["sid"]))
            sess["w"] = float(rec.get("w", 1.0))
            sess["q"] = rec.get("q")
            sess["r"] = bool(rec.get("r", False))
            sess["closed"] = False
        elif t == "sc":
            sid = str(rec["sid"])
            sess = self._session(sid)
            sess["closed"] = True
            sess["parked"] = []
            # A closed session's jobs are cancelled by the broker; the cx
            # record that follows pops them.  Defensive sweep anyway:
            for job_id in [j for j, job in self.jobs.items()
                           if job["sid"] == sid]:
                self.jobs.pop(job_id, None)
        elif t == "sub":
            sid = str(rec.get("sid", "default"))
            self._session(sid)  # implicit (default) sessions have no "so"
            self.jobs[str(rec["j"])] = {
                "sid": sid,
                "gk": rec.get("gk"),
                "p": rec.get("p") or {},
                "d": False,
            }
        elif t == "d":
            job = self.jobs.get(str(rec.get("j")))
            if job is not None:
                job["d"] = True
        elif t == "c":
            job = self.jobs.pop(str(rec.get("j")), None)
            if job is not None and rec.get("pk"):
                sess = self._session(job["sid"])
                if sess["r"] and not sess["closed"]:
                    sess["parked"].append({
                        "type": "results", "session": job["sid"],
                        "results": [{"job_id": str(rec.get("j")),
                                     "fitness": _unjfloat(rec.get("f"))}],
                    })
        elif t == "fl":
            self._session(str(rec["sid"]))["parked"] = []
        elif t == "x":
            self.jobs.pop(str(rec.get("j")), None)
        elif t == "q":
            job = self.jobs.get(str(rec.get("j")))
            if job is not None:
                job["d"] = False
        elif t == "cx":
            for job_id in rec.get("js", ()):
                self.jobs.pop(str(job_id), None)
        elif t == "g":
            self._session(str(rec["sid"]))["quarantine"].add(str(rec.get("gk")))

    # -- (de)hydration for the compacted snapshot --------------------------

    def to_snapshot(self) -> Dict[str, Any]:
        return {
            "schema": JOURNAL_SCHEMA,
            "epoch": self.epoch,
            "boot": self.boot_id,
            "sessions": {
                sid: {**sess, "quarantine": sorted(sess["quarantine"])}
                for sid, sess in self.sessions.items()
            },
            "jobs": self.jobs,
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "ReplayState":
        schema = int(snap.get("schema", 1))
        if schema > JOURNAL_SCHEMA:
            raise JournalSchemaError(
                f"snapshot schema {schema} is newer than this broker's "
                f"{JOURNAL_SCHEMA}; refusing to replay")
        state = cls()
        state.schema = schema
        state.epoch = int(snap.get("epoch", 0))
        state.boot_id = snap.get("boot")
        for sid, sess in (snap.get("sessions") or {}).items():
            state.sessions[str(sid)] = {
                "w": float(sess.get("w", 1.0)),
                "q": sess.get("q"),
                "r": bool(sess.get("r", False)),
                "closed": bool(sess.get("closed", False)),
                "quarantine": set(sess.get("quarantine") or ()),
                "parked": list(sess.get("parked") or ()),
            }
        for job_id, job in (snap.get("jobs") or {}).items():
            state.jobs[str(job_id)] = {
                "sid": str(job.get("sid", "default")),
                "gk": job.get("gk"),
                "p": job.get("p") or {},
                "d": bool(job.get("d", False)),
            }
        return state


def _read_tail(path: str) -> Tuple[List[Dict[str, Any]], bool]:
    """Parse the JSONL journal at ``path``.  Returns ``(records,
    torn_tail)``.  A final line that is incomplete (no trailing newline)
    or unparseable is a crash artifact: dropped loudly.  Damage anywhere
    else raises :class:`JournalCorruptError`."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if not raw:
        return [], False
    lines = raw.split(b"\n")
    torn: Optional[bytes] = None
    if lines[-1] != b"":
        torn = lines.pop()          # no trailing newline: torn mid-write
    else:
        lines.pop()                 # drop the empty split artifact
    records: List[Dict[str, Any]] = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict) or "t" not in rec:
                raise ValueError("not a journal record")
        except ValueError as e:
            if i == len(lines) - 1 and torn is None:
                torn = line         # complete line, torn payload
                break
            raise JournalCorruptError(
                f"journal record {i + 1} of {path} is corrupt "
                f"(not a crash-torn tail): {e}") from e
        records.append(rec)
    if torn is not None:
        logger.warning(
            "discarding torn journal tail (%d bytes) from %s — "
            "crash mid-append; replay continues from the previous record",
            len(torn), path)
        _get_registry().counter("journal_torn_tail_total").inc()
        return records, True
    return records, False


def replay_file(path: str) -> ReplayState:
    """Fold ``<path>.snap`` (if present) and the journal tail at ``path``
    into a :class:`ReplayState`.  Missing files replay to an empty state —
    a fresh broker with ``journal_path`` set starts at epoch 0 and boots
    into epoch 1."""
    snap_path = path + ".snap"
    if os.path.exists(snap_path):
        with open(snap_path, "r", encoding="utf-8") as fh:
            state = ReplayState.from_snapshot(json.load(fh))
    else:
        state = ReplayState()
    if os.path.exists(path):
        records, torn = _read_tail(path)
        for rec in records:
            state.apply(rec)
        state.torn_tail = torn
    return state


class DispatchJournal:
    """Append-only writer with batched fsync and offline compaction.

    Thread discipline mirrors the broker: every ``record_*`` call happens
    on the broker loop thread (or before the loop starts, during replay
    adoption) — the internal lock exists only for the ``status()``
    snapshot read from HTTP/ops threads and for the flusher.  ``flush``
    is called by the broker's periodic journal task; the hot path only
    appends pre-formatted strings to a list.
    """

    #: Inline (non-fsync) drain threshold — bounds buffer memory, never
    #: adds an fsync to the dispatch path.
    MAX_BUFFER = 4096
    #: Compact once this many records accumulate in the live file.
    COMPACT_EVERY = 50_000

    def __init__(self, path: str, fsync_interval: float = 0.05,
                 fault_injector: Any = None):
        self.path = path
        self.fsync_interval = float(fsync_interval)
        self._injector = fault_injector
        self._lock = threading.Lock()
        self._buf: List[str] = []
        self._fh = None
        self._wedged = False
        self._abandoned = False
        #: Set by an injected ``broker_crash`` fault; the broker's journal
        #: task turns it into an abrupt :meth:`JobBroker.kill`.
        self.crash_requested = False
        self._last_fsync = time.monotonic()
        self._records_since_compact = 0
        self._records_total: Dict[str, int] = {}
        self.boot_id = uuid.uuid4().hex[:12]
        self.epoch = 1
        self.replay_seconds = 0.0

    # -- boot --------------------------------------------------------------

    def open(self, state: Optional[ReplayState] = None) -> None:
        """Open for append.  With a replayed ``state`` the journal is
        immediately compacted to a snapshot of the *adopted* state (so the
        new boot's file starts from truth, not a replayed history) and the
        epoch advances past the replayed one."""
        if state is not None and state.epoch:
            self.epoch = state.epoch + 1
        if state is not None:
            state.epoch = self.epoch
            state.boot_id = self.boot_id
            self._write_snapshot(state.to_snapshot())
            self._fh = open(self.path, "w", encoding="utf-8")
        else:
            self._fh = open(self.path, "a", encoding="utf-8")
        self._append(json.dumps({"t": "meta", "schema": JOURNAL_SCHEMA,
                                 "boot": self.boot_id, "epoch": self.epoch},
                                separators=(",", ":")), "meta")
        self.flush()

    # -- hot-path appends --------------------------------------------------

    def _append(self, line: str, rtype: str) -> None:
        if self._wedged or self._abandoned:
            return
        self._buf.append(line)
        self._records_total[rtype] = self._records_total.get(rtype, 0) + 1
        self._records_since_compact += 1
        if len(self._buf) >= self.MAX_BUFFER:
            self._drain(fsync=False)

    def record_dispatch(self, job_id: str) -> None:
        """THE hot-path record — one per dispatched job.  Pre-formatted
        ``%``-string, no dict or dumps (see ``run_journal_gate``)."""
        self._append('{"t":"d","j":%s}' % _jid(job_id), "d")

    def record_submit(self, job_id: str, sid: str, gk: Optional[str],
                      payload: Dict[str, Any]) -> None:
        self._append(json.dumps(
            {"t": "sub", "j": job_id, "sid": sid, "gk": gk, "p": payload},
            separators=(",", ":"), default=str), "sub")

    def record_complete(self, job_id: str, fitness: float,
                        parked: bool = False) -> None:
        self._append('{"t":"c","j":%s,"f":%s,"pk":%d}'
                     % (_jid(job_id), _jfloat(float(fitness)),
                        1 if parked else 0), "c")

    def record_fail(self, job_id: str, reason: str) -> None:
        self._append(json.dumps({"t": "x", "j": job_id, "r": reason},
                                separators=(",", ":")), "x")

    def record_requeue(self, job_id: str) -> None:
        self._append('{"t":"q","j":%s}' % _jid(job_id), "q")

    def record_cancel(self, job_ids: List[str]) -> None:
        self._append(json.dumps({"t": "cx", "js": list(job_ids)},
                                separators=(",", ":")), "cx")

    def record_session_open(self, sid: str, weight: float,
                            max_in_flight: Optional[int],
                            remote: bool) -> None:
        self._append(json.dumps(
            {"t": "so", "sid": sid, "w": weight, "q": max_in_flight,
             "r": remote}, separators=(",", ":")), "so")

    def record_session_close(self, sid: str) -> None:
        self._append('{"t":"sc","sid":%s}' % _jid(sid), "sc")

    def record_flush(self, sid: str) -> None:
        self._append('{"t":"fl","sid":%s}' % _jid(sid), "fl")

    def record_quarantine(self, sid: str, gk: str) -> None:
        self._append(json.dumps({"t": "g", "sid": sid, "gk": gk},
                                separators=(",", ":")), "g")

    # -- durability --------------------------------------------------------

    def _drain(self, fsync: bool) -> None:
        """Write the buffer out.  The ``journal_write`` fault hook can
        inject a torn write here: a prefix of the pending bytes lands on
        disk and the journal wedges (drops every later append) — the
        deterministic stand-in for a crash mid-``write(2)``."""
        if not self._buf or self._fh is None or self._wedged:
            return
        # Swap FIRST (atomic store), then serialize: an append racing from
        # another thread lands in the fresh list, never in the void.
        buf, self._buf = self._buf, []
        data = "\n".join(buf) + "\n"
        if self._injector is not None:
            spec = self._injector.journal_write(self)
            if spec is not None and spec.kind == "broker_crash":
                # SIGKILL analog at the drain point: NOTHING reaches the
                # disk and every later append is void.
                self._abandoned = True
                self.crash_requested = True
                logger.warning("journal %s: injected broker crash at drain",
                               self.path)
                return
            if spec is not None and spec.kind == "journal_io_error":
                torn = data[:max(1, int(len(data) * float(
                    getattr(spec, "fraction", 0.5))))]
                try:
                    self._fh.write(torn)
                    self._fh.flush()
                except (OSError, ValueError):
                    pass
                self._wedged = True
                logger.warning("journal %s wedged by injected io error "
                               "(torn write of %d/%d bytes)",
                               self.path, len(torn), len(data))
                return
        try:
            self._fh.write(data)
            self._fh.flush()
            if fsync:
                os.fsync(self._fh.fileno())
                self._last_fsync = time.monotonic()
        except (OSError, ValueError):
            self._wedged = True
            logger.exception("journal %s write failed; wedging", self.path)

    def flush(self) -> None:
        """Batched fsync point — called by the broker's periodic journal
        task (and at clean shutdown), never per record."""
        with self._lock:
            self._drain(fsync=True)

    def maybe_compact(self) -> bool:
        if self._records_since_compact < self.COMPACT_EVERY:
            return False
        self.compact()
        return True

    def compact(self) -> None:
        """Fold the live file into ``<path>.snap`` and truncate.  Replays
        our own file offline — no live mirror of broker state to keep in
        sync.  Runs on the broker loop (rare; file is bounded by
        ``COMPACT_EVERY``)."""
        with self._lock:
            self._drain(fsync=True)
            if self._wedged or self._abandoned or self._fh is None:
                return
            state = replay_file(self.path)
            state.epoch = self.epoch
            state.boot_id = self.boot_id
            self._write_snapshot(state.to_snapshot())
            self._fh.close()
            self._fh = open(self.path, "w", encoding="utf-8")
            self._records_since_compact = 0
            self._buf.append(json.dumps(
                {"t": "meta", "schema": JOURNAL_SCHEMA, "boot": self.boot_id,
                 "epoch": self.epoch}, separators=(",", ":")))
            self._records_total["meta"] = self._records_total.get("meta", 0) + 1
            self._drain(fsync=True)

    def _write_snapshot(self, snap: Dict[str, Any]) -> None:
        tmp = self.path + ".snap.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(snap, fh, separators=(",", ":"), default=str)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path + ".snap")

    # -- lifecycle ---------------------------------------------------------

    def abandon(self) -> None:
        """SIGKILL analog: drop the un-fsynced buffer on the floor and stop
        writing — the crash took whatever had not reached the disk."""
        with self._lock:
            self._buf = []
            self._abandoned = True
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def close(self) -> None:
        """Clean shutdown: final batched fsync, then close."""
        with self._lock:
            self._drain(fsync=True)
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    # -- observability -----------------------------------------------------

    @property
    def wedged(self) -> bool:
        return self._wedged

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "path": self.path,
                "boot_id": self.boot_id,
                "epoch": self.epoch,
                "records_total": dict(self._records_total),
                "records_buffered": len(self._buf),
                "last_fsync_lag_s": round(
                    time.monotonic() - self._last_fsync, 3),
                "replay_seconds": self.replay_seconds,
                "wedged": self._wedged,
            }
