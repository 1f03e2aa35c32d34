"""The job broker: competing consumers, ack-after-work, redelivery.

This is the rebuild's replacement for the RabbitMQ broker + ``pika`` RPC
pattern (``gentun/server.py`` [PUB][BASELINE]; SURVEY.md §3.2, §5
"Distributed communication backend").  It reproduces the exact semantics the
reference got for free from AMQP:

- **competing consumers** — whichever worker has spare credit gets the next
  job; no ordering guarantees;
- **ack-after-work** — a worker's ``result`` message is the ack; jobs held
  by a worker that disconnects or stops heartbeating are requeued and
  redelivered to another worker (at-least-once);
- **redelivery without double-count** — the first ``result`` per job wins;
  late duplicates from a worker that "died" but finished anyway are dropped;
- **per-generation barrier** — :meth:`gather` blocks until every submitted
  job has a result (stragglers gate the generation, SURVEY.md §3.2);
- **completion-driven consumption** — :meth:`wait_any` blocks only until
  *some* submitted job reaches a terminal state, which is what the
  asynchronous steady-state engine (``algorithms_async.AsyncEvolution``)
  uses instead of the barrier: a returning result immediately breeds and
  dispatches a replacement, keeping the fleet busy through the tail.

Architecture: a single asyncio event loop in a daemon thread owns ALL broker
state (no locks on the hot path); the master thread talks to it through
``call_soon_threadsafe`` and a ``threading.Condition`` around the results
dict.  This control plane rides the network between hosts; the data plane
(a worker's training on its card) never touches it (SURVEY.md §5).

One deliberate extension beyond the reference: **worker capacity**.  A
worker may announce capacity N > 1 and receive N jobs at once, which lets a
TPU worker train the whole batch as one vmapped program (``models/cnn.py``)
instead of one individual at a time — the reference's one-job-per-worker
model wastes the MXU on small populations.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hmac
import itertools
import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set

from ..parallel.mesh import SIZE_SMALL, job_size_class
from ..telemetry import health as _health
from ..telemetry import lineage as _lineage
from ..telemetry import spans as _tele
from ..telemetry.registry import get_registry as _get_registry
from .journal import DispatchJournal, replay_file
from .packing import WindowPacker
from .protocol import (
    MAX_MESSAGE_BYTES,
    WIRE_CAPS,
    GenomeFragmentCache,
    JobWire,
    ProtocolError,
    build_job_wire,
    decode,
    encode,
    jobs2_frame,
    jobs_frame,
    pack_envelope,
    packed_entry2,
    parse_caps,
)
from .sessions import (
    DEFAULT_SESSION,
    FairShareScheduler,
    SearchSession,
    SessionRegistry,
    UnknownSessionError,
    genome_key,
)

__all__ = ["JobBroker", "JobFailed", "GatherTimeout"]

logger = logging.getLogger("gentun_tpu_torch.distributed")


class JobFailed(RuntimeError):
    """Some jobs exhausted their delivery attempts (every try raised worker-side).

    Raised by :meth:`JobBroker.gather` only after EVERY submitted job reached
    a terminal state, so it carries the full picture of the barrier:

    - :attr:`failures` — ``{job_id: reason}`` for the jobs that failed;
    - :attr:`partial` — ``{job_id: fitness}`` for the jobs that succeeded.

    The broker prunes all state for the gathered jobs before raising, so the
    defined retry is simply: apply ``partial``, then submit fresh jobs for
    the failed work (``DistributedPopulation.evaluate`` does exactly this —
    calling it again after a ``JobFailed`` reships only the failed
    individuals, with reset attempt counts).
    """

    def __init__(self, message: str, failures: Optional[Dict[str, str]] = None,
                 partial: Optional[Dict[str, float]] = None):
        super().__init__(message)
        self.failures = dict(failures or {})
        self.partial = dict(partial or {})


class GatherTimeout(TimeoutError):
    """The barrier timed out with jobs still unfinished (and none failed —
    a deadline with permanent failures raises :class:`JobFailed` instead).

    :attr:`partial` carries the fitnesses that DID arrive before the
    deadline, so a straggler-timeout generation keeps its finished work.
    The broker cancels the unfinished jobs and prunes all gathered state
    before raising, so a resubmit starts clean.
    """

    def __init__(self, message: str, partial: Optional[Dict[str, float]] = None):
        super().__init__(message)
        self.partial = dict(partial or {})


class _Worker:
    """Per-connection state, touched only from the broker loop thread."""

    __slots__ = ("worker_id", "writer", "capacity", "prefetch_depth", "credit",
                 "in_flight", "last_seen", "n_chips", "backend", "draining",
                 "mesh", "caps", "preemptible", "homes")

    def __init__(self, worker_id: str, writer: asyncio.StreamWriter, capacity: int,
                 n_chips: int = 1, backend: Optional[str] = None,
                 prefetch_depth: int = 0, mesh: Optional[Dict[str, int]] = None,
                 caps: frozenset = frozenset(), preemptible: bool = False,
                 homes: int = 1):
        self.worker_id = worker_id
        self.writer = writer
        self.capacity = capacity
        #: jobs the worker wants queued locally BEYOND its evaluation
        #: capacity (pipelined dispatch, protocol.py "Pipelined-dispatch
        #: field"); 0 for workers that never advertised one.
        self.prefetch_depth = prefetch_depth
        self.credit = 0
        self.in_flight: Set[str] = set()
        self.last_seen = time.monotonic()
        self.n_chips = n_chips
        self.backend = backend
        #: host-mesh advertisement (protocol.py "Host-mesh field"):
        #: {"pop": P, "data": D, "devices": N} for a host-level mesh
        #: worker whose capacity derives from its device mesh; None for
        #: per-chip workers (the entire pre-mesh fleet).
        self.mesh = mesh
        #: GRANTED wire capabilities (protocol.py "Wire fast path"): the
        #: intersection of what the worker advertised on ``hello`` and what
        #: this broker speaks.  Empty ⇔ the v1 frame set — every old worker.
        self.caps = caps
        #: Preemptible-capacity advertisement (protocol.py "Preemptible-
        #: capacity field"): True routes cheap rung-0 probes here when the
        #: fleet is mixed; absent/malformed on the wire degrades to False
        #: (stable), the conservative default.
        self.preemptible = preemptible
        #: Multi-home advertisement (protocol.py "Multi-home field"): how
        #: many broker shards this worker connected to.  Informational —
        #: this broker already advertised the worker's FULL window through
        #: the normal credit path (the worker meters per-broker credit
        #: itself) — but operators need it to read per-shard /statusz
        #: capacity sums correctly: a 2-homed capacity-8 worker shows 8 on
        #: BOTH shards.  1 for every single-homed (old) worker.
        self.homes = homes
        #: True once the worker announced an orderly exit (elastic
        #: membership): no new dispatches, excluded from the fleet sums —
        #: but still a live connection until its in-flight results land.
        self.draining = False

    @property
    def window(self) -> int:
        """Credit ceiling: evaluation slots plus the local prefetch queue."""
        return self.capacity + self.prefetch_depth


class JobBroker:
    """Embedded TCP job broker (master side).

    Parameters
    ----------
    host, port:
        Bind address; ``port=0`` picks an ephemeral port (read it back from
        :attr:`address` after :meth:`start`).
    token:
        Shared secret workers must present in ``hello`` — the counterpart of
        the reference's RabbitMQ user/password kwargs [PUB].  ``None``
        disables the check.
    heartbeat_timeout:
        Seconds of silence after which a worker *holding jobs* is declared
        dead and its jobs requeued.  Workers ping from a side thread even
        while training, so only a crashed/hung process trips this.
    max_attempts:
        Explicit worker-side ``fail`` replies per job before :meth:`gather`
        raises :class:`JobFailed`.  Worker *disconnects* never count (AMQP
        redelivers those indefinitely).
    fault_injector:
        Optional :class:`distributed.faults.FaultInjector` for deterministic
        chaos testing.  ``None`` (the default) costs one attribute check per
        frame and nothing else.
    straggler_floor_s, straggler_k:
        Stall-watchdog tuning (``telemetry/health.py``): a dispatched job is
        flagged as a straggler after ``max(floor, k × rolling-p95(RTT))``
        seconds in flight.  Only consulted while the ops plane is enabled
        (``telemetry.start_ops_server``); otherwise the watchdog sees no
        traffic at all.
    straggler_requeue:
        Opt-in: a flagged straggler is pulled from its worker and requeued
        for redelivery (the membership dedup drops the stalled worker's
        late result, exactly like disconnect redelivery).  Off by default —
        flagging alone never changes the dispatch schedule.
    quarantine_after:
        Poison-genome isolation (sessions.py): terminal failures of the
        SAME genome within one session before that session refuses to
        dispatch it again.  Per-session by design — a genome that crashes
        tenant A's species may be fine for tenant B's.
    quarantine_crash_requeues:
        Opt-in crash isolation: after this many disconnect-redeliveries of
        one job, the job fails terminally and its genome is quarantined in
        its session, instead of crash-looping through the whole fleet.
        ``None`` (default) preserves unbounded AMQP-style disconnect
        redelivery — required by the chaos suite's kill/redeliver tests.
    aggregator_url:
        Optional fleet metrics aggregator (``telemetry/aggregator.py``):
        while the broker runs, this process pushes metric snapshots there
        under role ``broker`` (shared per-process pusher — a master that
        also wired the URL merges roles instead of double-counting).
        Fail-open: aggregator downtime never touches dispatch.
    journal_path:
        Crash safety (``distributed/journal.py``): path of the
        append-only dispatch journal.  :meth:`start` REPLAYS whatever is
        there first — a restarted broker re-adopts its pre-crash sessions,
        parked results, and open jobs (all requeued as suspect through the
        at-least-once path) — then appends this boot's records under a
        fresh ``boot_id``/epoch.  ``None`` (default) disables journaling
        entirely: byte-identical wire behavior and zero hot-path cost.
    journal_fsync_interval:
        Batched-fsync cadence of the journal task, seconds.  Records
        buffer in memory between fsyncs (a crash loses at most one
        interval — safe: a lost ``c`` record only means one redundant,
        deduplicated re-evaluation).
    admission_rate, admission_burst:
        Per-tenant token-bucket admission control on the WIRE tenant paths
        (``session_open``/``submit``): sustained frames/s and burst size.
        ``None`` (default) disables rate limiting.  In-process submits are
        never rate-limited — a master throttling itself deadlocks.
    admission_queue_factor:
        Back-pressure heuristic: reject wire submits/opens with a
        structured ``error {code:"admission", retry_after_s}`` while the
        undispatched backlog exceeds ``factor × live fleet capacity``.
        ``None`` (default) disables the check.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        token: Optional[str] = None,
        heartbeat_timeout: float = 15.0,
        max_attempts: int = 3,
        fault_injector=None,
        straggler_floor_s: float = 30.0,
        straggler_k: float = 4.0,
        straggler_requeue: bool = False,
        quarantine_after: int = 3,
        quarantine_crash_requeues: Optional[int] = None,
        aggregator_url: Optional[str] = None,
        wire_caps: Optional[tuple] = None,
        journal_path: Optional[str] = None,
        journal_fsync_interval: float = 0.05,
        admission_rate: Optional[float] = None,
        admission_burst: Optional[float] = None,
        admission_queue_factor: Optional[float] = None,
        pack_windows: bool = False,
        pack_linger_ms: float = 50.0,
    ):
        self._host = host
        self._port = port
        # Fleet observability (telemetry/aggregator.py): pushing starts
        # with the broker and stops with it.  acquire_pusher dedups per
        # URL, so a master that also wired aggregator_url shares this
        # process's pusher (roles merge) instead of double-counting.
        self._aggregator_url = aggregator_url
        self._pusher = None
        self._token = token
        self._heartbeat_timeout = float(heartbeat_timeout)
        self._max_attempts = int(max_attempts)
        self._injector = fault_injector
        # Ops plane (telemetry/health.py): the watchdog is fed from the
        # loop thread behind `_health.enabled()` gates, checked by
        # _watchdog_loop.  Check cadence adapts to the floor so a test
        # with a sub-second floor is flagged promptly, without busy-spin.
        self._watchdog_interval = max(0.05, min(1.0, float(straggler_floor_s) / 4.0))
        self._straggler_requeue = bool(straggler_requeue)
        self._watchdog = _health.StallWatchdog(
            floor_s=straggler_floor_s,
            k=straggler_k,
            on_straggler=self._on_straggler if straggler_requeue else None,
        )

        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._reaper_task: Optional[asyncio.Task] = None
        self._watchdog_task: Optional[asyncio.Task] = None
        self._started = threading.Event()
        self._stopping = False

        # Crash safety: the dispatch journal and this boot's
        # identity.  _boot_id is None ⇔ journaling is off — the welcome
        # frame then carries no boot_id and the epoch check never fires,
        # byte-identical to the pre-journal broker.
        self._journal_path = journal_path
        self._journal_fsync_interval = max(0.005, float(journal_fsync_interval))
        self._journal: Optional[DispatchJournal] = None
        self._journal_task: Optional[asyncio.Task] = None
        self._journal_counts_synced: Dict[str, int] = {}
        self._boot_id: Optional[str] = None
        self._epoch = 0
        self._replay_seconds = 0.0
        self._restarts = 0
        # Admission control (wire tenants only): per-session token buckets
        # (sid -> (tokens, last_refill)) plus saturation back-pressure.
        # Loop-thread state, like the scheduler.
        self._admission_rate = None if admission_rate is None else float(admission_rate)
        self._admission_burst = None if admission_burst is None else float(admission_burst)
        self._admission_queue_factor = (
            None if admission_queue_factor is None else float(admission_queue_factor))
        self._admission_buckets: Dict[str, tuple] = {}
        self._admission_rejections: Dict[str, int] = {}
        # Cross-session window packing (packing.py): OFF by
        # default — _packer is None ⇔ _dispatch takes the original path
        # and every frame stays byte-identical to a pack-off build.
        # Loop-thread state, like the scheduler.
        self._pack_windows = bool(pack_windows)
        self._pack_linger_s = max(0.0, float(pack_linger_ms) / 1000.0)
        self._packer: Optional[WindowPacker] = (
            WindowPacker(self._pack_linger_s) if self._pack_windows else None)
        self._pack_timer: Optional[asyncio.TimerHandle] = None

        # Loop-thread state.  A job is "open" iff its id is in _payloads:
        # the first result pops the payload, and every other path (dispatch,
        # requeue, fail) checks membership — that is what makes redelivery
        # duplicates and stale scheduler entries harmless.
        #
        # Multi-tenant sessions (sessions.py): the single pending deque is
        # replaced by a fair-share scheduler over per-session queues.  With
        # one session (the implicit default) it degenerates to the old FIFO.
        self._registry = SessionRegistry(quarantine_after=quarantine_after)
        self._quarantine_crash_requeues = (
            None if quarantine_crash_requeues is None
            else max(1, int(quarantine_crash_requeues)))
        self._sched = FairShareScheduler(self._registry.weight)
        self._payloads: Dict[str, Dict[str, Any]] = {}
        self._fail_counts: Dict[str, int] = {}
        # Session tenancy maps, popped exactly where _payloads is popped.
        self._job_session: Dict[str, str] = {}
        self._job_genome: Dict[str, str] = {}
        self._crash_counts: Dict[str, int] = {}
        # Wire fast path (protocol.py "Wire fast path"): capabilities this
        # broker grants workers, the per-master genome fragment cache, and
        # the per-open-job wire records (popped exactly where _payloads is
        # popped) that make every re-dispatch a byte-join instead of a
        # re-serialization.
        self._wire_caps = frozenset(WIRE_CAPS if wire_caps is None else wire_caps)
        self._frag_cache = GenomeFragmentCache()
        self._job_wire: Dict[str, JobWire] = {}
        # Memoized wire-telemetry handles (memoize-or-die: the registry's
        # get-or-create takes a lock per lookup; the dispatch path bumps
        # per frame, not per job, but still holds its instruments).
        self._wire_counters: Dict[str, tuple] = {}
        self._encode_hist = None
        self._encode_samples = 0
        self._workers: Dict[int, _Worker] = {}
        self._worker_seq = itertools.count()
        # Sticky once any preemptible member has joined: gates the
        # preemptible_members gauge so stable-only fleets emit no new series.
        self._seen_preemptible = False
        # Telemetry (loop-thread only): monotonic (re)enqueue stamp per open
        # job, feeding queue_wait and job spans.  Populated only while
        # telemetry is enabled; pruned wherever _payloads is pruned.
        self._tele_enqueued: Dict[str, float] = {}
        # Monotonic handoff-to-worker stamp per dispatched job, feeding the
        # dispatch_rtt_s histogram (handoff → result: worker queue residence
        # + evaluation + frame transit).  Same lifecycle discipline as
        # _tele_enqueued; a requeue removes the stamp (the job is no longer
        # dispatched).
        self._tele_dispatched: Dict[str, float] = {}
        # TTFD anchors (loop-thread writes, snapshot reads): per-session
        # monotonic stamps of the FIRST submit and FIRST worker handoff,
        # feeding session_ttfd() and the session_stats wire reply's
        # ttfd_s.  Always maintained (one dict-membership check per job,
        # not per frame); cleared on session close.
        self._first_submit_t: Dict[str, float] = {}
        self._first_dispatch_t: Dict[str, float] = {}

        # Cross-thread results channel
        self._cond = threading.Condition()
        self._results: Dict[str, float] = {}
        self._failures: Dict[str, str] = {}
        # Running max of the fleet's advertised chip total, sampled whenever
        # a result arrives (a worker that disconnects right after
        # its final result must still count in the per-chip denominator).
        self._chips_seen = 0

    # -- lifecycle ---------------------------------------------------------

    @property
    def address(self) -> tuple[str, int]:
        if not self._started.is_set():
            raise RuntimeError("broker not started")
        return self._bound  # set in _serve

    def start(self) -> "JobBroker":
        if self._thread is not None:
            return self
        self._stopping = False  # allow stop() → start() restart
        if self._journal_path is not None and self._journal is None:
            # Replay BEFORE the loop serves: the rebuilt state is primed
            # single-threaded, and the first reconnecting worker already
            # sees the re-adopted queue.
            self._adopt_journal()
        self._thread = threading.Thread(target=self._run_loop, name="gentun-broker", daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10.0):
            raise RuntimeError("broker failed to start within 10s")
        # Ops-plane registration: dict writes, harmless while the plane is
        # disabled.  The loop's beat gates /healthz — a wedged broker loop
        # goes stale within a few watchdog intervals.
        _health.register_source(
            "broker_loop", timeout=max(2.0, 10.0 * self._watchdog_interval))
        _health.register_watchdog(self._watchdog)
        _health.register_status_provider("fleet", self._ops_status)
        if self._aggregator_url and self._pusher is None:
            from ..telemetry.aggregator import acquire_pusher
            self._pusher = acquire_pusher(self._aggregator_url, role="broker")
        return self

    def stop(self) -> None:
        if self._loop is None:
            return
        self._stopping = True
        loop = self._loop

        async def _shutdown():
            # loop.stop() sits in the finally: if any close() below raises,
            # run_forever must still return — otherwise the loop thread
            # outlives stop() as an unjoinable zombie holding the port.
            try:
                for w in list(self._workers.values()):
                    w.writer.close()
                if self._server is not None:
                    self._server.close()
                # Cancel every other task — connection handlers, the reaper
                # — and WAIT for their cleanup before stopping the loop:
                # stopping with handlers still parked on readline() destroys
                # pending tasks ("Task was destroyed but it is pending!" at
                # every master exit) and skips their finally-block cleanup.
                tasks = [t for t in asyncio.all_tasks(loop)
                         if t is not asyncio.current_task()]
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
            finally:
                loop.stop()

        loop.call_soon_threadsafe(lambda: asyncio.ensure_future(_shutdown()))
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():  # pragma: no cover - defensive
                logger.warning(
                    "broker loop thread did not exit within 5s of stop(); "
                    "abandoning it (daemon) — port may stay bound until "
                    "process exit"
                )
        self._thread = None
        self._loop = None
        self._started.clear()
        # The linger timer handle belongs to the dead loop; a restart's
        # first dispatch re-arms on the new one.
        self._pack_timer = None
        if self._journal is not None:
            # Clean shutdown: final batched fsync.  (kill() abandons the
            # buffer FIRST, so a killed broker's journal truly loses its
            # un-fsynced tail, like a real crash's.)  Dropping the handle
            # makes the next start() replay the file afresh.
            self._journal.close()
            self._journal = None
        _health.unregister_watchdog(self._watchdog)
        _health.unregister_status_provider("fleet", self._ops_status)
        _health.unregister_source("broker_loop")
        if self._pusher is not None:
            from ..telemetry.aggregator import release_pusher
            release_pusher(self._pusher)
            self._pusher = None
        self._watchdog.clear()

    def kill(self) -> None:
        """In-process SIGKILL analog (chaos / HA harness): die NOW.

        The journal's un-fsynced buffer is dropped on the floor first —
        exactly what a real ``kill -9`` takes — then every TCP connection
        and ALL loop-thread dispatch state is destroyed.  Workers see a
        disconnect and re-enter their capped-backoff reconnect loops; wire
        tenants likewise.  The ONLY road back is :meth:`start` replaying
        the same ``journal_path``.  The cross-thread results channel
        (``_results``/``_failures``/``_cond``) survives deliberately: it
        is the MASTER's memory, and for an embedded broker the master
        process did not die.
        """
        if self._journal is not None:
            self._journal.abandon()
        self.stop()
        self._registry = SessionRegistry(
            quarantine_after=self._registry.quarantine_after)
        self._sched = FairShareScheduler(self._registry.weight)
        self._payloads.clear()
        self._fail_counts.clear()
        self._job_session.clear()
        self._job_genome.clear()
        self._crash_counts.clear()
        self._job_wire.clear()
        self._frag_cache = GenomeFragmentCache()
        self._tele_enqueued.clear()
        self._tele_dispatched.clear()
        self._workers.clear()
        self._admission_buckets.clear()
        # Held pack windows die with the boot: the journal never saw a
        # dispatch for them, so replay returns them to the scheduler and
        # the fresh packer simply re-packs.
        if self._pack_windows:
            self._packer = WindowPacker(self._pack_linger_s)
        self._pack_timer = None
        self._journal = None
        self._boot_id = None

    def _adopt_journal(self) -> None:
        """Replay ``journal_path`` and rebuild the pre-crash dispatch
        state (caller thread, BEFORE the loop starts — single-threaded by
        construction).  Every replayed open job is suspect: requeued
        through the exact at-least-once path a worker disconnect uses,
        with its wire bytes rebuilt through the fragment cache so a
        re-send is byte-identical to the pre-crash dispatch."""
        t0 = time.perf_counter()
        state = replay_file(self._journal_path)
        restart = state.epoch > 0
        journal = DispatchJournal(self._journal_path,
                                  fsync_interval=self._journal_fsync_interval,
                                  fault_injector=self._injector)
        journal.open(state)  # compacts to the adopted snapshot, bumps epoch
        for sid, s in state.sessions.items():
            sess = self._registry.open(sid, weight=s["w"],
                                       max_in_flight=s["q"], remote=s["r"])
            if s["closed"]:
                # Keep the id burned: re-opening a closed session must
                # still raise, exactly as before the crash.
                sess.closed = True
                continue
            sess.quarantine |= s["quarantine"]
            for frame in s["parked"]:
                sess.undelivered.append(frame)
        memo: dict = {}
        for job_id, job in state.jobs.items():
            payload, sid = job["p"], job["sid"]
            gk = job["gk"] or genome_key(payload.get("genes"))
            jw = build_job_wire(job_id, payload, gk, self._frag_cache, memo)
            if sid != DEFAULT_SESSION:
                payload = dict(payload)
                payload["session"] = sid
                jw = jw.with_session(sid)
            self._payloads[job_id] = payload
            self._job_wire[job_id] = jw
            self._job_session[job_id] = sid
            self._job_genome[job_id] = gk
            self._sched.push(sid, job_id)
            sess = self._registry.peek(sid)
            if sess is not None and job["d"]:
                sess.requeued += 1  # was in flight when the broker died
        self._journal = journal
        self._boot_id = journal.boot_id
        self._epoch = journal.epoch
        self._journal_counts_synced = {}
        elapsed = time.perf_counter() - t0
        self._replay_seconds = journal.replay_seconds = round(elapsed, 6)
        reg = _get_registry()
        reg.gauge("journal_replay_seconds").set(elapsed)
        reg.gauge("broker_epoch").set(self._epoch)
        if restart:
            self._restarts += 1
            reg.counter("broker_restarts_total").inc()
            logger.warning(
                "broker restarted into epoch %d from journal %s: re-adopted "
                "%d session(s), requeued %d suspect open job(s) in %.3fs%s",
                self._epoch, self._journal_path, len(state.sessions),
                len(state.jobs), elapsed,
                " (torn tail discarded)" if state.torn_tail else "")
            _tele.record_event("broker_restarted", {
                "epoch": self._epoch, "sessions": len(state.sessions),
                "suspect_jobs": len(state.jobs),
                "replay_seconds": round(elapsed, 6),
                "torn_tail": state.torn_tail,
            })

    async def _journal_loop(self) -> None:
        """Batched-fsync driver: ONE ``writelines+flush+fsync`` per
        interval, whatever the dispatch rate — the hot path only appends
        pre-formatted strings (``run_journal_gate`` holds that cost to
        ≤ 2% of a dispatch).  Also threshold-compacts, mirrors the
        journal's record counts into ``journal_records_total{type}``, and
        turns an injected ``broker_crash`` into an abrupt :meth:`kill`."""
        journal = self._journal
        if journal is None:
            return
        while not self._stopping:
            await asyncio.sleep(self._journal_fsync_interval)
            journal.flush()
            journal.maybe_compact()
            if _tele.enabled():
                reg = _get_registry()
                for rtype, n in journal.status()["records_total"].items():
                    seen = self._journal_counts_synced.get(rtype, 0)
                    if n > seen:
                        reg.counter("journal_records_total", type=rtype).inc(n - seen)
                        self._journal_counts_synced[rtype] = n
            if journal.crash_requested:
                # kill() joins the loop thread — it must run elsewhere.
                threading.Thread(target=self.kill, name="gentun-broker-crash",
                                 daemon=True).start()
                return

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        loop.run_until_complete(self._serve())
        try:
            loop.run_forever()
        finally:
            loop.close()

    async def _serve(self) -> None:
        # Reader limit must cover a full protocol frame: the default 64 KiB
        # StreamReader limit would kill legitimate (if large) worker frames
        # with a LimitOverrunError instead of the clean ProtocolError path.
        self._server = await asyncio.start_server(
            self._handle_worker, self._host, self._port, limit=MAX_MESSAGE_BYTES + 2
        )
        sock = self._server.sockets[0]
        self._bound = sock.getsockname()[:2]
        self._reaper_task = asyncio.ensure_future(self._reaper())
        self._watchdog_task = asyncio.ensure_future(self._watchdog_loop())
        if self._journal is not None:
            self._journal_task = asyncio.ensure_future(self._journal_loop())
        self._started.set()
        logger.info("broker listening on %s:%d", *self._bound)

    # -- master-side API (called from any thread) --------------------------

    def submit(self, payloads: Dict[str, Dict[str, Any]],
               session: Optional[str] = None) -> None:
        """Enqueue jobs: {job_id: payload}.  Non-blocking.

        ``session`` tags the jobs with a tenant opened via
        :meth:`open_session`; ``None`` rides the implicit default session
        (the pre-session single-tenant behavior, byte-identical on the
        wire).  Naming an unknown or closed session raises
        :class:`~.sessions.UnknownSessionError` HERE, in the caller's
        thread — loud, never a silent drop — and bumps
        ``session_rejected_total{session}``.
        """
        if not self._started.is_set():
            raise RuntimeError("broker not started")
        sid = str(session) if session else DEFAULT_SESSION
        if session is not None:
            sess = self._registry.peek(sid)
            if sess is None or sess.closed:
                if sess is not None:
                    sess.rejected += len(payloads)
                _get_registry().counter("session_rejected_total", session=sid).inc(len(payloads))
                raise UnknownSessionError(
                    f"session {sid!r} is {'closed' if sess is not None else 'unknown'}; "
                    f"open_session() it before submitting")

        # Assemble each job's wire record in the CALLER's thread: the
        # byte-for-byte validation pass (an oversized payload raises where
        # the submitter can see it, instead of being swallowed by the loop
        # thread's best-effort writer) now doubles as the ONLY serialization
        # this job ever pays — dispatch and every requeue re-join these
        # cached fragments (protocol.py "Wire fast path").  The genome hash
        # moves off the loop thread with it.
        wires: Dict[str, JobWire] = {}
        memo: dict = {}  # batch-scoped: dedups the shared params object's dumps
        for job_id, payload in payloads.items():
            wires[job_id] = build_job_wire(
                job_id, payload, genome_key(payload.get("genes")),
                self._frag_cache, memo)

        self._loop.call_soon_threadsafe(
            self._enqueue_jobs, dict(payloads), sid, wires)

    def _enqueue_jobs(self, payloads: Dict[str, Dict[str, Any]], sid: str,
                      wires: Optional[Dict[str, JobWire]] = None) -> None:
        """Loop-thread enqueue: session books, quarantine gate, scheduler.

        Also the wire-client submit path (``_handle_client`` runs in the
        loop thread and calls this directly).  A session that closed
        between the caller-side check and this callback records loud
        terminal failures instead of silently dropping the jobs.
        """
        if sid == DEFAULT_SESSION:
            sess: Optional[SearchSession] = self._registry.ensure_default()
        else:
            sess = self._registry.peek(sid)
        if sess is None or sess.closed:
            _get_registry().counter("session_rejected_total", session=sid).inc(len(payloads))
            reason = f"session {sid!r} is {'closed' if sess is not None else 'unknown'}"
            if sess is not None:
                sess.rejected += len(payloads)
            if sess is not None and sess.remote:
                for job_id in payloads:
                    self._deliver_remote(sess, {"type": "fail", "session": sid,
                                                "job_id": job_id, "reason": reason})
            else:
                with self._cond:
                    for job_id in payloads:
                        self._failures[job_id] = reason
                    self._cond.notify_all()
            return
        tele = _tele.enabled()
        jrn = self._journal
        now = time.monotonic()
        quarantined: Dict[str, str] = {}
        for job_id, payload in payloads.items():
            jw = wires.get(job_id) if wires is not None else None
            if jw is None:
                # Wire-client submits arrive without records (arbitrary
                # dicts off the socket): build them here, loop thread.
                jw = build_job_wire(job_id, payload,
                                    genome_key(payload.get("genes")),
                                    self._frag_cache)
            gk = jw.gk
            if gk in sess.quarantine:
                # Poison isolation: this genome already burned its failure
                # budget in THIS session — fail instantly, never dispatch.
                sess.rejected += 1
                quarantined[job_id] = (
                    f"genome {gk} quarantined in session {sid!r} "
                    f"after repeated failures")
                continue
            if jrn is not None:
                # Journal the UNTAGGED payload: replay re-runs this very
                # tagging path, so the rebuilt wire bytes match exactly.
                jrn.record_submit(job_id, sid, gk, payload)
            if sid != DEFAULT_SESSION:
                # Tag a COPY: default-session payloads stay byte-identical
                # to the pre-session wire format, and callers keep their
                # dicts untouched either way.
                payload = dict(payload)
                payload["session"] = sid
                jw = jw.with_session(sid)
            self._payloads[job_id] = payload
            self._job_wire[job_id] = jw
            self._job_session[job_id] = sid
            self._job_genome[job_id] = gk
            self._sched.push(sid, job_id)
            sess.submitted += 1
            if sid not in self._first_submit_t:
                # TTFD anchor (telemetry/canary.py): the session's FIRST
                # submit.  One dict-membership check per job; cleared on
                # session close so a reopened id re-anchors.
                self._first_submit_t[sid] = now
            if tele:
                self._tele_enqueued[job_id] = now
        if quarantined:
            if sess.remote:
                for job_id, reason in quarantined.items():
                    self._deliver_remote(sess, {"type": "fail", "session": sid,
                                                "job_id": job_id, "reason": reason})
            else:
                with self._cond:
                    self._failures.update(quarantined)
                    self._cond.notify_all()
        if tele:
            self._update_flow_gauges()
        self._dispatch()

    def wait_any(
        self, job_ids: List[str], timeout: Optional[float] = None
    ) -> tuple[Dict[str, float], Dict[str, str]]:
        """Block until at least ONE of ``job_ids`` is terminal; no barrier.

        Returns ``(results, failures)`` — every fitness and permanent
        failure available at wake-up (so a burst of completions drains in
        one call), pruned from broker state exactly like :meth:`gather`'s.
        Both dicts empty ⇔ the timeout expired with nothing terminal.
        The caller owns retry/penalty policy; unlike :meth:`gather` this
        never raises, because the steady-state engine treats a failure as
        one completed (dead) evaluation, not a reason to stop the world.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        want = set(job_ids)
        with self._cond:
            while True:
                done_r = {j: self._results[j] for j in want if j in self._results}
                done_f = {j: self._failures[j] for j in want if j in self._failures}
                if done_r or done_f:
                    self._prune_gathered(set(done_r) | set(done_f))
                    return done_r, done_f
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return {}, {}
                self._cond.wait(timeout=min(remaining, 1.0) if remaining is not None else 1.0)

    def cancel(self, job_ids) -> None:
        """Withdraw still-open jobs (the public face of :meth:`_cancel_jobs`).

        The steady-state engine calls this for children still in flight
        when its evaluation budget is reached: their results are no longer
        wanted, and a late arrival is dropped as stale.
        """
        self._cancel_jobs(set(job_ids))

    def gather(self, job_ids: List[str], timeout: Optional[float] = None) -> Dict[str, float]:
        """Block until every job in ``job_ids`` has a fitness (the barrier).

        Raises :class:`JobFailed` if any job exhausted its attempts, and
        ``TimeoutError`` on timeout.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        want = set(job_ids)
        no_workers_since: Optional[float] = None
        with self._cond:
            while True:
                done_r = {j for j in want if j in self._results}
                done_f = {j for j in want if j in self._failures}
                open_jobs = want - done_r - done_f
                # The barrier waits for every job to reach a TERMINAL state
                # (result or permanent failure) before deciding the outcome:
                # one poisoned individual must not discard the rest of the
                # generation's finished work.
                if not open_jobs:
                    out = {j: self._results[j] for j in done_r}
                    failed = {j: self._failures[j] for j in done_f}
                    self._prune_gathered(want)
                    if failed:
                        job_id = sorted(failed)[0]
                        raise JobFailed(
                            f"{len(failed)} of {len(want)} job(s) failed permanently "
                            f"(first: {job_id}: {failed[job_id]})",
                            failures=failed,
                            partial=out,
                        )
                    return out
                # Fail fast when waiting cannot help: a permanent failure is
                # already recorded and NO worker is connected, so the open
                # jobs sit in the queue with nobody to run them.  (A busy
                # connected worker always eventually produces a result, a
                # fail, or a disconnect — all of which wake this loop.)
                # The no-workers condition must HOLD for a full heartbeat
                # window before we act on it: a worker in its reconnect
                # backoff makes self._workers transiently empty, and
                # aborting then would cancel still-runnable jobs.
                if done_f and not self._workers:
                    now = time.monotonic()
                    if no_workers_since is None:
                        no_workers_since = now
                    if now - no_workers_since >= self._heartbeat_timeout:
                        out = {j: self._results[j] for j in done_r}
                        failed = {j: self._failures[j] for j in done_f}
                        self._prune_gathered(want)
                        self._cancel_jobs(open_jobs)
                        raise JobFailed(
                            f"{len(done_f)} job(s) failed permanently with no workers "
                            f"connected for {self._heartbeat_timeout:.0f}s; cancelled "
                            f"{len(open_jobs)} undispatchable job(s)",
                            failures=failed,
                            partial=out,
                        )
                else:
                    no_workers_since = None
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    out = {j: self._results[j] for j in done_r}
                    failed = {j: self._failures[j] for j in done_f}
                    # Cancel + prune so timed-out generations leave no state
                    # behind (late results are then dropped as stale) and a
                    # resubmit starts with fresh attempt counts.
                    self._prune_gathered(want)
                    self._cancel_jobs(open_jobs)
                    missing = sorted(open_jobs)
                    if failed:
                        raise JobFailed(
                            f"barrier timed out with {len(failed)} permanent failure(s) "
                            f"and {len(missing)} unfinished job(s)",
                            failures=failed,
                            partial=out,
                        )
                    raise GatherTimeout(
                        f"{len(missing)} job(s) unfinished: {missing[:5]}...",
                        partial=out,
                    )
                # Poll at ≥1 Hz even under a long finite deadline: the
                # no-workers fail-fast above re-evaluates on wake-ups only,
                # and with zero workers connected nothing else notifies.
                self._cond.wait(timeout=min(remaining, 1.0) if remaining is not None else 1.0)

    def _prune_gathered(self, want: Set[str]) -> None:
        """Drop all master-side state for a gathered job set (holds _cond).

        Keeps the master O(one generation), not O(whole search), and gives a
        post-failure resubmit fresh attempt counts.  Late duplicates are
        dropped by the _payloads membership check, so pruning cannot
        resurrect a job.
        """
        for j in want:
            self._results.pop(j, None)
            self._failures.pop(j, None)
            self._fail_counts.pop(j, None)

    def _cancel_jobs(self, job_ids: Set[str]) -> None:
        """Withdraw still-open jobs (loop-thread async; safe from any thread).

        Removing the payload is the single source of truth: dispatch skips
        pending ids without payloads, and any result that still arrives is
        dropped as stale."""
        ids = set(job_ids)
        if not ids or self._loop is None:
            return
        self._loop.call_soon_threadsafe(self._cancel_ids, ids)

    def _cancel_ids(self, ids: Set[str]) -> None:
        """Loop-thread cancel body (also the close_session sweep)."""
        ops = _health.enabled()
        if self._journal is not None:
            withdrawn = sorted(j for j in ids if j in self._payloads)
            if withdrawn:
                self._journal.record_cancel(withdrawn)
        for j in ids:
            self._payloads.pop(j, None)
            self._job_wire.pop(j, None)
            self._job_session.pop(j, None)
            self._job_genome.pop(j, None)
            self._crash_counts.pop(j, None)
            self._tele_enqueued.pop(j, None)
            self._tele_dispatched.pop(j, None)
            if ops:
                self._watchdog.job_removed(j)
        # Drain cancelled ids from the scheduler now: with no worker
        # connected nothing else pops the queues, and a retry loop would
        # grow them by one generation per attempt.
        self._sched.remove(ids)
        if self._packer is not None:
            self._packer.remove(ids)
        for w in self._workers.values():
            # Restore the credit _dispatch deducted for cancelled jobs,
            # so the worker's next batch isn't shrunk for one cycle.
            cancelled_here = len(w.in_flight & ids)
            w.in_flight -= ids
            w.credit = min(w.window, w.credit + cancelled_here)
        # Late sweep: a result that was mid-delivery when gather pruned
        # (past the payload check, blocked on _cond) lands in _results
        # BEFORE this callback runs — handler and callbacks share the
        # loop thread, and call_soon callbacks queue behind the handler.
        # Sweeping here therefore removes any such orphan for good.
        with self._cond:
            for j in ids:
                self._results.pop(j, None)
                self._failures.pop(j, None)
                self._fail_counts.pop(j, None)
        if _tele.enabled():
            self._update_flow_gauges()

    def evaluate(self, payloads: Dict[str, Dict[str, Any]], timeout: Optional[float] = None) -> Dict[str, float]:
        """submit + gather in one call."""
        self.submit(payloads)
        return self.gather(list(payloads), timeout=timeout)

    # -- session API (multi-tenant; sessions.py) ---------------------------

    def open_session(self, session_id: Optional[str] = None, weight: float = 1.0,
                     max_in_flight: Optional[int] = None,
                     tag: Optional[str] = None) -> str:
        """Open (or re-attach to) a search session and return its id.

        ``weight`` sets the tenant's fair-share priority (a weight-2
        session gets 2× the dispatch share of a weight-1 neighbor while
        both are backlogged); ``max_in_flight`` caps how many of its jobs
        may be dispatched at once regardless of share.  ``tag="canary"``
        marks a probe session the broker keeps out of tenant-facing SLI
        series (tags are not journaled — probe sessions reopen fresh after
        a restart).  Safe from any thread; idempotent for an open id.
        """
        sess = self._registry.open(session_id, weight=weight,
                                   max_in_flight=max_in_flight, tag=tag)
        if self._journal is not None:
            jrn, loop = self._journal, self._loop

            def _rec(s=sess):
                jrn.record_session_open(s.session_id, s.weight,
                                        s.max_in_flight, s.remote)

            # Journal appends belong to the loop thread; before the loop
            # exists (pre-start adoption) the caller IS the only thread.
            if loop is not None and self._started.is_set():
                loop.call_soon_threadsafe(_rec)
            else:
                _rec()
        return sess.session_id

    def close_session(self, session_id: str) -> None:
        """Close a session: no new submits, its queued jobs are withdrawn
        and its capacity share flows back to the remaining tenants.
        Idempotent; unknown ids are a no-op (close-after-close races are
        normal during teardown)."""
        sid = str(session_id)
        sess = self._registry.close(sid)
        if sess is None or self._loop is None or not self._started.is_set():
            return

        def _do():
            if self._journal is not None:
                self._journal.record_session_close(sid)
            self._first_submit_t.pop(sid, None)
            self._first_dispatch_t.pop(sid, None)
            ids = {j for j, s in self._job_session.items() if s == sid}
            if ids:
                self._cancel_ids(ids)

        self._loop.call_soon_threadsafe(_do)

    def session_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-session book snapshot (submitted/completed/failed/rejected/
        requeued/quarantined, queue depth, in-flight).  Snapshot read —
        safe from any thread."""
        inflight = self._inflight_by_session()
        return {
            s.session_id: s.snapshot(
                in_flight=inflight.get(s.session_id, 0),
                queued=self._sched.session_depth(s.session_id))
            for s in self._registry.list()
        }

    def session_ttfd(self, session_id: Optional[str] = None) -> Optional[float]:
        """Time-to-first-dispatch for this session: seconds between its
        FIRST submit and the FIRST of its jobs handed to a worker, or
        None until both have happened.  The canary plane's
        ``canary_ttfd_seconds`` SLI — the user-visible "how long before
        the fleet started my work" signal that queue depth alone can't
        give.  Snapshot read; monotonic stamps share one clock domain
        (this process), so the difference is exact."""
        sid = str(session_id) if session_id else DEFAULT_SESSION
        t0 = self._first_submit_t.get(sid)
        t1 = self._first_dispatch_t.get(sid)
        if t0 is None or t1 is None:
            return None
        return max(0.0, t1 - t0)

    def session_capacity(self, session_id: Optional[str] = None) -> int:
        """This session's share of :meth:`fleet_capacity`.

        With ≤1 open session (or an unknown id — old single-tenant
        callers) this IS the full fleet capacity.  With concurrent
        tenants it is the weighted share ``total × w/W`` (min 1 while the
        fleet is non-empty, so a light tenant always makes progress),
        clamped by the session's ``max_in_flight`` quota.  The engines'
        in-flight targets read this instead of the raw fleet sum, so N
        searches sharing a fleet size themselves to their shares.
        """
        total = self.fleet_capacity()
        sid = str(session_id) if session_id else DEFAULT_SESSION
        open_s = self._registry.open_sessions()
        mine = next((s for s in open_s if s.session_id == sid), None)
        if mine is None or len(open_s) <= 1:
            cap = total
        elif total <= 0:
            cap = 0
        else:
            weight_sum = sum(s.weight for s in open_s)
            cap = max(1, round(total * mine.weight / weight_sum))
        if mine is not None and mine.max_in_flight is not None:
            cap = min(cap, mine.max_in_flight)
        return cap

    def session_prefetch(self, session_id: Optional[str] = None) -> int:
        """This session's share of :meth:`fleet_prefetch`, proportional
        like :meth:`session_capacity` and clamped so share + prefetch
        never exceeds the session's ``max_in_flight`` quota."""
        total = self.fleet_prefetch()
        sid = str(session_id) if session_id else DEFAULT_SESSION
        open_s = self._registry.open_sessions()
        mine = next((s for s in open_s if s.session_id == sid), None)
        if mine is None or len(open_s) <= 1:
            pre = total
        else:
            weight_sum = sum(s.weight for s in open_s)
            pre = int(total * mine.weight / weight_sum)
        if mine is not None and mine.max_in_flight is not None:
            pre = max(0, min(pre, mine.max_in_flight - self.session_capacity(sid)))
        return pre

    def _admission_check(self, sid: str,
                         cost: float = 1.0) -> Optional[tuple]:
        """Admission control for the WIRE tenant paths (loop thread).

        Returns None to admit, else ``(reason, retry_after_s)`` — the
        429-style verdict ``_handle_client`` turns into a structured
        ``error {code:"admission"}`` frame.  Two independent gates:

        - **saturation** (``admission_queue_factor``): while the
          undispatched backlog exceeds ``factor × live capacity``, taking
          more work only grows queue wait — ``retry_after_s`` estimates
          the excess backlog's drain time at current capacity.
        - **token bucket** (``admission_rate``/``admission_burst``): a
          per-tenant refill-on-read bucket; ``retry_after_s`` is the exact
          time until the needed tokens exist.

        In-process submits bypass this entirely: a master throttling
        itself would deadlock its own gather."""
        f = self._admission_queue_factor
        if f is not None:
            cap = max(1, self.fleet_capacity())
            depth = self._sched.depth()
            if depth + cost > f * cap:
                excess = depth + cost - f * cap
                return "saturated", max(0.1, round(excess / cap, 3))
        rate = self._admission_rate
        if rate is not None and rate > 0:
            burst = (self._admission_burst if self._admission_burst is not None
                     else max(1.0, rate))
            now = time.monotonic()
            tokens, last = self._admission_buckets.get(sid, (burst, now))
            tokens = min(burst, tokens + (now - last) * rate)
            # Debt-based bucket: a batch costing more than the burst is
            # admitted once the bucket is FULL and drives it negative, so
            # later requests wait out the repayment — never a retry_after_s
            # after which the same request would still be rejected.
            need = min(cost, burst)
            if tokens < need:
                self._admission_buckets[sid] = (tokens, now)
                return "rate_limited", max(0.05, round((need - tokens) / rate, 3))
            self._admission_buckets[sid] = (tokens - cost, now)
        return None

    def _inflight_by_session(self) -> Dict[str, int]:
        """Dispatched-unacked job count per session, recomputed from the
        worker table (no drift-prone counters).  Loop-thread exact; from
        other threads a snapshot read with one retry against a mid-copy
        resize, like every other fleet snapshot."""
        counts: Dict[str, int] = {}
        for w in list(self._workers.values()):
            try:
                held = list(w.in_flight)
            except RuntimeError:  # pragma: no cover - resized mid-copy
                held = list(w.in_flight)
            for job_id in held:
                sid = self._job_session.get(job_id, DEFAULT_SESSION)
                counts[sid] = counts.get(sid, 0) + 1
        return counts

    def _deliver_remote(self, sess: SearchSession, frame: Dict[str, Any]) -> bool:
        """Forward a result/fail frame to a wire tenant (loop thread).

        Detached (or broken) owners get the frame parked in the session's
        bounded ``undelivered`` queue, flushed on re-attach.  Returns True
        iff the frame was written to a live owner (False ⇔ parked — the
        journal's ``pk`` flag, so replay re-parks undelivered results)."""
        owner = sess.owner
        if owner is not None:
            try:
                data = encode(frame)
                owner.write(data)
            except Exception:  # connection died; reader cleanup will detach
                sess.owner = None
            else:
                self._note_wire(str(frame.get("type")), len(data))
                return True
        sess.undelivered.append(frame)
        return False

    def fleet_capacity(self) -> int:
        """Total job slots advertised by the LIVE fleet (0 when none).

        The asynchronous engine's default in-flight target: capacity-C
        fleet ⇒ keep C evaluations in flight.  Computed from current
        membership on every call — a worker that disconnects or drains
        leaves the sum immediately, and a late joiner enters it the moment
        its hello is accepted, so elastic fleets resize the engine's
        target without restarts.  Snapshot read — safe from any thread.
        """
        return sum(w.capacity for w in list(self._workers.values())
                   if not w.draining)

    def fleet_prefetch(self) -> int:
        """Total prefetch slots advertised by the LIVE fleet (0 when
        none, and 0 for a fleet of pre-pipelining workers).

        The asynchronous engine adds this to :meth:`fleet_capacity` for its
        default in-flight target: breeding ahead to ``capacity + prefetch``
        is what keeps every worker's local ready-queue non-empty, so a
        finished window starts the next one without waiting out a
        results→breed→dispatch round trip.  Draining workers are excluded
        like disconnected ones.  Snapshot read — safe from any thread.
        """
        return sum(w.prefetch_depth for w in list(self._workers.values())
                   if not w.draining)

    def fleet_members(self) -> int:
        """Number of connected workers, draining included (they still hold
        a live connection until their in-flight results land).  Snapshot
        read — safe from any thread."""
        return len(self._workers)

    def fleet_preemptible(self) -> int:
        """Number of LIVE (non-draining) workers advertising preemptible
        capacity.  The autoscaler's churn gauge and the placement plane's
        existence check share this read.  Snapshot read — safe from any
        thread."""
        return sum(1 for w in list(self._workers.values())
                   if w.preemptible and not w.draining)

    def fleet_mesh_pop(self) -> int:
        """Largest pop-axis size advertised by the LIVE fleet (1 when no
        worker advertised a mesh).

        The master-side half of mesh-aware dispatch: a host-level mesh
        worker pads every evaluation window up to its pop-axis multiple,
        so batch sizing that rounds to this multiple (speculative fill,
        ``DistributedPopulation._fill_target``) turns would-be padding
        waste into paid-for work.  Max — not LCM — across a heterogeneous
        fleet: aligning to the widest mesh keeps the biggest worker
        waste-free and costs the narrow ones nothing (their multiple
        divides the bucket shapes anyway on power-of-two hosts).
        Snapshot read — safe from any thread.
        """
        pops = [int((w.mesh or {}).get("pop", 1))
                for w in list(self._workers.values()) if not w.draining]
        return max([1] + [p for p in pops if p > 0])

    def fleet_chips(self) -> int:
        """Total accelerator chips advertised by the connected workers (≥1).

        Each worker's ``hello`` carries its ``n_chips`` (global device count
        for a multi-host worker, 1 for non-jax species), so the master can
        log the TRUE individuals/hour/chip for exactly the deployment the
        metric was designed for.  Snapshot read — safe from any thread.
        """
        return max(1, sum(w.n_chips for w in list(self._workers.values())))

    def reset_chips_seen(self) -> None:
        """Start a fresh per-sweep chip-count observation window."""
        with self._cond:
            self._chips_seen = 0

    def chips_seen(self) -> int:
        """The sweep's per-chip denominator (≥1): max of the CURRENT fleet
        chip total and any total observed at a result arrival since the last
        :meth:`reset_chips_seen`.  Counts both a worker that delivered its
        last result and disconnected before the end-of-sweep snapshot, and a
        late-joining worker that hasn't delivered yet."""
        with self._cond:
            return max(self._chips_seen, self.fleet_chips())

    @property
    def epoch(self) -> int:
        """The dispatch journal's epoch: 0 without a journal, one more at
        every restart from it."""
        return self._epoch

    def unknown_jobs(self, job_ids, timeout: float = 10.0) -> Optional[Set[str]]:
        """The ids among ``job_ids`` this broker holds nothing for: not
        queued, not in flight, no result or failure waiting; None while it
        is not serving.  Read on the loop thread, where a result moves from
        in flight to the results table within one callback, so a job in
        transit is never reported."""
        want = set(job_ids)
        if not self._started.is_set():
            return None
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def probe() -> None:
            with self._cond:
                done = {j for j in want if j in self._results or j in self._failures}
            fut.set_result({j for j in want - done if j not in self._payloads})

        self._loop.call_soon_threadsafe(probe)
        return fut.result(timeout=timeout)

    def outstanding(self) -> Dict[str, int]:
        """Sizes of every master-side job-state structure; all zero ⇔ the
        broker is quiescent (no open jobs, no undelivered results, no
        attempt counts).  The chaos suite asserts this after every final
        gather: at-least-once redelivery + dedup must leave ZERO state
        behind whatever faults fired mid-search.  Snapshot read (len only),
        safe from any thread.
        """
        with self._cond:
            results, failures = len(self._results), len(self._failures)
        return {
            "payloads": len(self._payloads),
            "pending": self._sched.depth(),
            "fail_counts": len(self._fail_counts),
            "results": results,
            "failures": failures,
            # Session tenancy maps share the _payloads lifecycle: nonzero
            # after a final gather means a pop site was missed.
            "job_sessions": len(self._job_session),
            "crash_counts": len(self._crash_counts),
            # Wire records share it too (encode-once fast path): a leak
            # here would pin payload bytes past job completion.
            "job_wires": len(self._job_wire),
            # Pack-held jobs are neither queued nor in flight; the linger
            # deadline bounds how long one may sit here, so at quiescence
            # this too must be zero.
            "packed_held": self._packer.held if self._packer is not None else 0,
        }

    @staticmethod
    def new_job_id() -> str:
        return uuid.uuid4().hex

    @staticmethod
    def _parse_prefetch(hello: Dict[str, Any], capacity: int) -> int:
        """The worker's advertised ``prefetch_depth``, validated and capped.

        Missing (old worker) or malformed values degrade to 0 — the
        pre-pipelining credit flow — never to a dropped connection.  The
        cap (4 × capacity) bounds how much of the queue one worker can
        hoard: prefetch hides one results→breed→dispatch round trip, so
        depth beyond a few windows only starves the rest of the fleet.
        """
        try:
            depth = int(hello.get("prefetch_depth", 0))
        except (TypeError, ValueError):
            return 0
        return max(0, min(depth, 4 * capacity))

    @staticmethod
    def _parse_homes(hello: Dict[str, Any]) -> int:
        """The worker's OPTIONAL multi-home advertisement (protocol.py
        "Multi-home field"): how many broker shards it joined.  Missing
        (every single-homed worker — the field is only sent when >1) or
        malformed degrades to 1, never a dropped connection."""
        try:
            homes = int(hello.get("homes", 1))
        except (TypeError, ValueError):
            return 1
        return max(1, homes)

    @staticmethod
    def _parse_mesh(msg: Dict[str, Any]) -> Optional[Dict[str, int]]:
        """The worker's OPTIONAL host-mesh advertisement, validated.

        Expects ``{"pop": P, "data": D, "devices": N}`` with positive
        ints (``devices`` may be 0 = unknown).  Advisory observability
        data — malformed values degrade to None (no mesh recorded), never
        drop the worker, same convention as ``n_chips``.
        """
        mesh = msg.get("mesh")
        if not isinstance(mesh, dict):
            return None
        try:
            pop = int(mesh.get("pop", 1))
            data = int(mesh.get("data", 1))
            devices = int(mesh.get("devices", 0))
        except (TypeError, ValueError):
            return None
        if pop < 1 or data < 1 or devices < 0:
            return None
        return {"pop": pop, "data": data, "devices": devices}

    # -- loop-thread internals --------------------------------------------

    def _update_flow_gauges(self) -> None:
        """Refresh the tail-regime flow gauges (loop thread, telemetry on).

        ``jobs_in_flight`` (jobs handed to workers, unacked) is the gauge
        the async-mode acceptance test samples: a capacity-C fleet under
        the steady-state engine must sustain it at ≥ C.  ``queue_depth``
        is the undispatched backlog; ``broker_queue_depth`` is kept as an
        alias for pre-existing dashboards.
        """
        reg = _get_registry()
        reg.gauge("jobs_in_flight").set(
            sum(len(w.in_flight) for w in self._workers.values()))
        depth = self._sched.depth()
        reg.gauge("queue_depth").set(depth)
        reg.gauge("broker_queue_depth").set(depth)
        # Per-tenant twins (labels): only emitted once a session table
        # exists, so single-tenant dashboards see no new series.
        sessions = self._registry.list()
        if sessions:
            inflight = self._inflight_by_session()
            for s in sessions:
                if s.tag == "canary":
                    # Probe sessions are invisible to tenant-facing SLI
                    # series: no per-session flow gauges (the canary plane
                    # publishes its own canary_* instruments instead).
                    continue
                sid = s.session_id
                reg.gauge("session_in_flight", session=sid).set(inflight.get(sid, 0))
                reg.gauge("session_queue_depth", session=sid).set(
                    self._sched.session_depth(sid))
        # Dispatched jobs beyond the workers' evaluation capacity are (from
        # the broker's vantage) sitting in worker-local ready-queues — the
        # double-buffering inventory.  Persistently 0 with prefetching
        # workers connected means the ENGINE is the bottleneck (not breeding
        # ahead fast enough); pinned at fleet_prefetch() means workers never
        # drain their queues (compute-bound — prefetch is pure win).
        reg.gauge("prefetch_queue_depth").set(
            sum(max(0, len(w.in_flight) - w.capacity)
                for w in self._workers.values()))

    def job_prefers_preemptible(self, job_id: str) -> bool:
        """Placement class of one open job: True ⇔ preemptible-preferred.

        Exactly the ASHA economics (DISTRIBUTED.md "Autoscaling &
        preemptible capacity"): a rung-0 small-class probe is cheap and
        fully requeue-able, so losing its worker mid-train costs one cheap
        retrain — route it to capacity that may vanish.  A high-rung
        promotion (rung ≥ 1) or a big/micro-class genome embodies real
        chip-seconds (or an axis-split program that must not thrash), so
        it pins to stable members.  Size class is judged worker-
        independently (``n_devices=1``) — a placement class must not
        change with whichever worker happens to be asking.  Pure dict
        reads plus the memoized :func:`job_size_class`; the per-decision
        cost is gated ≤ 2% of a dispatch by scripts/broker_throughput.py
        ``run_placement_gate``.
        """
        pl = self._payloads.get(job_id)
        if pl is None:  # defensive: racing a cancel — class is moot
            return False
        if (pl.get("fidelity") or {}).get("rung", 0):
            return False
        return job_size_class(pl.get("additional_parameters")) == SIZE_SMALL

    def _placeable_for(self, worker_preemptible: bool):
        """The ``pop_next`` placement filter for one worker's class."""
        if worker_preemptible:
            return self.job_prefers_preemptible
        return lambda job_id: not self.job_prefers_preemptible(job_id)

    def _dispatch(self) -> None:
        """Hand pending jobs to workers with spare credit (competing consumers).

        Everything a worker's credit allows goes out as ONE ``jobs`` frame —
        credit-based prefetch.  The worker never guesses (with a read
        timeout) whether more of its batch is still in flight: a capacity-8
        worker gets its 8 jobs in a single frame whatever the DCN latency.

        Job ORDER comes from the fair-share scheduler: weighted deficit
        round-robin across sessions, with per-session ``max_in_flight``
        quotas enforced here (a quota-full session's jobs stay queued and
        its turn passes to the others — work conservation).

        In a mixed stable+preemptible fleet the pass is also placement-
        aware: each worker only takes jobs of its class (rung-0 small
        probes → preemptible, everything else → stable), and the pass
        repeats while it makes progress so a head-of-queue job unblocked
        mid-pass still reaches a worker visited earlier.

        With cross-session window packing on (``pack_windows=True``) the
        whole pass is delegated to :meth:`_dispatch_packed` — the branch
        sits BEFORE the empty-queue fast return because the packer may
        hold linger-due jobs even when the scheduler is drained.
        """
        if self._packer is not None:
            self._dispatch_packed()
            return
        if self._sched.depth() == 0:
            return
        tele = _tele.enabled()
        ops = _health.enabled()
        jrn = self._journal
        # Quota eligibility is computed once and tracked incrementally
        # through this pass; the next _dispatch recomputes from the worker
        # table, so the count can never drift.
        inflight = self._inflight_by_session()
        sessions = self._registry.list()
        quotas = {s.session_id: s.max_in_flight
                  for s in sessions if s.max_in_flight is not None}
        # Canary probe sessions stay out of tenant-facing SLI series
        # (per-session queue_wait_s below, flow gauges in
        # _update_flow_gauges); built once per pass from the same registry
        # snapshot the quota table already walks.
        canary_sids = {s.session_id for s in sessions if s.tag == "canary"}

        def eligible(sid: str) -> bool:
            quota = quotas.get(sid)
            return quota is None or inflight.get(sid, 0) < quota

        exhausted = False  # no session has a dispatchable job left
        workers = list(self._workers.values())
        # Placement-aware dispatch (protocol.py "Preemptible-capacity
        # field") activates only for a MIXED live fleet: with both classes
        # present, rung-0 small-class probes route to preemptible members
        # and everything else pins to stable.  A homogeneous fleet takes
        # every job wherever there is credit — the "fallback to any
        # capacity when a class has none" rule, and what keeps the
        # stable-only path byte-identical to the pre-placement broker.
        placement_on = (
            any(w.preemptible for w in workers if not w.draining)
            and any(not w.preemptible for w in workers if not w.draining))
        while True:
            progress = False
            for w in workers:
                if exhausted:
                    break
                if w.draining:  # orderly exit in progress: never hand it work
                    continue
                placeable = (self._placeable_for(w.preemptible)
                             if placement_on else None)
                batch: List[tuple] = []  # (job_id, JobWire)
                batch_bytes = 0
                use_jobs2 = "jobs2" in w.caps
                # Keep each frame well under the protocol cap: submit() bounds
                # single jobs, but a large-capacity worker's combined batch could
                # exceed it — flush into multiple `jobs` frames when needed (the
                # client reads frames one per consume-loop iteration).
                soft_cap = MAX_MESSAGE_BYTES // 2
                while w.credit > 0:
                    nxt = self._sched.pop_next(
                        eligible, lambda j: j in self._payloads, placeable)
                    if nxt is None:
                        # Nothing queued / every session quota-full — or,
                        # with placement on, every queue head pinned to the
                        # OTHER class.  Only the class-blind read proves the
                        # whole pass is done.
                        if placeable is None:
                            exhausted = True
                        break
                    progress = True
                    sid, job_id = nxt
                    w.credit -= 1
                    w.in_flight.add(job_id)
                    inflight[sid] = inflight.get(sid, 0) + 1
                    if sid not in self._first_dispatch_t:
                        # TTFD landing stamp: this session's first handoff.
                        self._first_dispatch_t[sid] = time.monotonic()
                    if jrn is not None:
                        # THE hot-path journal record: a pre-formatted string
                        # append; fsync is the journal task's, never ours.
                        jrn.record_dispatch(job_id)
                    # Size-class dispatch accounting (big-genome regime,
                    # docs/OBSERVABILITY.md): one labeled counter bump per
                    # handoff.  job_size_class is jax-free integer math on the
                    # payload config — its cost share of a dispatch is gated
                    # at <= 2% by scripts/broker_throughput.py.
                    _get_registry().counter(
                        "jobs_dispatched_total",
                        genome_size_class=job_size_class(
                            self._payloads[job_id].get("additional_parameters"),
                            int((w.mesh or {}).get("devices") or 1)),
                    ).inc()
                    if tele:
                        # queue_wait: time from (re)enqueue to handoff.  The
                        # stamp stays in place — _on_result uses it for the
                        # end-to-end job span.
                        attrs = {"worker": w.worker_id}
                        if sid != DEFAULT_SESSION:
                            attrs["session"] = sid
                        t_enq = self._tele_enqueued.get(job_id)
                        if t_enq is not None:
                            wait = time.monotonic() - t_enq
                            _tele.record_span(
                                "queue_wait", t_enq, wait,
                                trace=self._payloads[job_id].get("trace"),
                                attrs=attrs,
                            )
                            # The registry twin of the span: a per-job wait
                            # histogram dashboards can read without span
                            # post-processing (tail-regime pressure signal).
                            # Session-labeled only for tenant jobs, so the
                            # single-tenant series name never changes; canary
                            # probes are excluded entirely (their waits are
                            # the canary plane's own SLIs, never a tenant's).
                            if sid in canary_sids:
                                pass
                            elif sid != DEFAULT_SESSION:
                                _get_registry().histogram(
                                    "queue_wait_s", session=sid).observe(wait)
                            else:
                                _get_registry().histogram("queue_wait_s").observe(wait)
                        # dispatch_rtt_s starts here: handoff to the worker.
                        self._tele_dispatched[job_id] = time.monotonic()
                    if _lineage.enabled():
                        pl = self._payloads[job_id]
                        _lineage.record(
                            "dispatched", self._job_genome.get(job_id),
                            job=job_id, worker=w.worker_id,
                            rung=(pl.get("fidelity") or {}).get("rung", 0),
                            session=sid if sid != DEFAULT_SESSION else None)
                    if ops:
                        # Same clock start as dispatch_rtt_s: the watchdog
                        # measures handoff → now against its rolling threshold.
                        self._watchdog.job_started(
                            job_id, w.worker_id,
                            session=sid if sid != DEFAULT_SESSION else None)
                    # Encode-once fast path: the entry bytes were assembled at
                    # enqueue (or on a previous dispatch of this very job) and
                    # size the split AND join the frame — a requeued job costs
                    # zero serialization here.
                    jw = self._job_wire.get(job_id)
                    if jw is None:  # defensive: open job without a record
                        jw = build_job_wire(job_id, self._payloads[job_id],
                                            self._job_genome.get(job_id)
                                            or genome_key(self._payloads[job_id].get("genes")),
                                            self._frag_cache)
                        self._job_wire[job_id] = jw
                    entry_bytes = len(jw.v1)
                    if batch and batch_bytes + entry_bytes > soft_cap:
                        self._flush_batch(w, batch, use_jobs2)
                        batch, batch_bytes = [], 0
                    batch.append((job_id, jw))
                    batch_bytes += entry_bytes
                if batch:
                    self._flush_batch(w, batch, use_jobs2)
            # One pass is the whole story for a class-blind fleet.  A mixed
            # fleet repeats while the pass made progress: a preemptible pop
            # can expose a stable-pinned job mid-pass (and vice versa) for a
            # worker the iteration already visited.
            if not placement_on or exhausted or not progress:
                break
        if tele:
            self._update_flow_gauges()

    # -- cross-session window packing (packing.py) ---------------

    def _pack_key(self, job_id: str) -> tuple:
        """The compile-compatibility key for one open job:
        ``(pack_envelope(env), job_size_class)`` — serialized static
        config + fidelity bytes, plus the genome size class.  Equal keys
        ⇒ the jobs compile to the same program and may share a window
        (purity argument: DISTRIBUTED.md "Cross-session window packing").
        """
        jw = self._job_wire.get(job_id)
        if jw is None:  # defensive: open job without a wire record
            jw = build_job_wire(job_id, self._payloads[job_id],
                                self._job_genome.get(job_id)
                                or genome_key(self._payloads[job_id].get("genes")),
                                self._frag_cache)
            self._job_wire[job_id] = jw
        sclass = job_size_class(
            self._payloads[job_id].get("additional_parameters"))
        return (pack_envelope(jw.env), sclass)

    def _pack_step(self, w: _Worker, size_class: str) -> int:
        """The packed-window target size for (worker, size class): the
        worker's capacity, mesh-aligned EXACTLY like the client's
        ``_chunk_jobs`` (round down to a multiple of the pop axis, floor
        at one row) so a packed frame is one evaluation chunk — never
        re-split worker-side.  Big/micro genomes never pack: the chunker
        makes them singleton windows, so the broker does too."""
        if size_class != SIZE_SMALL:
            return 1
        step = max(1, int(w.capacity))
        pop = int((w.mesh or {}).get("pop") or 1)
        if pop > 1 and step % pop:
            step = max(pop, step - step % pop)
        return step

    def _dispatch_packed(self) -> None:
        """The pack-mode dispatch pass: FILL then FLUSH then re-arm.

        FILL drains the fair-share scheduler into the packer's
        compatibility groups — through ``pop_next``, so the weighted DRR
        deficit is charged job-by-job in exactly the order an unpacked
        dispatch would have charged it, and session quotas count
        packer-held jobs as in flight.  Fill is bounded by the fleet's
        spare credit: with no worker able to take a window there is no
        reason to pull work out of the (observable, fair) queue.

        FLUSH hands each worker whole windows: a group ships when it can
        fill the worker's mesh-aligned capacity (``_pack_step``) or when
        its oldest job has lingered past the deadline — a lone
        latency-sensitive job never waits for fill beyond
        ``pack_linger_ms``.  In a mixed stable+preemptible fleet a group
        only lands on its placement class (rung-0 small probes →
        preemptible), same rule as the unpacked pass.

        Whatever still waits on its linger deadline re-arms the loop
        timer (:meth:`_arm_pack_timer`); a due-but-creditless group
        flushes on the next ready-triggered dispatch instead.
        """
        packer = self._packer
        now = time.monotonic()
        workers = [w for w in self._workers.values() if not w.draining]
        # -- fill ----------------------------------------------------------
        if self._sched.depth():
            spare = sum(w.credit for w in workers)
            inflight = self._inflight_by_session()
            for sid, n in packer.held_by_session().items():
                inflight[sid] = inflight.get(sid, 0) + n
            quotas = {s.session_id: s.max_in_flight
                      for s in self._registry.list()
                      if s.max_in_flight is not None}

            def eligible(sid: str) -> bool:
                quota = quotas.get(sid)
                return quota is None or inflight.get(sid, 0) < quota

            while packer.held < spare:
                nxt = self._sched.pop_next(
                    eligible, lambda j: j in self._payloads, None)
                if nxt is None:
                    break
                sid, job_id = nxt
                inflight[sid] = inflight.get(sid, 0) + 1
                key = self._pack_key(job_id)
                packer.add(sid, job_id, key, key[1],
                           self.job_prefers_preemptible(job_id), now)
        # -- flush ---------------------------------------------------------
        placement_on = (any(w.preemptible for w in workers)
                        and any(not w.preemptible for w in workers))
        while True:
            progress = False
            for w in workers:
                if w.credit <= 0:
                    continue
                for g in packer.groups():
                    if w.credit <= 0:
                        break
                    if not g.jobs:
                        continue
                    if placement_on and g.prefers_preemptible != w.preemptible:
                        continue
                    step = self._pack_step(w, g.size_class)
                    due = (now - g.arrivals[0]) >= packer.linger_s
                    if len(g.jobs) < step and not due:
                        continue
                    window = packer.take(g, min(len(g.jobs), step, w.credit),
                                         step, now)
                    if window:
                        self._send_packed_window(w, window, g.key[0])
                        progress = True
            if not progress:
                break
        self._arm_pack_timer(now)
        if _tele.enabled():
            self._update_flow_gauges()

    def _send_packed_window(self, w: _Worker, window: List[tuple],
                            pack_env: tuple) -> None:
        """Per-job dispatch bookkeeping + ONE packed frame.

        The per-job half mirrors the unpacked ``_dispatch`` body line for
        line — journal dispatch record, size-class counter, queue-wait
        span + histogram, dispatch-RTT stamp, lineage, watchdog — so every
        demux path downstream (result, requeue, quarantine, replay) keeps
        its session attribution untouched.  The frame half ships the whole
        window as one ``packed: true`` frame: ``jobs2`` workers get the
        compile envelope hoisted with per-job session/trace in the entries
        (``packed_entry2``), v1 workers get the session-tagged v1 entries.
        """
        tele = _tele.enabled()
        ops = _health.enabled()
        jrn = self._journal
        packer = self._packer
        reg = _get_registry()
        canary_sids = {s.session_id for s in self._registry.list()
                       if s.tag == "canary"}
        batch: List[JobWire] = []
        for sid, job_id in window:
            w.credit -= 1
            w.in_flight.add(job_id)
            if sid not in self._first_dispatch_t:
                self._first_dispatch_t[sid] = time.monotonic()
            if jrn is not None:
                jrn.record_dispatch(job_id)
            reg.counter(
                "jobs_dispatched_total",
                genome_size_class=job_size_class(
                    self._payloads[job_id].get("additional_parameters"),
                    int((w.mesh or {}).get("devices") or 1)),
            ).inc()
            if sid not in canary_sids:
                reg.counter("packed_jobs_total", session=sid).inc()
            if tele:
                attrs = {"worker": w.worker_id}
                if sid != DEFAULT_SESSION:
                    attrs["session"] = sid
                t_enq = self._tele_enqueued.get(job_id)
                if t_enq is not None:
                    wait = time.monotonic() - t_enq
                    _tele.record_span(
                        "queue_wait", t_enq, wait,
                        trace=self._payloads[job_id].get("trace"),
                        attrs=attrs,
                    )
                    if sid in canary_sids:
                        pass  # canary probes never feed tenant SLI series
                    elif sid != DEFAULT_SESSION:
                        reg.histogram("queue_wait_s", session=sid).observe(wait)
                    else:
                        reg.histogram("queue_wait_s").observe(wait)
                self._tele_dispatched[job_id] = time.monotonic()
            if _lineage.enabled():
                pl = self._payloads[job_id]
                _lineage.record(
                    "dispatched", self._job_genome.get(job_id),
                    job=job_id, worker=w.worker_id,
                    rung=(pl.get("fidelity") or {}).get("rung", 0),
                    session=sid if sid != DEFAULT_SESSION else None)
            if ops:
                self._watchdog.job_started(
                    job_id, w.worker_id,
                    session=sid if sid != DEFAULT_SESSION else None)
            jw = self._job_wire.get(job_id)
            if jw is None:  # defensive: open job without a record
                jw = build_job_wire(job_id, self._payloads[job_id],
                                    self._job_genome.get(job_id)
                                    or genome_key(self._payloads[job_id].get("genes")),
                                    self._frag_cache)
                self._job_wire[job_id] = jw
            batch.append(jw)
        # Defensive oversize split at the same soft cap as _dispatch; a
        # window is at most one capacity of few-KB genomes, so in practice
        # this is always a single frame (and every part stays <= the
        # window, so the worker-side no-resplit assertion holds per frame).
        soft_cap = MAX_MESSAGE_BYTES // 2
        parts: List[List[JobWire]] = []
        cur: List[JobWire] = []
        cur_bytes = 0
        for jw in batch:
            if cur and cur_bytes + len(jw.v1) > soft_cap:
                parts.append(cur)
                cur, cur_bytes = [], 0
            cur.append(jw)
            cur_bytes += len(jw.v1)
        parts.append(cur)
        self._encode_samples += 1
        sample = (self._encode_samples & 63) == 0
        t0 = time.perf_counter() if sample else 0.0
        if "jobs2" in w.caps:
            frames = [("jobs2", jobs2_frame(
                pack_env, [packed_entry2(jw) for jw in part], packed=True))
                for part in parts]
        else:
            frames = [("jobs", jobs_frame([jw.v1 for jw in part], packed=True))
                      for part in parts]
        if sample:
            self._note_encode(time.perf_counter() - t0)
        for mtype, data in frames:
            try:
                if self._injector is not None and \
                        self._injector.broker_send(w, decode(data)):
                    continue
                w.writer.write(data)
            except Exception:  # connection already broken; reader cleans up
                logger.debug("write to worker %s failed", w.worker_id,
                             exc_info=True)
                continue
            self._note_wire(mtype, len(data))
        reg.counter("packed_windows_total").inc()
        reg.histogram("pack_fill_ratio").observe(packer.fill_ratios[-1])
        reg.histogram("pack_linger_seconds").observe(packer.lingers[-1])

    def _arm_pack_timer(self, now: float) -> None:
        """(Re)arm the loop timer for the earliest linger deadline.

        Only future deadlines get a precise timer.  A deadline already in
        the past here means the flush pass just declined the window (no
        credit / wrong placement class); the next worker `ready` triggers
        a dispatch anyway, and a linger-cadence backstop poll guarantees
        a lone held job never waits on worker timing alone.
        """
        if self._pack_timer is not None:
            self._pack_timer.cancel()
            self._pack_timer = None
        deadline = self._packer.next_deadline()
        if deadline is None or self._loop is None:
            return
        delay = deadline - now
        if delay <= 0:
            delay = max(self._packer.linger_s, 0.01)
        self._pack_timer = self._loop.call_later(delay, self._pack_timer_fire)

    def _pack_timer_fire(self) -> None:
        self._pack_timer = None
        if not self._stopping:
            self._dispatch()

    def pack_stats(self) -> Optional[Dict[str, Any]]:
        """Pack-plane snapshot (``None`` when ``pack_windows=False``):
        windows/jobs/cross-session totals, currently-held count, and
        fill-ratio + linger percentile distributions.  Also surfaced in
        ``/statusz`` under ``fleet.packing`` for gentun_top."""
        if self._packer is None:
            return None
        return self._packer.snapshot()

    def _send(self, w: _Worker, msg: Dict[str, Any]) -> None:
        try:
            if self._injector is not None and self._injector.broker_send(w, msg):
                return
            data = encode(msg)
            w.writer.write(data)
        except Exception:  # connection already broken; reader will clean up
            logger.debug("write to worker %s failed", w.worker_id, exc_info=True)
            return
        self._note_wire(str(msg.get("type")), len(data))

    def _flush_batch(self, w: _Worker, batch: List[tuple],
                     use_jobs2: bool) -> None:
        """Send one dispatch batch as pre-assembled frame bytes.

        v1 workers get a single ``jobs`` frame, byte-identical to the
        pre-fast-path ``encode({"type": "jobs", "jobs": [...]})``.  A
        ``jobs2`` worker gets one frame per distinct shared envelope — one
        frame in the common case of a homogeneous window, and never a merge
        of jobs that don't share their envelope.  Frame assembly is sampled
        1-in-64 into ``frame_encode_seconds``; with a fault injector
        installed, the typed dict the injector contracts on is recovered by
        decoding the frame (cold path only — injectors are a test harness).
        """
        # 1-in-N histogram sampling: a perf_counter pair per sampled frame,
        # a single int test otherwise (memoize-or-die, run_wire_gate).
        self._encode_samples += 1
        sample = (self._encode_samples & 63) == 0
        t0 = time.perf_counter() if sample else 0.0
        if not use_jobs2:
            frames = [("jobs", jobs_frame([jw.v1 for _, jw in batch]))]
        else:
            groups: Dict[tuple, list] = {}
            order: List[tuple] = []
            for _, jw in batch:
                g = groups.get(jw.env)
                if g is None:
                    groups[jw.env] = g = []
                    order.append(jw.env)
                g.append(jw.entry2)
            frames = [("jobs2", jobs2_frame(env, groups[env])) for env in order]
        if sample:
            self._note_encode(time.perf_counter() - t0)
        for mtype, data in frames:
            try:
                if self._injector is not None and \
                        self._injector.broker_send(w, decode(data)):
                    continue
                w.writer.write(data)
            except Exception:  # connection already broken; reader cleans up
                logger.debug("write to worker %s failed", w.worker_id,
                             exc_info=True)
                continue
            self._note_wire(mtype, len(data))

    def _note_wire(self, mtype: str, nbytes: int) -> None:
        """Bump the per-frame-type wire counters through memoized handles."""
        handles = self._wire_counters.get(mtype)
        if handles is None:
            reg = _get_registry()
            handles = (reg.counter("wire_bytes_sent_total", type=mtype),
                       reg.counter("wire_frames_sent_total", type=mtype))
            self._wire_counters[mtype] = handles
        handles[0].inc(nbytes)
        handles[1].inc()

    def _note_encode(self, seconds: float) -> None:
        if self._encode_hist is None:
            self._encode_hist = _get_registry().histogram(
                "frame_encode_seconds", side="broker")
        self._encode_hist.observe(seconds)

    def _requeue_worker_jobs(self, w: _Worker, reason: str) -> None:
        tele = _tele.enabled()
        ops = _health.enabled()
        crash_cap = self._quarantine_crash_requeues
        for job_id in sorted(w.in_flight):
            if ops:
                self._watchdog.job_removed(job_id)
            if job_id in self._payloads:
                sid = self._job_session.get(job_id, DEFAULT_SESSION)
                if crash_cap is not None and reason == "disconnect":
                    # Crash isolation (opt-in): a job whose worker keeps
                    # dying mid-evaluation is most likely KILLING them.
                    # After crash_cap redeliveries it fails terminally and
                    # its genome is quarantined in its session, so one
                    # poison genome cannot crash-loop the fleet for every
                    # tenant.  Default None = unbounded AMQP redelivery.
                    n = self._crash_counts.get(job_id, 0) + 1
                    self._crash_counts[job_id] = n
                    if n >= crash_cap:
                        logger.error(
                            "job %s crashed its worker %d time(s); failing "
                            "terminally and quarantining its genome", job_id, n)
                        self._fail_terminal(
                            job_id,
                            f"worker crashed {n} time(s) while evaluating",
                            force_quarantine=True)
                        continue
                logger.warning("requeue job %s (%s, worker %s)", job_id, reason, w.worker_id)
                if self._journal is not None:
                    self._journal.record_requeue(job_id)
                # Disconnect redelivery is unbounded, like AMQP's.  This
                # covers the worker's whole in-flight set — the jobs it was
                # evaluating AND the ones still queued-but-unstarted in its
                # local prefetch queue (the broker cannot tell them apart,
                # and at-least-once makes the distinction irrelevant).
                self._sched.push(sid, job_id)
                sess = self._registry.peek(sid)
                if sess is not None:
                    sess.requeued += 1
                if _lineage.enabled():
                    _lineage.record(
                        "requeued", self._job_genome.get(job_id),
                        job=job_id, worker=w.worker_id, reason=reason,
                        session=sid if sid != DEFAULT_SESSION else None)
                if tele:
                    # Restart the clock: queue_wait/job measure time since
                    # the LAST enqueue, not since first submission.
                    self._tele_enqueued[job_id] = time.monotonic()
                self._tele_dispatched.pop(job_id, None)
        w.in_flight.clear()
        if tele:
            self._update_flow_gauges()

    def _fail_terminal(self, job_id: str, reason: str,
                       force_quarantine: bool = False) -> None:
        """Terminal failure: close the job's state, count its genome toward
        (or force) per-session quarantine, surface the failure to the
        session's owner.  Loop thread only."""
        if self._payloads.pop(job_id, None) is None:
            return
        self._job_wire.pop(job_id, None)
        sid = self._job_session.pop(job_id, DEFAULT_SESSION)
        gk = self._job_genome.pop(job_id, None)
        self._crash_counts.pop(job_id, None)
        self._fail_counts.pop(job_id, None)
        self._tele_enqueued.pop(job_id, None)
        self._tele_dispatched.pop(job_id, None)
        if self._journal is not None:
            self._journal.record_fail(job_id, reason)
        sess = self._registry.peek(sid)
        if sess is not None:
            # Quarantine bookkeeping (poison counts, counter, telemetry
            # event, lineage entry) lives with the session's books.
            newly_quarantined = sess.record_terminal_failure(
                gk, self._registry.quarantine_after,
                force_quarantine=force_quarantine)
            if newly_quarantined and self._journal is not None and gk:
                self._journal.record_quarantine(sid, gk)
        if _tele.enabled():
            self._update_flow_gauges()
        if sess is not None and sess.remote:
            self._deliver_remote(sess, {"type": "fail", "session": sid,
                                        "job_id": job_id, "reason": reason})
        else:
            with self._cond:
                self._failures[job_id] = reason
                self._cond.notify_all()

    async def _reaper(self) -> None:
        """Declare silent workers holding jobs dead; requeue their jobs."""
        while not self._stopping:
            await asyncio.sleep(self._heartbeat_timeout / 3.0)
            now = time.monotonic()
            for w in list(self._workers.values()):
                if w.in_flight and now - w.last_seen > self._heartbeat_timeout:
                    logger.warning("worker %s missed heartbeats; dropping", w.worker_id)
                    w.writer.close()  # triggers cleanup in _handle_worker

    async def _watchdog_loop(self) -> None:
        """Beat the broker's liveness source and sweep for stragglers.

        Separate from :meth:`_reaper` because the cadences differ by an
        order of magnitude: the reaper runs at heartbeat scale (seconds to
        tens of seconds), the watchdog must flag within a fraction of its
        floor.  While the ops plane is off each pass is one bool read and
        a sleep.
        """
        while not self._stopping:
            await asyncio.sleep(self._watchdog_interval)
            if _health.enabled():
                _health.beat("broker_loop")
                self._watchdog.check()

    def _on_straggler(self, info: Dict[str, Any]) -> None:
        """Watchdog requeue hook (``straggler_requeue=True``).  May fire
        from the loop thread (watchdog sweep) or an HTTP handler thread
        (healthz-triggered check); the mutation hops to the loop thread
        either way — broker state stays single-threaded."""
        loop = self._loop
        if loop is not None:
            loop.call_soon_threadsafe(self._requeue_straggler, info)

    def _requeue_straggler(self, info: Dict[str, Any]) -> None:
        job_id = str(info.get("job_id"))
        if job_id not in self._payloads or self._sched.queued(job_id):
            return  # finished/cancelled/already requeued since flagging
        holder = next((w for w in self._workers.values() if job_id in w.in_flight), None)
        if holder is None:
            return  # the worker vanished; disconnect cleanup already requeued
        logger.warning(
            "requeue straggler job %s (worker %s, in flight %.1fs > %.1fs threshold)",
            job_id, holder.worker_id, info.get("age_s", -1.0),
            info.get("threshold_s", -1.0))
        # The stalled worker's credit stays consumed: it is not accepting
        # new work anyway, and its late result is dropped by the payload
        # membership check like any redelivery duplicate.
        holder.in_flight.discard(job_id)
        sid = self._job_session.get(job_id, DEFAULT_SESSION)
        if self._journal is not None:
            self._journal.record_requeue(job_id)
        self._sched.push(sid, job_id)
        sess = self._registry.peek(sid)
        if sess is not None:
            sess.requeued += 1
        self._watchdog.job_removed(job_id)
        self._tele_dispatched.pop(job_id, None)
        if _tele.enabled():
            self._tele_enqueued[job_id] = time.monotonic()
        labels = {"worker": holder.worker_id}
        if sid != DEFAULT_SESSION:
            labels["session"] = sid
        _get_registry().counter("stragglers_requeued_total", **labels).inc()
        _tele.record_event("straggler_requeued", {
            "job_id": job_id, "worker_id": holder.worker_id, "session": sid,
            "age_s": info.get("age_s"), "threshold_s": info.get("threshold_s"),
        })
        if _lineage.enabled():
            _lineage.record(
                "requeued", self._job_genome.get(job_id),
                job=job_id, worker=holder.worker_id, reason="straggler",
                session=sid if sid != DEFAULT_SESSION else None)
        self._dispatch()

    def _ops_status(self) -> Dict[str, Any]:
        """The ``/statusz`` "fleet" block (registered as a status
        provider).  Snapshot reads from an HTTP thread, same discipline as
        :meth:`fleet_capacity`: list() the worker table, read scalars —
        never mutate."""
        now = time.monotonic()
        workers = [{
            "worker_id": w.worker_id,
            "capacity": w.capacity,
            "prefetch_depth": w.prefetch_depth,
            "credit": w.credit,
            "jobs_in_flight": len(w.in_flight),
            "last_seen_age_s": round(now - w.last_seen, 3),
            "n_chips": w.n_chips,
            "backend": w.backend,
            "draining": w.draining,
            "preemptible": w.preemptible,
            "mesh": w.mesh,
            "wire_caps": sorted(w.caps),
            "homes": w.homes,
        } for w in list(self._workers.values())]
        return {
            "address": list(self._bound) if self._started.is_set() else None,
            "workers": workers,
            # Encode-once fragment cache (protocol.py "Wire fast path"):
            # size + hit counters for the gentun_top wire panel.
            "fragment_cache": {
                "entries": len(self._frag_cache),
                "hits": self._frag_cache.hits,
                "misses": self._frag_cache.misses,
            },
            "members": len(workers),
            "draining": sum(1 for x in workers if x["draining"]),
            "preemptible_members": self.fleet_preemptible(),
            "live_capacity": self.fleet_capacity(),
            "live_prefetch": self.fleet_prefetch(),
            "queue_depth": self._sched.depth(),
            "open_jobs": len(self._payloads),
            "jobs_in_flight": sum(x["jobs_in_flight"] for x in workers),
            "straggler_threshold_s": round(self._watchdog.threshold(), 3),
            "stragglers": self._watchdog.stragglers(),
            "straggler_requeue": self._straggler_requeue,
            # Widest advertised pop axis (1 = no mesh workers): the
            # multiple mesh-aware batch sizing aligns to.
            "mesh_pop_multiple": self.fleet_mesh_pop(),
            # Tenant table (empty until the first submit/open_session):
            # per-session books for the /statusz sessions panel.
            "sessions": self.session_stats(),
            # Crash-safety plane: journal health for the
            # gentun_top broker panel; None ⇔ journaling off.
            "journal": (self._journal.status()
                        if self._journal is not None else None),
            "epoch": self._epoch,
            "restarts": self._restarts,
            "admission": {
                "rate": self._admission_rate,
                "burst": self._admission_burst,
                "queue_factor": self._admission_queue_factor,
                "rejected_by_session": dict(self._admission_rejections),
            },
            # Cross-session window packing: None ⇔ packing off
            # (no new statusz noise for the default build).
            "packing": self.pack_stats(),
        }

    async def _handle_worker(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        wid = next(self._worker_seq)
        worker: Optional[_Worker] = None
        try:
            hello = decode(await reader.readline())
            if hello.get("type") != "hello":
                writer.write(encode({"type": "error", "reason": "expected hello"}))
                return
            # Constant-time compare: the token is a shared secret and the
            # broker may listen on a routable DCN address.  Compare as UTF-8
            # bytes — compare_digest raises TypeError on non-ASCII str.
            if self._token is not None and not hmac.compare_digest(
                str(hello.get("token") or "").encode("utf-8"),
                self._token.encode("utf-8"),
            ):
                # code=auth lets the client distinguish a deterministic
                # credential rejection (terminal) from transient errors.
                writer.write(encode({"type": "error", "code": "auth", "reason": "bad token"}))
                logger.warning("worker rejected: bad token")
                return
            if str(hello.get("role") or "") == "client":
                # Session tenant over the wire (protocol.py "Session
                # messages") — not a worker: no credit, no capacity, no
                # entry in the fleet table.
                await self._handle_client(reader, writer)
                return
            try:
                n_chips = max(1, int(hello.get("n_chips", 1)))
            except (TypeError, ValueError):
                n_chips = 1  # malformed advertisement: degrade, don't drop
            backend = hello.get("backend") or None
            capacity = max(1, int(hello.get("capacity", 1)))
            worker = _Worker(
                worker_id=str(hello.get("worker_id", f"worker-{wid}")),
                writer=writer,
                capacity=capacity,
                n_chips=n_chips,
                backend=str(backend) if backend is not None else None,
                prefetch_depth=self._parse_prefetch(hello, capacity),
                mesh=self._parse_mesh(hello),
                # Grant only capabilities BOTH ends speak; an old worker
                # advertises nothing and lands on the v1 frame set.
                caps=parse_caps(hello) & self._wire_caps,
                # Strict literal check — absent/malformed degrades to
                # stable, the conservative placement default.
                preemptible=hello.get("preemptible") is True,
                homes=self._parse_homes(hello),
            )
            # Heterogeneous-fleet check : two workers scoring one
            # generation with different estimators (e.g. xgb.cv on one host,
            # sklearn HistGradientBoosting on another) produce incomparable
            # fitnesses — warn the operator the moment the second one joins.
            others = {w.backend for w in self._workers.values() if w.backend}
            if worker.backend and others and others != {worker.backend}:
                logger.warning(
                    "heterogeneous fitness backends in the fleet: worker %s "
                    "uses %s but connected workers use %s — fitnesses from "
                    "different backends are not comparable within a generation",
                    worker.worker_id, worker.backend, sorted(others),
                )
            self._workers[wid] = worker
            if _tele.enabled():
                reg = _get_registry()
                reg.gauge("broker_workers_connected").set(len(self._workers))
                reg.gauge("fleet_members").set(len(self._workers))
                # Gauge appears only once a preemptible member has EVER
                # joined — a stable-only fleet's metric snapshot gains no
                # new series (the telemetry off-path contract).
                if worker.preemptible or self._seen_preemptible:
                    self._seen_preemptible = True
                    reg.gauge("preemptible_members").set(self.fleet_preemptible())
                # Series appears only for multi-homed workers —
                # a single-broker fleet's metric snapshot gains nothing.
                if worker.homes > 1:
                    reg.gauge("worker_homes",
                              worker=worker.worker_id).set(worker.homes)
            _tele.record_event("worker_joined", {
                "worker_id": worker.worker_id, "capacity": worker.capacity,
                "prefetch_depth": worker.prefetch_depth,
                "members": len(self._workers),
            })
            # Echo the GRANTED capability set so the worker knows which
            # frames may arrive.  A caps-less worker gets the bare welcome —
            # byte-identical to every pre-caps broker.
            welcome: Dict[str, Any] = {"type": "welcome"}
            if worker.caps:
                welcome["caps"] = sorted(worker.caps)
            if self._boot_id is not None:
                # Boot identity: lets the worker stamp results
                # with the epoch that dispatched them, so a broker restart
                # can tell re-adopted work from truly stale echoes.  A
                # journal-off broker stays byte-identical on the wire.
                welcome["boot_id"] = self._boot_id
            writer.write(encode(welcome))
            logger.info(
                "worker %s connected (capacity %d, prefetch %d, %d chip(s)%s)",
                worker.worker_id, worker.capacity, worker.prefetch_depth,
                worker.n_chips,
                ", mesh pop=%(pop)d x data=%(data)d" % worker.mesh
                if worker.mesh else "",
            )

            while True:
                line = await reader.readline()
                if not line:
                    break  # EOF: worker gone
                msg = decode(line)
                if self._injector is not None:
                    # May delay, raise ProtocolError (corrupt), or close the
                    # connection and return None (drop_connection) — in which
                    # case the reader's EOF path runs the normal cleanup.
                    msg = self._injector.broker_recv(worker, msg)
                    if msg is None:
                        continue
                worker.last_seen = time.monotonic()
                mtype = msg["type"]
                if mtype == "ping":
                    # No pong reply, deliberately: the `last_seen` update
                    # above IS the liveness mechanism, and replies the
                    # client only reads between batches pile up unread in
                    # its receive buffer during a long training batch — a
                    # worker exiting right after its final results would
                    # then close a socket with unread data, turning the
                    # close into an RST that destroys the in-flight result
                    # frames at this end (measured: 3 of 4 results lost).
                    pass
                elif mtype == "ready":
                    try:
                        add = int(msg.get("credit", 1))
                    except (TypeError, ValueError):
                        add = 1  # malformed credit: degrade, don't drop the worker
                    # Credit ceiling is the worker's WINDOW (capacity +
                    # prefetch_depth): over-subscription keeps the worker's
                    # local ready-queue stocked so the device never waits
                    # for a results→breed→dispatch round trip.  With
                    # prefetch_depth 0 (or an old worker that never sent
                    # one) this is exactly the pre-pipelining clamp.
                    # A draining worker's late ready frame (in flight when
                    # its drain was processed) grants nothing.
                    if not worker.draining:
                        worker.credit = min(worker.window, worker.credit + add)
                        self._dispatch()
                elif mtype == "result":
                    self._on_result(worker, msg)
                elif mtype == "results":
                    # Coalesced form: one frame per worker evaluation group
                    # instead of one per job (protocol.py).  Each entry is
                    # deduplicated independently; the group's span report
                    # rides the frame and is ingested with the FIRST entry
                    # that survives dedup, so a duplicated frame still
                    # cannot double-ingest.
                    spans = msg.get("spans")
                    boot = msg.get("boot")
                    for entry in msg.get("results", ()):
                        e = dict(entry)
                        if spans is not None:
                            e["spans"] = spans
                        if boot is not None:
                            e["boot"] = boot
                        if self._on_result(worker, e):
                            spans = None
                elif mtype == "fail":
                    self._on_fail(worker, msg)
                elif mtype == "drain":
                    self._on_drain(worker, msg)
                elif mtype == "advertise":
                    self._on_advertise(worker, msg)
                else:
                    logger.warning("unknown message type %r from %s", mtype, worker.worker_id)
        except (ProtocolError, ConnectionError, asyncio.IncompleteReadError, ValueError) as e:
            # ValueError covers StreamReader limit overruns (frame > limit),
            # which should tear the connection down via the same cleanup path.
            logger.info("worker connection %d dropped: %s", wid, e)
        finally:
            if worker is not None:
                self._workers.pop(wid, None)
                if _tele.enabled():
                    reg = _get_registry()
                    reg.gauge("broker_workers_connected").set(len(self._workers))
                    reg.gauge("fleet_members").set(len(self._workers))
                    if self._seen_preemptible:
                        reg.gauge("preemptible_members").set(
                            self.fleet_preemptible())
                _tele.record_event("worker_left", {
                    "worker_id": worker.worker_id,
                    "drained": worker.draining,
                    "members": len(self._workers),
                })
                self._requeue_worker_jobs(worker, "disconnect")
                self._dispatch()
            writer.close()

    async def _handle_client(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        """Wire-tenant connection (``hello`` with ``role="client"``).

        Runs in the broker loop, so session/scheduler mutations go through
        the same single-threaded paths as worker frames.  A dropped
        connection DETACHES the client's sessions (results park in their
        ``undelivered`` queues for re-attach); it does not close them.
        """
        welcome: Dict[str, Any] = {"type": "welcome"}
        if self._boot_id is not None:
            welcome["boot_id"] = self._boot_id
        writer.write(encode(welcome))
        attached: Set[str] = set()

        def _reject(sid: Any, reason: str) -> None:
            # The loud error frame (never a silent drop) + its counter.
            sid = str(sid)
            _get_registry().counter("session_rejected_total", session=sid).inc()
            writer.write(encode({"type": "error", "code": "session",
                                 "session": sid, "reason": reason}))

        def _admission_reject(sid: Any, verdict: tuple) -> None:
            # The 429 of the wire protocol: a structured, retryable
            # rejection carrying how long to back off.  Loud counters by
            # (session, reason) + the per-session ops tally for gentun_top.
            sid = str(sid)
            reason, retry_after = verdict
            self._admission_rejections[sid] = (
                self._admission_rejections.get(sid, 0) + 1)
            _get_registry().counter("admission_rejected_total",
                                    session=sid, reason=reason).inc()
            writer.write(encode({"type": "error", "code": "admission",
                                 "session": sid, "reason": reason,
                                 "retry_after_s": retry_after}))

        try:
            while True:
                line = await reader.readline()
                if not line:
                    break  # EOF: client gone
                msg = decode(line)
                mtype = msg.get("type")
                if mtype == "session_open":
                    verdict = self._admission_check(
                        str(msg.get("session") or "new"))
                    if verdict is not None:
                        _admission_reject(msg.get("session") or "new", verdict)
                        continue
                    try:
                        weight = float(msg.get("weight", 1.0))
                    except (TypeError, ValueError):
                        weight = 1.0
                    quota = msg.get("max_in_flight")
                    try:
                        quota = None if quota is None else int(quota)
                    except (TypeError, ValueError):
                        quota = None
                    # OPTIONAL tag ("canary"): classification only — never
                    # journaled, bounded so a hostile frame can't balloon
                    # the registry.
                    tag = msg.get("tag")
                    tag = str(tag)[:64] if tag else None
                    try:
                        sess = self._registry.open(
                            msg.get("session"), weight=weight,
                            max_in_flight=quota, remote=True, tag=tag)
                    except UnknownSessionError as e:  # reopening a closed id
                        _reject(msg.get("session"), str(e))
                        continue
                    sess.owner = writer
                    attached.add(sess.session_id)
                    # Re-attach: flush results that arrived while detached.
                    flushed = False
                    while sess.undelivered:
                        writer.write(encode(sess.undelivered.popleft()))
                        flushed = True
                    if self._journal is not None:
                        self._journal.record_session_open(
                            sess.session_id, sess.weight,
                            sess.max_in_flight, True)
                        if flushed:
                            # The parked results left the broker: replay
                            # must not re-park them for a second delivery.
                            self._journal.record_flush(sess.session_id)
                    writer.write(encode({"type": "session_ok",
                                         "session": sess.session_id}))
                elif mtype == "session_detach":
                    sid = str(msg.get("session"))
                    sess = self._registry.peek(sid)
                    if sess is not None and sess.owner is writer:
                        sess.owner = None
                    attached.discard(sid)
                    writer.write(encode({"type": "session_ok", "session": sid}))
                elif mtype == "session_close":
                    sid = str(msg.get("session"))
                    self.close_session(sid)
                    attached.discard(sid)
                    writer.write(encode({"type": "session_ok", "session": sid}))
                elif mtype == "submit":
                    sid = str(msg.get("session") or DEFAULT_SESSION)
                    sess = self._registry.peek(sid)
                    if sess is None or sess.closed:
                        state = "closed" if sess is not None else "unknown"
                        if sess is not None:
                            sess.rejected += len(msg.get("jobs") or ())
                        _reject(sid, f"session {sid!r} is {state}")
                        continue
                    verdict = self._admission_check(
                        sid, cost=max(1, len(msg.get("jobs") or ())))
                    if verdict is not None:
                        _admission_reject(sid, verdict)
                        continue
                    payloads = {}
                    for job in msg.get("jobs") or ():
                        job = dict(job)
                        job_id = str(job.pop("job_id", "") or self.new_job_id())
                        # Resubmit dedup: a sharded master whose
                        # submit ack died with the link retries the SAME ids
                        # after reconnect — ids still open here were already
                        # enqueued, so scheduling them again would double-run
                        # the job.  (Ids already TERMINAL re-run instead; the
                        # client results table dedups by id, so at-least-once
                        # still converges.)
                        if job_id in self._payloads:
                            continue
                        payloads[job_id] = job
                    if payloads:
                        self._enqueue_jobs(payloads, sid)
                elif mtype == "cancel":
                    self._cancel_ids({str(j) for j in msg.get("jobs") or ()})
                elif mtype == "session_stats":
                    # Sizing snapshot for WIRE tenants: sharded
                    # masters read their session's capacity/prefetch share
                    # and the fleet's mesh/chip facts over the wire instead
                    # of an embedded broker reference.  OPTIONAL message —
                    # old clients never send it, old brokers never see it.
                    sid = str(msg.get("session") or DEFAULT_SESSION)
                    if msg.get("reset_chips") is True:
                        self.reset_chips_seen()
                    stats_reply = {
                        "type": "session_stats",
                        "session": sid,
                        "capacity": self.session_capacity(sid),
                        "prefetch": self.session_prefetch(sid),
                        "mesh_pop": self.fleet_mesh_pop(),
                        "chips": self.chips_seen(),
                    }
                    ttfd = self.session_ttfd(sid)
                    if ttfd is not None:
                        # OPTIONAL field (absent until the session's first
                        # dispatch, so pre-dispatch replies keep the old
                        # byte layout): the canary's canary_ttfd_seconds.
                        stats_reply["ttfd_s"] = round(ttfd, 6)
                    writer.write(encode(stats_reply))
                elif mtype == "ping":
                    pass
                else:
                    logger.warning("unknown client message type %r", mtype)
        finally:
            for sid in attached:
                sess = self._registry.peek(sid)
                if sess is not None and sess.owner is writer:
                    sess.owner = None
            writer.close()

    def _on_result(self, w: _Worker, msg: Dict[str, Any]) -> bool:
        """Record one result; True iff it was fresh (not a stale duplicate)."""
        job_id = str(msg["job_id"])
        # Parse BEFORE touching broker state: a malformed fitness must count
        # as a worker-side failure (redeliverable), not delete the payload
        # and lose the job for good.
        try:
            fitness = float(msg["fitness"])
        except (KeyError, TypeError, ValueError):
            self._on_fail(w, {"job_id": job_id, "reason": f"malformed fitness: {msg.get('fitness')!r}"})
            return False
        w.in_flight.discard(job_id)
        # Epoch check: a worker that survived a broker crash may
        # deliver results for jobs dispatched by a PREVIOUS boot.  They are
        # accepted iff the job key matches the journal-rebuilt open set
        # (at-least-once re-adoption: exactly the result we were about to
        # redundantly recompute) and otherwise dropped with their own
        # counter — e.g. a job the journal shows already completed.
        boot = msg.get("boot")
        if (boot is not None and self._boot_id is not None
                and boot != self._boot_id and job_id not in self._payloads):
            logger.info("stale result for %s from broker epoch %r dropped "
                        "(current boot %s)", job_id, boot, self._boot_id)
            _get_registry().counter("epoch_stale_results_total").inc()
            return False
        if job_id not in self._payloads:
            logger.info("duplicate/stale result for %s dropped (redelivery race)", job_id)
            return False
        payload = self._payloads[job_id]
        del self._payloads[job_id]
        self._job_wire.pop(job_id, None)
        sid = self._job_session.pop(job_id, DEFAULT_SESSION)
        self._job_genome.pop(job_id, None)
        self._crash_counts.pop(job_id, None)
        sess = self._registry.peek(sid)
        if sess is not None:
            sess.completed += 1
        if _health.enabled():
            # Fresh results only (behind the dedup check): a duplicate's
            # RTT would double-sample the watchdog's rolling window.
            self._watchdog.job_finished(job_id)
        if _tele.enabled():
            # Behind the membership check on purpose: a duplicated result
            # frame (chaos: duplicate_result) must not double-ingest the
            # worker's span report either.
            attrs = {"worker": w.worker_id}
            if sid != DEFAULT_SESSION:
                attrs["session"] = sid
            t_enq = self._tele_enqueued.pop(job_id, None)
            if t_enq is not None:
                dur = time.monotonic() - t_enq
                _tele.record_span("job", t_enq, dur,
                                  trace=payload.get("trace"),
                                  attrs=attrs)
                _get_registry().histogram("broker_job_latency_seconds").observe(dur)
            t_disp = self._tele_dispatched.pop(job_id, None)
            if t_disp is not None:
                # The pipelining acceptance signal: handoff → result.  With
                # prefetch, a job's RTT INCLUDES its residence in the
                # worker's local ready-queue, so per-job RTT grows while
                # fleet throughput does too — read it with queue depth
                # (docs/OBSERVABILITY.md "interpretation rules of thumb").
                rtt = time.monotonic() - t_disp
                _tele.record_span("dispatch_rtt", t_disp, rtt,
                                  trace=payload.get("trace"),
                                  attrs=attrs)
                _get_registry().histogram("dispatch_rtt_s").observe(rtt)
            reported = msg.get("spans")
            if reported:
                _tele.ingest(reported)
                # Chip-hour attribution: the worker's per-genome `device`
                # spans land in the cost ledger here, behind the same
                # dedup check, so a duplicated frame never double-bills.
                _lineage.observe_records(reported, worker=w.worker_id)
            self._update_flow_gauges()
        with self._cond:
            # Under _cond: reset_chips_seen()/chips_seen() run on the master
            # thread, and an unsynchronized read-modify-write here could
            # resurrect a pre-reset total into the next sweep.
            self._chips_seen = max(self._chips_seen, self.fleet_chips())
            if sess is None or not sess.remote:
                self._results[job_id] = fitness
                self._cond.notify_all()
        delivered = True
        if sess is not None and sess.remote:
            # Wire tenant: the result belongs to the attached client, not
            # the in-process results table — forward (or park) the frame.
            delivered = self._deliver_remote(sess, {
                "type": "results", "session": sid,
                "results": [{"job_id": job_id, "fitness": fitness}],
            })
        if self._journal is not None:
            # pk=1 ⇔ the result sits parked in the session's undelivered
            # queue: replay must re-park it for the re-attaching owner.
            self._journal.record_complete(job_id, fitness,
                                          parked=not delivered)
        return True

    def _on_fail(self, w: _Worker, msg: Dict[str, Any]) -> None:
        job_id = str(msg["job_id"])
        reason = str(msg.get("reason", "unknown"))
        w.in_flight.discard(job_id)
        if job_id not in self._payloads:
            return
        if _health.enabled():
            # Fail is not a round trip: forget without sampling the RTT.
            self._watchdog.job_removed(job_id)
        # Only explicit worker-side failures count toward max_attempts;
        # disconnect/reaper redeliveries are unbounded, like AMQP's.
        self._fail_counts[job_id] = self._fail_counts.get(job_id, 0) + 1
        if self._fail_counts[job_id] >= self._max_attempts:
            logger.error("job %s failed %d times: %s", job_id, self._fail_counts[job_id], reason)
            self._fail_terminal(job_id, reason)
        else:
            logger.warning("job %s failed (%s); requeueing", job_id, reason)
            sid = self._job_session.get(job_id, DEFAULT_SESSION)
            if self._journal is not None:
                self._journal.record_requeue(job_id)
            self._sched.push(sid, job_id)
            self._tele_dispatched.pop(job_id, None)
            if _lineage.enabled():
                _lineage.record(
                    "requeued", self._job_genome.get(job_id),
                    job=job_id, worker=w.worker_id, reason="worker_fail",
                    session=sid if sid != DEFAULT_SESSION else None)
            if _tele.enabled():
                self._tele_enqueued[job_id] = time.monotonic()
            self._dispatch()

    def _on_drain(self, w: _Worker, msg: Dict[str, Any]) -> None:
        """Orderly worker exit (elastic membership, protocol.py ``drain``).

        The worker announces it is leaving and reports the job ids still
        queued-but-unstarted in its local prefetch queue; those requeue
        for redelivery NOW instead of waiting for the disconnect, while
        the batch it is currently evaluating finishes and its results are
        accepted normally.  From this frame on the worker gets no new
        work, grants no credit, and leaves the fleet sums — the engines'
        next live-capacity read shrinks accordingly.  Any dispatched job
        the worker did NOT report (e.g. a ``jobs`` frame that was on the
        wire when it decided to drain) is covered by the disconnect
        requeue; at-least-once delivery makes the overlap harmless.
        """
        if w.draining:
            return  # duplicate drain frame: already winding down
        w.draining = True
        w.credit = 0
        tele = _tele.enabled()
        ops = _health.enabled()
        # OPTIONAL drain attribution (protocol.py "Preemptible-capacity
        # field"): "preempt" marks capacity-reclaim churn; anything else —
        # absent, old worker, hostile — degrades to the plain "drain".
        reason = "preempt" if msg.get("reason") == "preempt" else "drain"
        requeued = 0
        for job_id in msg.get("requeue") or ():
            job_id = str(job_id)
            if job_id not in w.in_flight or job_id not in self._payloads:
                continue  # finished/cancelled since the worker queued it
            w.in_flight.discard(job_id)
            sid = self._job_session.get(job_id, DEFAULT_SESSION)
            if self._journal is not None:
                self._journal.record_requeue(job_id)
            self._sched.push(sid, job_id)
            sess = self._registry.peek(sid)
            if sess is not None:
                sess.requeued += 1
            if _lineage.enabled():
                _lineage.record(
                    "requeued", self._job_genome.get(job_id),
                    job=job_id, worker=w.worker_id, reason=reason,
                    session=sid if sid != DEFAULT_SESSION else None)
            if ops:
                self._watchdog.job_removed(job_id)
            self._tele_dispatched.pop(job_id, None)
            if tele:
                self._tele_enqueued[job_id] = time.monotonic()
            requeued += 1
        logger.info(
            "worker %s draining: requeued %d unstarted job(s), finishing %d "
            "in flight", w.worker_id, requeued, len(w.in_flight))
        if tele:
            _get_registry().counter("worker_drains_total",
                                    worker=w.worker_id).inc()
            if self._seen_preemptible:
                _get_registry().gauge("preemptible_members").set(
                    self.fleet_preemptible())
            self._update_flow_gauges()
        _tele.record_event("worker_draining", {
            "worker_id": w.worker_id, "requeued": requeued,
            "finishing": len(w.in_flight), "reason": reason,
        })
        self._dispatch()

    def _on_advertise(self, w: _Worker, msg: Dict[str, Any]) -> None:
        """Capacity/prefetch re-advertisement (elastic membership).

        A worker whose local resources changed mid-run (chips freed,
        co-tenant gone) updates its hello-time numbers in place; the
        fleet sums — and through them the engines' in-flight targets —
        follow on their next read.  Malformed values keep the old numbers
        (degrade, don't drop, like every other field).  Credit above the
        new window is clamped; already-dispatched jobs are unaffected,
        and growth is granted by the worker's next ``ready`` frame.
        """
        if w.draining:
            return  # a draining worker has no capacity to re-advertise
        if "capacity" in msg:
            try:
                w.capacity = max(1, int(msg["capacity"]))
            except (TypeError, ValueError):
                pass
        if "prefetch_depth" in msg:
            w.prefetch_depth = self._parse_prefetch(msg, w.capacity)
        if "mesh" in msg:
            # Host-mesh workers re-advertise their shape with the new
            # capacity (elastic mesh shrink/grow: device lost or returned).
            w.mesh = self._parse_mesh(msg)
        if "preemptible" in msg:
            # Placement class change (e.g. a spot VM promoted to reserved
            # capacity).  Strict literal check, like hello.
            w.preemptible = msg["preemptible"] is True
            if _tele.enabled() and (w.preemptible or self._seen_preemptible):
                self._seen_preemptible = True
                _get_registry().gauge("preemptible_members").set(
                    self.fleet_preemptible())
        w.credit = min(w.credit, w.window)
        logger.info("worker %s re-advertised capacity=%d prefetch=%d%s",
                    w.worker_id, w.capacity, w.prefetch_depth,
                    " mesh pop=%(pop)d x data=%(data)d" % w.mesh
                    if w.mesh else "")
        _tele.record_event("worker_readvertised", {
            "worker_id": w.worker_id, "capacity": w.capacity,
            "prefetch_depth": w.prefetch_depth, "mesh": w.mesh,
        })
        self._dispatch()


def main(argv=None) -> int:
    """Standalone broker process (``python -m gentun_tpu_torch.distributed.broker``).

    The crash-safety counterpart of the embedded broker: run it under a
    supervisor with ``--journal``, and a restart after ``kill -9`` replays
    to the pre-crash dispatch state — workers re-adopt through their
    reconnect backoff, wire tenants through ``SessionClient`` re-attach.
    """
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m gentun_tpu_torch.distributed.broker",
        description="gentun_tpu_torch job broker (standalone, crash-safe with --journal)",
    )
    ap.add_argument("--host", default="127.0.0.1", help="bind address")
    ap.add_argument("--port", type=int, default=5672, help="bind port (0 = ephemeral)")
    ap.add_argument("--password", default=None, help="shared token workers/tenants must present")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="dispatch journal path: replay it on boot (crash "
                         "re-adoption), append this boot's records to it")
    ap.add_argument("--heartbeat-timeout", type=float, default=15.0)
    ap.add_argument("--max-attempts", type=int, default=3)
    ap.add_argument("--admission-rate", type=float, default=None, metavar="N",
                    help="per-tenant token-bucket rate (frames/s) on wire "
                         "session_open/submit; unset = no rate limit")
    ap.add_argument("--admission-burst", type=float, default=None, metavar="N",
                    help="token-bucket burst size (default: max(1, rate))")
    ap.add_argument("--admission-queue-factor", type=float, default=None, metavar="F",
                    help="reject wire submits while backlog > F x live "
                         "capacity (structured admission error with "
                         "retry_after_s); unset = no back-pressure")
    ap.add_argument("--aggregator-url", default=None, metavar="URL")
    ap.add_argument("--ops-port", type=int, default=None, metavar="PORT",
                    help="serve /metrics /healthz /statusz /alertz on "
                         "127.0.0.1:PORT (0 = ephemeral, logged)")
    ap.add_argument("--ops-host", default="127.0.0.1", metavar="ADDR")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    broker = JobBroker(
        host=args.host, port=args.port, token=args.password,
        heartbeat_timeout=args.heartbeat_timeout,
        max_attempts=args.max_attempts,
        aggregator_url=args.aggregator_url,
        journal_path=args.journal,
        admission_rate=args.admission_rate,
        admission_burst=args.admission_burst,
        admission_queue_factor=args.admission_queue_factor,
    )
    broker.start()
    if args.ops_port is not None:
        from ..telemetry import start_ops_server
        start_ops_server(host=args.ops_host, port=args.ops_port)
    logger.info("broker ready on %s:%d (epoch %d%s)", *broker.address,
                broker._epoch, ", journal on" if args.journal else "")
    try:
        while True:
            time.sleep(3600.0)
    except KeyboardInterrupt:
        logger.info("interrupt: stopping broker")
    finally:
        broker.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    raise SystemExit(main())
