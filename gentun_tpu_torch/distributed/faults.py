"""Deterministic fault injection for the distributed plane.

The broker reimplements the AMQP semantics the reference got for free from
RabbitMQ (SURVEY.md §3.2, §5: competing consumers, ack-after-work,
at-least-once redelivery), but every hardware artifact in DISTRIBUTED.md
records **0 retries, 0 requeues, 0 penalized individuals** — the failure
machinery (reaper, redelivery, ``JobFailed``/``GatherTimeout``,
duplicate-result drop, checkpoint resume) had only ever been unit-poked.
This module drives the whole stack through its failure paths
*deterministically*: a :class:`FaultPlan` is a seeded, serializable
schedule of faults, and a :class:`FaultInjector` fires them at named hook
points threaded through the production code.

Hook points and the fault kinds each supports:

====================  ==================================================
``broker_send``       drop_connection, delay, corrupt   (per jobs-frame)
``broker_recv``       drop_connection, delay, corrupt   (per worker frame)
``client_send``       drop_connection, delay, corrupt, duplicate_result
``client_recv``       drop_connection, delay, corrupt
``client_connect``    drop_connection (refuse), delay
``worker_pre_eval``   fail_eval, hang, delay, fitness_corrupt (per job)
``master_boundary``   kill_master                       (per generation)
``journal_write``     journal_io_error, broker_crash    (per journal drain)
====================  ==================================================

Fault kinds (the recoverable failure modes the plane is DESIGNED for —
there is deliberately no "silently lose one frame" kind, because TCP never
does that; a lost frame in the real world is a broken connection):

- ``drop_connection`` — close the socket mid-protocol (worker crash /
  partition).  Broker side: requeue-on-disconnect.  Client side:
  reconnect with capped exponential backoff.
- ``delay``           — stall a frame/connect by ``delay`` seconds
  (network latency, GC pause).  Must be invisible to the search outcome.
- ``corrupt``         — replace a frame with truncated garbage.  The
  receiver's ``ProtocolError`` path must tear the connection down and
  recover exactly like a disconnect.
- ``hang``            — stop heartbeating while holding jobs for
  ``duration`` seconds (hung process).  The broker's reaper must declare
  the worker dead and redeliver.
- ``fail_eval``       — raise inside the fitness evaluation (OOM, bad
  genes).  The ``fail`` reply must requeue up to ``max_attempts``.
- ``duplicate_result``— send a ``result`` frame twice (redelivery race /
  retransmit).  The broker must count the first only.
- ``kill_master``     — raise :class:`MasterKilled` at a generation
  boundary.  A checkpointed search must resume bit-identically.
- ``journal_io_error``— torn/short write on the dispatch journal: a
  ``fraction`` prefix of the pending batch reaches the disk, then the
  journal wedges.  Replay of the truncated tail must discard
  the torn record loudly, never poison the fold.
- ``broker_crash``    — the broker dies at a journal drain point WITHOUT
  flushing (the in-process SIGKILL analog): the buffer is dropped and
  ``DispatchJournal.crash_requested`` trips, which the broker's journal
  task turns into an abrupt :meth:`JobBroker.kill`.  Restart-with-replay
  must re-adopt every open job through the at-least-once path.
- ``fitness_corrupt`` — the evaluation SUCCEEDS but the worker reports a
  deterministically perturbed fitness (stale cache entry, packed-window
  demux bug, silent numeric corruption — the failure class NO transport
  machinery can catch, because the frame is well-formed).  Only the
  canary plane's golden-genome bit-equality check
  (``gentun_tpu_torch/telemetry/canary.py``) detects it.

Zero-cost when disabled: every production hook site is a single
``if self._injector is not None`` attribute check — no allocation, no
call — and the default injector is ``None`` everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..telemetry import spans as _tele
from ..telemetry.registry import get_registry as _get_registry
from .protocol import ProtocolError, encode

__all__ = [
    "HOOKS", "KINDS", "FaultSpec", "FaultPlan", "FaultInjector", "MasterKilled",
]

HOOKS = (
    "broker_send", "broker_recv", "client_send", "client_recv",
    "client_connect", "worker_pre_eval", "master_boundary",
    "journal_write",
)

KINDS = (
    "drop_connection", "delay", "corrupt", "hang", "fail_eval",
    "duplicate_result", "kill_master", "journal_io_error", "broker_crash",
    "fitness_corrupt",
)

#: Which kinds make sense at which hook — validated at FaultSpec build so a
#: typo'd plan fails loudly at construction, not silently never-fires.
_HOOK_KINDS: Dict[str, tuple] = {
    "broker_send": ("drop_connection", "delay", "corrupt"),
    "broker_recv": ("drop_connection", "delay", "corrupt"),
    "client_send": ("drop_connection", "delay", "corrupt", "duplicate_result"),
    "client_recv": ("drop_connection", "delay", "corrupt"),
    "client_connect": ("drop_connection", "delay"),
    "worker_pre_eval": ("fail_eval", "hang", "delay", "fitness_corrupt"),
    "master_boundary": ("kill_master",),
    "journal_write": ("journal_io_error", "broker_crash"),
}

#: A deliberately-invalid frame: ASCII so json sees JSONDecodeError (not
#: UnicodeDecodeError, which would bypass the ProtocolError path).
_CORRUPT_FRAME = b'{"truncated by fault inject' + b"\n"


class MasterKilled(RuntimeError):
    """Injected master death at a generation boundary (``kill_master``).

    Raised AFTER the boundary checkpoint was written, so the defined
    recovery is exactly a real crash's: rebuild the population (same
    port), re-run with the same checkpointer, and the search resumes
    bit-identically (``GeneticAlgorithm.run(..., checkpointer=...)``).
    """

    def __init__(self, generation: int):
        super().__init__(f"injected master kill at generation boundary {generation}")
        self.generation = int(generation)


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fire ``kind`` at hook ``hook`` on the ``at``-th
    matching event (0-based), for ``times`` consecutive matching events.

    ``match_type`` restricts counting to frames of one message type (e.g.
    only ``result`` frames); ``worker`` restricts broker-side hooks to one
    worker id; ``generation`` pins ``kill_master`` to a boundary.
    ``delay`` (seconds) parameterizes the ``delay`` kind, ``duration``
    the ``hang`` kind.
    """

    hook: str
    kind: str
    at: int = 0
    times: int = 1
    match_type: Optional[str] = None
    worker: Optional[str] = None
    generation: Optional[int] = None
    delay: float = 0.05
    duration: float = 1.0
    #: ``journal_io_error`` only: fraction of the pending batch that
    #: reaches the disk before the torn write wedges the journal.
    fraction: float = 0.5

    def __post_init__(self) -> None:
        if self.hook not in HOOKS:
            raise ValueError(f"unknown hook {self.hook!r}; choose from {HOOKS}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; choose from {KINDS}")
        if self.kind not in _HOOK_KINDS[self.hook]:
            raise ValueError(
                f"kind {self.kind!r} is not injectable at hook {self.hook!r} "
                f"(supported: {_HOOK_KINDS[self.hook]})"
            )
        if self.at < 0 or self.times < 1:
            raise ValueError(f"need at >= 0 and times >= 1, got at={self.at} times={self.times}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(**d)


class FaultPlan:
    """A seeded, serializable schedule of faults.

    Either build explicitly from :class:`FaultSpec` entries, or draw a
    random-but-reproducible plan with :meth:`sample` — two processes given
    the same seed construct the identical schedule, which is what lets a
    chaos run be replayed exactly (``scripts/chaos_run.py`` commits the
    plan JSON next to its artifact).
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: Optional[int] = None):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, specs={[s.to_dict() for s in self.specs]})"

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "specs": [s.to_dict() for s in self.specs]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls(specs=[FaultSpec.from_dict(s) for s in d.get("specs", [])],
                   seed=d.get("seed"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), separators=(",", ":"))

    @classmethod
    def from_json(cls, payload: str) -> "FaultPlan":
        return cls.from_dict(json.loads(payload))

    @classmethod
    def sample(cls, seed: int, n_faults: int = 4,
               hooks: Optional[Sequence[str]] = None) -> "FaultPlan":
        """A reproducible random plan: ``n_faults`` draws over ``hooks``
        (default: every hook except ``master_boundary``, which needs a
        resume harness around the search loop to be survivable)."""
        import numpy as np

        rng = np.random.default_rng(seed)
        pool = tuple(hooks) if hooks is not None else tuple(
            h for h in HOOKS if h != "master_boundary")
        specs = []
        for _ in range(int(n_faults)):
            hook = pool[int(rng.integers(len(pool)))]
            kinds = _HOOK_KINDS[hook]
            kind = kinds[int(rng.integers(len(kinds)))]
            specs.append(FaultSpec(
                hook=hook, kind=kind,
                at=int(rng.integers(0, 8)),
                delay=float(rng.uniform(0.01, 0.1)),
                duration=float(rng.uniform(0.5, 2.0)),
                generation=int(rng.integers(1, 4)) if kind == "kill_master" else None,
            ))
        return cls(specs, seed=seed)


class FaultInjector:
    """Live fault-firing state for ONE component (a broker, or a client).

    Give each component its OWN injector (even when they share a plan's
    spec values): per-spec event counters are what make the schedule
    deterministic, and two components racing one counter would not be.

    Every hook method is thread-safe (one lock around the counters) and
    records what it fired in :attr:`fired` so tests and the chaos artifact
    can assert the plan actually executed.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._counts = [0] * len(plan.specs)
        self.fired: List[Dict[str, Any]] = []
        self._hang_until = 0.0
        self._corrupt_jobs: set = set()

    # -- matching ----------------------------------------------------------

    def _match(self, hook: str, mtype: Optional[str] = None,
               worker: Optional[str] = None,
               generation: Optional[int] = None) -> Optional[FaultSpec]:
        """The first armed spec this event trips, advancing every matching
        spec's event counter (deterministic: counters only ever see events
        that satisfy the spec's own filters)."""
        with self._lock:
            hit = None
            for i, s in enumerate(self.plan.specs):
                if s.hook != hook:
                    continue
                if s.match_type is not None and mtype != s.match_type:
                    continue
                if s.worker is not None and worker != s.worker:
                    continue
                if s.generation is not None and generation != s.generation:
                    continue
                n = self._counts[i]
                self._counts[i] = n + 1
                if hit is None and s.at <= n < s.at + s.times:
                    hit = s
            if hit is not None:
                record = {
                    "hook": hook, "kind": hit.kind, "type": mtype,
                    "worker": worker, "generation": generation,
                }
                self.fired.append(record)
                if _tele.enabled():
                    # Structured trail of every injected fault: a counter per
                    # (hook, kind) in the registry plus an event record in the
                    # run artifact (docs/OBSERVABILITY.md; the chaos artifact
                    # asserts these — scripts/chaos_run.py).
                    _get_registry().counter(
                        "faults_injected_total", hook=hook, kind=hit.kind,
                    ).inc()
                    _tele.record_event("fault_injected", record)
            return hit

    # -- broker-side hooks (run on the broker loop thread) -----------------

    def broker_send(self, worker, msg: Dict[str, Any]) -> bool:
        """True ⇒ the broker must suppress the real send."""
        s = self._match("broker_send", msg.get("type"), worker=worker.worker_id)
        if s is None:
            return False
        if s.kind == "delay":
            time.sleep(s.delay)  # stalls the loop thread: an honest GC-pause
            return False
        if s.kind == "corrupt":
            try:
                worker.writer.write(_CORRUPT_FRAME)
            except Exception:
                pass
            return True
        # drop_connection: the reader's EOF path requeues this worker's jobs
        worker.writer.close()
        return True

    def broker_recv(self, worker, msg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The (possibly delayed) frame, or None ⇒ the handler must treat
        the connection as torn down (corrupt raises instead)."""
        s = self._match("broker_recv", msg.get("type"), worker=worker.worker_id)
        if s is None:
            return msg
        if s.kind == "delay":
            time.sleep(s.delay)
            return msg
        if s.kind == "corrupt":
            raise ProtocolError("injected corrupt frame")
        worker.writer.close()
        return None

    # -- client-side hooks (run on the worker's consume thread) ------------

    def client_send(self, client, msg: Dict[str, Any]) -> bool:
        """True ⇒ the client must suppress the real send (the injector has
        already written whatever the fault calls for)."""
        s = self._match("client_send", msg.get("type"))
        if s is None:
            return False
        if s.kind == "delay":
            time.sleep(s.delay)
            return False
        if s.kind == "duplicate_result":
            data = encode(msg)
            client._raw_send(data)
            client._raw_send(data)  # the replayed twin the broker must drop
            return True
        if s.kind == "corrupt":
            client._raw_send(_CORRUPT_FRAME)
            return True
        # drop_connection: die mid-batch; the consume loop's reconnect path
        # (and the broker's requeue-on-disconnect) must pick up the pieces.
        client._close()
        raise OSError("injected connection drop")

    def client_recv(self, client, msg: Dict[str, Any]) -> Dict[str, Any]:
        s = self._match("client_recv", msg.get("type"))
        if s is None:
            return msg
        if s.kind == "delay":
            time.sleep(s.delay)
            return msg
        if s.kind == "corrupt":
            raise ProtocolError("injected corrupt frame")
        client._close()
        raise ConnectionError("injected connection drop")

    def client_connect(self, client) -> None:
        s = self._match("client_connect")
        if s is None:
            return
        if s.kind == "delay":
            time.sleep(s.delay)
            return
        raise ConnectionError("injected connect refusal")

    def worker_pre_eval(self, client, job: Dict[str, Any]) -> None:
        s = self._match("worker_pre_eval", worker=None)
        if s is None:
            return
        if s.kind == "delay":
            time.sleep(s.delay)
            return
        if s.kind == "fail_eval":
            raise RuntimeError(f"injected eval failure (job {job.get('job_id')})")
        if s.kind == "fitness_corrupt":
            # The eval proceeds normally; the worker's result path consumes
            # this mark (take_fitness_corrupt) and perturbs the reported
            # fitness AFTER evaluation — a well-formed frame with a wrong
            # number, invisible to every transport check.
            with self._lock:
                self._corrupt_jobs.add(job.get("job_id"))
            return
        # hang: hold the jobs, stop heartbeating (the heartbeat loop checks
        # heartbeats_suppressed), and let the broker's reaper declare us dead.
        self._hang_until = time.monotonic() + s.duration
        time.sleep(s.duration)

    def take_fitness_corrupt(self, job_id: Any) -> bool:
        """Consume (once) a ``fitness_corrupt`` mark left by
        :meth:`worker_pre_eval` for this job."""
        with self._lock:
            if job_id in self._corrupt_jobs:
                self._corrupt_jobs.discard(job_id)
                return True
            return False

    @staticmethod
    def corrupt_fitness(value: Any) -> float:
        """The deterministic perturbation a ``fitness_corrupt`` fault
        applies: finite fitnesses shift by +1.0, anything else becomes
        1.0 — always a well-formed float, never bit-equal to the truth."""
        try:
            v = float(value)
        except (TypeError, ValueError):
            return 1.0
        if v != v or v in (float("inf"), float("-inf")):
            return 1.0
        out = v + 1.0
        if out == v:  # |v| swamps the +1.0 — nudge one ulp toward zero
            out = math.nextafter(v, 0.0)
        return out

    def heartbeats_suppressed(self) -> bool:
        """True while a ``hang`` fault is in force (checked by the client's
        heartbeat loop — once per interval, never per frame)."""
        return time.monotonic() < self._hang_until

    # -- journal hook (runs on the broker loop thread) ---------------------

    def journal_write(self, journal) -> Optional[FaultSpec]:
        """Fires once per journal drain (the batched write point, NOT per
        record).  Returns the matched spec — ``DispatchJournal._drain``
        executes the torn write / crash itself, because only it knows the
        pending bytes."""
        return self._match("journal_write")

    # -- master-side hook --------------------------------------------------

    def master_boundary(self, generation: int) -> None:
        """Fires at each generation boundary AFTER the checkpoint save;
        a matching ``kill_master`` spec raises :class:`MasterKilled`."""
        s = self._match("master_boundary", generation=generation)
        if s is not None:
            raise MasterKilled(generation)
