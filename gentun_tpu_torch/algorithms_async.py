"""Asynchronous steady-state evolution: the generation barrier, removed.

The port's copy of the JAX package's steady-state engine: the same
scheduler, draws and checkpoint schema, so a stub-fitness search gives the
same history in both packages.  Fitness values carry the port's own
protocol stamp; a checkpoint stamped with another one resumes without any
of its measurements (see :meth:`AsyncEvolution.load_state_dict`).

The generational loop (``algorithms.py``) evaluates a whole population,
waits at a barrier, then breeds the next generation — so a fleet is only
busy while a generation is wide, and the converged tail (1-4 fresh
individuals per generation) pays a program-switch + dispatch + RPC floor
per generation while most worker capacity idles.

:class:`AsyncEvolution` replaces the barrier with *regularized evolution*
(Real et al. 2019, "Regularized Evolution for Image Classifier Architecture
Search") driven by a completion loop in the barrier-free worker style of
population-based training (Jaderberg et al. 2017):

- a bounded, age-ordered population (the *ring*): youngest appended,
  oldest **evicted by age** — never by fitness — each time a child joins;
- **aging tournament selection**: parents are the fittest of a uniform
  sample of evaluated ring members;
- a configurable number of evaluations (default: the fleet's total
  capacity) stays in flight at all times — every completed evaluation
  immediately breeds and dispatches a replacement child, so the fleet
  stays busy through the tail.

The engine is mode-agnostic: a data-holding :class:`Population` evaluates
on a local thread pool; a ``DistributedPopulation`` uses the broker's
completion-driven API (``wait_any``) with one coalesced submit per wake-up.
Canonical-dedup and fitness-store reuse apply at dispatch: a child whose
``cache_key`` is already measured completes instantly without occupying a
worker slot, and a child identical to one already in flight attaches to it
as a *follower* instead of training twice.

Determinism: the engine consumes randomness only from its own generator,
and every breeding decision is driven by the completion stream — with a
deterministic completion order (one in-flight slot, or a single capacity-1
worker) the whole trajectory is a pure function of the seed, checkpoints
included.  The generational mode is untouched: ``GeneticAlgorithm`` remains
the default and stays bit-identical.

Multi-fidelity (``fidelity_ladder=``): asynchronous successive halving
(ASHA, Li et al. 2020) layered onto the same completion loop.  The ladder
is a list of ``additional_parameters`` overlays, rung 0 (cheap proxy
schedule) to the top (full schedule); every child is dispatched at rung 0
and, once a rung has seen ``eta`` completions per promotion slot, its
top-``1/eta`` ring members are promoted — a *promotion probe* (same
genes, next rung's overlay) rides the ordinary dispatch path, so rungs
never barrier and a straggling promotion never blocks breeding.  When a
probe lands, the member's fitness is replaced in place by the
higher-fidelity measurement (selection therefore always compares each
member at its highest completed rung) and the proxy/full results live
under disjoint fitness-cache keys (the overlay is part of the key).
``fidelity_ladder=None`` (default) is the pre-ladder engine, bit for bit.
See DISTRIBUTED.md "Multi-fidelity evolution".

Surrogate rung −1 (``surrogate=``): a :class:`~gentun_tpu_torch.surrogate.SurrogateGate`
threads a host-side learned ranker UNDER the ladder — every bred child is
scored before dispatch and only the top ``1/eta`` fraction of recent
scores enters rung 0; a rejected child is recorded (``gate_rejected``
lineage event + counter) and immediately replaced by re-breeding, so the
in-flight target stays saturated and rejected children never consume
budget.  The gate feeds on every completion, refits periodically, and
serializes into checkpoint schema v4 (model + window + pending
decisions), so kill/resume mid-gate is bit-identical.  ``surrogate=None``
(default) is the ungated engine, bit for bit — the sites read one
attribute.  See DISTRIBUTED.md "Surrogate rung −1".
"""

from __future__ import annotations

import itertools
import logging
import queue as _queue
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .individuals import Individual
from .populations import Population
from .surrogate import SurrogateGate
from .telemetry import health as _health
from .telemetry import lineage as _lineage
from .telemetry import spans as _tele
from .telemetry.registry import get_registry as _get_registry
from .utils.fitness_store import (
    FITNESS_PROTOCOL,
    fidelity_fingerprint,
    is_serializable_key,
    tuplify,
)

__all__ = ["AsyncEvolution"]

logger = logging.getLogger("gentun_tpu_torch")

#: event tuple: (token, fitness-or-None, error-reason-or-None)
_Event = Tuple[Any, Optional[float], Optional[str]]


class _Work:
    """One owed evaluation, as the scheduler tracks it.

    ``ind`` is the individual actually shipped (it carries the rung's
    config overlay).  ``is_member`` marks unevaluated RING members being
    measured in place (the pre-ladder cohort path).  ``target`` — when not
    None — is the ring member this result belongs to: promotion probes and
    ladder-mode cohort probes evaluate a config-overlaid twin of the
    member, then write the fitness back to the member itself.
    """

    __slots__ = ("ind", "is_member", "rung", "target")

    def __init__(self, ind: Individual, is_member: bool, rung: int = 0,
                 target: Optional[Individual] = None):
        self.ind = ind
        self.is_member = is_member
        self.rung = int(rung)
        self.target = target


class _LocalEvaluator:
    """Thread-pool evaluation for data-holding populations.

    One worker thread per in-flight slot; completions land on a queue in
    finish order.  With a single thread the executor is FIFO, which is the
    deterministic configuration the seeded-determinism and kill/resume
    tests rely on.
    """

    def __init__(self, n_threads: int):
        self._n = max(1, int(n_threads))
        self._pool = ThreadPoolExecutor(
            max_workers=self._n, thread_name_prefix="gentun-async-eval")
        self._done: _queue.Queue = _queue.Queue()
        self._seq = itertools.count()
        self._futures: Dict[int, Any] = {}

    def default_capacity(self) -> int:
        return self._n

    def live_capacity(self) -> int:
        return self._n  # thread pools don't resize mid-run

    def submit(self, individuals: List[Individual]) -> List[int]:
        tokens = []
        lin = _lineage.enabled()
        for ind in individuals:
            token = next(self._seq)
            fn = self._timed_fitness(ind) if lin else ind.get_fitness
            fut = self._pool.submit(fn)
            fut.add_done_callback(lambda f, t=token: self._done.put((t, f)))
            self._futures[token] = fut
            tokens.append(token)
        return tokens

    @staticmethod
    def _timed_fitness(ind: Individual):
        """Forensics wrapper: attribute the evaluation's device-seconds to
        the genome (docs/OBSERVABILITY.md "Search forensics").  Charged
        even when the evaluation raises — the chip time was spent."""
        def run():
            t0 = time.monotonic()
            try:
                return ind.get_fitness()
            finally:
                if not _tele.capturing():
                    _lineage.emit_device(
                        time.monotonic() - t0,
                        _lineage.genome_key(ind.get_genes()),
                        rung=(getattr(ind, "_fidelity_tag", None)
                              or {}).get("rung", 0),
                        start_monotonic=t0)
        return run

    def wait_any(self, timeout: Optional[float]) -> List[_Event]:
        try:
            token, fut = self._done.get(timeout=timeout)
        except _queue.Empty:
            return []
        events = [self._event(token, fut)]
        while True:  # drain whatever else already finished
            try:
                token, fut = self._done.get_nowait()
            except _queue.Empty:
                return events
            events.append(self._event(token, fut))

    def _event(self, token: int, fut) -> _Event:
        self._futures.pop(token, None)
        if fut.cancelled():
            return (token, None, "cancelled")
        exc = fut.exception()
        if exc is not None:
            return (token, None, repr(exc))
        return (token, float(fut.result()), None)

    def cancel(self, tokens) -> None:
        for t in tokens:
            fut = self._futures.pop(t, None)
            if fut is not None:
                fut.cancel()

    def close(self) -> None:
        try:
            self._pool.shutdown(wait=False, cancel_futures=True)
        except TypeError:  # pragma: no cover - pre-3.9 fallback
            self._pool.shutdown(wait=False)


class _DistributedEvaluator:
    """Completion-driven evaluation through a ``DistributedPopulation``.

    Thin: payload construction and the broker's ``wait_any``/``cancel``
    live on the population (``distributed/server.py``), keeping the wire
    format single-owner.  Tokens are broker job ids.
    """

    def __init__(self, population):
        self._pop = population
        self._open: set = set()

    def default_capacity(self) -> int:
        # Wait briefly for the fleet so "capacity" means the real fleet,
        # not the pre-connect instant — and keep watching after the first
        # worker appears, because its peers are usually mid-handshake: a
        # cap that stops growing for 0.75 s is taken as the fleet.
        deadline = time.monotonic() + 10.0
        cap, last_growth = 0, time.monotonic()
        while time.monotonic() < deadline:
            now = self._pop.fleet_capacity()
            if now > cap:
                cap, last_growth = now, time.monotonic()
            elif cap > 0 and time.monotonic() - last_growth >= 0.75:
                break
            time.sleep(0.05)
        # Breed ahead to the fleet's full dispatch WINDOW — evaluation
        # slots plus the workers' advertised prefetch queues — so every
        # worker always has a decoded next window waiting (the engine half
        # of the pipelined dispatch plane).  A fleet advertising no
        # prefetch yields exactly the old target, keeping prefetch_depth=0
        # trajectories bit-identical.
        prefetch = getattr(self._pop, "fleet_prefetch", lambda: 0)()
        return max(1, cap) + max(0, int(prefetch))

    def live_capacity(self) -> int:
        """Instant dispatch-window read of the CURRENT fleet — no settling
        wait.  0 means "no live workers right now" (drain, crash-reconnect
        gap); the engine keeps its last-known target through that instant
        rather than stalling the refill loop."""
        cap = self._pop.fleet_capacity()
        if cap <= 0:
            return 0
        prefetch = getattr(self._pop, "fleet_prefetch", lambda: 0)()
        return cap + max(0, int(prefetch))

    def submit(self, individuals: List[Individual]) -> List[str]:
        ids = self._pop.submit_individuals(individuals)
        self._open.update(ids)
        return ids

    def wait_any(self, timeout: Optional[float]) -> List[_Event]:
        if not self._open:
            return []
        results, failures = self._pop.wait_any_results(list(self._open), timeout=timeout)
        self._open -= set(results) | set(failures)
        return ([(j, f, None) for j, f in results.items()]
                + [(j, None, r) for j, r in failures.items()])

    def cancel(self, tokens) -> None:
        ids = [t for t in tokens if t in self._open]
        self._open -= set(ids)
        if ids:
            self._pop.cancel_jobs(ids)

    def close(self) -> None:
        pass  # population/broker lifecycle belongs to the caller


class AsyncEvolution:
    """Steady-state aging-tournament evolution without a generation barrier.

    Parameters
    ----------
    population:
        The initial cohort — a :class:`Population` (local evaluation) or a
        ``DistributedPopulation`` (broker-backed).  Its size is the ring's
        bound for the whole search.
    tournament_size:
        Members sampled per parent draw; the fittest wins.
    max_in_flight:
        Evaluations kept in flight at all times.  ``None`` (default)
        resolves at :meth:`run` to the connected fleet's total capacity
        (distributed) or 1 (local).
    seed:
        Seeds the engine's own RNG; ``None`` shares the population's.
    checkpoint_every:
        Completions between checkpoint saves (and ``master_boundary``
        fault hooks) when a checkpointer is attached.
    job_timeout:
        Max seconds to wait for ANY completion before raising — ``None``
        waits forever (the generational default).
    fidelity_ladder:
        ``None`` (default): single-fidelity, the pre-ladder engine bit for
        bit.  Otherwise a sequence of ``additional_parameters`` overlays,
        rung 0 (proxy) → last (full schedule; ``{}`` means "the
        population's own config").  Children dispatch at rung 0; the
        top-``1/eta`` of each rung promote asynchronously.
    eta:
        ASHA reduction factor: one promotion slot per ``eta`` completions
        at a rung.  Ignored without a ladder.
    surrogate:
        ``None`` (default): no rung −1, the engine bit for bit.
        Otherwise a :class:`~gentun_tpu_torch.surrogate.SurrogateGate` that
        scores every bred child on the host before dispatch and admits
        only the top fraction; rejected children are re-bred in place
        (they never occupy a slot or consume budget).  Checkpoints carry
        the gate (schema v4); on resume the checkpoint's gate state wins.
    """

    def __init__(
        self,
        population: Population,
        tournament_size: int = 5,
        max_in_flight: Optional[int] = None,
        seed: Optional[int] = None,
        checkpoint_every: int = 8,
        job_timeout: Optional[float] = None,
        fidelity_ladder: Optional[Sequence[Mapping[str, Any]]] = None,
        eta: int = 4,
        surrogate: Optional[SurrogateGate] = None,
    ):
        self.population = population
        self.tournament_size = int(tournament_size)
        self.max_in_flight = None if max_in_flight is None else max(1, int(max_in_flight))
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.job_timeout = job_timeout
        if fidelity_ladder is not None:
            ladder = [dict(r) for r in fidelity_ladder]
            if not ladder:
                raise ValueError("fidelity_ladder must name at least one rung "
                                 "(use None for single-fidelity)")
            if int(eta) < 2:
                raise ValueError(f"eta must be >= 2 (got {eta}): promoting "
                                 "every completion is not a ladder")
            self._ladder: Optional[List[Dict[str, Any]]] = ladder
        else:
            self._ladder = None
        self.eta = int(eta)
        #: rung −1 — ``None`` is the ungated engine (every site below
        #: reads this one attribute: the off path costs one read).
        self._surrogate = surrogate
        #: per-rung fitnesses of every completion at that rung, in
        #: completion order — the ASHA promotion quota reads this, so it is
        #: serialized for deterministic resume.
        self._rung_completions: List[List[float]] = (
            [[] for _ in (self._ladder or ())])
        #: per-rung ever-best (copies, like ``best``); ``best`` itself is
        #: the best at the HIGHEST rung with any completion, because proxy
        #: and full-schedule fitnesses are not comparable numbers.
        self._best_by_rung: Dict[int, Individual] = {}
        self.rng = np.random.default_rng(seed) if seed is not None else population.rng
        self.pop_size = len(population)
        self.completed = 0
        self.dispatched = 0
        self.history: List[Dict[str, Any]] = []
        #: copy of the best individual EVER completed — aging eviction may
        #: remove the champion from the ring, so the ring's fittest member
        #: is not the search's answer.
        self.best: Optional[Individual] = None
        self._checkpointer = None
        self._fault_injector = None
        self._last_ckpt = 0
        # Scheduler state (also serialized): children bred/promotions
        # decided and dispatched but not yet completed, in dispatch order —
        # the piece a resumed run must re-dispatch to continue the same
        # trajectory.  Values are _Work records keyed by id(work.ind).
        self._open_children: Dict[int, _Work] = {}
        self._restored_in_flight: List[_Work] = []
        # Run-local maps (rebuilt by run()).
        self._queue: List[_Work] = []
        self._inflight: Dict[Any, _Work] = {}
        self._followers: Dict[Any, List[_Work]] = {}
        self._key_to_token: Dict[Any, Any] = {}
        self._cap = 1
        self._elastic = False
        self._evaluator = None

    # -- hooks (same contract as GeneticAlgorithm) -------------------------

    def set_checkpointer(self, checkpointer) -> None:
        """Attach a completion-boundary checkpointer (``utils/checkpoint.py``)."""
        self._checkpointer = checkpointer

    def set_fault_injector(self, injector) -> None:
        """Attach a chaos injector; ``master_boundary`` fires with the
        completion count, AFTER each checkpoint save — a ``kill_master``
        fault therefore lands exactly where resume is guaranteed from."""
        self._fault_injector = injector

    # -- selection ---------------------------------------------------------

    def select_parent(self) -> Individual:
        """Aging tournament over the ring's evaluated members."""
        with _tele.span("select"):
            members = [i for i in self.population if i.fitness_evaluated]
            t = min(self.tournament_size, len(members))
            idx = self.rng.choice(len(members), size=t, replace=False)
            contenders = [members[int(i)] for i in idx]
            key = lambda ind: ind.get_fitness()
            return max(contenders, key=key) if self.population.maximize else min(contenders, key=key)

    # -- the completion loop -----------------------------------------------

    def run(self, max_evaluations: int, checkpointer=None) -> Individual:
        """Run until ``max_evaluations`` evaluations completed (TOTAL, like
        the generational ``run`` under a checkpointer: the initial cohort
        counts, cache-answered children count, permanently failed
        evaluations count — the budget is completions, so the loop always
        terminates).  Returns a copy of the best individual ever measured.

        With ``checkpointer``, the run is crash-resumable: any existing
        checkpoint is restored first (ring, RNG state, history, best, and
        the children that were in flight), and a killed master re-run with
        the same arguments continues the search — deterministically, when
        the completion order is deterministic (see the module docstring).
        """
        if checkpointer is not None:
            self.set_checkpointer(checkpointer)
            if checkpointer.resume(self):
                logger.info("resumed async search at %d completion(s)", self.completed)
        budget = int(max_evaluations)
        evaluator = self._make_evaluator()
        self._evaluator = evaluator
        cap = self.max_in_flight
        # An explicit max_in_flight pins the target; None means "track the
        # fleet" — resolved once here (with the settling wait) and then
        # re-read every wake-up so the in-flight target follows workers
        # joining, draining, and re-advertising mid-run.
        self._elastic = cap is None
        if cap is None:
            cap = evaluator.default_capacity()
        self._cap = max(1, int(cap))
        self._last_ckpt = self.completed
        # Everything whose evaluation is owed but not running: unevaluated
        # ring members first (initial cohort / in-flight-at-kill members),
        # then checkpointed in-flight children/promotions in dispatch
        # order.  With a ladder, cohort members are measured through a
        # rung-0 probe (same genes, proxy overlay) so the whole search —
        # founders included — starts at proxy fidelity.
        self._queue = []
        for ind in self.population:
            if ind.fitness_evaluated:
                continue
            if self._ladder is None:
                self._queue.append(_Work(ind, True))
            else:
                probe = self.population.spawn(
                    genes=ind.get_genes(), additional_parameters=self._ladder[0])
                self._queue.append(_Work(probe, False, rung=0, target=ind))
        self._queue += self._restored_in_flight
        self._restored_in_flight = []
        self._inflight = {}
        self._followers = {}
        self._key_to_token = {}
        self._open_children = {}
        # Re-dispatch re-counts the queued work (members and restored
        # children alike), so the budget gate stays consistent on resume.
        self.dispatched = self.completed
        logger.info(
            "starting AsyncEvolution: ring=%d, budget=%d (%d done), in-flight target=%d",
            self.pop_size, budget, self.completed, self._cap,
        )
        self._status_session = getattr(self.population, "session", None) or "default"
        if self._surrogate is not None:
            # Bind the gate to this search (objective direction, per-tenant
            # dataset space, warm-start).  Idempotent — a resumed gate
            # (checkpoint carried ``prepared``) skips the refetch.
            self._surrogate.prepare(
                self.population.individuals[0].get_genes(),
                self.population.maximize, session=self._status_session)
        _health.register_engine_status(self._status_session, self._ops_status)
        with _tele.span("run", {"mode": "async", "budget": budget,
                                "max_in_flight": self._cap}) as run_span:
            # /statusz "active trace_id" (None while telemetry is off —
            # the no-op span has no trace_id attribute).
            self._run_trace_id = getattr(run_span, "trace_id", None)
            try:
                self._refill(evaluator, budget)
                while self.completed < budget and (self._inflight or self._queue):
                    # Advisory /statusz beat: one bool read when the ops
                    # plane is off.  Never gates /healthz — a wake-up can
                    # legitimately be an evaluation-time apart.
                    _health.beat("engine_loop")
                    events = evaluator.wait_any(self.job_timeout)
                    if not events:
                        raise TimeoutError(
                            f"no evaluation completed within {self.job_timeout}s "
                            f"({len(self._inflight)} in flight, "
                            f"{self.completed}/{budget} done)")
                    for token, fitness, error in events:
                        self._on_event(token, fitness, error)
                    if self._elastic:
                        # Elastic fleet: follow live membership.  A 0 read
                        # is a transient (every worker mid-reconnect or
                        # draining) — keep the last-known target so the
                        # refill gate doesn't collapse to zero and wedge.
                        live = evaluator.live_capacity()
                        if live > 0 and live != self._cap:
                            logger.info(
                                "in-flight target %d -> %d (fleet resized)",
                                self._cap, live)
                            self._cap = live
                    self._refill(evaluator, budget)
                    self._boundary()
            finally:
                _health.unregister_engine_status(self._status_session, self._ops_status)
                leftover = list(self._inflight)
                if leftover:
                    # Budget reached with children still training: their
                    # results are unwanted — withdraw instead of waiting.
                    evaluator.cancel(leftover)
                    for token in leftover:
                        work = self._inflight.pop(token)
                        self._open_children.pop(id(work.ind), None)
                        if work.target is not None:
                            work.target._promo_pending = False
                    self._key_to_token = {}
                    self._followers = {}
                for work in self._queue:
                    if work.target is not None:
                        work.target._promo_pending = False
                self._evaluator = None
                evaluator.close()
                # End-of-run fleet push (no-op when nothing is wired):
                # the final completion counters reach the aggregator.
                from .telemetry.aggregator import flush_active_pushers

                flush_active_pushers()
        if self.best is None:
            raise RuntimeError("no evaluation ever completed successfully")
        logger.info(
            "async search done: %d completion(s), best fitness %.6g, genes %s",
            self.completed, self.best.get_fitness(), self.best.get_genes(),
        )
        return self.best

    def _ops_status(self) -> Dict[str, Any]:
        """The ``/statusz`` "engine" block while an async search runs
        (``telemetry/health.py`` status provider; snapshot reads only —
        ``self.best`` is replaced wholesale, never mutated in place)."""
        best = self.best
        status = {
            "mode": "async",
            "session": getattr(self, "_status_session", "default"),
            "completed": self.completed,
            "dispatched": self.dispatched,
            "in_flight": len(self._inflight),
            "in_flight_target": self._cap,
            "queued": len(self._queue),
            "ring_size": self.pop_size,
            "best_fitness": best.get_fitness() if best is not None else None,
            "trace_id": getattr(self, "_run_trace_id", None),
        }
        if self._ladder is not None:
            # Per-rung ladder snapshot (docs/OBSERVABILITY.md): how far up
            # the fidelity ladder the search has climbed, at a glance.
            pending = [0] * len(self._ladder)
            for w in list(self._queue) + list(self._inflight.values()):
                if w.target is not None and w.rung < len(pending):
                    pending[w.rung] += 1
            status["rungs"] = [
                {
                    "rung": r,
                    "completions": len(self._rung_completions[r]),
                    "best_fitness": (self._best_by_rung[r].get_fitness()
                                     if r in self._best_by_rung else None),
                    "probes_pending": pending[r],
                }
                for r in range(len(self._ladder))
            ]
        if self._surrogate is not None:
            status["surrogate"] = self._surrogate.status()
        return status

    # -- internals ---------------------------------------------------------

    def _make_evaluator(self):
        if hasattr(self.population, "broker"):
            return _DistributedEvaluator(self.population)
        return _LocalEvaluator(self.max_in_flight or 1)

    def _can_breed(self) -> bool:
        return any(i.fitness_evaluated for i in self.population)

    def _breed(self) -> Individual:
        with _tele.span("reproduce"):
            mother = self.select_parent()
            father = self.select_parent()
            child = mother.reproduce(father, self.rng)
            if self._ladder is not None:
                # Every child enters the ladder at the proxy rung: same
                # genes, rung-0 overlay (spawn with explicit genes draws no
                # randomness, so the trajectory stays seed-pure).
                child = self.population.spawn(
                    genes=child.get_genes(),
                    additional_parameters=self._ladder[0])
            if _lineage.enabled():
                _lineage.record(
                    "born", _lineage.genome_key(child.get_genes()),
                    parents=[_lineage.genome_key(mother.get_genes()),
                             _lineage.genome_key(father.get_genes())],
                    op="reproduce", genes=child.get_genes())
            return child

    def _next_child(self) -> Individual:
        """Breed the next dispatchable child — through the surrogate gate
        (rung −1) when one is attached.  A rejected child is recorded
        (``gate_rejected`` lineage event + counter inside the gate) and
        immediately replaced by re-breeding, so the caller always gets a
        child and the in-flight target stays saturated; the gate's
        reject-streak cap bounds the loop.  Rejections happen BEFORE the
        dispatch count, so they never consume budget."""
        child = self._breed()
        gate = self._surrogate
        if gate is None:
            return child
        while True:
            admit, score = gate.decide(child.get_genes(), rung=0)
            if admit:
                return child
            if _lineage.enabled():
                _lineage.record(
                    "gate_rejected", _lineage.genome_key(child.get_genes()),
                    score=score, rung=0)
            child = self._breed()

    def _tag_fidelity(self, work: _Work) -> None:
        """Stamp the wire fidelity tag on an outgoing individual (OPTIONAL
        per-job ``fidelity`` field, see ``distributed/protocol.py``) —
        workers cross-check it against the shipped config before training."""
        if self._ladder is None:
            return
        work.ind._fidelity_tag = {
            "v": 1,
            "rung": work.rung,
            "fingerprint": fidelity_fingerprint(work.ind.additional_parameters),
        }

    def _refill(self, evaluator, budget: int) -> None:
        """Top the in-flight set back up to the target, breeding as needed.

        Children bred in one wake-up ship as ONE submit (one coalesced
        ``jobs`` frame per worker window downstream).  Dispatch-side dedup:
        a child already in the fitness cache (this search or a loaded
        fitness store) completes instantly; a child identical to an
        in-flight job becomes its follower.  Neither occupies a slot, so
        the loop keeps breeding until real work fills the capacity or the
        budget is spent.  Promotion probes queued by completions take
        strict priority over fresh breeding (they are the scarce
        high-fidelity work the ladder exists to schedule).
        """
        tele = _tele.enabled()
        to_submit: List[Tuple[_Work, Any]] = []
        while (self.dispatched < budget
               and len(self._inflight) + len(to_submit) < self._cap):
            if self._queue:
                work = self._queue.pop(0)
            elif self._can_breed():
                work = _Work(self._next_child(), False)
            else:
                break  # nothing evaluated yet: wait for the cohort
            self.dispatched += 1
            key = self.population._safe_cache_key(work.ind)
            cached = self.population.fitness_cache.get(key) if key is not None else None
            if cached is not None:
                if tele:
                    _get_registry().counter(
                        "fitness_cache_hits_total", rung=str(work.rung)).inc()
                if _lineage.enabled():
                    _lineage.record(
                        "cache_hit",
                        _lineage.genome_key(work.ind.get_genes()),
                        source="local", rung=work.rung)
                self._complete(work, float(cached), cached=True)
                continue
            if tele:
                _get_registry().counter(
                    "fitness_cache_misses_total", rung=str(work.rung)).inc()
            token = self._key_to_token.get(key) if key is not None else None
            if token is not None:
                self._followers.setdefault(token, []).append(work)
                self._track_open(work)
                if _lineage.enabled():
                    _lineage.record(
                        "follower_attach",
                        _lineage.genome_key(work.ind.get_genes()),
                        rung=work.rung)
                continue
            to_submit.append((work, key))
        if to_submit:
            for work, _ in to_submit:
                self._tag_fidelity(work)
            tokens = evaluator.submit([w.ind for w, _ in to_submit])
            for token, (work, key) in zip(tokens, to_submit):
                self._inflight[token] = work
                if key is not None:
                    self._key_to_token[key] = token
                self._track_open(work)

    def _track_open(self, work: _Work) -> None:
        """Record dispatched-but-unfinished work the checkpoint must carry.

        Children and PROMOTION probes are serialized (the breeding RNG
        draws / promotion decision behind them are already spent, so a
        resumed run must re-dispatch exactly these).  Ladder-mode COHORT
        probes are not: an unevaluated ring member re-probes from the ring
        state alone.
        """
        if work.is_member:
            return
        if work.target is not None and not work.target.fitness_evaluated:
            return  # cohort probe — reconstructed from the ring on resume
        self._open_children[id(work.ind)] = work

    def _on_event(self, token, fitness: Optional[float], error: Optional[str]) -> None:
        work = self._inflight.pop(token, None)
        if work is None:
            return  # cancelled/stale
        key = self.population._safe_cache_key(work.ind)
        if key is not None and self._key_to_token.get(key) is token:
            del self._key_to_token[key]
        followers = self._followers.pop(token, [])
        if error is not None:
            self._fail(work, error)
            for f in followers:
                self._fail(f, error)
            return
        self._complete(work, fitness)
        for f in followers:
            self._complete(f, fitness)

    def _complete(self, work: _Work, fitness: float, cached: bool = False) -> None:
        """One evaluation finished: membership, cache, best, history,
        and — with a ladder — the ASHA promotion sweep at this rung."""
        ind = work.ind
        if not ind.fitness_evaluated:
            ind.set_fitness(fitness)
        key = self.population._safe_cache_key(ind)
        if key is not None and not cached:
            self.population.fitness_cache[key] = float(fitness)
        self._open_children.pop(id(ind), None)
        if work.target is not None:
            # Probe landing: the measurement belongs to the ring member.
            # A promotion REPLACES the member's lower-rung fitness in
            # place, so tournament selection always compares each member
            # at its highest completed rung.
            member = work.target
            member.set_fitness(float(fitness))
            member._rung = work.rung
            member._promo_pending = False
        elif not work.is_member:
            # Steady-state transition: child in (youngest), oldest out.
            if self._ladder is not None:
                ind._rung = work.rung
            self.population.insert(ind)
            if len(self.population) > self.pop_size:
                evicted = self.population.evict_oldest()
                if evicted is not None:
                    self._cancel_promotions_for(evicted)
                    if _lineage.enabled():
                        _lineage.record(
                            "evicted",
                            _lineage.genome_key(evicted.get_genes()))
        elif self._ladder is not None:
            ind._rung = work.rung
        self._update_best(work, float(fitness))
        self.completed += 1
        if self._surrogate is not None:
            # Every completion trains rung −1 (members, probes, cached and
            # failed-over followers alike) and resolves the child's pending
            # gate decision into the precision@k buffer.
            self._surrogate.observe_result(
                ind.get_genes(), work.rung, float(fitness))
        if _lineage.enabled():
            _lineage.record(
                "completed", _lineage.genome_key(ind.get_genes()),
                fitness=float(fitness), rung=work.rung,
                cached=bool(cached) or None,
                promotion=(work.target is not None and work.rung > 0) or None)
        entry = {
            "completed": self.completed,
            "fitness": float(fitness),
            "best_fitness": self.best.get_fitness(),
            "in_flight": len(self._inflight),
            "cached": bool(cached),
        }
        if self._ladder is not None:
            entry["rung"] = work.rung
            entry["promotion"] = work.target is not None and work.rung > 0
            self._rung_completions[work.rung].append(float(fitness))
            self._maybe_promote(work.rung)
        self.history.append(entry)

    def _update_best(self, work: _Work, fitness: float) -> None:
        maximize = self.population.maximize

        def _better(f, incumbent):
            if incumbent is None:
                return True
            inc = incumbent.get_fitness()
            return f > inc if maximize else f < inc

        if self._ladder is None:
            if _better(fitness, self.best):
                self.best = work.ind.copy()  # keeps the fitness
            return
        # Ladder mode: proxy and full-schedule fitnesses are different
        # quantities — track a best per rung, and expose the best at the
        # highest rung that has completed anything as THE best.
        if _better(fitness, self._best_by_rung.get(work.rung)):
            b = work.ind.copy()
            b.set_fitness(fitness)
            b._rung = work.rung
            self._best_by_rung[work.rung] = b
        self.best = self._best_by_rung[max(self._best_by_rung)]

    def _maybe_promote(self, rung: int) -> None:
        """ASHA promotion sweep after a completion at ``rung``: the rung
        owns ``completions // eta`` promotion slots, of which the sweep
        fills the still-open ones — best ring member first, and only with
        members whose fitness makes the top-``quota`` cut.  Filling at
        most the open slots is what keeps the rung sizes geometric
        (≈ 1/eta of the rung below); the cut alone would over-promote,
        because ring turnover keeps producing members above a historical
        threshold.  No barrier: the sweep never waits for stragglers, it
        only reads what has already completed (Li et al. 2020, §3.1)."""
        if self._ladder is None or rung + 1 >= len(self._ladder):
            return
        vals = self._rung_completions[rung]
        quota = len(vals) // self.eta
        if quota <= 0:
            return
        # Promotions already spent from this rung: completions at rung+1
        # (everything above rung 0 got there only by promotion) plus probes
        # still queued or training.  Derived, not counted — so a cancelled
        # or failed probe refunds its slot automatically and a resumed
        # checkpoint reconstructs the same number from the same state.
        spent = len(self._rung_completions[rung + 1]) + sum(
            1 for w in list(self._queue) + list(self._inflight.values())
            if w.target is not None and w.rung == rung + 1)
        open_slots = quota - spent
        if open_slots <= 0:
            return
        cut = sorted(vals, reverse=self.population.maximize)[quota - 1]
        candidates = []
        for member in list(self.population):
            if getattr(member, "_rung", None) != rung:
                continue
            if getattr(member, "_promo_pending", False):
                continue
            if getattr(member, "_promo_failed_rung", None) == rung + 1:
                continue  # its probe failed permanently — no retry loop
            if not member.fitness_evaluated:
                continue
            f = member.get_fitness()
            if (f < cut) if self.population.maximize else (f > cut):
                continue
            candidates.append(member)
        # Best-first within the open slots (stable sort → ring order breaks
        # ties deterministically).
        candidates.sort(key=lambda m: m.get_fitness(),
                        reverse=self.population.maximize)
        tele = _tele.enabled()
        lin = _lineage.enabled()
        for member in candidates[:open_slots]:
            probe = self.population.spawn(
                genes=member.get_genes(),
                additional_parameters=self._ladder[rung + 1])
            member._promo_pending = True
            self._queue.append(_Work(probe, False, rung=rung + 1, target=member))
            if tele:
                _get_registry().counter(
                    "promotions_total", rung=str(rung + 1)).inc()
            if lin:
                _lineage.record(
                    "promoted", _lineage.genome_key(member.get_genes()),
                    from_rung=rung, to_rung=rung + 1)

    def _cancel_promotions_for(self, member: Individual) -> None:
        """Withdraw any queued or in-flight promotion probe targeting an
        evicted member: its result could no longer join the ring, and an
        abandoned in-flight probe would leak a ``jobs_in_flight`` slot.
        The broker's cancel restores the worker's credit; the dispatch
        count is retracted so the budget still measures completions."""
        if self._ladder is None or not getattr(member, "_promo_pending", False):
            return
        # Queued probes were never dispatched — dropping them costs nothing.
        self._queue = [w for w in self._queue if w.target is not member]
        stale = [tok for tok, w in self._inflight.items() if w.target is member]
        for tok in stale:
            w = self._inflight.pop(tok)
            key = self.population._safe_cache_key(w.ind)
            if key is not None and self._key_to_token.get(key) is tok:
                del self._key_to_token[key]
            self._open_children.pop(id(w.ind), None)
            self.dispatched -= 1  # retracted, never completing
            for f in self._followers.pop(tok, []):
                # Followers ride another token's evaluation; with it
                # cancelled they go back to the queue (their dispatch is
                # retracted too — they re-count when re-popped).
                self.dispatched -= 1
                self._open_children.pop(id(f.ind), None)
                if f.target is not member:
                    self._queue.insert(0, f)
        if stale and self._evaluator is not None:
            self._evaluator.cancel(stale)
            if _tele.enabled():
                _get_registry().counter(
                    "promotions_cancelled_total").inc(len(stale))
        member._promo_pending = False

    def _fail(self, work: _Work, reason: str) -> None:
        """A permanently failed evaluation consumes budget and breeds a
        replacement (via the next refill) but never joins the ring — a
        failed MEMBER leaves it, so aging eviction never has to step over
        a corpse, and a failed PROMOTION probe leaves its member exactly
        as it was (lower-rung fitness intact, marked so the ladder never
        retries the same doomed promotion)."""
        logger.warning("async evaluation failed permanently: %s", reason)
        ind = work.ind
        if self._surrogate is not None:
            self._surrogate.forget(ind.get_genes())
        if _lineage.enabled():
            _lineage.record(
                "failed", _lineage.genome_key(ind.get_genes()),
                rung=work.rung, reason=str(reason)[:200])
        self._open_children.pop(id(ind), None)
        if work.target is not None:
            work.target._promo_pending = False
            if work.target.fitness_evaluated:
                work.target._promo_failed_rung = work.rung
            else:
                # A failed COHORT probe: the member never got a fitness at
                # all — it leaves the ring like any failed member would.
                try:
                    self.population.individuals.remove(work.target)
                except ValueError:  # pragma: no cover - defensive
                    pass
        elif work.is_member:
            try:
                self.population.individuals.remove(ind)
            except ValueError:  # pragma: no cover - defensive
                pass
        self.completed += 1
        entry = {
            "completed": self.completed,
            "fitness": None,
            "best_fitness": None if self.best is None else self.best.get_fitness(),
            "in_flight": len(self._inflight),
            "failed": True,
        }
        if self._ladder is not None:
            entry["rung"] = work.rung
        self.history.append(entry)

    def _boundary(self) -> None:
        """Checkpoint (and fire the chaos boundary hook) every
        ``checkpoint_every`` completions — the async analogue of the
        generation boundary."""
        if self.completed - self._last_ckpt < self.checkpoint_every:
            return
        self._last_ckpt = self.completed
        # Search-progress gauges for the fleet dashboard — the async
        # analogue of the generational engine's per-generation set, at the
        # same cadence as the checkpoint boundary (never per completion).
        sess = getattr(self, "_status_session", None) or "default"
        reg = _get_registry()
        reg.gauge("engine_completions", session=sess,
                  mode="async").set(self.completed)
        if self.best is not None and self.best.get_fitness() is not None:
            reg.gauge("engine_best_fitness", session=sess,
                      mode="async").set(float(self.best.get_fitness()))
        if self._checkpointer is not None:
            with _tele.span("checkpoint"):
                self._checkpointer.save(self)
        if self._fault_injector is not None:
            # After the checkpoint: a kill here is the recoverable crash.
            self._fault_injector.master_boundary(self.completed)

    # -- (de)serialization state for checkpoint/resume ---------------------

    def _member_index(self, member: Individual) -> Optional[int]:
        for i, ind in enumerate(self.population.individuals):
            if ind is member:
                return i
        return None

    def _work_state(self, w: _Work) -> Optional[Dict[str, Any]]:
        """One laddered in-flight/queued checkpoint entry, or None for a
        promotion whose member already left the ring (eviction cancels
        those — nothing to resume)."""
        entry: Dict[str, Any] = {
            "genes": w.ind.get_genes(),
            "rung": w.rung,
            "kind": "child" if w.target is None else "promotion",
        }
        if w.target is not None:
            idx = self._member_index(w.target)
            if idx is None:  # pragma: no cover - eviction cancels these
                return None
            entry["member_index"] = idx
        return entry

    def state_dict(self) -> Dict[str, Any]:
        fitness_cache = [
            [k, v]
            for k, v in self.population.fitness_cache.items()
            if is_serializable_key(k)
        ]
        if self._ladder is None:
            # Ladderless: the exact v2 in-flight shape (a list of genes).
            open_children: List[Any] = [
                w.ind.get_genes() for w in self._open_children.values()]
        else:
            # v3: enough to resume a promotion AS a promotion — the rung,
            # and which ring member the probe reports to.
            open_children = []
            for w in self._open_children.values():
                entry = self._work_state(w)
                if entry is not None:
                    open_children.append(entry)
            # Decided-but-undispatched work (the queue): promotion probes
            # and requeued children waiting for an in-flight slot.  Cohort
            # probes are NOT serialized — their members are unevaluated in
            # the ring, so ``run()`` reconstructs them — but a queued
            # promotion dropped here would silently demote its member on
            # resume and diverge from the uninterrupted trajectory.
            queued = []
            for w in self._queue:
                if w.target is not None and not w.target.fitness_evaluated:
                    continue  # cohort probe: rebuilt from the ring
                entry = self._work_state(w)
                if entry is not None:
                    queued.append(entry)
        state = {
            "algorithm": "AsyncEvolution",
            "fitness_protocol": FITNESS_PROTOCOL,
            "fitness_cache": fitness_cache,
            "completed": self.completed,
            "dispatched": self.completed + len(open_children),
            "tournament_size": self.tournament_size,
            "max_in_flight": self.max_in_flight,
            "checkpoint_every": self.checkpoint_every,
            "rng_state": self.rng.bit_generator.state,
            "history": self.history,
            "best": None if self.best is None else {
                "genes": self.best.get_genes(),
                "fitness": self.best.get_fitness(),
            },
            "population": {
                "size": self.pop_size,
                "maximize": self.population.maximize,
                "crossover_rate": self.population.crossover_rate,
                "mutation_rate": self.population.mutation_rate,
                "additional_parameters": self.population.additional_parameters,
                "individuals": [
                    self._member_state(ind) for ind in self.population
                ],
            },
            # Children bred-but-uncompleted, in dispatch order: a resumed
            # run re-dispatches exactly these (the breeding RNG draws that
            # produced them are already consumed in rng_state).
            "in_flight": open_children,
        }
        if self._ladder is not None:
            state["queued"] = queued
            state["ladder"] = self._ladder
            state["eta"] = self.eta
            state["rung_completions"] = self._rung_completions
            state["best_by_rung"] = [
                {"rung": r, "genes": b.get_genes(), "fitness": b.get_fitness()}
                for r, b in sorted(self._best_by_rung.items())
            ]
        if self._surrogate is not None:
            # Schema v4: the whole rung −1 — model weights AND training
            # samples, score window, pending gate decisions — so a killed
            # master resumes the gated trajectory bit-identically.
            state["surrogate"] = self._surrogate.state_dict()
        return state

    def _member_state(self, ind: Individual) -> Dict[str, Any]:
        entry: Dict[str, Any] = {"genes": ind.get_genes(), "fitness": ind._fitness}
        if self._ladder is not None:
            entry["rung"] = getattr(ind, "_rung", 0)
            failed = getattr(ind, "_promo_failed_rung", None)
            if failed is not None:
                entry["promo_failed_rung"] = failed
        return entry

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        algo = state.get("algorithm")
        if algo not in (None, "AsyncEvolution"):
            raise ValueError(
                f"checkpoint was written by {algo}, not AsyncEvolution — "
                "generational and steady-state scheduler state are not "
                "interchangeable; resume it with the matching class")
        self.completed = int(state["completed"])
        self.tournament_size = int(state["tournament_size"])
        if state.get("max_in_flight") is not None:
            self.max_in_flight = int(state["max_in_flight"])
        self.checkpoint_every = int(state.get("checkpoint_every", self.checkpoint_every))
        self.rng.bit_generator.state = state["rng_state"]
        self.history = list(state["history"])
        pop_state = state["population"]
        self.pop_size = int(pop_state.get("size", len(pop_state["individuals"])))
        self.population.maximize = bool(pop_state["maximize"])
        self.population.crossover_rate = float(pop_state["crossover_rate"])
        self.population.mutation_rate = float(pop_state["mutation_rate"])
        self.population.additional_parameters = dict(pop_state["additional_parameters"])
        # Same cross-protocol guard as the generational loader: fitnesses
        # measured under an older fitness-RNG protocol are incomparable —
        # drop them (loudly) and let the ring re-measure.
        proto = state.get("fitness_protocol", 1)
        proto_ok = proto == FITNESS_PROTOCOL
        if not proto_ok:
            logger.warning(
                "checkpoint was written under fitness RNG protocol %s "
                "(current: %s); discarding its fitness values, cache, best, "
                "rung records and surrogate measurements — the resumed "
                "search re-measures instead of mixing incomparable "
                "measurements", proto, FITNESS_PROTOCOL,
            )
        # Ladder state (schema v3).  The checkpoint's ladder wins over the
        # constructor's, like every other serialized knob — a resumed run
        # continues the SAME search, not a reconfigured one.
        ladder = state.get("ladder")
        if ladder is not None:
            self._ladder = [dict(r) for r in ladder]
            self.eta = int(state.get("eta", self.eta))
            self._rung_completions = [
                [float(v) for v in rung] if proto_ok else []
                for rung in state.get("rung_completions",
                                      [[] for _ in self._ladder])
            ]
        # Surrogate state (schema v4).  The checkpoint's gate wins over the
        # constructor's (same precedent as the ladder): a resumed run
        # continues the SAME gated search.  A v3 file (no "surrogate" key)
        # under a gated ctor keeps the ctor's fresh gate — it just starts
        # untrained, i.e. admit-all.
        sur_state = state.get("surrogate")
        if sur_state is not None:
            if self._surrogate is None:
                self._surrogate = SurrogateGate.from_state(sur_state)
            else:
                self._surrogate.load_state_dict(sur_state)
            if not proto_ok:
                # Its samples, window and pending decisions are fitness
                # values of the other namespace; the gate starts untrained.
                self._surrogate.drop_measurements()
        individuals = []
        for ind_state in pop_state["individuals"]:
            ind = self.population.spawn(genes=ind_state["genes"])
            if ind_state["fitness"] is not None and proto_ok:
                ind.set_fitness(ind_state["fitness"])
                if self._ladder is not None:
                    ind._rung = int(ind_state.get("rung", 0))
            if ind_state.get("promo_failed_rung") is not None:
                ind._promo_failed_rung = int(ind_state["promo_failed_rung"])
            individuals.append(ind)
        self.population.individuals = individuals
        restored = {
            tuplify(key): float(fit) for key, fit in state.get("fitness_cache", [])
        } if proto_ok else {}
        # Keep a ServiceBackedCache's shared-service backing across resume
        # (same duck-typed hook as GeneticAlgorithm.load_state_dict).
        cache = self.population.fitness_cache
        if hasattr(cache, "rebase"):
            cache.rebase(restored)
        else:
            self.population.fitness_cache = restored
        best = state.get("best")
        if best is not None and proto_ok:
            b = self.population.spawn(genes=best["genes"])
            b.set_fitness(best["fitness"])
            self.best = b
        else:
            self.best = None
        self._best_by_rung = {}
        if self._ladder is not None and proto_ok:
            for entry in state.get("best_by_rung", []):
                r = int(entry["rung"])
                overlay = self._ladder[min(r, len(self._ladder) - 1)]
                b = self.population.spawn(
                    genes=entry["genes"], additional_parameters=overlay)
                b.set_fitness(entry["fitness"])
                b._rung = r
                self._best_by_rung[r] = b
            if self._best_by_rung:
                self.best = self._best_by_rung[max(self._best_by_rung)]
        self._restored_in_flight = []
        # In-flight first, then the undispatched queue — the original
        # dispatch order, so the resumed trajectory replays it.
        for entry in list(state.get("in_flight", [])) + list(state.get("queued", [])):
            if self._ladder is None:
                # v2 shape: the entry IS the genes dict of a rung-0 child.
                self._restored_in_flight.append(
                    _Work(self.population.spawn(genes=entry), False))
                continue
            if "kind" not in entry:  # v2 file resumed WITH a ladder ctor
                entry = {"genes": entry, "rung": 0, "kind": "child"}
            rung = min(int(entry.get("rung", 0)), len(self._ladder) - 1)
            overlay = self._ladder[rung]
            probe = self.population.spawn(
                genes=entry["genes"], additional_parameters=overlay)
            target = None
            if entry.get("kind") == "promotion":
                if not proto_ok:
                    continue  # its member lost the fitness it was promoted on
                idx = entry.get("member_index")
                if idx is not None and 0 <= int(idx) < len(individuals):
                    target = individuals[int(idx)]
                    target._promo_pending = True
                else:  # pragma: no cover - defensive
                    continue
            self._restored_in_flight.append(
                _Work(probe, False, rung=rung, target=target))
        self._last_ckpt = self.completed
