"""Master-side distribution: a Population that farms fitness out to workers.

Reference parity: ``DistributedPopulation`` (and the [UNCERTAIN]
``DistributedGridPopulation``) in ``gentun/server.py`` [PUB][BASELINE]
(SURVEY.md §2.0 row 10, §3.2).  Preserved semantics:

- constructed WITHOUT training data — workers own the data, the master
  ships only genes + ``additional_parameters`` and receives fitness scalars;
- drop-in replacement for ``Population``: the GA outer loop is unchanged;
- fitness evaluation publishes one job per unevaluated individual and
  blocks until every reply arrives (the per-generation barrier);
- at-least-once delivery with dedup is the broker's job
  (``distributed/broker.py``).

The broker is embedded: constructing a ``DistributedPopulation`` starts a
TCP listener inside the master process (no external RabbitMQ — SURVEY.md
§2.1), and successive generations share it via :meth:`clone_with`.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Type

import numpy as np

from ..individuals import Individual
from ..parallel.mesh import SIZE_SMALL, job_size_class
from ..populations import GridPopulation, Population
from ..telemetry import health as _health
from ..telemetry import lineage as _lineage
from ..telemetry import spans as _tele
from ..telemetry.registry import get_registry as _get_registry
from .broker import GatherTimeout, JobBroker, JobFailed
from .sessions import DEFAULT_SESSION

__all__ = ["DistributedPopulation", "DistributedGridPopulation"]

logger = logging.getLogger("gentun_tpu_torch.distributed")
#: Seconds between checks for jobs a restarted embedded broker lost.
_LOST_JOB_POLL_S = 1.0


def _params_copier():
    """One defensive payload copy per DISTINCT source dict per submit call.

    A population's individuals overwhelmingly share ONE
    ``additional_parameters`` dict (the run config), yet each payload used
    to take its own ``dict()`` copy — N copies the broker then serializes
    into N identical wire fragments.  Memoizing the copy by source identity
    keeps the caller-isolation contract (payloads never alias a dict the
    caller can mutate) while giving the wire fast path one shared object
    per config, so ``jobs2`` envelope grouping and the fragment cache see
    maximal sharing.  id() keying is safe here: the memo only lives for one
    submit call, during which the source individuals are referenced.
    """
    copies: Dict[int, Dict[str, Any]] = {}

    def copy(src: Mapping[str, Any]) -> Dict[str, Any]:
        c = copies.get(id(src))
        if c is None:
            c = copies[id(src)] = dict(src)
        return c

    return copy


class DistributedPopulation(Population):
    """Population whose fitness sweep runs on remote workers.

    Extra constructor knobs versus :class:`Population` (data args are gone):

    - ``host``/``port``: broker bind address (``port=0`` = ephemeral; read
      the bound address from :attr:`broker_address` to point workers at it).
    - ``user``/``password``: auth parity with the reference's RabbitMQ
      kwargs [PUB]; ``password`` becomes the broker token.
    - ``job_timeout``: per-generation barrier timeout in seconds (None =
      wait forever, the reference's behavior).
    - ``broker``: share an existing started :class:`JobBroker` instead of
      owning one (used by :meth:`clone_with` across generations).
    - ``evaluate_retries``: extra :meth:`evaluate` passes after a
      ``JobFailed``/``GatherTimeout`` before giving up.  Each retry reships
      ONLY the still-unevaluated individuals (finished fitnesses are
      applied before the exception propagates internally), with fresh
      broker attempt counts — so a transient worker glitch or straggler
      timeout no longer kills a 50-generation search (the reference's
      AMQP redelivers forever and never surfaces this).
    - ``failed_policy``: what to do when retries are exhausted and some
      individuals still lack fitness.  ``"raise"`` (default) re-raises —
      today's loud behavior; ``"penalize"`` assigns them the worst
      fitness observed in the generation (never cached — a penalty is not
      a measurement) and lets the search continue, unless NOTHING
      evaluated at all, which still raises.
    - ``fitness_store``: path to a cross-run fitness store
      (``utils/fitness_store.py``).  Loaded at construction (in-memory
      ``fitness_cache`` entries win on collision) and merged back
      atomically at :meth:`close` — a repeated distributed search over
      already-measured genomes ships ZERO jobs.  The store rides
      ``clone_with``, so closing whichever generation's population the
      caller ends up holding saves every fitness the search measured.
    - ``cache_url``: base URL of a shared fitness service
      (``distributed/fitness_service.py``, ``http://host:port``).  The
      population's ``fitness_cache`` becomes a
      :class:`~gentun_tpu_torch.distributed.fitness_service.ServiceBackedCache`:
      local misses read through to the service (a genome ANY run already
      measured completes instantly, never dispatched — the dispatch-side
      dedup extended across runs) and new measurements publish
      write-behind.  Layers OVER ``fitness_store`` (file entries seed the
      local side; the file still saves at :meth:`close`).  Service downtime
      degrades to local-only with a ``fitness_service_degraded`` telemetry
      event — it never fails the search.  Note: when both ``fitness_cache``
      and ``cache_url`` are given, the wrapped cache is a NEW dict seeded
      from the one passed in (clones still share the wrapper by identity).
    - ``fault_injector``: chaos testing (``distributed/faults.py``).
      Passed through to an owned :class:`JobBroker`; ignored when an
      external ``broker`` is shared (inject on that broker directly).
    - ``straggler_floor_s``/``straggler_k``/``straggler_requeue``: stall
      watchdog tuning for an owned broker (``telemetry/health.py``; active
      only while the ops plane is on — see docs/OBSERVABILITY.md "Live ops
      plane").  Ignored when sharing an external ``broker``.
    - ``session``: multi-tenant search sessions (``distributed/sessions.py``,
      DISTRIBUTED.md "Multi-tenant search sessions").  Naming a session
      opens it on the broker (idempotent) and tags every job this
      population ships with it; ``fleet_capacity``/``fleet_prefetch``
      then report THIS session's fair share of the fleet, so N engines
      sharing one broker via ``broker=`` size themselves to their shares
      with no engine changes.  ``None`` (default) rides the implicit
      single-tenant session — byte-identical pre-session behavior.
    - ``session_weight``/``session_quota``: the session's fair-share
      priority and optional hard in-flight cap (only meaningful with
      ``session``).
    - ``cache_namespace``: optional per-session key prefix for the shared
      fitness service (only meaningful with ``cache_url``).  The DEFAULT
      is no namespace — cross-tenant dedup stays ON, because cache keys
      are content-addressed (a fitness is a property of the genome, not
      the tenant; quotas govern compute, not cache hits).  Set it only to
      ISOLATE a tenant whose measurements must not be shared (different
      data, incompatible species).
    - ``aggregator_url``: optional fleet metrics aggregator
      (``telemetry/aggregator.py``).  The master pushes periodic metric
      snapshots there (role ``master``; the owned broker merges into the
      same per-process pusher) for the life of the population.  Fail-open
      with cooldown — aggregator downtime can never touch a search.
    """

    def __init__(
        self,
        species: Type[Individual],
        individual_list: Optional[Sequence[Individual]] = None,
        size: Optional[int] = None,
        crossover_rate: float = 0.5,
        mutation_rate: float = 0.015,
        maximize: bool = True,
        additional_parameters: Optional[Dict[str, Any]] = None,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        user: Optional[str] = None,
        password: Optional[str] = None,
        job_timeout: Optional[float] = None,
        max_attempts: int = 3,
        heartbeat_timeout: float = 15.0,
        broker: Optional[JobBroker] = None,
        fitness_cache: Optional[Dict[Any, float]] = None,
        evaluate_retries: int = 0,
        failed_policy: str = "raise",
        fitness_store: Optional[str] = None,
        cache_url: Optional[str] = None,
        speculative_fill=False,
        fault_injector=None,
        straggler_floor_s: float = 30.0,
        straggler_k: float = 4.0,
        straggler_requeue: bool = False,
        session: Optional[str] = None,
        session_weight: float = 1.0,
        session_quota: Optional[int] = None,
        cache_namespace: Optional[str] = None,
        aggregator_url: Optional[str] = None,
        broker_urls: Optional[list] = None,
    ):
        if failed_policy not in ("raise", "penalize"):
            raise ValueError(f"unknown failed_policy {failed_policy!r}")
        self.fitness_store = fitness_store
        if fitness_store:
            from ..utils.fitness_store import load_fitness_cache

            loaded = load_fitness_cache(fitness_store)
            if fitness_cache is None:
                fitness_cache = loaded
            else:
                # Merge IN PLACE so the provided dict keeps its identity
                # (clones share the cache object); live measurements beat
                # stored ones, hence setdefault.
                for k, v in loaded.items():
                    fitness_cache.setdefault(k, v)
        self.cache_url = cache_url
        self.cache_namespace = cache_namespace
        self._cache_client = None
        self._cache_status_fn = None
        if cache_url:
            from .fitness_service import FitnessServiceClient, ServiceBackedCache

            self._cache_client = FitnessServiceClient(cache_url)
            # Wrap AFTER the store merge so file entries seed the local
            # side (they stay local; only new measurements publish).  The
            # wrapper IS the fitness_cache from here on — clones share it
            # by identity like any cache dict.
            fitness_cache = ServiceBackedCache(self._cache_client, fitness_cache,
                                               namespace=cache_namespace)
            cache = fitness_cache
            # One callable object for register AND unregister (removal is
            # identity-checked); closed over the cache, not self, so any
            # clone's close() can evict it.
            self._cache_status_fn = cache.stats
            _health.register_status_provider("fitness_service", self._cache_status_fn)
        # Fleet observability (telemetry/aggregator.py): the master pushes
        # its metric snapshots for as long as this population lives.  The
        # per-process pusher is refcounted and shared per URL, so the owned
        # in-process broker below wiring the same URL merges into one
        # instance (role "master+broker") — never a double-counted fleet.
        self.aggregator_url = aggregator_url
        self._pusher = None
        if aggregator_url:
            from ..telemetry.aggregator import acquire_pusher

            self._pusher = acquire_pusher(aggregator_url, role="master")
        super().__init__(
            species,
            x_train=None,
            y_train=None,
            individual_list=individual_list,
            size=size,
            crossover_rate=crossover_rate,
            mutation_rate=mutation_rate,
            maximize=maximize,
            additional_parameters=additional_parameters,
            seed=seed,
            rng=rng,
            fitness_cache=fitness_cache,
            speculative_fill=speculative_fill,
        )
        self.job_timeout = job_timeout
        self.evaluate_retries = int(evaluate_retries)
        self.failed_policy = failed_policy
        #: populated by every evaluate() call: {"attempts", "retries",
        #: "penalized"} — the GA merges it into the generation history.
        self.eval_stats: Dict[str, int] = {}
        if broker is not None and broker_urls:
            raise ValueError("pass broker= OR broker_urls=, not both")
        if broker is not None:
            self.broker = broker
            self._owns_broker = False
        elif broker_urls:
            # Horizontal sharding: this master is a TENANT of
            # N operator-run broker shards — its session is consistent-
            # hashed to ONE home shard and every broker call goes over
            # the wire through the ShardedBroker facade.  Broker-process
            # knobs (heartbeat_timeout, max_attempts, stragglers, fault
            # injection) belong to the shard operators, not this ctor.
            if fault_injector is not None:
                raise ValueError(
                    "fault_injector requires an embedded broker, not broker_urls")
            from .shard import ShardedBroker

            self.broker = ShardedBroker(
                broker_urls, token=password,
                retry_window=max(60.0, float(job_timeout or 0.0)))
            # "Owns" the facade (close() must drop its shard connections);
            # the shard broker PROCESSES are operator-owned and outlive us.
            self._owns_broker = True
        else:
            self.broker = JobBroker(
                host=host,
                port=port,
                token=password,
                heartbeat_timeout=heartbeat_timeout,
                max_attempts=max_attempts,
                fault_injector=fault_injector,
                straggler_floor_s=straggler_floor_s,
                straggler_k=straggler_k,
                straggler_requeue=straggler_requeue,
                aggregator_url=aggregator_url,
            ).start()
            self._owns_broker = True
        # Session tenancy: an explicit session is opened on the broker
        # (idempotent — a clone or a reconnecting master re-attaches) and
        # tags every submit from this population.  _session_arg stays None
        # for the implicit default so submits stay untagged (and the
        # default session is only lazily created broker-side).
        self._session_arg = str(session) if session else None
        # Steady-state submits not yet terminal: job id -> (payload, the
        # broker's journal epoch when last known held).
        self._open_async: Dict[str, tuple] = {}
        self.session = self._session_arg or DEFAULT_SESSION
        self.session_weight = float(session_weight)
        self.session_quota = session_quota
        if self._session_arg is not None:
            self.broker.open_session(self._session_arg, weight=session_weight,
                                     max_in_flight=session_quota)

    # -- lifecycle ---------------------------------------------------------

    @property
    def broker_address(self) -> tuple:
        return self.broker.address

    def close(self) -> None:
        # Persist first (a stopped broker must not lose fitnesses), but a
        # save failure must not leave the listener running either.
        try:
            if self.fitness_store:
                from ..utils.fitness_store import save_fitness_cache

                n = save_fitness_cache(self.fitness_cache, self.fitness_store)
                logger.info("fitness store %s: %d entries after merge", self.fitness_store, n)
        finally:
            if self._cache_client is not None:
                if self._cache_status_fn is not None:
                    _health.unregister_status_provider(
                        "fitness_service", self._cache_status_fn)
                # Flush the write-behind queue so the LAST generation's
                # measurements reach the service too, then stop the flusher.
                self._cache_client.close()
            from .shard import ShardedBroker

            if self._session_arg is not None and (
                    not self._owns_broker
                    or isinstance(self.broker, ShardedBroker)):
                # Release this tenant's slot on the SHARED broker so its
                # fair-share weight stops diluting the neighbors.  (An
                # owned broker is stopping anyway; idempotent either way.
                # A ShardedBroker facade is "owned" but the shard broker
                # PROCESSES are shared — the session must close remotely
                # or its weight dilutes the shard's other tenants forever.)
                self.broker.close_session(self._session_arg)
            if self._owns_broker:
                self.broker.stop()
            if self._pusher is not None:
                # After the broker's own release: the final flush then
                # carries the fully-settled end-of-run counters.
                from ..telemetry.aggregator import release_pusher

                release_pusher(self._pusher)
                self._pusher = None

    def __enter__(self) -> "DistributedPopulation":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- asynchronous (steady-state) evaluation API ------------------------
    #
    # Used by ``algorithms_async.AsyncEvolution`` instead of the barrier:
    # ship → wait for ANY completion → breed a replacement → ship again.
    # Payload construction (genes + additional_parameters + trace) lives
    # here so the wire format has exactly one owner for both modes.

    def fleet_capacity(self) -> int:
        """THIS session's share of the fleet's job slots (0 when none).

        Single-tenant populations (no ``session``) see the full fleet
        total, exactly as before; concurrent tenants see their weighted
        share, which is how unmodified engines size their in-flight
        targets to coexist on one fleet.
        """
        return self.broker.session_capacity(self._session_arg)

    def fleet_prefetch(self) -> int:
        """This session's share of the fleet's prefetch slots.

        The engine's breed-ahead target is ``fleet_capacity() +
        fleet_prefetch()`` — enough in-flight work that every worker holds
        a decoded next window while its current one trains.  0 for a
        fleet of old or ``prefetch_depth=0`` workers, which keeps the
        pre-pipelining in-flight target (and trajectories) unchanged.
        """
        return self.broker.session_prefetch(self._session_arg)

    def _fill_target(self, n_real, params=None):
        """Speculative-fill target, additionally aligned to the fleet's
        widest advertised mesh pop-axis (``JobBroker.fleet_mesh_pop``).

        A host-level mesh worker pads every evaluation window up to its
        pop-axis multiple regardless of what the master ships
        (``models/cnn._prepare_population_setup``) — slots the compile
        bucket alone doesn't predict.  Rounding the fill target to the
        mesh multiple turns that padding into paid-for speculative
        trainings whose fitnesses seed the cache, instead of sliced-away
        waste (``eval_pad_waste_total``).  Fleets with no mesh workers
        get the base bucket target unchanged.

        Big-genome regime: the rounding is per size class.  Non-small
        configs (``parallel.mesh.job_size_class`` on the evaluation
        params — jax-free) run ONE genome per program on the narrow-pop
        ``(1, n)`` mesh, so there is no pop multiple to align to and no
        compile bucket to fill — speculative padding would train extra
        over-budget genomes at full price for nothing.  They keep the
        exact real count (plus only an EXPLICIT integer
        ``speculative_fill``, which remains an operator decision).
        """
        if job_size_class(params) != SIZE_SMALL:
            target = int(n_real)
            if self.speculative_fill is not True and self.speculative_fill:
                target = max(target, int(self.speculative_fill))
            return target
        target = super()._fill_target(n_real, params)
        multiple = self.broker.fleet_mesh_pop()
        if multiple > 1 and target % multiple:
            target += multiple - target % multiple
        return target

    def submit_individuals(self, individuals: Sequence[Individual]) -> List[str]:
        """Ship evaluation jobs without waiting; returns aligned job ids.

        One broker submit per call — the engine breeds every replacement a
        wake-up allows and ships them together, so the dispatch side stays
        one coalesced ``jobs`` frame per worker capacity window even in
        completion-driven mode.
        """
        payloads: Dict[str, Dict[str, Any]] = {}
        ids: List[str] = []
        ctx = _tele.current_context() if _tele.enabled() else None
        # Forensics opt-in rides the trace context (lineage.py): workers
        # only emit per-job device spans when the master is accounting.
        ctx = _lineage.forensic_context(ctx)
        params_copy = _params_copier()
        for ind in individuals:
            job_id = JobBroker.new_job_id()
            payload: Dict[str, Any] = {
                "genes": ind.get_genes(),
                "additional_parameters": params_copy(ind.additional_parameters),
            }
            # OPTIONAL per-job fidelity tag (protocol.py): stamped by the
            # multi-fidelity engine so workers can refuse a mislabeled
            # rung with a structured fail frame instead of training it.
            fidelity = getattr(ind, "_fidelity_tag", None)
            if fidelity is not None:
                payload["fidelity"] = dict(fidelity)
            if ctx is not None:
                payload["trace"] = ctx
            payloads[job_id] = payload
            ids.append(job_id)
        if payloads:
            self.broker.submit(payloads, session=self._session_arg)
            epoch = getattr(self.broker, "epoch", None)
            if epoch is not None:
                for job_id, payload in payloads.items():
                    self._open_async[job_id] = (payload, epoch)
        return ids

    def wait_any_results(self, job_ids: Sequence[str], timeout: Optional[float] = None):
        """Block until ≥1 of ``job_ids`` is terminal; ``(results, failures)``.

        An embedded broker that restarted from its journal holds nothing
        for a job whose submit record died in the abandoned buffer; while
        waiting, each epoch change submits such jobs again under their ids
        (the master's half of at-least-once delivery).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._resubmit_lost()
            step = _LOST_JOB_POLL_S if deadline is None else max(
                0.0, min(_LOST_JOB_POLL_S, deadline - time.monotonic()))
            results, failures = self.broker.wait_any(list(job_ids), timeout=step)
            if results or failures or (deadline is not None and time.monotonic() >= deadline):
                for job_id in (*results, *failures):
                    self._open_async.pop(job_id, None)
                return results, failures

    def _resubmit_lost(self) -> None:
        epoch = getattr(self.broker, "epoch", None)
        stale = {j: p for j, (p, e) in self._open_async.items() if e != epoch}
        if not stale:
            return
        lost = self.broker.unknown_jobs(stale)
        if lost is None:  # restarting: ask again once it serves
            return
        for job_id, payload in stale.items():
            self._open_async[job_id] = (payload, epoch)
        if lost:
            logger.warning("broker epoch %d holds nothing for %d open job(s) (their submit "
                           "died with the previous epoch); submitting them again",
                           epoch, len(lost))
            self.broker.submit({j: stale[j] for j in lost}, session=self._session_arg)

    def cancel_jobs(self, job_ids: Sequence[str]) -> None:
        """Withdraw still-open jobs whose results are no longer wanted."""
        for job_id in job_ids:
            self._open_async.pop(job_id, None)
        self.broker.cancel(job_ids)

    # -- the distributed fitness sweep ------------------------------------

    def evaluate(self) -> int:
        """Evaluate the population remotely, with bounded failure retries.

        Returns the number of jobs that completed remotely across all
        passes.  Each pass ships only still-unevaluated individuals, so a
        retry after ``JobFailed``/``GatherTimeout`` re-trains exactly the
        failed/unfinished work.  After ``evaluate_retries`` extra passes,
        ``failed_policy`` decides: re-raise, or penalize the stragglers
        with the generation's worst fitness and keep the search alive.
        """
        if not any(not ind.fitness_evaluated for ind in self.individuals):
            # Nothing to do — and crucially, don't reset eval_stats: a
            # follow-up no-op call (get_fittest() evaluates lazily) must not
            # erase the real sweep's retry bookkeeping before the GA logs it.
            return 0
        stats = {"attempts": 0, "retries": 0, "penalized": 0}
        self.eval_stats = stats
        self.broker.reset_chips_seen()
        completed = 0
        while True:
            stats["attempts"] += 1
            try:
                done = completed + self._evaluate_once()
                # chips_seen() = max(current fleet, sweep-long observation):
                # a worker that exits right after its final result still
                # counts, as does a late joiner.  The GA's logger divides the
                # north-star metric by this instead of the master's
                # (always-1) local chip count.
                stats["n_chips"] = self.broker.chips_seen()
                return done
            except (JobFailed, GatherTimeout) as e:
                partial = getattr(e, "partial", {}) or {}
                spec_ids = getattr(self, "_spec_job_ids", set())
                completed += len([j for j in partial if j not in spec_ids])
                if stats["attempts"] <= self.evaluate_retries:
                    stats["retries"] += 1
                    logger.warning(
                        "evaluate() pass %d/%d failed (%s); retrying the "
                        "unfinished individuals",
                        stats["attempts"], self.evaluate_retries + 1, e,
                    )
                    continue
                evaluated = [i for i in self.individuals if i.fitness_evaluated]
                if self.failed_policy == "penalize" and evaluated:
                    fits = [i.get_fitness() for i in evaluated]
                    worst = min(fits) if self.maximize else max(fits)
                    for ind in self.individuals:
                        if not ind.fitness_evaluated:
                            ind.set_fitness(worst)  # deliberately NOT cached
                            stats["penalized"] += 1
                    logger.error(
                        "evaluate() exhausted %d pass(es); penalized %d "
                        "unfinished individual(s) with fitness %.6g (%s)",
                        stats["attempts"], stats["penalized"], worst, e,
                    )
                    stats["n_chips"] = self.broker.chips_seen()
                    return completed
                raise

    def _evaluate_once(self) -> int:
        """One ship-and-gather pass (no retry policy).

        This is the reference's population-level fitness override
        (SURVEY.md §3.2): genes out, fitness scalars back, barrier at the
        end of the sweep.  Before anything hits the wire, the fitness cache
        answers already-trained architectures, and duplicates within the
        sweep collapse to one job (``Individual.cache_key`` — SURVEY.md §7
        hard part #1); only genuinely new work reaches the workers.
        """
        tele = _tele.enabled()
        pending = [ind for ind in self.individuals if not ind.fitness_evaluated]
        n_before = len(pending)
        pending = self._fill_from_cache(pending)
        if tele and n_before > len(pending):
            _get_registry().counter(
                "population_cache_hits_total", species=self.species.__name__,
            ).inc(n_before - len(pending))
        if not pending:
            self._drop_predispatch()
            return 0
        adopted = self._adopt_predispatch(pending)
        if adopted is not None:
            by_id, dup_map = adopted
            self._spec_job_ids = set()
            logger.info("adopting %d pre-dispatched job(s) for this sweep", len(by_id))
            return self._gather_apply(list(by_id), by_id, dup_map)
        payloads, by_id, dup_map, rep_job = self._build_payloads(pending)
        if tele and len(pending) > len(payloads):
            _get_registry().counter(
                "population_dedup_collapsed_total", species=self.species.__name__,
            ).inc(len(pending) - len(payloads))
        n_spec = 0
        if self.speculative_fill and payloads:
            # Tail-generation mitigation : a capacity
            # worker pads a small batch to the compile-shape bucket anyway
            # (models/cnn._pop_bucket) — ship speculative elite-mutant jobs
            # to occupy those otherwise-wasted slots.  Their fitnesses land
            # in the cache only (the individuals are not population
            # members), answering future generations' children for free.
            spec_inds = self._speculative_individuals(
                self._fill_target(len(payloads)) - len(payloads), set(rep_job)
            )
            spec_ids = set()
            params_copy = _params_copier()
            for spec in spec_inds:
                job_id = JobBroker.new_job_id()
                payloads[job_id] = {
                    "genes": spec.get_genes(),
                    "additional_parameters": params_copy(spec.additional_parameters),
                }
                by_id[job_id] = spec
                spec_ids.add(job_id)
                n_spec += 1
            # Remembered for the failure paths: partial-result counting in
            # evaluate() must not credit speculative jobs as population work.
            self._spec_job_ids = spec_ids
        else:
            self._spec_job_ids = set()
        if tele and n_spec:
            _get_registry().counter(
                "population_speculative_total", species=self.species.__name__,
            ).inc(n_spec)
        logger.info(
            "distributing %d fitness evaluations (%d deduplicated, %d speculative)",
            len(payloads),
            len(pending) - (len(payloads) - n_spec),
            n_spec,
        )
        # The barrier covers REAL jobs only: a failed or straggling
        # speculative job must never abort, stall, or burn a retry of a
        # generation whose population work succeeded.  Speculative results
        # are collected best-effort afterwards (same worker batch, so they
        # normally sit in the results channel already).
        real_ids = [j for j in payloads if j not in self._spec_job_ids]
        if _tele.enabled():
            # Cross-process trace propagation (docs/OBSERVABILITY.md): the
            # live master-side span context (normally the generation's
            # `evaluate` span) rides every job payload; workers re-attach
            # it so their train/eval spans join this trace.
            ctx = _lineage.forensic_context(_tele.current_context())
            if ctx is not None:
                for payload in payloads.values():
                    payload["trace"] = ctx
        self.broker.submit(payloads, session=self._session_arg)
        # Speculative jobs don't count as population work: the GA's
        # individuals/hour metric stays a statement about real individuals.
        return self._gather_apply(real_ids, by_id, dup_map)

    def _build_payloads(self, pending: Sequence[Individual]):
        """Wire payloads for ``pending`` with in-sweep dedup.

        Returns ``(payloads, by_id, dup_map, rep_job)``: duplicates within
        the sweep collapse to one representative job
        (``Individual.cache_key`` — SURVEY.md §7 hard part #1); only
        genuinely new work reaches the workers.
        """
        payloads: Dict[str, Dict[str, Any]] = {}
        by_id: Dict[str, Individual] = {}
        dup_map: Dict[str, List[Individual]] = {}
        rep_job: Dict[Any, str] = {}
        params_copy = _params_copier()
        for ind in pending:
            key = self._safe_cache_key(ind)
            if key is not None and key in rep_job:
                dup_map.setdefault(rep_job[key], []).append(ind)
                continue
            job_id = JobBroker.new_job_id()
            if key is not None:
                rep_job[key] = job_id
            payloads[job_id] = {
                "genes": ind.get_genes(),
                "additional_parameters": params_copy(ind.additional_parameters),
            }
            fidelity = getattr(ind, "_fidelity_tag", None)
            if fidelity is not None:
                payloads[job_id]["fidelity"] = dict(fidelity)
            by_id[job_id] = ind
        return payloads, by_id, dup_map, rep_job

    def _gather_apply(
        self,
        real_ids: List[str],
        by_id: Dict[str, Individual],
        dup_map: Dict[str, List[Individual]],
    ) -> int:
        """Barrier + fitness application for one sweep's real jobs."""
        try:
            results = self.broker.gather(real_ids, timeout=self.job_timeout)
        except JobFailed as e:
            # Keep the generation's finished work: apply every fitness that
            # DID come back, then surface the failures.  The broker pruned
            # its state (attempt counts included), so the defined retry is
            # simply calling evaluate() again — only the still-unevaluated
            # (= failed) individuals are reshipped, as fresh jobs.
            self._apply_results(e.partial, by_id, dup_map)
            self._collect_speculative(by_id, timeout=0.0)
            raise JobFailed(
                f"{len(e.failures)} of {len(real_ids)} job(s) failed permanently; "
                f"{len(e.partial)} successful result(s) were applied. "
                f"Call evaluate() again to reship only the failed individuals.",
                failures=e.failures,
                partial=e.partial,
            ) from e
        except GatherTimeout as e:
            # Straggler timeout: keep whatever finished before the deadline;
            # a retry (evaluate() again) reships only the unfinished work.
            self._apply_results(e.partial, by_id, dup_map)
            self._collect_speculative(by_id, timeout=0.0)
            raise
        self._apply_results(results, by_id, dup_map)
        self._collect_speculative(by_id, timeout=10.0)
        return len(real_ids)

    # -- breed-ahead pre-dispatch (pipelined generational mode) ------------

    def predispatch(self) -> int:
        """Ship this population's cache-missed work NOW, without waiting.

        The generational half of the pipelined dispatch plane
        (``GeneticAlgorithm(breed_ahead=True)``): called right after the
        next generation is bred, so its jobs travel while the master
        checkpoints/logs and the workers' prefetch queues refill during
        what used to be the inter-generation bubble.  The next
        ``evaluate()`` call adopts the in-flight jobs instead of
        re-submitting; if the population was mutated in between, the
        stale jobs are cancelled and evaluate() falls back to the normal
        build-and-submit path.  Returns the number of jobs shipped.
        """
        tele = _tele.enabled()
        pending = [ind for ind in self.individuals if not ind.fitness_evaluated]
        n_before = len(pending)
        pending = self._fill_from_cache(pending)
        if tele and n_before > len(pending):
            _get_registry().counter(
                "population_cache_hits_total", species=self.species.__name__,
            ).inc(n_before - len(pending))
        if not pending:
            self._pre = None
            return 0
        payloads, by_id, dup_map, _rep = self._build_payloads(pending)
        if tele and len(pending) > len(payloads):
            _get_registry().counter(
                "population_dedup_collapsed_total", species=self.species.__name__,
            ).inc(len(pending) - len(payloads))
        if tele:
            ctx = _lineage.forensic_context(_tele.current_context())
            if ctx is not None:
                for payload in payloads.values():
                    payload["trace"] = ctx
        self.broker.submit(payloads, session=self._session_arg)
        self._pre = (by_id, dup_map)
        logger.info("pre-dispatched %d job(s) for the next generation", len(payloads))
        return len(payloads)

    def _adopt_predispatch(self, pending: Sequence[Individual]):
        """Return ``(by_id, dup_map)`` if an earlier :meth:`predispatch`
        covers exactly this sweep's pending set; else cancel it and return
        ``None``.  Coverage is checked by object identity — any mutation
        of the population between breed-ahead and evaluate() (caller
        edits, partial retry passes) safely voids the pre-dispatch."""
        pre = getattr(self, "_pre", None)
        self._pre = None
        if pre is None:
            return None
        by_id, dup_map = pre
        covered = {id(ind) for ind in by_id.values()}
        for dups in dup_map.values():
            covered.update(id(d) for d in dups)
        if covered == {id(ind) for ind in pending}:
            return by_id, dup_map
        logger.info("pre-dispatched jobs stale (population changed); cancelling %d", len(by_id))
        self.broker.cancel(list(by_id))
        return None

    def _drop_predispatch(self) -> None:
        """Cancel any outstanding pre-dispatch (nothing pending to adopt it)."""
        pre = getattr(self, "_pre", None)
        self._pre = None
        if pre is not None:
            self.broker.cancel(list(pre[0]))

    def _collect_speculative(self, by_id: Dict[str, Individual], timeout: float) -> None:
        """Best-effort gather of the sweep's speculative jobs into the
        fitness cache.  Failures and stragglers are ignored (and the
        broker's gather prunes/cancels them), never surfaced."""
        spec_ids = getattr(self, "_spec_job_ids", set())
        if not spec_ids:
            return
        try:
            res = self.broker.gather(list(spec_ids), timeout=timeout)
        except (JobFailed, GatherTimeout) as e:
            res = dict(getattr(e, "partial", {}) or {})
            logger.info(
                "speculative job(s) incomplete — ignored (%s; %d result(s) kept)",
                type(e).__name__, len(res),
            )
        self._apply_results(res, by_id, {})
        for job_id in res:
            self._record_speculative(by_id[job_id])

    def _apply_results(
        self,
        results: Dict[str, float],
        by_id: Dict[str, Individual],
        dup_map: Dict[str, List[Individual]],
    ) -> None:
        for job_id, fitness in results.items():
            ind = by_id[job_id]
            ind.set_fitness(fitness)
            key = self._safe_cache_key(ind)
            if key is not None:
                self.fitness_cache[key] = float(fitness)
                self._speculative_origins().pop(key, None)
            for dup in dup_map.get(job_id, []):
                dup.set_fitness(fitness)

    # -- generational continuity ------------------------------------------

    def clone_with(self, individuals: Sequence[Individual]) -> "DistributedPopulation":
        """Next-generation population sharing this one's running broker."""
        clone = DistributedPopulation(
            species=self.species,
            individual_list=list(individuals),
            crossover_rate=self.crossover_rate,
            mutation_rate=self.mutation_rate,
            maximize=self.maximize,
            additional_parameters=self.additional_parameters,
            rng=self.rng,
            job_timeout=self.job_timeout,
            broker=self.broker,
            fitness_cache=self.fitness_cache,
            evaluate_retries=self.evaluate_retries,
            failed_policy=self.failed_policy,
            speculative_fill=self.speculative_fill,
            # Session tenancy rides clones: re-opening is an idempotent
            # attach, so every generation keeps the same tag and share.
            session=self._session_arg,
            session_weight=self.session_weight,
            session_quota=self.session_quota,
        )
        clone.cache_namespace = self.cache_namespace
        # Carry the store path WITHOUT reloading the file every generation:
        # the clone shares this population's cache dict already.
        clone.fitness_store = self.fitness_store
        # Same for the shared-cache client: the ServiceBackedCache flowed in
        # through fitness_cache= above (the ctor only wraps when cache_url is
        # passed, which it isn't here), so hand over the client and the
        # registered status callable — whichever population gets close()d
        # flushes the write-behind queue and evicts the provider exactly once.
        clone.cache_url = self.cache_url
        clone._cache_client = self._cache_client
        clone._cache_status_fn = self._cache_status_fn
        # An embedded broker stays closeable through evolution: every clone
        # of an owning population co-owns it, so close() on whichever
        # population the caller ends up holding (the GA hands back clones)
        # stops the listener.  JobBroker.stop() is idempotent, so original +
        # clones closing in any order is safe.  Externally-provided brokers
        # (broker= at construction) are never owned and never stopped here.
        clone._owns_broker = self._owns_broker
        self._carry_spec_rng(clone)
        return clone


class DistributedGridPopulation(DistributedPopulation):
    """Grid-initialised distributed population (SURVEY.md §2.0 row 10).

    First generation enumerates the cartesian product of ``genes_grid``
    (like :class:`gentun_tpu_torch.populations.GridPopulation`); later generations
    evolve as a plain :class:`DistributedPopulation` via ``clone_with``.
    """

    def __init__(
        self,
        species: Type[Individual],
        genes_grid: Optional[Mapping[str, Sequence[Any]]] = None,
        **kwargs,
    ):
        super().__init__(species, individual_list=[], **kwargs)
        self.populate_from_grid(genes_grid)
