"""GA outer loops: generational evolution with selection/elitism.

Reference parity: ``GeneticAlgorithm`` and ``RussianRouletteGA`` in
``gentun/algorithms.py`` [PUB] (SURVEY.md §2.0 rows 2-3, §3.1).  The outer
loop is deliberately identical in shape to the reference — evaluate the
population, log the fittest, select parents, reproduce into the next
generation — because the north star keeps it "untouched" (BASELINE.json).

What's new versus the reference:

- explicit seeded RNG (reproducible searches),
- structured per-generation records including the north-star metric,
  individuals evaluated per hour (SURVEY.md §5 "Metrics"),
- optional generation-boundary checkpointing (SURVEY.md §5
  "Checkpoint / resume" — absent in the reference, required by the rebuild).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .individuals import Individual
from .populations import Population
from .telemetry import health as _health
from .telemetry import lineage as _lineage
from .telemetry import spans as _tele
from .telemetry.registry import get_registry as _get_registry
from .utils.fitness_store import FITNESS_PROTOCOL, is_serializable_key, tuplify

__all__ = ["GeneticAlgorithm", "RussianRouletteGA"]

logger = logging.getLogger("gentun_tpu_torch")


def _initialized_chip_count() -> int:
    """Local CUDA device count, WITHOUT triggering CUDA initialization.

    The GA outer loop is pure bookkeeping; it must not be the code that
    initializes CUDA just to normalise a metric.  Only ask torch once the
    fitness path has placed work on a CUDA device (``utils/device_state``).
    """
    import sys

    if "torch" not in sys.modules:
        return 1
    from .utils.device_state import backend_used

    if not backend_used():  # CUDA never used by the fitness path: don't force it
        return 1
    return max(1, sys.modules["torch"].cuda.device_count())


class GeneticAlgorithm:
    """Tournament-selection GA with elitism (gentun ``GeneticAlgorithm`` [PUB]).

    Per generation: evaluate every individual (lazily/cached), keep the best
    unchanged if ``elitism``, then fill the next generation with children of
    tournament-selected parents (sample ``tournament_size`` members, fittest
    wins — SURVEY.md §2.3 "Selection").

    ``breed_ahead`` (off by default; trajectories are bit-identical when
    off): as soon as a generation is bred, pre-dispatch its cache-missed
    children to the fleet (``Population.predispatch``) so workers' prefetch
    queues refill during the master's checkpoint/log window instead of
    sitting idle across the generation boundary — the generational half of
    the pipelined dispatch plane (DISTRIBUTED.md "Pipelined dispatch").
    The next ``evaluate()`` adopts the in-flight jobs; selection order,
    RNG draws, and fitness values are unchanged either way, because the
    generational trajectory is completion-order independent.  A no-op for
    local populations.
    """

    def __init__(
        self,
        population: Population,
        tournament_size: int = 5,
        elitism: bool = True,
        seed: Optional[int] = None,
        breed_ahead: bool = False,
    ):
        self.population = population
        self.tournament_size = tournament_size
        self.elitism = elitism
        self.breed_ahead = bool(breed_ahead)
        self.rng = np.random.default_rng(seed) if seed is not None else population.rng
        self.generation = 0
        self.history: List[Dict[str, Any]] = []
        self._checkpointer = None
        self._fault_injector = None

    # -- checkpointing hook (wired by utils.checkpoint) --------------------

    def set_checkpointer(self, checkpointer) -> None:
        """Attach a generation-boundary checkpointer (``utils/checkpoint.py``)."""
        self._checkpointer = checkpointer

    def set_fault_injector(self, injector) -> None:
        """Attach a chaos-testing injector (``distributed/faults.py``).

        Its only master-side hook is ``master_boundary``, fired AFTER the
        generation checkpoint is written — a ``kill_master`` fault therefore
        simulates a crash at the exact point resume is guaranteed from.
        """
        self._fault_injector = injector

    # -- selection ---------------------------------------------------------

    def select_parent(self) -> Individual:
        """Tournament selection: sample t individuals, fittest wins."""
        with _tele.span("select"):
            size = len(self.population)
            t = min(self.tournament_size, size)
            idx = self.rng.choice(size, size=t, replace=False)
            contenders = [self.population[int(i)] for i in idx]
            key = lambda ind: ind.get_fitness()
            return max(contenders, key=key) if self.population.maximize else min(contenders, key=key)

    # -- evolution ---------------------------------------------------------

    def evolve_population(self) -> None:
        """One generation step: evaluate → select → reproduce (SURVEY.md §3.1).

        Telemetry: the whole step is a ``generation`` span; ``evaluate``,
        ``select`` (inside :meth:`select_parent`), ``reproduce``, and
        ``checkpoint`` nest under it.  The evaluate span is live while job
        payloads are built, so its context is what rides the wire to
        workers (``DistributedPopulation._evaluate_once``).
        """
        # Advisory heartbeat for /statusz (one bool read when the ops plane
        # is off): a generation legitimately takes unbounded time, so this
        # never gates /healthz — it tells an operator when the engine last
        # crossed a generation boundary.
        _health.beat("engine_loop")
        with _tele.span("generation", {"generation": self.generation}):
            t0 = time.monotonic()
            # Count only the individuals actually trained this step (cached
            # elites, fitness-cache hits, and dedup'd duplicates don't inflate
            # the metric): evaluate() reports exactly how many hit the
            # compute path.
            with _tele.span("evaluate"):
                evaluated = self.population.evaluate() or 0
                fittest = self.population.get_fittest()
            elapsed = max(time.monotonic() - t0, 1e-9)
            self._log_generation(fittest, evaluated, elapsed)

            next_individuals: List[Individual] = []
            if self.elitism:
                next_individuals.append(fittest.copy())  # keeps cached fitness
            with _tele.span("reproduce"):
                lin = _lineage.enabled()
                while len(next_individuals) < len(self.population):
                    mother = self.select_parent()
                    father = self.select_parent()
                    child = mother.reproduce(father, self.rng)
                    if lin:
                        _lineage.record(
                            "born", _lineage.genome_key(child.get_genes()),
                            parents=[
                                _lineage.genome_key(mother.get_genes()),
                                _lineage.genome_key(father.get_genes()),
                            ],
                            op="reproduce",
                            generation=self.generation + 1,
                            genes=child.get_genes())
                    next_individuals.append(child)

            # clone_with keeps the population's concrete type across
            # generations (a DistributedPopulation must carry its broker
            # forward).
            self.population = self.population.clone_with(next_individuals)
            if self.breed_ahead:
                # Ship the freshly-bred generation's jobs BEFORE the
                # checkpoint/log bookkeeping below: the wire time and the
                # workers' decode overlap work the master was going to do
                # anyway.  Resume safety: a pre-dispatch is never
                # checkpointed — a resumed run's evaluate() simply
                # re-submits fresh jobs (at-least-once, dedup on cache key).
                with _tele.span("predispatch"):
                    self.population.predispatch()
            self.generation += 1
            if self._checkpointer is not None:
                with _tele.span("checkpoint"):
                    self._checkpointer.save(self)
            if self._fault_injector is not None:
                # After the checkpoint: a kill here is the recoverable crash.
                self._fault_injector.master_boundary(self.generation)

    def run(self, max_generations: int, checkpointer=None) -> Individual:
        """Run the search; returns the final fittest individual.

        Matches the reference's entry point
        ``GeneticAlgorithm(population).run(n)`` (SURVEY.md §3.1):
        ``max_generations`` means "N more generations from here".

        With ``checkpointer`` (a ``utils/checkpoint.Checkpointer``), run
        becomes crash-resumable: the checkpointer is attached, any existing
        checkpoint is resumed first, and ``max_generations`` is the TOTAL
        generation count for the search — a master killed at generation k
        and re-run with the same arguments executes the remaining
        ``max_generations - k`` and produces the identical trajectory.
        """
        if checkpointer is not None:
            self.set_checkpointer(checkpointer)
            if checkpointer.resume(self):
                logger.info("resumed from checkpoint at generation %d", self.generation)
        remaining = max_generations - self.generation if checkpointer is not None else max_generations
        logger.info(
            "starting %s: population=%d, generations=%d",
            type(self).__name__,
            len(self.population),
            remaining,
        )
        # One root span per run → one trace_id stitching every generation
        # (and, via payload propagation, every worker span) together.
        # Engine status is keyed by search session (multi-tenant brokers:
        # N engines sharing a fleet each get a /statusz row instead of
        # last-writer-wins); single-tenant runs key under "default".
        self._status_session = getattr(self.population, "session", None) or "default"
        _health.register_engine_status(self._status_session, self._ops_status)
        try:
            with _tele.span("run", {"generations": max(remaining, 0)}) as run_span:
                # /statusz "active trace_id": the no-op span has no
                # trace_id attribute, so this stays None when disabled.
                self._run_trace_id = getattr(run_span, "trace_id", None)
                for _ in range(max(remaining, 0)):
                    self.evolve_population()
                # The final offspring still need fitness; give the pass its
                # own evaluate span so its worker spans parent consistently.
                with _tele.span("evaluate"):
                    self.population.evaluate()
                    best = self.population.get_fittest()
        finally:
            _health.unregister_engine_status(self._status_session, self._ops_status)
            # End-of-run fleet push: the final generation's counters reach
            # the aggregator even if the caller keeps the population open.
            # No-op (an empty-dict read) when nothing is wired.
            from .telemetry.aggregator import flush_active_pushers

            flush_active_pushers()
        logger.info("search done: best fitness %.6g, genes %s", best.get_fitness(), best.get_genes())
        return best

    def _ops_status(self) -> Dict[str, Any]:
        """The ``/statusz`` "engine" block (``telemetry/health.py`` status
        provider, polled from HTTP threads — snapshot reads only)."""
        # Ever-best across the whole run, not just the last generation —
        # without elitism a generation's best can regress.
        fits = [h["best_fitness"] for h in self.history
                if h.get("best_fitness") is not None]
        best = None
        if fits:
            best = max(fits) if self.population.maximize else min(fits)
        return {
            "mode": "generational",
            "session": getattr(self, "_status_session", "default"),
            "generation": self.generation,
            "population_size": len(self.population),
            "best_fitness": best,
            "trace_id": getattr(self, "_run_trace_id", None),
        }

    # -- logging -----------------------------------------------------------

    def _log_generation(self, fittest: Individual, evaluated: int, elapsed_s: float) -> None:
        # Distributed sweeps record the connected fleet's advertised chip
        # total (workers' `hello` → broker.fleet_chips()); that is the true
        # denominator for the per-chip metric — the master process itself
        # never uses the device, so its local count would always be 1.
        stats = getattr(self.population, "eval_stats", None) or {}
        n_chips = int(stats.get("n_chips") or 0) or _initialized_chip_count()
        record = {
            "generation": self.generation,
            "best_fitness": fittest.get_fitness(),
            "best_genes": fittest.get_genes(),
            "population_size": len(self.population),
            "evaluated": int(evaluated),  # individuals that actually trained
            "eval_wall_s": round(elapsed_s, 3),
            "n_chips": n_chips,
            # the north-star metric (BASELINE.json): individuals/hour/chip
            "individuals_per_hour_per_chip": round(evaluated / (elapsed_s / 3600.0) / n_chips, 2),
        }
        # Search-progress gauges for the fleet dashboard (once per
        # generation — off the dispatch hot path; always-on like the mesh
        # gauges so an aggregator-wired master reports progress even with
        # span telemetry off).
        sess = (getattr(self, "_status_session", None)
                or getattr(self.population, "session", None) or "default")
        reg = _get_registry()
        reg.gauge("engine_generation", session=sess,
                  mode="generational").set(self.generation)
        fit = fittest.get_fitness()
        if fit is not None:
            reg.gauge("engine_best_fitness", session=sess,
                      mode="generational").set(float(fit))
        # Distributed populations report their failure-recovery bookkeeping
        # (bounded retries / penalized stragglers) — record it so a resumed
        # or audited search can see exactly which generations degraded.
        if stats and (stats.get("retries") or stats.get("penalized")):
            record["evaluate_attempts"] = stats["attempts"]
            record["evaluate_retries"] = stats["retries"]
            record["penalized"] = stats["penalized"]
        self.history.append(record)
        logger.info("generation %s", json.dumps(record, default=str))

    # -- (de)serialization state for checkpoint/resume ---------------------

    def state_dict(self) -> Dict[str, Any]:
        # Fitness-cache keys are nested tuples, usually of JSON-native
        # leaves (Individual.cache_key); JSON turns tuples into lists and
        # tuplify() reverses that exactly on load (the shared convention —
        # utils/fitness_store.py).  Unserializable keys are skipped: the
        # checkpoint must never crash the search over a cache entry, and a
        # dropped entry only costs a retrain after resume.
        fitness_cache = [
            [k, v]
            for k, v in self.population.fitness_cache.items()
            if is_serializable_key(k)
        ]
        return {
            "algorithm": type(self).__name__,
            "fitness_protocol": FITNESS_PROTOCOL,
            "fitness_cache": fitness_cache,
            "generation": self.generation,
            "tournament_size": self.tournament_size,
            "elitism": self.elitism,
            "breed_ahead": self.breed_ahead,
            "rng_state": self.rng.bit_generator.state,
            "history": self.history,
            "population": {
                "maximize": self.population.maximize,
                "crossover_rate": self.population.crossover_rate,
                "mutation_rate": self.population.mutation_rate,
                "additional_parameters": self.population.additional_parameters,
                "individuals": [
                    {
                        "genes": ind.get_genes(),
                        "fitness": ind._fitness,
                    }
                    for ind in self.population
                ],
            },
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        algo = state.get("algorithm")
        if algo == "AsyncEvolution":
            raise ValueError(
                "checkpoint was written by AsyncEvolution — steady-state "
                "scheduler state (completion counters, in-flight children) "
                "has no generational equivalent; resume it with AsyncEvolution")
        self.generation = int(state["generation"])
        self.tournament_size = int(state["tournament_size"])
        self.elitism = bool(state["elitism"])
        if "breed_ahead" in state:  # absent in pre-pipelining checkpoints
            self.breed_ahead = bool(state["breed_ahead"])
        self.rng.bit_generator.state = state["rng_state"]
        self.history = list(state["history"])
        pop_state = state["population"]
        # Restore population config BEFORE spawning, so individuals are built
        # with the checkpoint's genome spec and operator rates, not whatever
        # config the receiving population happened to be constructed with.
        self.population.maximize = bool(pop_state["maximize"])
        self.population.crossover_rate = float(pop_state["crossover_rate"])
        self.population.mutation_rate = float(pop_state["mutation_rate"])
        self.population.additional_parameters = dict(pop_state["additional_parameters"])
        # A checkpoint written under an older fitness-measurement RNG
        # protocol carries values a resumed search cannot compare against
        # fresh ones (utils/fitness_store.FITNESS_PROTOCOL): drop every
        # stored fitness — genes, RNG state, and history survive, the
        # current population re-measures.  Loud: re-measuring costs real
        # chip time and the user should know why.
        proto = state.get("fitness_protocol", 1)
        proto_ok = proto == FITNESS_PROTOCOL
        if not proto_ok:
            logger.warning(
                "checkpoint was written under fitness RNG protocol %s "
                "(current: %s); discarding its fitness values and cache — "
                "the resumed search re-measures the current generation "
                "instead of mixing incomparable measurements", proto,
                FITNESS_PROTOCOL,
            )
        individuals = []
        for ind_state in pop_state["individuals"]:
            ind = self.population.spawn(genes=ind_state["genes"])
            if ind_state["fitness"] is not None and proto_ok:
                ind.set_fitness(ind_state["fitness"])
            individuals.append(ind)
        self.population.individuals = individuals
        restored = {
            tuplify(key): float(fit) for key, fit in state.get("fitness_cache", [])
        } if proto_ok else {}
        # A ServiceBackedCache (distributed/fitness_service.py) must keep its
        # shared-service backing across resume; rebase() swaps contents in
        # place instead of being replaced by a plain dict.
        cache = self.population.fitness_cache
        if hasattr(cache, "rebase"):
            cache.rebase(restored)
        else:
            self.population.fitness_cache = restored


class RussianRouletteGA(GeneticAlgorithm):
    """Fitness-proportional (roulette) selection, per the Genetic-CNN paper.

    gentun ``RussianRouletteGA`` [BASELINE names it; PUB for mechanism]
    (SURVEY.md §2.0 row 3).  Parents are drawn with probability proportional
    to fitness (shifted to be positive; inverted when minimising), instead of
    by tournament.

    ``selection_floor`` (VERDICT r4 weak #5 — a DOCUMENTED deviation knob,
    see docs/ARCHITECTURE.md "Roulette selection floor"): the default 0.1
    range-shifts the weights so the generation's worst member keeps a
    non-zero selection chance — without it, range-normalised weights give
    the worst member probability exactly 0 every generation, which is
    effectively an extra deterministic truncation step the paper doesn't
    have.  ``selection_floor=None`` selects the EXACT paper behavior:
    weights proportional to the raw (positive) fitness values — for
    accuracy-valued fitness in [0, 1] the spread between members is small
    relative to the mean, so exact-proportional selection pressure is far
    weaker than the floored range-shifted variant, not stronger.
    """

    def __init__(self, *args, selection_floor: Optional[float] = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        if selection_floor is not None and selection_floor < 0:
            raise ValueError(f"selection_floor must be >= 0 or None, got {selection_floor}")
        if selection_floor is None and not self.population.maximize:
            # p ∝ f is meaningless for losses (negated fitnesses are all
            # negative, so every generation would hit the degenerate shift
            # that zeroes the worst member — the opposite of what the exact
            # mode advertises).
            raise ValueError(
                "selection_floor=None (exact p ∝ f roulette) requires a "
                "maximizing population with positive fitnesses; use a "
                "numeric floor when minimizing"
            )
        self.selection_floor = selection_floor

    def _selection_weights(self) -> np.ndarray:
        # Fitnesses are fixed during the reproduction loop, so the weight
        # vector is reused across the ~2N parent draws of a generation; the
        # weights are a pure function of the fitness values, so those alone
        # key the cache (in-place set_fitness() changes them and invalidates).
        fit_list = self.population.get_fitnesses()
        key = tuple(fit_list)
        cached = getattr(self, "_weights_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        fits = np.asarray(fit_list, dtype=np.float64)
        if not self.population.maximize:
            fits = -fits
        lo, hi = fits.min(), fits.max()
        if hi == lo:
            weights = np.full(len(fits), 1.0 / len(fits))
        elif self.selection_floor is None:
            # Exact paper roulette: p_i ∝ fitness_i.  Defined for positive
            # fitness (the paper's recognition accuracies); anything else
            # falls back to the minimal shift that makes weights valid.
            if lo <= 0:
                if not getattr(self, "_warned_nonpositive", False):
                    self._warned_nonpositive = True
                    logger.warning(
                        "exact roulette (selection_floor=None) needs positive "
                        "fitnesses; min is %.6g — shifting by it (warned once)", lo,
                    )
                fits = fits - lo
            weights = fits / fits.sum()
        else:
            # Range-shift so the worst member keeps a small non-zero chance.
            shifted = fits - lo + self.selection_floor * (hi - lo)
            weights = shifted / shifted.sum()
        self._weights_cache = (key, weights)
        return weights

    def select_parent(self) -> Individual:
        with _tele.span("select"):
            weights = self._selection_weights()
            idx = int(self.rng.choice(len(self.population), p=weights))
            return self.population[idx]

    # selection_floor must ride checkpoints like its sibling hyperparams
    # (tournament_size, elitism): an exact-paper (None) study must not
    # silently resume with the default floored selection.

    def state_dict(self) -> Dict[str, Any]:
        state = super().state_dict()
        state["selection_floor"] = self.selection_floor
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        super().load_state_dict(state)
        if "selection_floor" in state:
            self.selection_floor = state["selection_floor"]
        # The weights cache is keyed on the fitness tuple alone; a restored
        # floor must not serve weights computed under the old one.
        self._weights_cache = None
