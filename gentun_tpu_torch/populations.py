"""Populations: collections of individuals sharing training data.

Reference parity: ``Population`` and ``GridPopulation`` in
``gentun/populations.py`` [PUB] (SURVEY.md §2.0 row 4).  A population holds
the individuals plus the shared ``(x_train, y_train)`` and the ``maximize``
flag; it knows how to random-init ``size`` individuals, enumerate a grid of
gene values, and report the fittest member.

Departure from the reference: :meth:`Population.evaluate` is a first-class
population-level operation.  When the species' fitness model supports it,
the *whole population* trains as one batched program — every genome shares
one masked supergraph with the population as a tensor axis, so evaluating N
individuals is one batched training instead of N sequential Keras fits (the
main individuals/hour/chip lever).  The per-individual lazy path
(``Individual.get_fitness``) still works and is what distributed workers use.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Type

import numpy as np

from .individuals import Individual, _freeze
from .telemetry import lineage as _lineage
from .telemetry import spans as _tele
from .telemetry.registry import get_registry as _get_registry

__all__ = ["Population", "GridPopulation"]

logger = logging.getLogger("gentun_tpu_torch")

#: species whose cache_key() already raised once (log each species once)
_cache_key_warned: set = set()

#: memo sentinel: this individual's key is known-unusable, don't retry
_UNCACHEABLE = object()


def _compile_bucket(n: int) -> int:
    """Mirror of ``parallel/mesh.pop_bucket`` (kept here so the GA path
    imports no model code).  ``tests/test_torch_ga.py`` asserts the two
    stay in lockstep."""
    if n >= 16:
        return n
    b = 2  # floor 2, matching _pop_bucket: singleton programs are
    while b < n:  # numerically distinct (see models/cnn._pop_bucket)
        b *= 2
    return b


def _raw_genes(ind: Individual):
    """An individual's genes, bit for bit, as a hashable value (arrays and
    tuples of the same bits compare equal)."""
    return _freeze({k: np.asarray(v).tolist() for k, v in ind.get_genes().items()})


class Population:
    """A fixed-size set of individuals of one species.

    Args mirror the reference constructor (``gentun/populations.py`` [PUB]):
    ``species`` (the Individual subclass), shared data, either ``size`` for
    random init or an explicit ``individual_list``, operator rates, the
    optimisation direction, and ``additional_parameters`` forwarded to every
    individual.  ``seed`` is new: it makes the whole run reproducible.
    """

    def __init__(
        self,
        species: Type[Individual],
        x_train=None,
        y_train=None,
        individual_list: Optional[Sequence[Individual]] = None,
        size: Optional[int] = None,
        crossover_rate: float = 0.5,
        mutation_rate: float = 0.015,
        maximize: bool = True,
        additional_parameters: Optional[Dict[str, Any]] = None,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        fitness_cache: Optional[Dict[Any, float]] = None,
        speculative_fill=False,
    ):
        self.species = species
        self.x_train = x_train
        self.y_train = y_train
        self.crossover_rate = crossover_rate
        self.mutation_rate = mutation_rate
        self.maximize = maximize
        #: False = off; True = fill only the compile bucket's padding slots
        #: (free); int N = fill small batches up to at least N (opt-in cost).
        self.speculative_fill = speculative_fill
        self.additional_parameters = dict(additional_parameters or {})
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        # Fitness by Individual.cache_key(): shared across generations via
        # clone_with, so an architecture (not just an Individual object) is
        # trained at most once per search (SURVEY.md §7 hard part #1).
        self.fitness_cache: Dict[Any, float] = fitness_cache if fitness_cache is not None else {}

        if individual_list is not None:
            self.individuals: List[Individual] = list(individual_list)
        elif size is not None:
            self.individuals = [self.spawn() for _ in range(size)]
            if _lineage.enabled():
                # Random init is where every founder lineage starts: record
                # the births here (not in spawn(), which the ladder and
                # promotion probes also call for genome *copies*).
                for ind in self.individuals:
                    _lineage.record(
                        "born", _lineage.genome_key(ind.get_genes()),
                        op="spawn", genes=ind.get_genes())
        else:
            raise ValueError("provide either `size` or `individual_list`")

    # -- construction ------------------------------------------------------

    def spawn(
        self,
        genes: Optional[Mapping[str, Any]] = None,
        additional_parameters: Optional[Mapping[str, Any]] = None,
    ) -> Individual:
        """Create one individual of this population's species.

        ``additional_parameters`` overrides the population's own config for
        this ONE individual — the multi-fidelity engine uses it to dispatch
        the same genes under per-rung training schedules (the cache key
        embeds the merged config, so rungs never share fitness entries).
        """
        params = dict(self.additional_parameters)
        if additional_parameters is not None:
            params.update(additional_parameters)
        return self.species(
            x_train=self.x_train,
            y_train=self.y_train,
            genes=dict(genes) if genes is not None else None,
            crossover_rate=self.crossover_rate,
            mutation_rate=self.mutation_rate,
            maximize=self.maximize,
            rng=self.rng,
            additional_parameters=params,
        )

    def add_individual(self, individual: Individual) -> None:
        self.individuals.append(individual)

    # -- steady-state (asynchronous) membership ----------------------------
    #
    # The async engine (algorithms_async.AsyncEvolution) treats the
    # individuals list as an AGE-ORDERED ring: index 0 is the oldest member,
    # appends are the youngest.  Insert/evict are incremental — no
    # generation-sized rebuild, no clone_with — so a completed evaluation
    # updates membership in O(1)/O(n) while other evaluations stay in flight.

    def insert(self, individual: Individual) -> None:
        """Append ``individual`` as the population's youngest member."""
        self.individuals.append(individual)

    def evict_oldest(self, require_evaluated: bool = True) -> Optional[Individual]:
        """Remove and return the oldest member (aging eviction, Real et al.
        2019: age, not fitness, decides who dies — the regularization that
        forces rediscovery of good architectures).

        With ``require_evaluated`` (the default) the oldest EVALUATED member
        goes instead, skipping members whose evaluation is still in flight —
        evicting those would orphan a result the scheduler already paid for.
        Returns None when no member is eligible.
        """
        for i, ind in enumerate(self.individuals):
            if not require_evaluated or ind.fitness_evaluated:
                return self.individuals.pop(i)
        return None

    def populate_from_grid(self, genes_grid: Optional[Mapping[str, Sequence[Any]]] = None) -> None:
        """Append one individual per point of the gene-value grid.

        Shared by ``GridPopulation`` and ``DistributedGridPopulation``
        (SURVEY.md §2.0 rows 4, 10): enumeration itself lives in
        :meth:`GenomeSpec.grid`.
        """
        probe = self.spawn()
        for genome in probe.spec.grid(gene_values=genes_grid):
            self.add_individual(self.spawn(genes=genome))

    # -- container protocol (gentun exposes the same) ----------------------

    def __len__(self) -> int:
        return len(self.individuals)

    def get_size(self) -> int:
        return len(self.individuals)

    def __getitem__(self, item: int) -> Individual:
        return self.individuals[item]

    def __iter__(self):
        return iter(self.individuals)

    def get_species(self) -> Type[Individual]:
        return self.species

    def get_data(self):
        return self.x_train, self.y_train

    # -- fitness -----------------------------------------------------------

    def evaluate(self) -> int:
        """Ensure every individual has a fitness; returns the number that
        actually *trained* (cache hits and dedup'd duplicates don't count —
        the GA uses this for the individuals/hour/chip metric).

        Order of attack, each step narrowing the pending set:

        1. **cache** — individuals whose :meth:`Individual.cache_key` was
           already trained (this generation or an earlier one, via the
           cache ``clone_with`` carries forward) get the stored fitness;
        2. **dedup** — of the rest, one representative per distinct key
           trains; duplicates inherit its result;
        3. **group-wise batched training** — representatives are grouped by
           ``additional_parameters`` and each group trains as ONE vmapped
           program when the species' model exposes
           ``cross_validate_population`` (``models/cnn.py``) — divergent
           configs no longer force the whole population sequential;
        4. **sequential fallback** — anything else takes the reference's
           lazy per-individual path (SURVEY.md §3.1).
        """
        # Telemetry (docs/OBSERVABILITY.md): counters are incremented once
        # per aggregate — never per individual — and only when enabled, so
        # the disabled path does no extra work beyond one bool read.
        tele = _tele.enabled()
        pending = [ind for ind in self.individuals if not ind.fitness_evaluated]
        n_before = len(pending)
        pending = self._fill_from_cache(pending)
        if tele and n_before > len(pending):
            _get_registry().counter(
                "population_cache_hits_total", species=self.species.__name__,
            ).inc(n_before - len(pending))
        trained = 0
        for group in self._group_by_params(pending):
            reps = self._dedupe_group(group)
            if tele and len(group) > len(reps):
                _get_registry().counter(
                    "population_dedup_collapsed_total", species=self.species.__name__,
                ).inc(len(group) - len(reps))
            batch = reps
            spec: List[Individual] = []
            if self.speculative_fill and reps and self._batch_fn(reps) is not None:
                # Tail-generation mitigation (VERDICT r4 weak #2): the
                # compile-shape bucket pads a small batch anyway, and the
                # padding slots train DISCARDED dummy genomes.  Fill them
                # with mutated copies of the current elite instead — near
                # convergence most children ARE small mutations of the
                # elite, so these results cache-hit future generations.
                # speculative_fill=True fills only the existing padding
                # slots (strictly free); an int raises the fill target to
                # that batch size (extra compute traded for cache hits —
                # use a bucket size, e.g. 8 or 16, to reuse compiled shapes).
                seen = {k for k in (self._safe_cache_key(i) for i in reps) if k is not None}
                spec = self._speculative_individuals(
                    self._fill_target(len(reps), reps[0].additional_parameters) - len(reps),
                    seen,
                    template=reps[0],
                )
                batch = reps + spec
                if tele and spec:
                    _get_registry().counter(
                        "population_speculative_total", species=self.species.__name__,
                    ).inc(len(spec))
            # The `train` span covers the group's actual compute — batched
            # OR the sequential fallback — so every species (a worker-side
            # OneMax as much as a vmapped CNN) reports training time.
            # cnn.py's finer compile/train/eval spans nest inside this one.
            # Forensics (docs/OBSERVABILITY.md "Search forensics"): local
            # evaluation attributes its own device-seconds — an even share
            # of the group's train wall time per representative.  Skipped
            # inside a worker capture (the worker's own per-job device
            # spans are the ones the broker bills — never both).
            lin = _lineage.enabled() and not _tele.capturing()
            t_train0 = time.monotonic()
            if tele:
                with _tele.span("train", {"individuals": len(batch),
                                          "species": self.species.__name__}) as sp:
                    batched_ok = self._train_group(batch, reps)
                    sp.set(batched=batched_ok)
            else:
                batched_ok = self._train_group(batch, reps)
            if lin and reps:
                share = (time.monotonic() - t_train0) / len(reps)
                for i, ind in enumerate(reps):
                    _lineage.emit_device(
                        share, _lineage.genome_key(ind.get_genes()),
                        rung=(getattr(ind, "_fidelity_tag", None)
                              or {}).get("rung", 0),
                        start_monotonic=t_train0 + i * share)
            if batched_ok:
                for ind in spec:
                    self._record_speculative(ind)
            trained += len(reps)
            self._publish_group(group, reps)
        return trained

    def predispatch(self) -> int:
        """Breed-ahead hook: start this population's fitness work early.

        Local evaluation has nowhere to send work ahead of time, so the
        base class is a no-op returning 0 — the knob
        (``GeneticAlgorithm(breed_ahead=True)``) is harmless without a
        fleet.  ``DistributedPopulation`` overrides this to ship the
        cache-missed individuals to the broker immediately and lets the
        next ``evaluate()`` adopt the in-flight jobs (DISTRIBUTED.md
        "Pipelined dispatch").
        """
        return 0

    def _train_group(self, batch: List[Individual], reps: List[Individual]) -> bool:
        """Train one parameter-group: batched if the species supports it,
        else the reference's sequential per-individual path.  Returns
        whether the batched path ran (speculative results only exist
        then)."""
        if self._evaluate_batched(batch):
            return True
        for ind in reps:  # sequential fallback: skip speculation
            ind.get_fitness()
        return False

    def _fill_target(self, n_real: int, params: Optional[Mapping[str, Any]] = None) -> int:
        """Batch size speculation fills to: the compile bucket (free mode,
        ``speculative_fill=True``), or at least the configured int target.

        With ``pop_padding=False`` in the group's config the model pads
        nothing, so free mode has NO free slots — only an explicit int
        target adds (paid-for) speculation there.
        """
        pads = (params or {}).get("pop_padding", True)
        target = _compile_bucket(n_real) if pads else n_real
        if self.speculative_fill is not True and self.speculative_fill:
            target = max(target, int(self.speculative_fill))
        return target

    def _speculative_individuals(
        self, n_slots: int, exclude_keys: set, template: Optional["Individual"] = None
    ) -> List["Individual"]:
        """Up to ``n_slots`` fresh unevaluated individuals speculatively
        worth training: mutated copies of the best already-evaluated member
        (the GA's future children concentrate around the elite).  The
        children are built from ``template`` (an individual of the batch
        being trained) so they carry the BATCH's additional_parameters —
        caching an elite-genes mutant trained under another group's config
        would poison the cache.  Never duplicates a pending key, a cached
        architecture, or another speculative pick; returns [] when there is
        no evaluated member yet (generation 0 fills its bucket with real
        work anyway)."""
        if n_slots <= 0:
            return []
        evaluated = [i for i in self.individuals if i.fitness_evaluated]
        if not evaluated:
            return []
        key_fn = lambda i: i.get_fitness()
        parent = max(evaluated, key=key_fn) if self.maximize else min(evaluated, key=key_fn)
        if template is None:
            template = parent
        # Speculation must NOT perturb the search: drawing mutants from
        # self.rng would shift every subsequent selection/reproduction draw,
        # making a speculative run a different search from a non-speculative
        # one under the same seed.  A dedicated deterministic stream keeps
        # trajectories identical with the feature on or off.
        spec_rng = getattr(self, "_spec_rng", None)
        if spec_rng is None:
            spec_rng = self._spec_rng = np.random.default_rng(0x5BEC)
        # The mutate-until-changed loop compares against the parent's GENES
        # under the template's params, so cross-group gene seeding works.
        base_key = self._safe_cache_key(template.copy(genes=parent.get_genes()))
        out: List[Individual] = []
        for _ in range(4 * n_slots):  # bounded attempts: duplicates happen
            if len(out) >= n_slots:
                break
            child = template.copy(genes=parent.get_genes())
            # At reference mutation rates (~0.015/bit) a single mutate() is
            # usually a no-op; keep mutating until the ARCHITECTURE actually
            # changes (bounded — a rate of 0 must not spin forever).
            key = None
            for _ in range(32):
                child.mutate(spec_rng)
                key = self._safe_cache_key(child)
                if key is not None and key != base_key:
                    break
            if key is None or key == base_key or key in exclude_keys or key in self.fitness_cache:
                continue
            exclude_keys.add(key)
            out.append(child)
        return out

    # -- cache / dedup plumbing -------------------------------------------

    @staticmethod
    def _safe_cache_key(ind: Individual):
        """``ind.cache_key()``, or None (= never cached) if it can't be built
        or isn't usable as a dict key (hashable).

        A failure downgrades the search to cache-less behavior (correct but
        retrains every genome), so the first one per species is logged loudly
        rather than swallowed.  The key is memoized on the individual
        (invalidated by ``set_genes``/``mutate``): canonicalising a
        Genetic-CNN DAG is not free, and evaluate() needs the key at several
        steps per generation.
        """
        memo = getattr(ind, "_cache_key_memo", None)
        if memo is not None:
            return None if memo is _UNCACHEABLE else memo
        try:
            key = ind.cache_key()
            hash(key)  # must be usable for dict lookup, not merely built
        except Exception:
            ind._cache_key_memo = _UNCACHEABLE
            species = type(ind).__name__
            if species not in _cache_key_warned:
                _cache_key_warned.add(species)
                logger.warning(
                    "cache_key() failed for species %s — fitness caching and "
                    "dedup are DISABLED for it (every genome will retrain)",
                    species,
                    exc_info=True,
                )
            return None
        ind._cache_key_memo = key
        return key

    def _fill_from_cache(self, pending: List[Individual]) -> List[Individual]:
        """Assign cached fitnesses; return the individuals still unevaluated.

        An entry a speculative job measured answers only the genome it
        trained: a cache key collapses isomorphic genomes, but a fitness is
        a function of the RAW genome (its init and dropout streams are
        seeded from the genome's content), so an isomorphic relabeling would
        get another genome's number and the search would differ from one
        without speculation.  The first pending individual of a key decides
        for all of that key, as the representative that would train does;
        a mismatch trains, and its result replaces the entry.
        """
        origins = self._speculative_origins()
        remaining: List[Individual] = []
        decided: Dict[Any, bool] = {}
        for ind in pending:
            key = self._safe_cache_key(ind)
            if key is not None and key in self.fitness_cache:
                origin = origins.get(key)
                if origin is None or decided.setdefault(key, _raw_genes(ind) == origin):
                    ind.set_fitness(self.fitness_cache[key])
                    continue
            remaining.append(ind)
        for key, adopted in decided.items():
            if adopted:  # now the search's own measurement of this key
                origins.pop(key, None)
        return remaining

    def _speculative_origins(self) -> Dict[Any, Any]:
        """Cache keys whose entry a speculative job measured → the raw genes
        it trained (shared across generations like the cache itself)."""
        origins = getattr(self, "_spec_origin", None)
        if origins is None:
            origins = self._spec_origin = {}
        return origins

    def _record_speculative(self, ind: Individual) -> None:
        """Cache a speculative individual's fitness under its key, marked
        as answering its own raw genes only."""
        key = self._safe_cache_key(ind)
        if key is not None:
            self.fitness_cache[key] = ind.get_fitness()
            self._speculative_origins()[key] = _raw_genes(ind)

    @staticmethod
    def _group_by_params(pending: List[Individual]) -> List[List[Individual]]:
        """Partition by ``additional_parameters`` (batched training needs one
        shared config per compiled program — same grouping the distributed
        worker applies, ``distributed/client.py``).  Keys via ``_freeze``:
        collision-free even for numpy-array params, unlike ``repr``."""
        groups: Dict[Any, List[Individual]] = {}
        for ind in pending:
            try:
                key = _freeze(ind.additional_parameters)
                hash(key)
            except TypeError:
                # Unhashable config (e.g. a bytearray param): degrade that
                # individual to its own sequential group instead of crashing.
                key = ("__unhashable__", id(ind))
            groups.setdefault(key, []).append(ind)
        return list(groups.values())

    def _dedupe_group(self, group: List[Individual]) -> List[Individual]:
        """First individual per distinct cache key; un-keyable ones all pass."""
        reps: List[Individual] = []
        seen = set()
        for ind in group:
            key = self._safe_cache_key(ind)
            if key is None or key not in seen:
                if key is not None:
                    seen.add(key)
                reps.append(ind)
        return reps

    def _publish_group(self, group: List[Individual], reps: List[Individual]) -> None:
        """Store representatives' results in the cache; fan out to duplicates."""
        origins = self._speculative_origins()
        for ind in reps:
            key = self._safe_cache_key(ind)
            if key is not None:
                self.fitness_cache[key] = ind.get_fitness()
                origins.pop(key, None)
        for ind in group:
            if not ind.fitness_evaluated:
                ind.set_fitness(self.fitness_cache[self._safe_cache_key(ind)])

    def _batch_fn(self, pending: List[Individual]):
        """The species' population-batched trainer, or None when the group
        can only evaluate sequentially.  Checked BEFORE speculation so
        sequential species never pay the mutant-generation cost."""
        if self.x_train is None or self.y_train is None:
            return None
        model_cls = getattr(self.species, "model_cls", None)
        if model_cls is None:
            from .individuals import GeneticCnnIndividual

            if not issubclass(self.species, GeneticCnnIndividual):
                return None
            try:
                from .models.cnn import GeneticCnnModel
            except ImportError:  # pragma: no cover - torch missing
                return None
            model_cls = GeneticCnnModel
        return getattr(model_cls, "cross_validate_population", None)

    def _evaluate_batched(self, pending: List[Individual]) -> bool:
        """Try the single-program batched evaluation; True on success.

        ``pending`` shares one ``additional_parameters`` dict by construction
        (:meth:`_group_by_params`), so the whole group decodes under one
        config and trains as one population-batched program.
        """
        if not pending:
            return True
        batch_fn = self._batch_fn(pending)
        if batch_fn is None:
            return False
        params = pending[0].additional_parameters
        genomes = [ind.get_genes() for ind in pending]
        fitnesses = batch_fn(self.x_train, self.y_train, genomes, **params)
        for ind, fit in zip(pending, fitnesses):
            ind.set_fitness(float(fit))
        return True

    # -- generational continuity ------------------------------------------

    def clone_with(self, individuals: Sequence[Individual]) -> "Population":
        """A next-generation population with this one's config and data.

        The GA outer loop calls this instead of naming a class, so
        subclasses (notably ``DistributedPopulation``, which must carry its
        broker across generations) stay subclasses through evolution.
        ``GridPopulation`` deliberately degrades to a plain ``Population``:
        grid enumeration only describes generation zero.
        """
        clone = Population(
            species=self.species,
            x_train=self.x_train,
            y_train=self.y_train,
            individual_list=list(individuals),
            crossover_rate=self.crossover_rate,
            mutation_rate=self.mutation_rate,
            maximize=self.maximize,
            additional_parameters=self.additional_parameters,
            rng=self.rng,
            fitness_cache=self.fitness_cache,
            speculative_fill=self.speculative_fill,
        )
        self._carry_spec_rng(clone)
        return clone

    def _carry_spec_rng(self, clone: "Population") -> None:
        """Carry the speculative RNG stream across generations (like
        fitness_cache): re-seeding each clone would replay already-cached
        elite mutants until the bounded attempt budget starves and
        speculation silently stops filling slots.  The speculative entries'
        origins ride along with the cache they describe."""
        spec_rng = getattr(self, "_spec_rng", None)
        if spec_rng is not None:
            clone._spec_rng = spec_rng
        clone._spec_origin = self._speculative_origins()

    def get_fittest(self) -> Individual:
        """Best individual under the population's direction (evaluating lazily)."""
        self.evaluate()
        key = lambda ind: ind.get_fitness()
        return max(self.individuals, key=key) if self.maximize else min(self.individuals, key=key)

    def get_fitnesses(self) -> List[float]:
        self.evaluate()
        return [ind.get_fitness() for ind in self.individuals]


class GridPopulation(Population):
    """Population initialised from the cartesian product of per-gene grids.

    Mirrors gentun's ``GridPopulation`` (``gentun/populations.py`` [PUB];
    SURVEY.md §2.3 "Initialization"): instead of random genomes, enumerate
    every combination of the provided per-gene value lists.

    ``genes_grid`` maps gene name → list of values; genes not present use
    their full ``grid_values()`` (careful: binary genes enumerate 2**length).
    """

    def __init__(
        self,
        species: Type[Individual],
        x_train=None,
        y_train=None,
        genes_grid: Optional[Mapping[str, Sequence[Any]]] = None,
        crossover_rate: float = 0.5,
        mutation_rate: float = 0.015,
        maximize: bool = True,
        additional_parameters: Optional[Dict[str, Any]] = None,
        seed: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        super().__init__(
            species,
            x_train=x_train,
            y_train=y_train,
            individual_list=[],
            crossover_rate=crossover_rate,
            mutation_rate=mutation_rate,
            maximize=maximize,
            additional_parameters=additional_parameters,
            seed=seed,
            rng=rng,
        )
        self.populate_from_grid(genes_grid)
