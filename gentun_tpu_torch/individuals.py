"""Individuals: a genome value + lazy, cached fitness evaluation.

Reference parity: gentun's ``Individual`` ABC and its two species,
``XgboostIndividual`` and ``GeneticCnnIndividual`` (``gentun/individuals.py``
[PUB]; SURVEY.md §2.0 rows 5-7).  The reference's key behaviors preserved here:

- ``get_fitness()`` is lazy and cached — an individual trains its model at
  most once; reproduction produces children with fitness unset, so unchanged
  elites are never re-trained (SURVEY.md §2.3 "Fitness caching").
- ``reproduce(partner)`` = uniform per-gene crossover then mutation, returning
  a *new* individual.
- ``additional_parameters`` is the de-facto config schema: every non-genome
  knob (stage sizes, epochs, k-fold count, ...) travels in this dict, and it
  must survive serialization to workers (SURVEY.md §5 "Config / flag system").

The rebuild differs in one deliberate way: randomness is never global.  Every
stochastic method takes or holds an explicit ``numpy.random.Generator``.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Dict, Mapping, Optional, Type

import numpy as np

from .genes import GenomeSpec, boosting_genome, genetic_cnn_genome, xgboost_genome

__all__ = ["Individual", "GeneticCnnIndividual", "BoostingIndividual", "XgboostIndividual"]


def _freeze(obj: Any) -> Any:
    """Recursively convert ``obj`` into a hashable, order-stable structure.

    Dicts become sorted ``(key, value)`` tuples, sequences become tuples,
    numpy scalars/arrays become plain values/bytes.  Used to build fitness
    cache keys out of genome dicts and ``additional_parameters``.
    """
    if isinstance(obj, Mapping):
        return tuple((k, _freeze(v)) for k, v in sorted(obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    if isinstance(obj, (set, frozenset)):
        return tuple(sorted((_freeze(v) for v in obj), key=repr))
    if isinstance(obj, np.ndarray):
        return (obj.shape, obj.dtype.str, obj.tobytes())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class Individual:
    """A candidate solution: genome dict + lazily evaluated fitness.

    Subclasses define :meth:`build_spec` (the genome) and :meth:`evaluate`
    (train the fitness model and return a scalar).  ``x_train``/``y_train``
    are held by the individual, mirroring the reference's design where the
    *data* stays local and only genes cross process boundaries (SURVEY.md §1).
    """

    #: True for species whose fitness runs on the accelerator (here the CUDA
    #: device).  The name is the JAX package's, kept so that the distributed
    #: worker, which advertises its chip count in the broker handshake, reads
    #: the same attribute from either package's species.
    uses_jax: bool = False

    def __init__(
        self,
        x_train=None,
        y_train=None,
        genes: Optional[Mapping[str, Any]] = None,
        crossover_rate: float = 0.5,
        mutation_rate: float = 0.015,
        maximize: bool = True,
        rng: Optional[np.random.Generator] = None,
        additional_parameters: Optional[Dict[str, Any]] = None,
        **kwargs,
    ):
        self.x_train = x_train
        self.y_train = y_train
        self.crossover_rate = crossover_rate
        self.mutation_rate = mutation_rate
        self.maximize = maximize
        self.additional_parameters: Dict[str, Any] = dict(additional_parameters or {})
        # Extra kwargs fold into additional_parameters, matching gentun's habit
        # of passing model knobs straight through the individual constructor.
        self.additional_parameters.update(kwargs)
        self._rng = rng if rng is not None else np.random.default_rng()
        self.spec: GenomeSpec = self.build_spec(**self.additional_parameters)
        if genes is None:
            self.genes: Dict[str, Any] = self.spec.sample(self._rng)
        else:
            self.genes = self.spec.validate(genes)
        self._fitness: Optional[float] = None
        # Memo for Population._safe_cache_key: cache_key() can be expensive
        # (GeneticCnnIndividual canonicalises the DAG) and the population
        # asks for it several times per generation.
        self._cache_key_memo: Any = None

    # -- genome ------------------------------------------------------------

    def build_spec(self, **params) -> GenomeSpec:
        raise NotImplementedError

    def get_genes(self) -> Dict[str, Any]:
        return dict(self.genes)

    def set_genes(self, genes: Mapping[str, Any]) -> None:
        self.genes = self.spec.validate(genes)
        self._fitness = None
        self._cache_key_memo = None

    # -- fitness -----------------------------------------------------------

    def evaluate(self) -> float:
        """Train the fitness model; subclass hot path (SURVEY.md §3.1)."""
        raise NotImplementedError

    def get_fitness(self) -> float:
        """Lazy, cached fitness (gentun ``Individual.get_fitness`` [PUB])."""
        if self._fitness is None:
            self._fitness = float(self.evaluate())
        return self._fitness

    def set_fitness(self, fitness: float) -> None:
        """Write fitness from outside — used by the distributed master when a
        worker's reply arrives (SURVEY.md §3.2)."""
        self._fitness = float(fitness)

    @property
    def fitness_evaluated(self) -> bool:
        return self._fitness is not None

    def cache_key(self):
        """Hashable identity of this individual's *training job*.

        Two individuals with equal keys are guaranteed the same expected
        fitness, so population/GA-level caches (``Population.fitness_cache``)
        train one representative and share the result across duplicates,
        re-derived elites, and later generations — the reference re-trains
        every new Individual object even when its genome already ran
        (SURVEY.md §7 "hard parts" #1).  Default: the frozen
        ``(genes, additional_parameters)`` pair; species can collapse more
        (:meth:`GeneticCnnIndividual.cache_key` maps architecture-isomorphic
        genomes to one key via :func:`gentun_tpu_torch.ops.dag.canonical_key`).
        """
        return (type(self).__name__, _freeze(self.genes), _freeze(self.additional_parameters))

    # -- genetic operators -------------------------------------------------

    def crossover(self, partner: "Individual", rng: Optional[np.random.Generator] = None) -> "Individual":
        """Uniform per-gene crossover; returns a child with fitness unset."""
        rng = rng if rng is not None else self._rng
        child_genes = self.spec.crossover(self.genes, partner.genes, rng, self.crossover_rate)
        return self.copy(genes=child_genes)

    def mutate(self, rng: Optional[np.random.Generator] = None) -> "Individual":
        """Mutate in place (resets cached fitness); returns self for chaining."""
        rng = rng if rng is not None else self._rng
        new_genes = self.spec.mutate(self.genes, rng, self.mutation_rate)
        if new_genes != self.genes:
            self.genes = new_genes
            self._fitness = None
            self._cache_key_memo = None
        return self

    def reproduce(self, partner: "Individual", rng: Optional[np.random.Generator] = None) -> "Individual":
        """Crossover then mutation → new individual (gentun ``reproduce`` [PUB])."""
        return self.crossover(partner, rng).mutate(rng)

    def copy(self, genes: Optional[Mapping[str, Any]] = None) -> "Individual":
        """Clone (sharing the data arrays, copying the genome).

        A plain ``copy()`` keeps the cached fitness — that is what lets elites
        survive generations without re-training (SURVEY.md §2.3).  Passing
        explicit ``genes`` (the reproduction path) always yields an
        unevaluated clone, matching the reference's "children have fitness
        unset" semantics even when the child genome coincides with a parent's.
        """
        clone = type(self)(
            x_train=self.x_train,
            y_train=self.y_train,
            genes=dict(self.genes) if genes is None else dict(genes),
            crossover_rate=self.crossover_rate,
            mutation_rate=self.mutation_rate,
            maximize=self.maximize,
            rng=self._rng,
            additional_parameters=_copy.deepcopy(self.additional_parameters),
        )
        if genes is None:
            clone._fitness = self._fitness
        return clone

    # -- misc --------------------------------------------------------------

    @classmethod
    def fitness_backend(cls) -> Optional[str]:
        """Name of the fitness-model backend this species trains with, or None.

        Advertised in the distributed worker's ``hello`` so the master can
        warn when a mixed fleet would score one generation with two
        different estimators (ADVICE r3: a worker with xgboost installed
        and one without silently return incomparable fitnesses).
        """
        model_cls = getattr(cls, "model_cls", None)
        return model_cls.__name__ if model_cls is not None else None

    def __repr__(self) -> str:
        fit = f"{self._fitness:.6g}" if self._fitness is not None else "unevaluated"
        return f"{type(self).__name__}(genes={self.genes}, fitness={fit})"


class GeneticCnnIndividual(Individual):
    """Genetic-CNN architecture-search individual.

    Genome: one bit-string per stage encoding the intra-stage DAG
    (gentun ``GeneticCnnIndividual`` [PUB]; SURVEY.md §2.0 row 7).  Fitness:
    k-fold mean validation accuracy of the decoded CNN, trained on the CUDA device by
    :class:`gentun_tpu_torch.models.cnn.GeneticCnnModel`.

    ``additional_parameters`` (all optional, with reference-shaped defaults —
    SURVEY.md §3.4):  ``nodes``, ``input_shape``, ``kernels_per_layer``,
    ``kfold``, ``epochs``, ``learning_rate``, ``batch_size``, ``dense_units``,
    ``dropout_rate``, ``n_classes``.
    """

    #: set in tests to swap the fitness backend without touching the class
    model_cls: Optional[Type] = None

    uses_jax = True  # fitness trains on the accelerator → workers report chips

    @classmethod
    def fitness_backend(cls) -> Optional[str]:
        return cls.model_cls.__name__ if cls.model_cls is not None else "GeneticCnnModel"

    def build_spec(self, **params) -> GenomeSpec:
        return genetic_cnn_genome(tuple(params.get("nodes", (3, 5))))

    def cache_key(self):
        """Collapse architecture-isomorphic genomes to one cache entry.

        Distinct bit-strings that decode to the same network up to node
        relabeling (:func:`gentun_tpu_torch.ops.dag.canonical_key`) share a key —
        beyond exact-duplicate dedup, this means e.g. the k=3 single-edge
        graphs 1→2 and 2→3 train once between them.
        """
        from .ops.dag import canonical_key

        nodes = tuple(self.additional_parameters.get("nodes", (3, 5)))
        return (type(self).__name__, canonical_key(self.genes, nodes), _freeze(self.additional_parameters))

    def evaluate(self) -> float:
        if self.x_train is None or self.y_train is None:
            raise RuntimeError(
                "this individual has no training data; in distributed mode "
                "fitness must be assigned via set_fitness() from a worker reply"
            )
        model_cls = self.model_cls
        if model_cls is None:
            from .models.cnn import GeneticCnnModel as model_cls  # lazy: keeps torch import off the GA path
        model = model_cls(self.x_train, self.y_train, self.genes, **self.additional_parameters)
        return model.cross_validate()


class BoostingIndividual(Individual):
    """Gradient-boosting hyperparameter-search individual (control path).

    The rebuild's counterpart of gentun's ``XgboostIndividual`` (SURVEY.md
    §2.0 row 6), on sklearn ``HistGradientBoosting`` where xgboost is
    missing.  Host-side: its fitness never touches the accelerator.

    ``additional_parameters``: ``kfold`` (default 5), ``metric``
    (default "accuracy"), ``task`` ("classification" | "regression").

    Backend selection: real xgboost (``models/xgboost.py`` — the
    reference's ``xgb.cv``) whenever ``import xgboost`` succeeds, else the
    sklearn translation (``models/boosting.py``).  Override with
    ``model_cls``.
    """

    model_cls: Optional[Type] = None

    @classmethod
    def fitness_backend(cls) -> Optional[str]:
        if cls.model_cls is not None:
            return cls.model_cls.__name__
        from .models import default_boosting_model

        return default_boosting_model().__name__

    def build_spec(self, **params) -> GenomeSpec:
        return boosting_genome()

    def evaluate(self) -> float:
        if self.x_train is None or self.y_train is None:
            raise RuntimeError(
                "this individual has no training data; in distributed mode "
                "fitness must be assigned via set_fitness() from a worker reply"
            )
        model_cls = self.model_cls
        if model_cls is None:
            from .models import default_boosting_model

            model_cls = default_boosting_model()
        model = model_cls(self.x_train, self.y_train, self.genes, **self.additional_parameters)
        return model.cross_validate()


class XgboostIndividual(BoostingIndividual):
    """The reference species, genome included (``gentun/individuals.py``
    [PUB]; SURVEY.md §2.0 row 6): searches the 11 XGBoost hyperparameters
    (eta, max_depth, min_child_weight, gamma, subsample,
    colsample_bytree/bylevel, lambda, alpha, max_delta_step,
    scale_pos_weight) with the reference's (default, min, max) bounds.

    Backend follows :class:`BoostingIndividual`'s selection: real
    ``xgb.cv`` when xgboost is importable (all 11 genes live — full
    reference parity), sklearn translation otherwise (7 live, warned).
    """

    def build_spec(self, **params) -> GenomeSpec:
        return xgboost_genome()
