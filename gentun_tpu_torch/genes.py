"""Gene and genome specifications for the GA engine.

Reference parity: in gentun the genome lives implicitly inside each
``Individual`` subclass as a dict of hyperparameter values plus per-gene
(default, minimum, maximum) bounds (``gentun/individuals.py`` [PUB]; see
SURVEY.md §2.3).  The TPU rebuild factors that into an explicit, declarative
layer: a :class:`GenomeSpec` is an ordered collection of typed genes, and all
genetic operators (sampling, crossover, mutation) are pure functions of a
``numpy.random.Generator`` — determinism under a fixed seed is a design goal
(SURVEY.md §7 step 1), because it is what makes the distributed search
reproducible and the operator suite property-testable.

Genome *values* are plain JSON-serializable dicts ``{gene_name: value}``;
binary genes are tuples of 0/1 ints.  Keeping values as plain data (rather
than objects) is what lets the distributed layer ship genes over the wire
untouched, mirroring the reference's tiny wire format (SURVEY.md §1).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Iterable, List, Mapping, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "BinaryGene",
    "FloatGene",
    "IntGene",
    "ChoiceGene",
    "Gene",
    "GenomeSpec",
    "genetic_cnn_genome",
    "boosting_genome",
    "xgboost_genome",
]


@dataclasses.dataclass(frozen=True)
class BinaryGene:
    """A fixed-length bit-string gene.

    Used for the Genetic-CNN DAG encoding: one gene per stage, one bit per
    ordered node pair (SURVEY.md §2.3; gentun ``GeneticCnnIndividual`` [PUB]).
    """

    name: str
    length: int

    def __post_init__(self):
        if self.length < 0:
            raise ValueError(f"gene {self.name!r}: length must be >= 0")

    def default(self) -> Tuple[int, ...]:
        return (1,) * self.length  # fully-connected DAG

    def sample(self, rng: np.random.Generator) -> Tuple[int, ...]:
        # Bernoulli(0.5) per bit, per the reference's random init (SURVEY §2.3).
        return tuple(int(b) for b in rng.integers(0, 2, size=self.length))

    def mutate(self, value: Tuple[int, ...], rng: np.random.Generator, rate: float) -> Tuple[int, ...]:
        """Per-bit flip with probability ``rate`` (gentun bit-flip mutation)."""
        flips = rng.random(self.length) < rate
        return tuple(int(b) ^ int(f) for b, f in zip(value, flips))

    def validate(self, value: Any) -> Tuple[int, ...]:
        value = tuple(int(v) for v in value)
        if len(value) != self.length or any(v not in (0, 1) for v in value):
            raise ValueError(f"gene {self.name!r}: invalid bit-string {value!r}")
        return value

    def grid_values(self) -> List[Tuple[int, ...]]:
        """All 2**length values — only sensible for short genes."""
        return [tuple(bits) for bits in itertools.product((0, 1), repeat=self.length)]


@dataclasses.dataclass(frozen=True)
class FloatGene:
    """A bounded float hyperparameter, sampled uniformly from [minimum, maximum].

    Mirrors the (default, minimum, maximum) triples gentun attaches to each
    XGBoost hyperparameter (SURVEY.md §2.0 row 6).
    """

    name: str
    default_value: float
    minimum: float
    maximum: float
    log_scale: bool = False

    def __post_init__(self):
        if not (self.minimum <= self.default_value <= self.maximum):
            raise ValueError(f"gene {self.name!r}: default outside bounds")
        if self.log_scale and self.minimum <= 0:
            raise ValueError(f"gene {self.name!r}: log-scale needs minimum > 0")

    def default(self) -> float:
        return float(self.default_value)

    def sample(self, rng: np.random.Generator) -> float:
        if self.log_scale:
            lo, hi = math.log(self.minimum), math.log(self.maximum)
            return float(math.exp(rng.uniform(lo, hi)))
        return float(rng.uniform(self.minimum, self.maximum))

    def mutate(self, value: float, rng: np.random.Generator, rate: float) -> float:
        # Per-gene re-sample with probability `rate` (SURVEY §2.3: scalar
        # genomes mutate by random re-sample, not perturbation).
        return self.sample(rng) if rng.random() < rate else float(value)

    def validate(self, value: Any) -> float:
        value = float(value)
        if not (self.minimum <= value <= self.maximum):
            raise ValueError(f"gene {self.name!r}: {value} outside [{self.minimum}, {self.maximum}]")
        return value

    def grid_values(self, n: int = 5) -> List[float]:
        if self.log_scale:
            return [float(v) for v in np.geomspace(self.minimum, self.maximum, n)]
        return [float(v) for v in np.linspace(self.minimum, self.maximum, n)]


@dataclasses.dataclass(frozen=True)
class IntGene:
    """A bounded integer hyperparameter (inclusive bounds)."""

    name: str
    default_value: int
    minimum: int
    maximum: int

    def __post_init__(self):
        if not (self.minimum <= self.default_value <= self.maximum):
            raise ValueError(f"gene {self.name!r}: default outside bounds")

    def default(self) -> int:
        return int(self.default_value)

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.integers(self.minimum, self.maximum + 1))

    def mutate(self, value: int, rng: np.random.Generator, rate: float) -> int:
        return self.sample(rng) if rng.random() < rate else int(value)

    def validate(self, value: Any) -> int:
        value = int(value)
        if not (self.minimum <= value <= self.maximum):
            raise ValueError(f"gene {self.name!r}: {value} outside [{self.minimum}, {self.maximum}]")
        return value

    def grid_values(self, n: int = 5) -> List[int]:
        span = self.maximum - self.minimum
        n = min(n, span + 1)
        return sorted({int(round(v)) for v in np.linspace(self.minimum, self.maximum, n)})


@dataclasses.dataclass(frozen=True)
class ChoiceGene:
    """A categorical hyperparameter drawn from a fixed choice list."""

    name: str
    default_value: Any
    choices: Tuple[Any, ...]

    def __post_init__(self):
        object.__setattr__(self, "choices", tuple(self.choices))
        if self.default_value not in self.choices:
            raise ValueError(f"gene {self.name!r}: default not in choices")

    def default(self) -> Any:
        return self.default_value

    def sample(self, rng: np.random.Generator) -> Any:
        return self.choices[int(rng.integers(0, len(self.choices)))]

    def mutate(self, value: Any, rng: np.random.Generator, rate: float) -> Any:
        return self.sample(rng) if rng.random() < rate else value

    def validate(self, value: Any) -> Any:
        # JSON round-trips lists to tuples and back; normalise before checking.
        if isinstance(value, list):
            value = tuple(value)
        if value not in self.choices:
            raise ValueError(f"gene {self.name!r}: {value!r} not in {self.choices!r}")
        return value

    def grid_values(self) -> List[Any]:
        return list(self.choices)


Gene = Union[BinaryGene, FloatGene, IntGene, ChoiceGene]


class GenomeSpec:
    """An ordered, named collection of genes plus the genetic operators.

    All operators are pure: they take explicit values and an explicit
    ``numpy.random.Generator`` and return new value dicts.  ``Individual``
    wraps these with the reference's stateful API (SURVEY.md §2.0 row 5).
    """

    def __init__(self, genes: Sequence[Gene]):
        names = [g.name for g in genes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate gene names: {names}")
        self._genes: Tuple[Gene, ...] = tuple(genes)
        self._by_name: Dict[str, Gene] = {g.name: g for g in genes}

    @property
    def genes(self) -> Tuple[Gene, ...]:
        return self._genes

    @property
    def names(self) -> List[str]:
        return [g.name for g in self._genes]

    def __len__(self) -> int:
        return len(self._genes)

    def __getitem__(self, name: str) -> Gene:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    # -- operators ---------------------------------------------------------

    def default(self) -> Dict[str, Any]:
        return {g.name: g.default() for g in self._genes}

    def sample(self, rng: np.random.Generator) -> Dict[str, Any]:
        """Random genome: Bernoulli(0.5) bits / uniform scalars (SURVEY §2.3)."""
        return {g.name: g.sample(rng) for g in self._genes}

    def crossover(
        self,
        a: Mapping[str, Any],
        b: Mapping[str, Any],
        rng: np.random.Generator,
        rate: float = 0.5,
    ) -> Dict[str, Any]:
        """Uniform crossover at *gene* granularity.

        The child takes each whole gene from parent ``b`` with probability
        ``rate``, else from parent ``a``; bits within a gene are never spliced
        (gentun ``Individual.crossover`` [PUB]; SURVEY.md §2.3).
        """
        picks = rng.random(len(self._genes)) < rate
        return {
            g.name: (b if take_b else a)[g.name]
            for g, take_b in zip(self._genes, picks)
        }

    def mutate(
        self,
        value: Mapping[str, Any],
        rng: np.random.Generator,
        rate: float = 0.015,
    ) -> Dict[str, Any]:
        """Per-bit flip (binary) / per-gene re-sample (scalar) at ``rate``.

        The 0.015 default mirrors the reference's mutation rate
        (SURVEY.md §2.3, exact constant tagged [UNCERTAIN] there).
        """
        return {g.name: g.mutate(value[g.name], rng, rate) for g in self._genes}

    def validate(self, value: Mapping[str, Any]) -> Dict[str, Any]:
        """Canonicalise and bounds-check a genome value dict (e.g. off the wire)."""
        missing = [g.name for g in self._genes if g.name not in value]
        if missing:
            raise ValueError(f"genome missing genes: {missing}")
        extra = [k for k in value if k not in self._by_name]
        if extra:
            raise ValueError(f"genome has unknown genes: {extra}")
        return {g.name: g.validate(value[g.name]) for g in self._genes}

    def grid(
        self,
        grid_sizes: Mapping[str, int] | None = None,
        gene_values: Mapping[str, Sequence[Any]] | None = None,
    ) -> List[Dict[str, Any]]:
        """Cartesian product of per-gene value grids (``GridPopulation`` init).

        Mirrors gentun's grid-of-gene-values initialisation
        (``gentun/populations.py`` [PUB]; SURVEY.md §2.0 row 4).  Per-gene
        axes come from, in priority order: an explicit value list in
        ``gene_values``, a point count in ``grid_sizes`` (numeric genes), or
        the gene's full ``grid_values()``.
        """
        grid_sizes = dict(grid_sizes or {})
        gene_values = dict(gene_values or {})
        unknown = [k for k in gene_values if k not in self._by_name]
        if unknown:
            raise ValueError(f"gene_values has unknown genes: {unknown}")
        axes: List[List[Any]] = []
        for g in self._genes:
            if g.name in gene_values:
                axes.append([g.validate(v) for v in gene_values[g.name]])
            elif isinstance(g, (FloatGene, IntGene)) and g.name in grid_sizes:
                axes.append(g.grid_values(grid_sizes[g.name]))
            else:
                axes.append(g.grid_values())
        return [dict(zip(self.names, combo)) for combo in itertools.product(*axes)]


# ---------------------------------------------------------------------------
# Canonical genomes
# ---------------------------------------------------------------------------


def genetic_cnn_genome(nodes: Sequence[int] = (3, 5)) -> GenomeSpec:
    """Genetic-CNN DAG genome: gene ``S_k`` has K_k*(K_k-1)/2 bits.

    One bit per ordered node pair (i<j) within stage k — the Xie & Yuille
    ICCV 2017 encoding the reference implements (SURVEY.md §2.3; gentun
    ``GeneticCnnIndividual`` [PUB]).  For nodes=(3, 5) the search space is
    2**(3+10) = 8192 architectures.
    """
    return GenomeSpec(
        [BinaryGene(f"S_{k + 1}", k_s * (k_s - 1) // 2) for k, k_s in enumerate(nodes)]
    )


def boosting_genome() -> GenomeSpec:
    """Hyperparameter genome for the sklearn gradient-boosting control path.

    The rebuild's equivalent of gentun's ``XgboostIndividual`` genome
    (SURVEY.md §2.0 row 6): xgboost is absent from this environment, so the
    control path targets ``sklearn.ensemble.HistGradientBoostingClassifier``
    with an equivalent bounded-hyperparameter search space.
    """
    return GenomeSpec(
        [
            FloatGene("learning_rate", 0.1, 0.001, 1.0, log_scale=True),
            IntGene("max_depth", 6, 2, 12),
            IntGene("max_leaf_nodes", 31, 4, 128),
            IntGene("min_samples_leaf", 20, 1, 100),
            FloatGene("l2_regularization", 0.0, 0.0, 10.0),
            IntGene("max_bins", 255, 16, 255),
            IntGene("max_iter", 100, 10, 300),
        ]
    )


def xgboost_genome() -> GenomeSpec:
    """The reference's XGBoost hyperparameter genome, for drop-in parity.

    Gene set and (default, min, max) bounds per gentun ``XgboostIndividual``
    (``gentun/individuals.py`` [PUB]; SURVEY.md §2.0 row 6 — exact set tagged
    [UNCERTAIN] there).  Usable with any fitness model that consumes these
    names (real xgboost is not installed here; see ``models/boosting.py``).
    """
    return GenomeSpec(
        [
            FloatGene("eta", 0.3, 0.001, 1.0, log_scale=True),
            IntGene("min_child_weight", 1, 0, 10),
            IntGene("max_depth", 6, 3, 10),
            FloatGene("gamma", 0.0, 0.0, 10.0),
            IntGene("max_delta_step", 0, 0, 10),
            FloatGene("subsample", 1.0, 0.5, 1.0),
            FloatGene("colsample_bytree", 1.0, 0.5, 1.0),
            FloatGene("colsample_bylevel", 1.0, 0.5, 1.0),
            FloatGene("lambda", 1.0, 0.0, 10.0),
            FloatGene("alpha", 0.0, 0.0, 10.0),
            FloatGene("scale_pos_weight", 1.0, 0.0, 10.0),
        ]
    )
