"""gentun_tpu_torch — the PyTorch/CUDA port of the JAX package.

A second package beside the JAX package (the reference, which stays as it
is).  It carries the same module tree and names:

- the deterministic, seeded GA engine (``genes``, ``individuals``,
  ``populations``, ``algorithms``), copied from the reference;
- Genetic-CNN fitness as a masked supergraph trained for a whole population
  at once on the CUDA device (``ops``, ``models``);
- the steady-state engine with its fidelity ladder and surrogate gate
  (``algorithms_async``, ``surrogate``), the boosting control-path species
  (host-side, sklearn or xgboost imported lazily), the telemetry plane and
  the distributed plane (``distributed``: broker, master, worker CLI,
  fitness and compile services, autoscaler).

The port imports ``torch`` and never ``jax``, and nothing of the JAX package:
where it needs one of the reference's jax-free modules it keeps its own copy.
Fitness values it measures carry their own protocol stamp
(``utils.fitness_store.FITNESS_PROTOCOL``) and never mix with the
reference's.
"""

from .genes import (
    BinaryGene,
    ChoiceGene,
    FloatGene,
    GenomeSpec,
    IntGene,
    boosting_genome,
    genetic_cnn_genome,
    xgboost_genome,
)
from .individuals import BoostingIndividual, GeneticCnnIndividual, Individual, XgboostIndividual
from .populations import GridPopulation, Population
from .algorithms import GeneticAlgorithm, RussianRouletteGA
from .algorithms_async import AsyncEvolution
from .surrogate import FitnessSurrogate, SurrogateGate
from . import telemetry  # noqa: F401  (zero-dependency)

__all__ = [
    "telemetry",
    "BinaryGene",
    "FloatGene",
    "IntGene",
    "ChoiceGene",
    "GenomeSpec",
    "genetic_cnn_genome",
    "boosting_genome",
    "xgboost_genome",
    "Individual",
    "GeneticCnnIndividual",
    "BoostingIndividual",
    "XgboostIndividual",
    "Population",
    "GridPopulation",
    "GeneticAlgorithm",
    "RussianRouletteGA",
    "AsyncEvolution",
    "FitnessSurrogate",
    "SurrogateGate",
]

__version__ = "0.1.0"

# The fitness model pulls in torch; keep it optional at import time so the
# GA engine works without it, as the reference does with jax.
try:  # pragma: no cover - exercised implicitly
    from .models.cnn import GeneticCnnModel  # noqa: F401

    __all__.append("GeneticCnnModel")
except ImportError:  # pragma: no cover
    pass

try:  # pragma: no cover
    from .models.boosting import BoostingModel  # noqa: F401

    __all__.append("BoostingModel")
except ImportError:  # pragma: no cover
    pass

try:  # pragma: no cover
    from .distributed.server import DistributedPopulation, DistributedGridPopulation  # noqa: F401
    from .distributed.client import GentunClient  # noqa: F401
    from .distributed.broker import GatherTimeout, JobBroker, JobFailed  # noqa: F401

    __all__ += [
        "DistributedPopulation",
        "DistributedGridPopulation",
        "GentunClient",
        "JobBroker",
        "JobFailed",
        "GatherTimeout",
    ]
except ImportError:  # pragma: no cover
    pass
