"""Fitness models: the compute layer.

``GentunModel`` is the ABC; ``GeneticCnnModel`` is the CUDA hot path.  The
boosting control-path species of the JAX package are not ported yet.
"""

from .generic import GentunModel
from .cnn import GeneticCnnModel, MaskedGeneticCnn, params_from_reference

__all__ = ["GentunModel", "GeneticCnnModel", "MaskedGeneticCnn", "params_from_reference"]
