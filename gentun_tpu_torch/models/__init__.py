"""Fitness models: the compute layer.

``GentunModel`` is the ABC; ``GeneticCnnModel`` is the CUDA hot path; the
boosting control path has two interchangeable host-side backends, as in
the JAX package — ``XgboostModel`` (the reference's exact ``xgb.cv``
semantics, used whenever xgboost is importable) and ``BoostingModel``
(sklearn gradient boosting, the fallback).  Both accept the same
``additional_parameters``, so individuals and wire payloads are
backend-agnostic, and both import their library lazily: the package
imports without sklearn or xgboost.
"""

import logging

from .generic import GentunModel
from .cnn import GeneticCnnModel, MaskedGeneticCnn, params_from_reference

__all__ = ["GentunModel", "GeneticCnnModel", "MaskedGeneticCnn", "params_from_reference",
           "default_boosting_model"]

_backend_logged = False


def default_boosting_model():
    """The boosting fitness backend available in this process.

    Fallback chain: real xgboost (``models/xgboost.py`` — all 11 reference
    genes live) when importable, else the sklearn translation
    (``models/boosting.py`` — 7 of 11 live, warned loudly).

    The selection is logged once per process (ADVICE r3): in a distributed
    search a mixed fleet would otherwise silently score one generation with
    two different estimators; workers also advertise the backend name in
    their broker handshake so the MASTER warns on heterogeneity
    (``distributed/broker.py``).
    """
    global _backend_logged
    from .xgboost import XgboostModel, xgboost_available

    if xgboost_available():
        selected = XgboostModel
    else:
        from .boosting import BoostingModel

        selected = BoostingModel
    if not _backend_logged:
        _backend_logged = True
        logging.getLogger("gentun_tpu_torch").info(
            "boosting fitness backend: %s", selected.__name__
        )
    return selected


try:
    from .boosting import BoostingModel  # noqa: F401

    __all__ += ["BoostingModel"]
except ImportError:  # pragma: no cover
    pass
