"""Fitness-model base class.

Reference parity: ``GentunModel`` ABC in ``gentun/models/generic_models.py``
[PUB] (SURVEY.md §2.0 row 8): a fitness model owns ``(x_train, y_train)``
plus hyperparameters and exposes ``cross_validate() -> float`` — the single
scalar the GA consumes.  Everything else about a model is species-specific.
"""

from __future__ import annotations

import abc
from typing import Any, Mapping

import numpy as np

__all__ = ["GentunModel"]


class GentunModel(abc.ABC):
    """ABC for fitness models: train under a genome, return a fitness scalar."""

    def __init__(self, x_train, y_train, genes: Mapping[str, Any]):
        self.x_train = np.asarray(x_train)
        self.y_train = np.asarray(y_train)
        self.genes = dict(genes)

    @abc.abstractmethod
    def cross_validate(self) -> float:
        """k-fold cross-validation; returns the mean validation metric."""
