"""Real-XGBoost fitness model: the reference's ``xgb.cv`` semantics.

Reference parity: ``XgboostModel`` in ``gentun/models/xgboost_models.py``
[PUB] (SURVEY.md §2.0 row 8): k-fold cross-validation via ``xgb.cv`` with
early stopping; fitness = the mean validation metric at the best round.

xgboost is an optional dependency (this copy of the JAX package's module
runs where it is missing too), so this module imports it lazily and the
package auto-selects backends: ``BoostingIndividual``/``XgboostIndividual`` use :class:`XgboostModel`
whenever ``import xgboost`` succeeds and fall back to the sklearn
translation (``models/boosting.py``) otherwise — a user who installs
xgboost gets the reference's exact semantics (all 11 genes live) with no
code changes.  The ``additional_parameters`` surface (``kfold``, ``task``,
``metric``, ``seed``, ``early_stopping``) is identical across the two
backends, so populations and wire payloads are backend-agnostic.

Genome keys may be either the reference's xgboost names (pass through —
:func:`gentun_tpu_torch.genes.xgboost_genome`) or the sklearn names
(:func:`gentun_tpu_torch.genes.boosting_genome` — translated where a faithful
equivalent exists).
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Dict, Mapping

import numpy as np

from .generic import GentunModel

__all__ = ["XgboostModel", "xgboost_available"]

logger = logging.getLogger("gentun_tpu_torch")

#: reference 11-gene genome: these pass straight through to xgb params
_XGB_NATIVE = {
    "eta", "min_child_weight", "max_depth", "gamma", "max_delta_step",
    "subsample", "colsample_bytree", "colsample_bylevel", "lambda", "alpha",
    "scale_pos_weight",
}

#: sklearn-named genes (boosting_genome) → xgboost equivalents.  min_samples_leaf
#: maps to min_child_weight: for the default squared/softmax losses the
#: hessian is ~1 per row, so "minimum child hessian weight" IS approximately
#: a minimum leaf sample count.
_SKLEARN_TO_XGB = {
    "learning_rate": ("eta", float),
    "l2_regularization": ("lambda", float),
    "min_samples_leaf": ("min_child_weight", float),
    "max_depth": ("max_depth", int),
    "max_bins": ("max_bin", int),
    "max_leaf_nodes": ("max_leaves", int),
}

#: sklearn-named genes consumed OUTSIDE the params dict
_CONTROL_GENES = {"max_iter"}


@functools.lru_cache(maxsize=1)
def xgboost_available() -> bool:
    # Cached: failed imports are NOT cached by Python, and this runs per
    # fitness evaluation via default_boosting_model() — without the cache
    # an xgboost-less worker would re-scan sys.path thousands of times.
    try:
        import xgboost  # noqa: F401

        return True
    except ImportError:
        return False


def genes_to_xgb_params(genes: Mapping[str, Any]) -> Dict[str, Any]:
    """Genome dict → ``xgb.cv`` params (without objective/metric).

    xgboost-named genes pass through verbatim — with a real xgboost
    backend ALL 11 reference genes are live (the sklearn translation's
    inert-gene caveat disappears, which is the whole point of this
    adapter).  sklearn-named genes translate where faithful; anything
    unknown raises rather than silently searching a dead dimension.
    """
    params: Dict[str, Any] = {}
    for name, value in genes.items():
        if name in _XGB_NATIVE:
            params[name] = int(value) if name in ("max_depth", "max_delta_step") else float(value)
        elif name in _SKLEARN_TO_XGB:
            target, conv = _SKLEARN_TO_XGB[name]
            params[target] = conv(value)
        elif name in _CONTROL_GENES:
            continue  # handled by the model (num_boost_round)
        else:
            raise ValueError(f"gene {name!r} has no xgboost mapping")
    if "max_leaves" in params and params["max_leaves"] > 0:
        # max_leaves only binds under lossguide growth (hist tree method).
        params.setdefault("tree_method", "hist")
        params.setdefault("grow_policy", "lossguide")
    return params


class XgboostModel(GentunModel):
    """k-fold CV fitness via ``xgb.cv`` (the reference's exact hot loop).

    ``additional_parameters`` — same surface as
    :class:`gentun_tpu_torch.models.boosting.BoostingModel`:

    - ``kfold=5``: folds (``nfold``);
    - ``task="classification"`` | ``"regression"``;
    - ``metric``: ``"accuracy"`` (→ xgboost ``merror``, reported as
      1 − merror so larger is better, like the sklearn backend),
      ``"auc"``, or ``"rmse"``;
    - ``seed=0``;
    - ``early_stopping=True``: ``early_stopping_rounds`` (the reference's
      ``xgb.cv`` early stop);

    plus xgboost-specific knobs mirroring the reference constructor:
    ``num_boost_round=500`` (a ``max_iter`` gene overrides it) and
    ``early_stopping_rounds=20``.
    """

    def __init__(
        self,
        x_train,
        y_train,
        genes: Mapping[str, Any],
        kfold: int = 5,
        task: str = "classification",
        metric: str | None = None,
        seed: int = 0,
        early_stopping: bool = True,
        num_boost_round: int = 500,
        early_stopping_rounds: int = 20,
    ):
        super().__init__(x_train, y_train, genes)
        if task not in ("classification", "regression"):
            raise ValueError(f"unknown task {task!r}")
        self.kfold = int(kfold)
        self.task = task
        self.metric = metric or ("accuracy" if task == "classification" else "rmse")
        if task == "regression" and self.metric in ("accuracy", "auc"):
            raise ValueError(f"metric {self.metric!r} requires classification")
        if task == "classification" and self.metric == "rmse":
            raise ValueError("metric 'rmse' requires task='regression'")
        if self.metric == "auc" and len(np.unique(np.asarray(y_train))) != 2:
            # Fail here, loudly, rather than deep inside xgb.cv with an
            # obscure "label must be in [0,1]" abort mid-generation.
            raise ValueError("metric 'auc' requires binary labels")
        self.seed = int(seed)
        self.early_stopping = bool(early_stopping)
        self.num_boost_round = int(genes.get("max_iter", num_boost_round))
        self.early_stopping_rounds = int(early_stopping_rounds)

    def _objective_and_metric(self, n_classes: int) -> tuple:
        """(objective params, xgboost eval_metric, postprocess fn)."""
        if self.task == "regression":
            return {"objective": "reg:squarederror"}, "rmse", lambda m: m
        if self.metric == "auc":
            return {"objective": "binary:logistic"}, "auc", lambda m: m
        if n_classes > 2:
            return (
                {"objective": "multi:softmax", "num_class": n_classes},
                "merror",
                lambda m: 1.0 - m,  # accuracy, like the sklearn backend
            )
        return {"objective": "binary:logistic"}, "error", lambda m: 1.0 - m

    def cross_validate(self) -> float:
        """``xgb.cv`` with early stopping; mean validation metric at the
        best round (last row of the cv table — xgb.cv truncates at the
        early stop, exactly the reference's reading of it)."""
        import xgboost as xgb

        x = np.asarray(self.x_train, dtype=np.float64)
        y = np.asarray(self.y_train)
        if self.task == "classification":
            # xgboost wants labels 0..K-1; remap like sklearn would.
            classes, y = np.unique(y, return_inverse=True)
            n_classes = len(classes)
        else:
            y = np.asarray(y, dtype=np.float64)
            n_classes = 0
        obj, xgb_metric, post = self._objective_and_metric(n_classes)
        params = {**genes_to_xgb_params(self.genes), **obj}
        cv = xgb.cv(
            params,
            xgb.DMatrix(x, label=y),
            num_boost_round=self.num_boost_round,
            nfold=self.kfold,
            metrics=(xgb_metric,),
            early_stopping_rounds=self.early_stopping_rounds if self.early_stopping else None,
            stratified=self.task == "classification",
            seed=self.seed,
        )
        mean_col = f"test-{xgb_metric}-mean"
        return float(post(float(np.asarray(cv[mean_col])[-1])))
