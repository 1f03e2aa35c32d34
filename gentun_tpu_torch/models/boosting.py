"""Gradient-boosting fitness model — the host-side control path.

The port's copy of the JAX package's module; neither uses the accelerator,
and both give the same fitness on the same data, genes and seed.

Reference parity: ``XgboostModel`` in ``gentun/models/xgboost_models.py``
[PUB] (SURVEY.md §2.0 row 8): k-fold cross-validation of a gradient-boosted
tree model over the genome's hyperparameters, fitness = mean validation
metric.  xgboost is an optional dependency, so the fallback targets
sklearn's ``HistGradientBoosting{Classifier,Regressor}``
— the same histogram-based GBDT algorithm family — while keeping the model
interface pluggable so a real xgboost backend can drop in unchanged.

Genome keys are the sklearn constructor names (see
:func:`gentun_tpu_torch.genes.boosting_genome`); xgboost-style keys (from
:func:`gentun_tpu_torch.genes.xgboost_genome`) are translated where an equivalent
exists — for the reference's 11-gene genome, 7 stay live
(colsample_bytree/bylevel fold into ``max_features``, ``scale_pos_weight``
into ``class_weight``; ``alpha`` maps to ``l2_regularization`` only in
genomes without a competing ``lambda``, so it is inert in the reference
genome) — and every inert gene triggers ONE loud warning stating the
effective search dimensionality, so a reference genome never searches
silently-dead dimensions.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Tuple

import numpy as np

from .generic import GentunModel

__all__ = ["BoostingModel"]

logger = logging.getLogger("gentun_tpu_torch")

# xgboost name → (sklearn name, converter); translation for reference-shaped
# genomes (gentun XgboostIndividual [PUB]).  Of the 11 reference genes, 7 map
# onto HistGradientBoosting knobs (colsample_* jointly onto max_features,
# scale_pos_weight onto class_weight for binary classification); the rest —
# gamma, subsample, max_delta_step, and alpha whenever lambda is also present
# — have NO sklearn equivalent and are reported loudly as inert (see
# _warn_inert), never silently dropped.
_XGB_TO_SKLEARN = {
    "eta": ("learning_rate", float),
    "max_depth": ("max_depth", int),
    "lambda": ("l2_regularization", float),
    "min_child_weight": ("min_samples_leaf", lambda v: max(1, int(round(v)))),
}

#: xgboost genes with no HistGradientBoosting counterpart at all (documented
#: here for readers; translation-wise they land in the same inert bucket as
#: any unknown knob)
_XGB_INERT = {"gamma", "subsample", "max_delta_step"}

_SKLEARN_KEYS = {
    "learning_rate",
    "max_depth",
    "max_leaf_nodes",
    "min_samples_leaf",
    "l2_regularization",
    "max_bins",
    "max_iter",
    "max_features",
}

#: inert/shadowed-gene sets already warned about (one loud warning per set)
_inert_warned: set = set()


def _warn_inert(inert: Tuple[str, ...], shadowed: Tuple[str, ...], total: int) -> None:
    if (not inert and not shadowed) or (inert, shadowed) in _inert_warned:
        return
    _inert_warned.add((inert, shadowed))
    dead = len(inert) + len(shadowed)
    parts = []
    if inert:
        parts.append(
            f"{len(inert)} with no sklearn HistGradientBoosting equivalent "
            f"(INERT): {', '.join(inert)}"
        )
    if shadowed:
        # These DO have an equivalent — another gene in the same genome
        # claimed the knob (e.g. eta vs learning_rate, alpha vs lambda).
        # Remove the duplicate key to make them live, don't drop them.
        parts.append(
            f"{len(shadowed)} SHADOWED by a competing gene for the same "
            f"knob: {', '.join(shadowed)}"
        )
    logger.warning(
        "xgboost genome translation: %d of %d gene(s) are dead in this "
        "search — %s. The effective search dimensionality is %d, not %d.  "
        "Install a real xgboost backend (the model interface is pluggable) "
        "for the full reference space.",
        dead, total, "; ".join(parts), total - dead, total,
    )


def _genes_to_params(
    genes: Mapping[str, Any],
    task: str = "classification",
    classes: Any = None,
) -> Dict[str, Any]:
    """Genome dict → HistGradientBoosting constructor kwargs.

    ``classes`` (``np.unique(y_train)``) lets ``scale_pos_weight`` target the
    dataset's actual positive class; without it, integer labels {0, 1} are
    assumed.
    """
    params: Dict[str, Any] = {}
    inert = []
    shadowed = []
    colsample = 1.0
    colsample_genes = []
    # Pass 1: sklearn-named genes bind first, so in a mixed genome an
    # explicit sklearn key deterministically wins over its xgboost twin
    # (which is then reported shadowed) regardless of dict order.
    for name, value in genes.items():
        if name in _SKLEARN_KEYS:
            params[name] = (
                float(value)
                if name in ("learning_rate", "l2_regularization", "max_features")
                else int(value)
            )
    for name, value in genes.items():
        if name in _SKLEARN_KEYS:
            continue
        if name in ("colsample_bytree", "colsample_bylevel"):
            # xgboost applies tree- and level-wise column subsampling
            # multiplicatively; sklearn has one per-split `max_features`
            # fraction, so the product is the faithful joint mapping.
            colsample *= float(value)
            colsample_genes.append(name)
        elif name == "scale_pos_weight":
            # xgboost semantics: up-weight the POSITIVE class of a binary
            # task.  sklearn's HistGradientBoosting applies a class_weight
            # dict to LABEL-ENCODED classes (0..K-1, verified on sklearn
            # 1.9: original-label keys raise "classes not in class_weight"),
            # so {0: 1, 1: w} up-weights the second sorted class — the
            # positive one under xgboost's 0/1, {-1,1}, or {1,2} conventions
            # — for every binary label encoding.  `classes` only decides
            # whether the task is binary at all.
            n_classes = 2 if classes is None else len(np.asarray(classes))
            if task == "classification" and n_classes == 2:
                params["class_weight"] = {0: 1.0, 1: float(value)}
            else:
                inert.append(name)  # regression / multiclass: no equivalent
        elif name == "alpha":
            # L1 regularization has no sklearn knob; fold into l2 only when
            # the genome has no lambda of its own (approximate, but keeps
            # the gene live rather than dead).
            if "lambda" not in genes and "l2_regularization" not in genes:
                params["l2_regularization"] = float(value)
            else:
                shadowed.append(name)  # lambda claimed the l2 knob
        elif name in _XGB_TO_SKLEARN:
            target, conv = _XGB_TO_SKLEARN[name]
            if target in params:
                shadowed.append(name)  # its sklearn twin claimed the knob
            else:
                params[target] = conv(value)
        else:
            inert.append(name)  # known-inert (_XGB_INERT) or unknown knob:
            # surface it, don't hide it
    if colsample_genes:
        if "max_features" in params:
            # An explicit sklearn max_features gene won in pass 1; the
            # colsample twins lose and are reported, never silently merged.
            shadowed.extend(colsample_genes)
        else:
            params["max_features"] = min(1.0, max(0.05, colsample))
    _warn_inert(tuple(sorted(inert)), tuple(sorted(shadowed)), len(genes))
    return params


class BoostingModel(GentunModel):
    """k-fold CV fitness for gradient-boosted trees (sklearn backend).

    ``additional_parameters`` (mirroring the reference's kwargs style,
    SURVEY.md §5 "Config / flag system"):

    - ``kfold=5``: folds for cross-validation;
    - ``task="classification"`` or ``"regression"``;
    - ``metric``: ``"accuracy"`` (default, classification), ``"auc"``
      (binary classification), ``"rmse"`` (default for regression; reported
      negated so that *larger is always better* is up to the caller's
      ``maximize`` flag — the raw mean metric is returned unmodified);
    - ``seed=0``: fold-split seed;
    - ``early_stopping=True``: sklearn's internal validation early stop,
      the counterpart of ``xgb.cv``'s early stopping in the reference.
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
    ):
        super().__init__(x_train, y_train, genes)
        if task not in ("classification", "regression"):
            raise ValueError(f"unknown task {task!r}")
        self.kfold = int(kfold)
        self.task = task
        self.metric = metric or ("accuracy" if task == "classification" else "rmse")
        self.seed = int(seed)
        self.early_stopping = bool(early_stopping)
        if self.task == "regression" and self.metric in ("accuracy", "auc"):
            raise ValueError(f"metric {self.metric!r} requires classification")

    def _build(self):
        from sklearn.ensemble import (
            HistGradientBoostingClassifier,
            HistGradientBoostingRegressor,
        )

        params = _genes_to_params(
            self.genes,
            task=self.task,
            classes=np.unique(self.y_train) if self.task == "classification" else None,
        )
        cls = (
            HistGradientBoostingClassifier
            if self.task == "classification"
            else HistGradientBoostingRegressor
        )
        return cls(
            random_state=self.seed,
            early_stopping=self.early_stopping,
            **params,
        )

    def _score(self, model, x_val, y_val) -> float:
        if self.metric == "accuracy":
            return float(model.score(x_val, y_val))
        if self.metric == "auc":
            from sklearn.metrics import roc_auc_score

            proba = model.predict_proba(x_val)[:, 1]
            return float(roc_auc_score(y_val, proba))
        if self.metric == "rmse":
            pred = model.predict(x_val)
            return float(np.sqrt(np.mean((pred - y_val) ** 2)))
        raise ValueError(f"unknown metric {self.metric!r}")

    def cross_validate(self) -> float:
        """Mean validation metric over stratified/plain k-fold splits."""
        from sklearn.model_selection import KFold, StratifiedKFold

        splitter_cls = StratifiedKFold if self.task == "classification" else KFold
        splitter = splitter_cls(n_splits=self.kfold, shuffle=True, random_state=self.seed)
        scores = []
        for tr_idx, val_idx in splitter.split(self.x_train, self.y_train):
            model = self._build()
            model.fit(self.x_train[tr_idx], self.y_train[tr_idx])
            scores.append(self._score(model, self.x_train[val_idx], self.y_train[val_idx]))
        return float(np.mean(scores))
