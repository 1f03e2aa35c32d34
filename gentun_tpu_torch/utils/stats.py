"""Small paired-comparison statistics for experiment scripts.

A copy of the JAX package's ``utils/stats.py`` (GA vs random paired by
seed, SEARCH.md; paired-by-genome studies).  Pure numpy + stdlib: scipy is
not a dependency (pyproject), and the exact Binomial(n, 1/2) arithmetic is
three lines.
"""

from __future__ import annotations

from math import comb
from typing import Dict, Tuple

import numpy as np

__all__ = ["sign_test_p", "bootstrap_ci", "paired_row", "fmt_paired"]


def sign_test_p(deltas: np.ndarray) -> float:
    """Two-sided exact sign test on the non-zero paired deltas.

    Two-sided p = sum of Binomial(n, 1/2) pmf over all outcomes whose pmf
    is ≤ pmf(observed wins) — the standard minimum-likelihood definition
    (matches ``scipy.stats.binomtest(..., p=0.5)``, verified in tests).
    """
    deltas = np.asarray(deltas, dtype=np.float64)
    nz = deltas[deltas != 0]
    n = len(nz)
    if n == 0:
        return 1.0
    wins = int((nz > 0).sum())
    pmf = [comb(n, j) * 0.5**n for j in range(n + 1)]
    p = sum(pj for pj in pmf if pj <= pmf[wins] * (1 + 1e-12))
    return float(min(1.0, p))


def bootstrap_ci(
    deltas: np.ndarray, n_boot: int = 10_000, alpha: float = 0.05, seed: int = 0
) -> Tuple[float, float]:
    """Seeded percentile bootstrap CI for the mean of paired deltas."""
    deltas = np.asarray(deltas, dtype=np.float64)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(deltas), size=(n_boot, len(deltas)))
    means = deltas[idx].mean(axis=1)
    return (float(np.quantile(means, alpha / 2)), float(np.quantile(means, 1 - alpha / 2)))


def paired_row(deltas: np.ndarray) -> Dict:
    """Full paired summary: mean, bootstrap CI, win rate, exact sign test."""
    deltas = np.asarray(deltas, dtype=np.float64)
    lo, hi = bootstrap_ci(deltas)
    return {
        "mean": float(deltas.mean()),
        "ci": (lo, hi),
        "wins": int((deltas > 0).sum()),
        "ties": int((deltas == 0).sum()),
        "n": int(len(deltas)),
        "p_sign": sign_test_p(deltas),
    }


def fmt_paired(s: Dict) -> str:
    """One markdown-table cell: ``mean [CI] | wins/n | p``."""
    return (
        f"{s['mean']:+.4f} [{s['ci'][0]:+.4f}, {s['ci'][1]:+.4f}] | "
        f"{s['wins']}/{s['n'] - s['ties']}"
        + (f" ({s['ties']} ties)" if s["ties"] else "")
        + f" | {s['p_sign']:.3f}"
    )
