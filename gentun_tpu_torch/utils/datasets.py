"""Dataset loaders for the canonical workloads (BASELINE.md configs).

A copy of the JAX package's ``utils/datasets.py``: for the same arguments
and seed it returns the same arrays.  Nothing downloads, so each loader
resolves in priority order:

1. a real on-disk copy, if ``data_dir`` (or ``GENTUN_TPU_DATA``) points at
   numpy archives of the expected shape;
2. real sklearn-bundled data where a faithful stand-in exists
   (``load_digits`` for MNIST-class work, ``load_wine`` /
   ``load_breast_cancer`` for the UCI control path — these ship with
   sklearn, no download);
3. deterministic synthetic data of the exact target shape (class
   prototypes + Gaussian noise), clearly flagged in the return value.

Every loader returns ``(x, y, meta)`` with ``meta["synthetic"]`` telling
the caller (and the benchmark record) what it actually got.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = [
    "load_mnist",
    "load_cifar10",
    "load_cifar100",
    "load_uci_wine",
    "load_uci_binary",
    "synthetic_images",
]

Arrays = Tuple[np.ndarray, np.ndarray, Dict[str, Any]]


def _data_dir(data_dir: Optional[str]) -> Optional[str]:
    return data_dir or os.environ.get("GENTUN_TPU_DATA")


def _try_npz(data_dir: Optional[str], name: str, shape_hwc: Tuple[int, int, int]) -> Optional[Arrays]:
    d = _data_dir(data_dir)
    if not d:
        return None
    path = os.path.join(d, f"{name}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        x, y = np.asarray(z["x"], np.float32), np.asarray(z["y"], np.int32)
    if x.ndim == 3:
        x = x[..., None]
    if x.shape[1:] != shape_hwc:
        raise ValueError(f"{path}: expected images {shape_hwc}, got {x.shape[1:]}")
    if x.max() > 1.5:  # raw 0-255 → normalise
        x = x / 255.0
    return x, y, {"synthetic": False, "source": path}


def synthetic_images(
    n: int,
    shape_hwc: Tuple[int, int, int],
    n_classes: int,
    noise: float = 0.5,
    seed: int = 0,
    sample_seed: Optional[int] = None,
) -> Arrays:
    """Class-prototype + noise images: learnable, deterministic, any shape.

    ``sample_seed`` draws the *samples* (labels + noise) from a separate
    stream while keeping the class prototypes from ``seed`` — i.e. a fresh
    disjoint draw from the SAME underlying task.  Use it to build a holdout
    set for a training set generated with ``sample_seed=None``: the default
    path is bit-identical to the original single-stream draw, so existing
    artifacts and seeded comparisons are unaffected.
    """
    if sample_seed == seed:
        raise ValueError(
            "sample_seed must differ from seed: equal seeds would draw the "
            "samples from the same stream positions that generated the class "
            "prototypes, correlating the 'fresh' noise with the task itself"
        )
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, *shape_hwc)).astype(np.float32)
    if sample_seed is not None:
        rng = np.random.default_rng(sample_seed)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = protos[y] + noise * rng.normal(size=(n, *shape_hwc)).astype(np.float32)
    src = f"synthetic(seed={seed})" if sample_seed is None else f"synthetic(seed={seed},sample_seed={sample_seed})"
    return x, y, {"synthetic": True, "source": src}


def load_mnist(n: Optional[int] = None, data_dir: Optional[str] = None, seed: int = 0) -> Arrays:
    """28×28×1, 10 classes (BASELINE config #1).

    Fallback #2 is sklearn's real ``load_digits`` (1797 genuine handwritten
    digits at 8×8) upscaled to 28×28 — real data beats synthetic for
    accuracy comparisons even if the resolution is nearer MNIST-small.
    """
    found = _try_npz(data_dir, "mnist", (28, 28, 1))
    if found is not None:
        x, y, meta = found
    else:
        try:
            from sklearn.datasets import load_digits

            digits = load_digits()
            imgs = digits.images.astype(np.float32) / 16.0  # (1797, 8, 8)
            x = np.repeat(np.repeat(imgs, 4, axis=1), 4, axis=2)[..., None]  # 8×8 → 32×32
            x = x[:, 2:30, 2:30, :]  # centre-crop 32 → 28, the canonical shape
            y = digits.target.astype(np.int32)
            meta = {"synthetic": False, "source": "sklearn.load_digits upscaled 8x8→28x28"}
        except ImportError:  # pragma: no cover
            x, y, meta = synthetic_images(4096, (28, 28, 1), 10, seed=seed)
    return _subsample((x, y, meta), n, seed)


def _subsample(found: Arrays, n: Optional[int], seed: int) -> Arrays:
    """Uniform random subsample to ``n`` rows (no-op when n >= len)."""
    x, y, meta = found
    if n is not None and n < len(x):
        idx = np.random.default_rng(seed).permutation(len(x))[:n]
        x, y = x[idx], y[idx]
    return x, y, meta


def load_cifar10(n: int = 10_000, data_dir: Optional[str] = None, seed: int = 0) -> Arrays:
    """32×32×3, 10 classes (BASELINE config #2)."""
    found = _try_npz(data_dir, "cifar10", (32, 32, 3))
    if found is not None:
        return _subsample(found, n, seed)
    return synthetic_images(n, (32, 32, 3), 10, seed=seed)


def load_cifar100(n: int = 10_000, data_dir: Optional[str] = None, seed: int = 0) -> Arrays:
    """32×32×3, 100 classes (BASELINE config #5)."""
    found = _try_npz(data_dir, "cifar100", (32, 32, 3))
    if found is not None:
        return _subsample(found, n, seed)
    return synthetic_images(n, (32, 32, 3), 100, seed=seed)


def load_uci_wine() -> Arrays:
    """Real UCI wine (ships with sklearn) — BASELINE config #3."""
    from sklearn.datasets import load_wine

    data = load_wine()
    return (
        data.data.astype(np.float64),
        data.target.astype(np.int64),
        {"synthetic": False, "source": "sklearn.load_wine (UCI)"},
    )


def load_uci_binary() -> Arrays:
    """Real binary-classification UCI-style table (breast cancer, sklearn)."""
    from sklearn.datasets import load_breast_cancer

    data = load_breast_cancer()
    return (
        data.data.astype(np.float64),
        data.target.astype(np.int64),
        {"synthetic": False, "source": "sklearn.load_breast_cancer (UCI)"},
    )
