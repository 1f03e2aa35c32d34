"""The inputs of a run, made from ``--seed``: images, labels, and the call's
keyword arguments for the system.

The images are class prototypes plus noise (the synthetic task the
repository's CIFAR-shaped benchmarks train on, since no CIFAR archive is on
disk): 10 or 100 prototypes drawn from a normal, and each image its class's
prototype plus ``image_noise`` times a normal.  The same seed gives the
same bytes.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from .genomes import _MASK64, rng_for


def model_seed(seed: int) -> int:
    """The seed the system's CV call takes (fold permutation, batch order,
    initial weights, dropout): ``--seed`` as a non-negative 63-bit number."""
    return (int(seed) & _MASK64) >> 1


def images(config: Dict[str, Any], seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(x, y)``: ``n_train_images`` float32 NHWC images and int32 labels."""
    shape = tuple(config["input_shape"])
    n, n_classes = int(config["n_train_images"]), int(config["n_classes"])
    rng = rng_for(seed, 0xDA7A)
    protos = rng.standard_normal(size=(n_classes, *shape), dtype=np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    noise = rng.standard_normal(size=(n, *shape), dtype=np.float32)
    noise *= np.float32(config["image_noise"])
    noise += protos[y]
    return noise, y


#: The config keys the system's CV call takes as they stand in the file.
MODEL_KEYS = ("nodes", "kernels_per_layer", "dense_units", "n_classes", "input_shape", "kfold",
              "epochs", "learning_rate", "batch_size", "momentum", "nesterov", "dropout_rate",
              "compute_dtype")


def call_kwargs(config: Dict[str, Any], seed: int, cache_dir: str) -> Dict[str, Any]:
    """Keyword arguments of ``GeneticCnnModel.cross_validate_population``."""
    kw = {k: config[k] for k in MODEL_KEYS}
    for k in ("nodes", "kernels_per_layer", "input_shape", "epochs", "learning_rate"):
        kw[k] = tuple(kw[k])
    return {**kw, "seed": model_seed(seed), "cache_dir": cache_dir}
