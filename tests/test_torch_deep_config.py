"""BASELINE config #5's structure on the port, on the CPU: the deep Genetic
CNN (S=(5,5,5), 100 classes) at small widths against the benchmark's plain
float32 reference, and the benchmark's configuration file for it."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import data, genomes
from benchmark.reference.gcnn import Reference
from gentun_tpu_torch.models.cnn import GeneticCnnModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Config #5's stages and classes at small widths and 8×8 images, float32
#: compute, so that the system and the reference compute the same numbers.
DEEP = dict(nodes=[5, 5, 5], kernels_per_layer=[4, 8, 16], input_shape=[8, 8, 3],
            dense_units=16, n_classes=100, n_train_images=256, image_noise=0.5, kfold=2,
            epochs=[1], learning_rate=[0.05], batch_size=16, momentum=0.9, nesterov=False,
            dropout_rate=0.5, compute_dtype="float32")

#: The keys of ``benchmark/configs/gcnn-cifar100-s555.json`` and their
#: values as config #5 states them; a key the file gives another value is
#: named in its ``reduced`` or ``assumed``.
PUBLISHED = {"nodes": [5, 5, 5], "kernels_per_layer": [64, 128, 256], "dense_units": 512,
             "n_classes": 100, "input_shape": [32, 32, 3]}
STATED = {**PUBLISHED, "compute_dtype": "bfloat16", "momentum": 0.9, "dropout_rate": 0.5,
          "n_train_images": 10000, "image_noise": 0.5, "kfold": 2, "epochs": [1]}


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("seed", [7, 2**33 + 3])
def test_the_deep_network_is_the_reference_in_float32(seed):
    x, y = data.images(DEEP, seed)
    gs = genomes.sample_genomes(DEEP["nodes"], 4, seed, 1)
    kw = {**data.call_kwargs(DEEP, seed, os.path.join(ROOT, "build", "kernels")), "mesh": "cpu"}
    fit = GeneticCnnModel.cross_validate_population(x, y, gs, **kw)
    ref = Reference(x, y, DEEP, kw["seed"], "cpu")
    assert np.array_equal(np.asarray(fit, np.float32),
                          np.asarray([ref.fitness(g) for g in gs], np.float32))


def test_the_benchmark_configuration_keeps_config_5s_widths():
    with open(os.path.join(ROOT, "benchmark", "configs", "gcnn-cifar100-s555.json")) as fh:
        cfg = json.load(fh)
    for key, value in PUBLISHED.items():
        assert cfg[key] == value, key
    named = set(cfg["reduced"]) | set(cfg["assumed"])
    for key, value in STATED.items():
        assert cfg[key] == value or key in named, key
    for key in ("batch_size", "learning_rate"):
        assert key in named, key
    assert not set(PUBLISHED) & set(cfg["reduced"])  # no width and no depth is cut
