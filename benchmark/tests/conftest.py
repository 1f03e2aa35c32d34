"""Tests of the benchmark: CPU tests at tiny sizes, and tests marked ``card``
that need a CUDA card (``pytest benchmark/tests -m card`` on the machine that
has one; elsewhere they skip, deciding inside the ``card`` fixture)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: A configuration small enough for the CPU: float32 compute, so the system
#: and the plain reference compute the same numbers.
TINY = dict(nodes=[3, 4], kernels_per_layer=[4, 8], input_shape=[8, 8, 3], dense_units=16,
            n_classes=4, n_train_images=256, image_noise=0.5, kfold=2, epochs=[2],
            learning_rate=[0.05], batch_size=16, momentum=0.9, nesterov=False,
            dropout_rate=0.5, compute_dtype="float32")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _manifest(tmp_path, limits, pop: int, judged: int):
    """A manifest with one tiny cell, under ``tmp_path``, whose parts are the
    benchmark's own drivers and metrics and one traffic mix of its own."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    base = tmp_path / "parts"
    for kind in ("drivers", "metrics"):
        shutil.copytree(os.path.join(ROOT, "benchmark", kind), base / kind)
    (base / "traffic").mkdir(parents=True)
    (base / "traffic" / "tiny-mix.json").write_text(json.dumps(
        {"driver": "generation", "pop": pop, "judged": judged, "why": "tiny"}))
    (tmp_path / "tiny.json").write_text(json.dumps({**TINY, "limits": limits}))
    manifest["configs"] = [{"name": "tiny", "source": "test", "file": "tiny.json",
                            "reduced": [], "why": "test"}]
    manifest["workloads"] = [{"name": "tiny-cell", "config": "tiny", "traffic": "tiny-mix",
                              "chips": 1, "why": "test"}]
    for m in manifest["per_layer"]:
        m["workloads"] = ["tiny-cell"]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    return str(path), str(base)


@pytest.fixture
def tiny_manifest(tmp_path):
    """``make(limits, pop, judged)`` → (manifest path, parts directory)."""
    return lambda limits, pop=6, judged=12: _manifest(tmp_path, limits, pop, judged)
