"""The port's boosting control path against the JAX package's, and the
port's two new examples.

The boosting species is host-side in both packages (sklearn's
``HistGradientBoosting``, or ``xgb.cv`` where xgboost is installed), so on
the same data, genes and seed the port's fitness is the reference's bit
for bit.  The port must import without sklearn, which it loads lazily.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import gentun_tpu as ref
import gentun_tpu_torch as port
from gentun_tpu.models import boosting as ref_boosting
from gentun_tpu.models import xgboost as ref_xgboost
from gentun_tpu_torch.models import boosting as port_boosting
from gentun_tpu_torch.models import default_boosting_model
from gentun_tpu_torch.models import xgboost as port_xgboost

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """One OpenMP thread for sklearn's ``HistGradientBoosting`` in this
    module.  It starts a thread per core, and beside other test workers
    doing the same the threads spin against each other (a case that takes
    seconds alone took minutes in a 6-worker run).  Both packages' fits
    run under the same limit, so every comparison here still holds."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1):
        yield


@pytest.fixture(scope="module")
def tabular():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(120, 5))
    logits = x[:, 0] * 2.0 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = (logits + 0.3 * rng.normal(size=120) > 0).astype(np.int64)
    return x, y


def _genomes(pkg_genes_fn, n, seed):
    rng = np.random.default_rng(seed)
    spec = pkg_genes_fn()
    return [spec.sample(rng) for _ in range(n)]


@pytest.mark.parametrize("genome", ["boosting", "xgboost"])
@pytest.mark.parametrize("task, metric", [("classification", "accuracy"),
                                          ("classification", "auc"),
                                          ("regression", "rmse")])
def test_boosting_cv_equals_reference(tabular, genome, task, metric):
    """sklearn fallback: the same CV value for sampled sklearn-named and
    xgboost-named genomes (the latter translated)."""
    x, y = tabular
    if task == "regression":
        y = x[:, 0] * 1.5 + x[:, 1]
    genomes = _genomes(getattr(port, f"{genome}_genome"), 2, seed=len(metric))
    assert genomes == _genomes(getattr(ref, f"{genome}_genome"), 2, seed=len(metric))
    cfg = dict(kfold=2, task=task, metric=metric, seed=5)
    for genes in genomes:
        want = ref_boosting.BoostingModel(x, y, genes, **cfg).cross_validate()
        got = port_boosting.BoostingModel(x, y, genes, **cfg).cross_validate()
        assert np.isfinite(got) and got == want


def test_xgboost_species_falls_back_to_the_same_fitness(tabular, monkeypatch):
    """Without xgboost the ``XgboostIndividual`` trains the sklearn
    translation of the reference's 11-gene genome, in both packages, to
    the same value; the gene translation for ``xgb.cv`` agrees too."""
    monkeypatch.setitem(sys.modules, "xgboost", None)  # importing it fails
    port_xgboost.xgboost_available.cache_clear()
    ref_xgboost.xgboost_available.cache_clear()
    try:
        assert default_boosting_model() is port_boosting.BoostingModel
        x, y = tabular
        fits = []
        for pkg in (ref, port):
            pop = pkg.Population(pkg.XgboostIndividual, x_train=x, y_train=y, size=3, seed=2,
                                 additional_parameters={"kfold": 2, "seed": 1})
            fits.append([(ind.get_genes(), ind.get_fitness()) for ind in pop])
        assert fits[1] == fits[0] and all(np.isfinite(f) for _, f in fits[1])
        for genes in _genomes(port.xgboost_genome, 3, seed=9):
            assert port_xgboost.genes_to_xgb_params(genes) == ref_xgboost.genes_to_xgb_params(genes)
    finally:
        port_xgboost.xgboost_available.cache_clear()
        ref_xgboost.xgboost_available.cache_clear()


def test_boosting_ga_history_equals_reference(tabular):
    x, y = tabular
    runs = []
    for pkg in (ref, port):
        pop = pkg.Population(pkg.BoostingIndividual, x_train=x, y_train=y, size=4, seed=0,
                             additional_parameters={"kfold": 2, "seed": 0})
        best = pkg.GeneticAlgorithm(pop, seed=0).run(1)
        runs.append((best.get_genes(), best.get_fitness(),
                     [(i.get_genes(), i.get_fitness()) for i in pop]))
    assert runs[1] == runs[0]


def test_xgboost_adapter_call_equals_reference(monkeypatch):
    """With an ``xgboost`` module present the adapter makes the same
    ``xgb.cv`` call as the reference's (a recording stand-in module)."""
    calls = []

    fake = types.ModuleType("xgboost")

    class DMatrix:
        def __init__(self, data, label=None):
            self.data, self.label = np.asarray(data), np.asarray(label)

    def cv(params, dtrain, **kw):
        calls.append((params, dtrain.data.tolist(), dtrain.label.tolist(), kw))
        return {f"test-{kw['metrics'][0]}-mean": [0.5, 0.3, 0.25]}

    fake.DMatrix, fake.cv = DMatrix, cv
    monkeypatch.setitem(sys.modules, "xgboost", fake)
    x = np.random.default_rng(0).normal(size=(30, 4))
    y = np.array([7, 8, 9] * 10)
    genes = port.xgboost_genome().default()
    got = port_xgboost.XgboostModel(x, y, genes, kfold=3, seed=4).cross_validate()
    want = ref_xgboost.XgboostModel(x, y, genes, kfold=3, seed=4).cross_validate()
    assert got == want == pytest.approx(0.75)
    assert calls[1] == calls[0]


BLOCK_SKLEARN = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError("sklearn is blocked")
        return None

sys.meta_path.insert(0, _Block())
import numpy as np
import gentun_tpu_torch as port
from gentun_tpu_torch import BoostingIndividual, XgboostIndividual, AsyncEvolution
pop = port.Population(BoostingIndividual, x_train=np.zeros((4, 2)), y_train=np.zeros(4),
                      size=3, seed=0)
try:
    pop[0].get_fitness()
except ImportError as exc:
    print("FITNESS NEEDS SKLEARN:", exc)
import torch
print("CUDA INITIALIZED", torch.cuda.is_initialized())
print("SKLEARN", sorted(m for m in sys.modules if m.split(".")[0] == "sklearn"))
print("BAD", sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "gentun_tpu")))
"""


def test_port_imports_without_sklearn():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", BLOCK_SKLEARN], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FITNESS NEEDS SKLEARN: sklearn is blocked" in out.stdout, out.stdout
    assert "CUDA INITIALIZED False" in out.stdout
    assert "SKLEARN []" in out.stdout and "BAD []" in out.stdout


def _example(name):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(REPO / "examples"))


def test_boosting_example_runs_tiny():
    result = _example("torch_uci_boosting_ga").main(
        ["--generations", "1", "--population", "4", "--kfold", "2"])
    assert 0.0 <= result["best_fitness"] <= 1.0


def test_mnist_example_runs_tiny_on_the_cpu(tmp_path):
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = ["--device", "cpu", "--generations", "1", "--population", "3", "--kfold", "2",
                "--epochs", "1", "--n-images", "48", "--kernels", "2", "2",
                "--batch-size", "8", "--dense-units", "8",
                "--checkpoint", str(tmp_path / "ckpt.json")]
        result = _example("torch_mnist_genetic_cnn").main(args)
        assert result["generation"] == 1 and np.isfinite(result["best_fitness"])
        again = _example("torch_mnist_genetic_cnn").main(args)  # resumes, runs one more
        assert again["generation"] == 2 and np.isfinite(again["best_fitness"])
    finally:
        torch.set_num_threads(threads)
