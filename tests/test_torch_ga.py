"""The port's GA engine against the JAX package's, and the port's import guard.

With a deterministic stub fitness (OneMax, as in ``tests/test_algorithms.py``)
both packages' GA runs make the same draws from the same seeds, so their
histories must be bit-identical apart from the wall-clock fields.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gentun_tpu import algorithms as ref_alg
from gentun_tpu import genes as ref_genes
from gentun_tpu import individuals as ref_ind
from gentun_tpu import populations as ref_pop

from gentun_tpu_torch import algorithms as port_alg
from gentun_tpu_torch import genes as port_genes
from gentun_tpu_torch import individuals as port_ind
from gentun_tpu_torch import populations as port_pop
from gentun_tpu_torch.utils import fitness_store as port_store

REPO = Path(__file__).resolve().parent.parent
#: History fields measured on the wall clock, which two runs never share.
TIMED = {"eval_wall_s", "individuals_per_hour_per_chip"}


def _onemax(pkg_ind, pkg_genes):
    class OneMax(pkg_ind.Individual):
        def build_spec(self, **params):
            return pkg_genes.genetic_cnn_genome(tuple(params.get("nodes", (5,))))

        def evaluate(self):
            return float(sum(sum(g) for g in self.genes.values()))

    return OneMax


def _history(pkg_alg, pkg_pop, species, ga_cls, seed, generations):
    pop = pkg_pop.Population(
        species, x_train=np.zeros(1), y_train=np.zeros(1), size=12, seed=seed,
        additional_parameters={"nodes": (3, 5)}, mutation_rate=0.05,
    )
    ga = getattr(pkg_alg, ga_cls)(pop, tournament_size=3, seed=seed)
    best = ga.run(generations)
    hist = [{k: v for k, v in rec.items() if k not in TIMED} for rec in ga.history]
    return hist, best.get_genes(), best.get_fitness(), [i.get_genes() for i in ga.population]


@pytest.mark.parametrize("ga_cls", ["GeneticAlgorithm", "RussianRouletteGA"])
@pytest.mark.parametrize("seed", [0, 5])
def test_onemax_history_bit_identical(ga_cls, seed, monkeypatch):
    # Each package records ``n_chips`` from its own "the fitness path used
    # the accelerator" marker; an earlier test in this process may have set
    # the reference's (which then counts the virtual jax CPU devices).  The
    # stub fitness uses no device, so both markers are held unset.
    from gentun_tpu.utils import jax_state as ref_state
    from gentun_tpu_torch.utils import device_state as port_state

    monkeypatch.setattr(ref_state, "_backend_used", False)
    monkeypatch.setattr(port_state, "_backend_used", False)
    want = _history(ref_alg, ref_pop, _onemax(ref_ind, ref_genes), ga_cls, seed, 6)
    got = _history(port_alg, port_pop, _onemax(port_ind, port_genes), ga_cls, seed, 6)
    assert got == want


def test_state_dict_stamps_the_ports_own_protocol():
    from gentun_tpu.utils.fitness_store import FITNESS_PROTOCOL as ref_protocol

    pop = port_pop.Population(_onemax(port_ind, port_genes), x_train=np.zeros(1),
                              y_train=np.zeros(1), size=4, seed=0)
    ga = port_alg.GeneticAlgorithm(pop, seed=0)
    ga.run(1)
    state = ga.state_dict()
    assert state["fitness_protocol"] == port_store.FITNESS_PROTOCOL != ref_protocol


def test_fitness_store_refuses_reference_protocol(tmp_path):
    """A store the reference wrote is dropped by the port, not mixed in."""
    from gentun_tpu.utils import fitness_store as ref_store

    path = tmp_path / "store.json"
    ref_store.save_fitness_cache({("k",): 0.5}, str(path))
    assert port_store.load_fitness_cache(str(path)) == {}
    port_store.save_fitness_cache({("k",): 0.75}, str(path))
    assert ref_store.load_fitness_cache(str(path)) == {}


def test_chip_count_does_not_touch_cuda_before_the_fitness_path(monkeypatch):
    from gentun_tpu_torch.utils import device_state

    monkeypatch.setattr(device_state, "_backend_used", False)
    assert port_alg._initialized_chip_count() == 1
    monkeypatch.setattr(device_state, "_backend_used", True)
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert port_alg._initialized_chip_count() == 4


def test_population_evaluate_runs_the_ports_batched_trainer():
    """Population.evaluate → the port's cross_validate_population, on the CPU."""
    from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual, Population

    rng = np.random.default_rng(0)
    protos = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 3, size=96).astype(np.int32)
    x = protos[y] + 0.3 * rng.normal(size=(96, 8, 8, 1)).astype(np.float32)
    params = dict(nodes=(3,), kernels_per_layer=(4,), kfold=2, epochs=(1,),
                  learning_rate=(0.05,), batch_size=16, dense_units=8,
                  compute_dtype="float32", mesh="cpu")
    pop = Population(GeneticCnnIndividual, x_train=x, y_train=y, size=4, seed=0,
                     additional_parameters=params)
    assert pop._batch_fn(list(pop)).__self__.__module__ == "gentun_tpu_torch.models.cnn"
    GeneticAlgorithm(pop, seed=0).run(2)
    fits = [ind.get_fitness() for ind in pop]
    assert all(np.isfinite(fits)) and all(0.0 <= f <= 1.0 for f in fits)


GUARD = """
import sys
import numpy as np
import gentun_tpu_torch
from gentun_tpu_torch import GeneticAlgorithm, Individual, Population, genetic_cnn_genome
from gentun_tpu_torch.models import cnn  # noqa: F401

class OneMax(Individual):
    def build_spec(self, **p):
        return genetic_cnn_genome((3, 4))
    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))

pop = Population(OneMax, x_train=np.zeros(1), y_train=np.zeros(1), size=6, seed=0)
GeneticAlgorithm(pop, seed=0).run(1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gentun_tpu"))
print("BAD", bad)
"""


def test_import_guard_subprocess():
    """Importing the port and running a GA step loads no jax and no reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", GUARD], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_static_import_guard():
    """No file of the port, and not chip_smoke.py, bench_torch.py,
    torch_entry.py, the port's examples or its scripts, names jax or the
    reference."""
    files = sorted((REPO / "gentun_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "bench_torch.py", REPO / "torch_entry.py",
        *sorted((REPO / "examples").glob("torch_*.py")),
        *sorted((REPO / "scripts").glob("torch_*.py"))]
    assert len(files) > 45 and (REPO / "examples" / "torch_cifar100_deep.py") in files
    assert REPO / "examples" / "torch_cifar10_genetic_cnn.py" in files
    assert len(list((REPO / "scripts").glob("torch_*.py"))) == 11
    distributed = {p.name for p in (REPO / "gentun_tpu_torch" / "distributed").glob("*.py")}
    assert distributed == {p.name for p in (REPO / "gentun_tpu" / "distributed").glob("*.py")}
    assert REPO / "gentun_tpu_torch" / "telemetry" / "canary.py" in files
    assert REPO / "examples" / "torch_distributed_search.py" in files
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", re.M)
    reference = re.compile(r"gentun_tpu(?!_torch)")
    for path in files:
        text = path.read_text()
        assert not jax_import.search(text), path
        assert not reference.search(text), path


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    CUDA device, both from the repo and copied alone into an empty directory."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             env=env, cwd=str(cwd), timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


class _IsoModel:
    """A batched trainer whose fitness reads the raw bits: the ones count
    plus a small term from the bits' order, so isomorphic genomes (same
    count) measure differently."""

    trained = 0

    @classmethod
    def cross_validate_population(cls, x, y, genomes, **params):
        cls.trained += len(genomes)
        out = []
        for g in genomes:
            bits = [int(b) for k in sorted(g) for b in g[k]]
            out.append(sum(bits) + sum(b << i for i, b in enumerate(bits)) / 2.0 ** (len(bits) + 1))
        return np.asarray(out, np.float32)


class _Iso(port_ind.Individual):
    """Cache key: each stage's ones count, collapsing genomes the way a
    canonical DAG key collapses relabelings; fitness: ``_IsoModel``'s raw
    number."""

    model_cls = _IsoModel

    def build_spec(self, **p):
        return port_genes.genetic_cnn_genome((4, 4))

    def cache_key(self):
        return ("Iso", tuple(sum(int(b) for b in self.genes[k]) for k in sorted(self.genes)))

    def evaluate(self):
        return float(_IsoModel.cross_validate_population(None, None, [self.genes])[0])


@pytest.mark.parametrize("fill", [True, 8])
def test_speculation_leaves_the_search_unchanged(fill):
    """Speculative fill trains elite mutants into the cache; an entry it
    made answers only the raw genome it trained, so a search with it follows
    the same trajectory as one without (an isomorphic relabeling would get
    another genome's fitness)."""

    def run(speculative_fill):
        _IsoModel.trained = 0
        pop = port_pop.Population(_Iso, x_train=np.zeros(1), y_train=np.zeros(1), size=6, seed=0,
                                  mutation_rate=0.05, speculative_fill=speculative_fill)
        ga = port_alg.GeneticAlgorithm(pop, seed=0)
        ga.run(12)
        return [(h["generation"], h["best_fitness"], h["best_genes"]) for h in ga.history]

    off = run(False)
    trained_off = _IsoModel.trained
    on = run(fill)
    assert _IsoModel.trained > trained_off  # speculation trained mutants
    assert on == off
