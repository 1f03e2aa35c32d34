"""The port's utils, bench and entry points, held against the JAX package where it has them.

Datasets, stats and checkpoints are copies: for the same inputs they give
the reference's outputs (checkpoints excepted where the fitness namespace
differs by design).  The bench, the entry points and the config #5 example
run here on the CPU at tiny shapes, as a caller asks for it (``mesh="cpu"``,
``device="cpu"``, ``--device cpu``); without a CUDA device the bench refuses.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gentun_tpu import algorithms as ref_alg
from gentun_tpu import genes as ref_genes
from gentun_tpu import individuals as ref_ind
from gentun_tpu import populations as ref_pop
from gentun_tpu.utils import checkpoint as ref_ckpt
from gentun_tpu.utils import datasets as ref_data
from gentun_tpu.utils import stats as ref_stats

from gentun_tpu_torch import algorithms as port_alg
from gentun_tpu_torch import genes as port_genes
from gentun_tpu_torch import individuals as port_ind
from gentun_tpu_torch import populations as port_pop
from gentun_tpu_torch.ops import _build
from gentun_tpu_torch.utils import checkpoint as port_ckpt
from gentun_tpu_torch.utils import datasets as port_data
from gentun_tpu_torch.utils import kernel_cache, profiling
from gentun_tpu_torch.utils import stats as port_stats
from gentun_tpu_torch.utils.fitness_store import FITNESS_PROTOCOL

REPO = Path(__file__).resolve().parent.parent
TIMED = {"eval_wall_s", "individuals_per_hour_per_chip"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work (see
    ``tests/test_torch_cnn.py``), restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def _no_device_marker(monkeypatch):
    """Both packages' "the fitness path used the accelerator" markers unset,
    so a stub GA's ``n_chips`` does not depend on earlier tests."""
    from gentun_tpu.utils import jax_state
    from gentun_tpu_torch.utils import device_state

    monkeypatch.setattr(jax_state, "_backend_used", False)
    monkeypatch.setattr(device_state, "_backend_used", False)


def _assert_same_arrays(got, want):
    assert len(got) == len(want) == 3
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


class TestDatasets:
    @pytest.mark.parametrize("call", [
        ("load_cifar100", dict(n=64)),
        ("load_cifar100", dict(n=48, seed=3)),
        ("load_cifar10", dict(n=40)),
        ("load_mnist", dict(n=50)),
        ("load_mnist", dict()),
        ("load_uci_wine", dict()),
        ("load_uci_binary", dict()),
    ], ids=lambda c: f"{c[0]}({','.join(f'{k}={v}' for k, v in c[1].items())})")
    def test_loaders_equal_reference(self, call, monkeypatch):
        monkeypatch.delenv("GENTUN_TPU_DATA", raising=False)
        name, kwargs = call
        _assert_same_arrays(getattr(port_data, name)(**kwargs), getattr(ref_data, name)(**kwargs))

    @pytest.mark.parametrize("sample_seed", [None, 9])
    def test_synthetic_images_equal_reference(self, sample_seed):
        args = (32, (8, 8, 3), 5)
        _assert_same_arrays(port_data.synthetic_images(*args, seed=4, sample_seed=sample_seed),
                            ref_data.synthetic_images(*args, seed=4, sample_seed=sample_seed))
        with pytest.raises(ValueError):
            port_data.synthetic_images(*args, seed=4, sample_seed=4)

    def test_npz_on_disk_comes_first(self, tmp_path, monkeypatch):
        rng = np.random.default_rng(1)
        np.savez(tmp_path / "cifar100.npz",
                 x=rng.integers(0, 255, size=(24, 32, 32, 3)).astype(np.uint8),
                 y=rng.integers(0, 100, size=24))
        monkeypatch.setenv("GENTUN_TPU_DATA", str(tmp_path))
        got = port_data.load_cifar100(n=8)
        assert not got[2]["synthetic"] and got[0].max() <= 1.0
        _assert_same_arrays(got, ref_data.load_cifar100(n=8))


def _onemax(pkg_ind, pkg_genes):
    class OneMax(pkg_ind.Individual):
        def build_spec(self, **p):
            return pkg_genes.genetic_cnn_genome((4, 4))

        def evaluate(self):
            return float(sum(sum(g) for g in self.genes.values()))

    return OneMax


def _ga(pkg_alg, pkg_pop, species, pop_seed, ga_seed):
    pop = pkg_pop.Population(species, x_train=np.zeros(1), y_train=np.zeros(1), size=6,
                             seed=pop_seed)
    return pkg_alg.GeneticAlgorithm(pop, seed=ga_seed)


def _state(ga):
    """History (wall-clock fields dropped) and population, as JSON: a
    resumed history's genes come back from the file as lists."""
    hist = [{k: v for k, v in rec.items() if k not in TIMED} for rec in ga.history]
    return json.dumps([hist, [(ind.get_genes(), ind.get_fitness()) for ind in ga.population]])


@pytest.mark.usefixtures("_no_device_marker")
class TestCheckpoint:
    def test_kill_and_resume_gives_the_same_history(self, tmp_path):
        """A search killed after 2 generations and run again with the same
        checkpointer ends where the uninterrupted one does, bit for bit."""
        species = _onemax(port_ind, port_genes)
        full = _ga(port_alg, port_pop, species, 42, 7)
        full.run(5)
        path = str(tmp_path / "search.json")
        first = _ga(port_alg, port_pop, species, 42, 7)
        first.run(2, checkpointer=port_ckpt.Checkpointer(path))
        del first  # the kill
        again = _ga(port_alg, port_pop, species, 0, 0)  # seeds come from the checkpoint
        again.run(5, checkpointer=port_ckpt.Checkpointer(path))
        assert again.generation == 5
        assert _state(again) == _state(full)
        with open(path) as f:
            state = json.load(f)
        assert state["fitness_protocol"] == FITNESS_PROTOCOL
        assert state["schema_version"] == port_ckpt.CHECKPOINT_SCHEMA == ref_ckpt.CHECKPOINT_SCHEMA

    def test_reference_checkpoint_resumes_without_its_fitness(self, tmp_path):
        """Genes, generation and RNG state of a checkpoint the JAX package
        wrote resume; its fitness values and cache do not enter the port's."""
        path = str(tmp_path / "search.json")
        ref_ga = _ga(ref_alg, ref_pop, _onemax(ref_ind, ref_genes), 3, 5)
        ref_ga.run(2, checkpointer=ref_ckpt.Checkpointer(path))
        ga = _ga(port_alg, port_pop, _onemax(port_ind, port_genes), 0, 0)
        assert port_ckpt.Checkpointer(path).resume(ga)
        assert ga.generation == 2
        assert [i.get_genes() for i in ga.population] == [i.get_genes() for i in ref_ga.population]
        assert not any(ind.fitness_evaluated for ind in ga.population)
        assert dict(ga.population.fitness_cache) == {}
        assert ga.rng.bit_generator.state == ref_ckpt.load_checkpoint(path)["rng_state"]

    def test_namespaced_path_and_missing_file(self, tmp_path):
        path = str(tmp_path / "search.json")
        assert port_ckpt.namespaced_path(path, "tenant a") == ref_ckpt.namespaced_path(
            path, "tenant a")
        assert port_ckpt.load_checkpoint(path) is None


def test_stats_equal_reference():
    deltas = np.random.default_rng(3).normal(0.01, 0.05, size=25)
    deltas[:3] = 0.0
    assert port_stats.sign_test_p(deltas) == ref_stats.sign_test_p(deltas)
    assert port_stats.bootstrap_ci(deltas, n_boot=500) == ref_stats.bootstrap_ci(deltas, n_boot=500)
    row = port_stats.paired_row(deltas)
    assert row == ref_stats.paired_row(deltas)
    assert port_stats.fmt_paired(row) == ref_stats.fmt_paired(row)


class TestProfiling:
    def test_trace_writes_a_chrome_trace_on_the_cpu(self, tmp_path):
        with profiling.trace(str(tmp_path / "tb")):
            torch.ones(64, 64) @ torch.ones(64, 64)
        files = list((tmp_path / "tb").glob("trace-*.json"))
        assert len(files) == 1
        events = json.loads(files[0].read_text())["traceEvents"]
        assert any("mm" in str(e.get("name", "")) for e in events)
        with profiling.trace(str(tmp_path / "off"), enabled=False):
            pass
        assert not (tmp_path / "off").exists()

    def test_eval_timer_summary(self):
        timer = profiling.EvalTimer(n_chips=2)
        with timer.measure(10, label="a"):
            pass
        with timer.measure(6):
            pass
        s = timer.summary()
        assert timer.total_individuals == s["individuals"] == 16
        assert [r["label"] for r in timer.records] == ["a", ""]


class TestKernelCache:
    def test_points_the_build_lists_and_counts(self, tmp_path):
        before = _build.build_dir()
        try:
            d = tmp_path / "k"
            assert kernel_cache.enable_compilation_cache(str(d)) == str(d)
            assert _build.library_path().parent == d
            (d / "libgentun_kernels_0123.so").write_bytes(b"x" * 10)
            (d / "libgentun_kernels_0123.77.tmp.so").write_bytes(b"y")
            (d / ".hidden").write_bytes(b"z")
            assert list(kernel_cache.list_cache_entries()) == ["libgentun_kernels_0123.so"]
            assert kernel_cache.cache_stats() == {"dir": str(d), "enabled": True, "entries": 1,
                                                  "bytes": 10}
            assert kernel_cache.list_cache_entries(str(tmp_path / "absent")) == {}
            with pytest.raises(TypeError):
                kernel_cache.enable_compilation_cache(False)
            (tmp_path / "file").write_bytes(b"")
            assert kernel_cache.enable_compilation_cache(str(tmp_path / "file" / "sub")) is None
            assert _build.build_dir() == d  # the unusable dir left the build where it was
        finally:
            _build.use_build_dir(before)

    def test_default_is_the_checkouts_build_dir(self, monkeypatch):
        monkeypatch.delenv("GENTUN_TORCH_CACHE_DIR", raising=False)
        assert Path(kernel_cache.default_cache_dir()) == REPO / "build" / "kernels"
        monkeypatch.setenv("GENTUN_TORCH_CACHE_DIR", "/elsewhere")
        assert kernel_cache.default_cache_dir() == "/elsewhere"

    def test_publish_hooks_run_and_fail_soft(self):
        seen = []

        def bad():
            raise RuntimeError("hook fault")

        for hook in (seen.append, bad):
            kernel_cache.register_publish_hook(hook if hook is bad else (lambda: seen.append(1)))
        try:
            kernel_cache.run_publish_hooks()
            assert seen == [1]
        finally:
            kernel_cache._publish_hooks.clear()


def _load_script(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class TestBenchEntryExample:
    def test_bench_measures_a_tiny_config_on_the_cpu(self):
        bench = _load_script(REPO / "bench_torch.py")
        rng = np.random.default_rng(0)
        protos = rng.normal(size=(4, 8, 8, 1)).astype(np.float32)
        y = rng.integers(0, 4, size=96).astype(np.int32)
        x = protos[y] + 0.3 * rng.normal(size=(96, 8, 8, 1)).astype(np.float32)
        cfg = dict(nodes=(3,), kernels_per_layer=(4,), kfold=2, epochs=(1,),
                   learning_rate=(0.05,), batch_size=16, dense_units=8, compute_dtype="float32",
                   seed=0)
        out = bench.measure(x, y, cfg, pop=3, mesh="cpu", reps=2)
        assert out["accs"].shape == (3,) and np.isfinite(out["accs"]).all()
        assert len(out["all_seconds"]) == 2 and out["warmup_seconds"] > 0
        # the FLOP count at config #2's shape, as bench.py counts it
        assert bench.forward_flops_per_image(bench.PROXY) == pytest.approx(248.1e6, rel=1e-3)

    def test_bench_refuses_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], capture_output=True,
                             text=True, env=env, cwd=str(REPO), timeout=120)
        assert out.returncode != 0
        assert "{" not in out.stdout

    def test_entry_forward_on_the_cpu(self):
        import torch_entry

        forward, args = torch_entry.entry(device="cpu")
        logits = forward(*args)
        assert logits.dtype == torch.float32 and tuple(logits.shape) == (1, 8, 10)
        assert torch.isfinite(logits).all()

    def test_dryrun_multichip_refuses_many_cards_and_a_missing_card(self, monkeypatch):
        import torch_entry

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_entry.dryrun_multichip(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_entry.dryrun_multichip(1)
        with pytest.raises(RuntimeError, match="CUDA"):
            torch_entry.entry()

    @pytest.mark.usefixtures("_no_device_marker")
    def test_config5_example_runs_tiny_on_the_cpu_and_resumes(self, tmp_path):
        example = _load_script(REPO / "examples" / "torch_cifar100_deep.py")
        argv = ["--generations", "1", "--population", "2", "--n-images", "64",
                "--kernels", "2", "2", "2", "--batch-size", "16", "--dense-units", "4",
                "--device", "cpu", "--checkpoint", str(tmp_path / "deep.json")]
        first = example.main(argv)
        assert first["generation"] == 1 and np.isfinite(first["best_fitness"])
        resumed = example.main(argv)
        assert resumed["generation"] == 1
        assert (resumed["best_genes"], resumed["best_fitness"]) == (
            first["best_genes"], first["best_fitness"])
