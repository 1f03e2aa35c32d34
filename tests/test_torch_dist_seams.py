"""The seams the port's distributed plane rewrote, held on the CPU.

The rest of the plane is a copy and runs the JAX package's own tests
(``tests/test_torch_dist_*.py``).  These cases hold what differs: the
compile service's fingerprint and its flush, the kernel cache a fetched
library lands in, the device probes of ``GentunClient``, the worker CLI's
refusals, the worker module as a process, and the device rule (a worker
without a card fails its jobs, it never answers from the CPU).
"""

import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gentun_tpu_torch import GeneticCnnIndividual, Individual, genetic_cnn_genome
from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient, JobFailed
from gentun_tpu_torch.distributed import compile_service as cs
from gentun_tpu_torch.distributed import worker as worker_cli
from gentun_tpu_torch.ops import _build
from gentun_tpu_torch.utils import kernel_cache

REPO = Path(__file__).resolve().parents[1]
TINY_CNN = dict(nodes=(2,), kernels_per_layer=(2,), kfold=2, epochs=(1,),
                learning_rate=(0.05,), batch_size=16, dense_units=8,
                compute_dtype="float32", seed=0)


class OneMax(Individual):
    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work, restored after: with
    several test workers on the same cores, torch's thread-pool barriers wait
    on descheduled threads (see ``tests/test_torch_cnn.py``)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_concurrent_publish_lands_before_flush_returns(tmp_path):
    """Six clients publish one blob at once; each ``flush()`` returns only
    after its POST landed, so the service counts six puts every time."""
    svc = cs.CompileService(port=0, max_bytes=1 << 20).start()
    try:
        for rep in range(20):
            clients = []
            for i in range(6):
                d = tmp_path / f"r{rep}w{i}"
                d.mkdir()
                (d / f"entry_shared_{rep}").write_bytes(b"q" * 256)
                clients.append(cs.CompileServiceClient(svc.url, cache_dir=str(d),
                                                       fingerprint="aa" * 8))
            threads = [threading.Thread(target=c.scan_publish) for c in clients]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
            assert all(c.flush(5.0) for c in clients)
            assert sum(c.stats()["published"] for c in clients) == 6
            assert svc.stats()["puts"] == 6 * (rep + 1), rep
            for c in clients:
                c.close()
    finally:
        svc.stop()


def test_platform_components_name_the_port_facts():
    comps = cs.platform_components(probe_devices=False)
    assert set(comps) == {"torch", "cuda", "sm", "driver", "nvcc_flags", "kernel_sources"}
    assert comps["torch"] == torch.__version__
    assert comps["sm"] == comps["driver"] == "unprobed"
    assert comps["nvcc_flags"] == " ".join(_build.NVCC_FLAGS)
    assert _build.library_path().name == f"libgentun_kernels_{comps['kernel_sources']}.so"
    assert not torch.cuda.is_initialized()  # unprobed never initializes CUDA


def test_fingerprint_follows_the_kernel_sources(tmp_path, monkeypatch):
    before = cs.platform_fingerprint(probe_devices=False)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert cs.platform_fingerprint(probe_devices=False) == before  # same bytes
    cu = next(csrc.glob("*.cu"))
    cu.write_text(cu.read_text() + "\n// edited\n")
    assert cs.platform_fingerprint(probe_devices=False) != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert len({before, cs.platform_fingerprint(probe_devices=False)}) == 2


def test_prefetched_library_spares_nvcc(tmp_path, monkeypatch):
    """A library fetched under the name the current sources hash to is what
    ``_build.build()`` loads; it never runs the compiler."""
    svc = cs.CompileService(port=0).start()
    old_dir = _build.build_dir()
    try:
        src_dir, dst_dir = tmp_path / "first", tmp_path / "second"
        src_dir.mkdir()
        _build.use_build_dir(src_dir)
        name = _build.library_path().name
        (src_dir / name).write_bytes(b"\x7fELF built-once")
        first = cs.CompileServiceClient(svc.url, cache_dir=str(src_dir), fingerprint="ab" * 8)
        assert first.scan_publish() == 1 and first.flush(5.0)
        second = cs.CompileServiceClient(svc.url, cache_dir=str(dst_dir), fingerprint="ab" * 8)
        assert second.prefetch() == 1
        _build.use_build_dir(dst_dir)

        def _no_nvcc():
            raise AssertionError("nvcc ran although the library was fetched")

        monkeypatch.setattr(_build, "_nvcc", _no_nvcc)
        assert _build.build() == dst_dir / name
        assert (dst_dir / name).read_bytes() == b"\x7fELF built-once"
        assert set(kernel_cache.list_cache_entries(str(dst_dir))) == {name}
        first.close()
        second.close()
    finally:
        _build.use_build_dir(old_dir)
        svc.stop()


def test_auto_capacity_probes_cuda_device_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    c = GentunClient(GeneticCnnIndividual, *DATA, host="127.0.0.1", capacity="auto")
    assert (c.capacity, c._mesh_shape) == (16, (8, 1))
    assert c._fleet_chips() == 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    c = GentunClient(GeneticCnnIndividual, *DATA, host="127.0.0.1", capacity="auto")
    assert (c.capacity, c._mesh_shape, c._fleet_chips()) == (2, (1, 1), 1)


def test_host_species_never_touches_cuda(monkeypatch):
    def _boom():
        raise AssertionError("a host-only species probed the CUDA devices")

    monkeypatch.setattr(torch.cuda, "device_count", _boom)
    c = GentunClient(OneMax, *DATA, host="127.0.0.1", capacity=4,
                     compile_cache_url="http://127.0.0.1:9")
    assert c._fleet_chips() == 1
    assert c._compile_client._probe_devices is False
    with pytest.raises(ValueError, match="mesh_devices"):
        GentunClient(OneMax, *DATA, host="127.0.0.1", capacity="auto")


def test_multihost_client_counts_the_world_s_cards(monkeypatch):
    """A multihost worker's mesh spans its ranks, one card each: capacity
    ``auto`` and the hello's chip count read the world size, never the
    local CUDA devices."""
    from gentun_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    c = GentunClient(GeneticCnnIndividual, *DATA, host="127.0.0.1", capacity="auto",
                     multihost=True)
    assert (c.capacity, c._mesh_shape, c._fleet_chips()) == (8, (4, 1), 4)
    assert c._is_leader


@pytest.mark.parametrize("kwargs", [
    dict(fitness_store="fitness.json"),
    dict(cache_url="127.0.0.1:9"),
    dict(compile_cache_url="http://127.0.0.1:9"),
    dict(broker_urls=["127.0.0.1:1", "127.0.0.1:2"]),
])
def test_multihost_client_refuses_per_host_state(kwargs):
    """What one host has and another may not (a store file, a cache hit, a
    shard connection) would part the ranks mid-collective: refused."""
    with pytest.raises(ValueError, match="multihost"):
        GentunClient(OneMax, *DATA, host="127.0.0.1", multihost=True, **kwargs)


@pytest.mark.parametrize("argv, message", [
    (["--num-processes", "2", "--process-id", "0"], "require --coordinator"),
    (["--backend", "gloo"], "require --coordinator"),
    (["--coordinator", "10.0.0.1:8476"], "requires --num-processes and --process-id"),
    (["--coordinator", "h:1", "--compile-cache-url", "http://h:9737"],
     "--compile-cache-url is not supported with --coordinator"),
    (["--mesh", "2x1"], "does not factor the worker's 1 rank(s)"),
    (["--mesh", "3x"], "--mesh"),
    (["--capacity", "0"], "--capacity"),
])
def test_worker_cli_refusals(argv, message):
    with pytest.raises(SystemExit) as exc:
        worker_cli.main(argv)
    assert message in str(exc.value)


def test_worker_without_a_card_fails_its_jobs():
    """The master's default configuration asks for the CUDA device; a worker
    that has none answers every job with a ``fail`` frame carrying the device
    error, and the master raises instead of taking a CPU fitness."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 2, size=32).astype(np.int32)
    stop = threading.Event()
    with DistributedPopulation(GeneticCnnIndividual, size=2, seed=1, port=0,
                               additional_parameters=dict(TINY_CNN), job_timeout=60,
                               max_attempts=2) as pop:
        client = GentunClient(GeneticCnnIndividual, x, y, port=pop.broker_address[1],
                              capacity=2, heartbeat_interval=0.2, reconnect_delay=0.05)
        t = threading.Thread(target=client.work, kwargs={"stop_event": stop}, daemon=True)
        t.start()
        try:
            with pytest.raises(JobFailed) as exc:
                pop.evaluate()
            chain, err = [], exc.value
            while err is not None:
                chain.append(str(err))
                err = err.__cause__ or err.__context__
            assert any("runs on the CUDA device and none is available" in m for m in chain), chain
            assert not any(ind.fitness_evaluated for ind in pop)
        finally:
            stop.set()
            t.join(timeout=15)


def test_worker_module_serves_tiny_cnn_jobs():
    """``python -m gentun_tpu_torch.distributed.worker`` loads its data,
    serves two genetic-cnn jobs of a port master and exits 0 at
    ``--max-jobs``; the fitnesses equal a local evaluation on the same data."""
    from gentun_tpu_torch import Population
    from gentun_tpu_torch.utils.datasets import load_mnist

    params = dict(TINY_CNN, mesh="cpu")
    x, y, _ = load_mnist(n=64)
    local = Population(GeneticCnnIndividual, x_train=x, y_train=y, size=2, seed=9,
                       additional_parameters=params)
    local.evaluate()
    want = {ind.cache_key(): ind.get_fitness() for ind in local}
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    with DistributedPopulation(GeneticCnnIndividual, size=2, seed=9, port=0,
                               additional_parameters=params, job_timeout=600,
                               heartbeat_timeout=120) as pop:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gentun_tpu_torch.distributed.worker",
             "--port", str(pop.broker_address[1]), "--species", "genetic-cnn",
             "--dataset", "mnist", "--n", "64", "--capacity", "2", "--max-jobs", "2"],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        try:
            pop.evaluate()
            assert {ind.cache_key(): ind.get_fitness() for ind in pop} == want
            out, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, out.decode()[-3000:]
            assert b"worker exiting after 2 job(s)" in out
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_canary_probe_of_a_golden_sealed_from_a_local_evaluation(tmp_path):
    """A golden sealed from one genome's fitness in a single-process pop-4
    evaluation is reproduced bit for bit by a worker serving the canary's
    one-genome ``no_memo`` probe (purity across program widths), twice."""
    from gentun_tpu_torch import Population
    from gentun_tpu_torch.distributed import JobBroker
    from gentun_tpu_torch.telemetry import lineage
    from gentun_tpu_torch.telemetry.canary import CanaryDaemon, GoldenSet
    from gentun_tpu_torch.utils.fitness_store import fidelity_fingerprint

    params = dict(TINY_CNN, mesh="cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 2, size=32).astype(np.int32)
    local = Population(GeneticCnnIndividual, x_train=x, y_train=y, size=4, seed=2,
                       additional_parameters=params)
    local.evaluate()
    genes = local[2].get_genes()
    path = str(tmp_path / "golden.json")
    GoldenSet(path).seal(GoldenSet.key("cnn", fidelity_fingerprint(params),
                                       lineage.genome_key(genes)), local[2].get_fitness())
    broker = JobBroker(port=0).start()
    stop = threading.Event()
    client = GentunClient(GeneticCnnIndividual, x, y, port=broker.address[1], capacity=2,
                          heartbeat_interval=0.2, reconnect_delay=0.05)
    t = threading.Thread(target=client.work, kwargs={"stop_event": stop}, daemon=True)
    t.start()
    canary = CanaryDaemon([f"127.0.0.1:{broker.address[1]}"],
                          [{"genes": genes, "additional_parameters": params}],
                          space_key="cnn", probe_interval=999, probe_timeout=120,
                          golden_path=path, serve_http=False)
    try:
        for _ in range(2):
            r = canary.probe_once()
            assert r["result"] == "ok" and not r["newly_sealed"], r
            assert r["fitness"] == local[2].get_fitness()
    finally:
        canary.stop()
        stop.set()
        t.join(timeout=30)
        broker.stop()


def test_example_demo_runs_tiny_on_the_cpu(capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_distributed_search", REPO / "examples" / "torch_distributed_search.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["demo", "--device", "cpu", "--generations", "2", "--population", "4",
                  "--n-images", "64", "--nodes", "2", "--kernels", "2", "--batch-size", "16"])
    assert "demo best fitness:" in capsys.readouterr().out


def test_submits_a_restarted_broker_lost_are_submitted_again(tmp_path):
    """A steady-state master on an embedded journaled broker: submits whose
    journal records die in the abandoned buffer of a kill are unknown to the
    restarted broker, and waiting on them submits them again under their ids
    (without that, the wait never ends)."""
    import socket

    from gentun_tpu_torch import Population
    from gentun_tpu_torch.distributed import JobBroker

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    broker = JobBroker(port=port, journal_path=str(tmp_path / "broker.journal"),
                       journal_fsync_interval=3600.0).start()
    stop = threading.Event()
    try:
        pop = DistributedPopulation(OneMax, size=3, seed=0, host="127.0.0.1", port=port,
                                    broker=broker, job_timeout=60)
        individuals = list(Population(OneMax, *DATA, size=3, seed=1))
        ids = pop.submit_individuals(individuals)
        deadline = time.monotonic() + 10.0
        while broker.unknown_jobs(ids) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert broker.unknown_jobs(ids) == set()
        broker.kill()  # nothing was flushed: every submit dies with the epoch
        broker.start()
        assert broker.epoch == 2 and broker.unknown_jobs(ids) == set(ids)
        client = GentunClient(OneMax, *DATA, host="127.0.0.1", port=port,
                              heartbeat_interval=0.2, reconnect_delay=0.05)
        threading.Thread(target=client.work, kwargs={"stop_event": stop}, daemon=True).start()
        got = {}
        deadline = time.monotonic() + 30.0
        while len(got) < len(ids) and time.monotonic() < deadline:
            results, failures = pop.wait_any_results([j for j in ids if j not in got],
                                                     timeout=5.0)
            assert not failures
            got.update(results)
        assert got == {j: ind.evaluate() for j, ind in zip(ids, individuals)}
        pop.close()
    finally:
        stop.set()
        broker.stop()


def test_a_result_the_master_gathered_is_not_run_again_after_a_restart(tmp_path):
    """A master gathers a result whose completion record is still in the
    journal's unsynced buffer when the broker is killed.  The restarted
    broker replays the job as open; it must drop it, not run it again: a
    second result would land in the results table after the master took the
    first, an orphan no gather ever drains."""
    import socket

    from gentun_tpu_torch import Population
    from gentun_tpu_torch.distributed import JobBroker

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    broker = JobBroker(port=port, journal_path=str(tmp_path / "broker.journal"),
                       journal_fsync_interval=3600.0).start()
    stop = threading.Event()
    try:
        pop = DistributedPopulation(OneMax, size=2, seed=0, host="127.0.0.1", port=port,
                                    broker=broker, job_timeout=60)
        first, second = (list(Population(OneMax, *DATA, size=2, seed=seed)) for seed in (1, 2))
        ids = pop.submit_individuals(first)
        deadline = time.monotonic() + 10.0
        while broker.unknown_jobs(ids) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert broker.unknown_jobs(ids) == set()
        broker._journal.flush()  # the submits are durable; what follows is not
        client = GentunClient(OneMax, *DATA, host="127.0.0.1", port=port,
                              heartbeat_interval=0.2, reconnect_delay=0.05)
        threading.Thread(target=client.work, kwargs={"stop_event": stop}, daemon=True).start()
        assert broker.gather(ids, timeout=30) == {j: ind.evaluate() for j, ind in zip(ids, first)}
        broker.kill()  # the completion records die with the unsynced buffer
        broker.start()
        assert broker.epoch == 2
        assert broker.unknown_jobs(ids) == set(ids)  # dropped at replay, not requeued
        # The same worker reconnects and serves a new generation; nothing of
        # the gathered one comes back.
        later = pop.submit_individuals(second)
        assert broker.gather(later, timeout=30) == {
            j: ind.evaluate() for j, ind in zip(later, second)}
        assert set(broker.outstanding().values()) == {0}
        pop.close()
    finally:
        stop.set()
        broker.stop()
