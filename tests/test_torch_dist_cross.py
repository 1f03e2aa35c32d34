"""The port's distributed plane against the JAX package's, across the wire.

The wire is byte-compatible, so either package's master can be served by
either package's workers, and each fitness equals the serving package's own
local evaluation.  The fitness services, the compile-service fingerprints
and the canary's goldens keep the two packages' values apart.
"""

import contextlib
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import gentun_tpu as ref
import gentun_tpu_torch as port
from gentun_tpu.distributed import compile_service as ref_cs
from gentun_tpu.distributed import fitness_service as ref_fs
from gentun_tpu.distributed import protocol as ref_proto
from gentun_tpu.telemetry import canary as ref_canary
from gentun_tpu_torch.distributed import compile_service as port_cs
from gentun_tpu_torch.distributed import fitness_service as port_fs
from gentun_tpu_torch.distributed import protocol as port_proto
from gentun_tpu_torch.telemetry import canary as port_canary

TINY_CNN = dict(nodes=(3, 3), kernels_per_layer=(4, 4), kfold=2, epochs=(1,),
                learning_rate=(0.05,), batch_size=16, dense_units=8,
                compute_dtype="float32", seed=0)


@contextlib.contextmanager
def _one_thread_here():
    """One OpenMP and one torch intra-op thread for the calling thread,
    restored after.  Both limits are per thread: a thread started under
    them still gets a pool of one thread per core."""
    from threadpoolctl import threadpool_limits

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One OpenMP and one torch intra-op thread in the main thread: sklearn's
    and torch's thread pools spin against other test workers' otherwise (see
    ``tests/test_torch_cnn.py``).  The limits hold for this thread only; a
    client thread takes them itself (``_serve``)."""
    with _one_thread_here():
        yield


def _work_one_thread(client, stop):
    """``client.work`` under the same limits as the main thread."""
    with _one_thread_here():
        client.work(stop_event=stop)


def _images():
    rng = np.random.default_rng(3)
    protos = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 3, size=48).astype(np.int32)
    x = (protos[y] + 0.25 * rng.normal(size=(48, 8, 8, 1))).astype(np.float32)
    return x, y


def _tabular():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(60, 4)).astype(np.float64)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.int64)
    return x, y


def _fitnesses(pop):
    """``(genes as JSON, fitness)`` of each individual, sorted."""
    return sorted((json.dumps(ind.get_genes(), sort_keys=True, default=list), ind.get_fitness())
                  for ind in pop)


# species name -> (package -> Individual class, data, the package's parameters)
SPECIES = {
    "genetic-cnn": (lambda pkg: pkg.GeneticCnnIndividual, _images,
                    {ref: dict(TINY_CNN, mesh=None), port: dict(TINY_CNN, mesh="cpu")}),
    "boosting": (lambda pkg: pkg.BoostingIndividual, _tabular,
                 {ref: {"kfold": 2}, port: {"kfold": 2}}),
}


def test_frames_encode_to_equal_bytes():
    genes = {"S_1": (1, 0, 1), "S_2": (0, 1, 1, 0, 0, 1)}
    params = dict(TINY_CNN, nodes=(3, 4), learning_rate=(0.05, 0.01))
    payloads = [
        {"genes": genes, "additional_parameters": params},
        {"genes": genes, "additional_parameters": params,
         "fidelity": {"v": 1, "rung": 0, "fingerprint": "ab" * 8}, "session": "s-1",
         "trace": {"t": "0123", "s": "45"}, "no_memo": True},
    ]
    caches = {ref_proto: ref_proto.GenomeFragmentCache(), port_proto: port_proto.GenomeFragmentCache()}
    wires = {}
    for proto, cache in caches.items():
        wires[proto] = [proto.build_job_wire(f"job-{i}", p, f"gk{i}", cache, memo={})
                        for i, p in enumerate(payloads)]
    for r, p in zip(wires[ref_proto], wires[port_proto]):
        assert (r.gk, r.v1, r.entry2, r.env) == (p.gk, p.v1, p.entry2, p.env)
        assert r.with_session("t-2").v1 == p.with_session("t-2").v1
    for proto in (ref_proto, port_proto):
        ws = wires[proto]
        wires[proto] = (
            proto.jobs_frame([w.v1 for w in ws]),
            proto.jobs_frame([w.v1 for w in ws], packed=True),
            proto.jobs2_frame(ws[0].env, [w.entry2 for w in ws]),
            proto.jobs2_frame(proto.pack_envelope(ws[1].env),
                              [proto.packed_entry2(w) for w in ws], packed=True),
        )
    assert wires[ref_proto] == wires[port_proto]
    assert port_proto.decode(wires[ref_proto][2]) == ref_proto.decode(wires[port_proto][2])
    messages = [
        {"type": "hello", "worker_id": "w", "token": None, "capacity": 20, "prefetch_depth": 20,
         "n_chips": 1, "backend": None, "caps": ["jobs2"], "mesh": {"pop": 1, "data": 1, "devices": 1}},
        {"type": "fail", "job_id": "j", "reason": "evaluate: RuntimeError('x')", "boot": "b"},
        *ref_proto.coalesce_results([{"job_id": "j1", "fitness": 0.8125},
                                     {"job_id": "j2", "fitness": -0.0, "session": "s"}]),
    ]
    for msg in messages:
        assert ref_proto.encode(msg) == port_proto.encode(msg)
    assert (ref_proto.coalesce_results([{"job_id": "j", "fitness": 0.5}])
            == port_proto.coalesce_results([{"job_id": "j", "fitness": 0.5}]))


def _serve(master_pkg, worker_pkg, species):
    """One generation of ``master_pkg``'s master served by a ``worker_pkg``
    client thread; returns its fitnesses and the worker package's local
    evaluation of the same population."""
    cls_of, data, params = SPECIES[species]
    x, y = data()
    local = worker_pkg.Population(cls_of(worker_pkg), x_train=x, y_train=y, size=4, seed=11,
                                  additional_parameters=params[worker_pkg])
    local.evaluate()
    stop = threading.Event()
    from importlib import import_module

    dist = import_module(f"{master_pkg.__name__}.distributed")
    client_mod = import_module(f"{worker_pkg.__name__}.distributed")
    with dist.DistributedPopulation(cls_of(master_pkg), size=4, seed=11, port=0,
                                    additional_parameters=params[worker_pkg],
                                    job_timeout=300) as pop:
        client = client_mod.GentunClient(cls_of(worker_pkg), x, y, port=pop.broker_address[1],
                                         capacity=4, heartbeat_interval=0.2,
                                         reconnect_delay=0.05)
        t = threading.Thread(target=_work_one_thread, args=(client, stop), daemon=True)
        t.start()
        try:
            pop.evaluate()
            got = _fitnesses(pop)
        finally:
            stop.set()
            t.join(timeout=30)
    return got, _fitnesses(local)


@pytest.mark.parametrize("species", sorted(SPECIES))
def test_reference_master_served_by_port_worker(species):
    got, want = _serve(ref, port, species)
    assert len(got) == 4 and got == want


@pytest.mark.parametrize("species", sorted(SPECIES))
def test_port_master_served_by_reference_worker(species):
    got, want = _serve(port, ref, species)
    assert len(got) == 4 and got == want


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=5) as resp:
        return resp.status


@pytest.mark.parametrize("service_pkg", ["reference", "port"])
def test_fitness_services_refuse_the_other_protocol(service_pkg):
    svc_mod, client_mod = (ref_fs, port_fs) if service_pkg == "reference" else (port_fs, ref_fs)
    assert svc_mod.FITNESS_PROTOCOL != client_mod.FITNESS_PROTOCOL
    svc = svc_mod.FitnessService(port=0).start()
    try:
        client = client_mod.FitnessServiceClient(svc.url)
        assert client.lookup(["k"]) == {}
        assert client.degraded
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(svc.url + "/v1/lookup", {"v": 1, "version": client_mod.STORE_VERSION,
                                           "keys": ["k"], "protocol": client_mod.FITNESS_PROTOCOL})
        assert exc.value.code == 409
        assert _post(svc.url + "/v1/lookup", {"v": 1, "version": svc_mod.STORE_VERSION,
                                              "keys": ["k"], "protocol": svc_mod.FITNESS_PROTOCOL}) == 200
        client.close()
    finally:
        svc.stop()


def test_compile_fingerprints_differ_from_the_reference():
    r = ref_cs.platform_components(probe_devices=False)
    p = port_cs.platform_components(probe_devices=False)
    assert "jax" in r and "kernel_sources" in p and "jax" not in p
    assert ref_cs.platform_fingerprint(probe_devices=False) != port_cs.platform_fingerprint(
        probe_devices=False)
    assert ref_cs.COMPILE_PROTOCOL == port_cs.COMPILE_PROTOCOL  # same wire, other namespace


def test_reference_golden_file_is_refused(tmp_path):
    path = str(tmp_path / "golden.json")
    ref_canary.GoldenSet(path).seal("space:fp:gk", 0.75)
    with pytest.raises(ValueError, match="fitness protocol"):
        port_canary.GoldenSet(path)
    with pytest.raises(ValueError, match="fitness protocol"):
        port_canary.CanaryDaemon(["127.0.0.1:9"], [{"genes": {"S_1": [1, 0, 1]}}],
                                 golden_path=path, serve_http=False)
    port_canary.GoldenSet(str(tmp_path / "port.json")).seal("space:fp:gk", 0.75)
    assert port_canary.GoldenSet(str(tmp_path / "port.json")).get("space:fp:gk") == 0.75
