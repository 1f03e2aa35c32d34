"""The port's multi-host worker: one logical worker as ranks of a gloo group.

The JAX package's ``tests/test_multihost.py`` cases, held against the
port's ``parallel/multihost.py`` and ``GentunClient(multihost=True)`` on a
real two-rank gloo group of CPU processes, started as subprocesses of this
file (``--child``) under a deadline and killed on exit:

- a leader and a follower serve a tiny CNN generation from a master in
  this process, every fitness equal to the same population evaluated in
  one process, and the worker advertises both ranks' cards;
- ``broadcast_payload`` round-trips objects across its size buckets on both
  ranks;
- the leader SIGKILLed, the follower exits with code 17 within the
  watchdog's bound.

``TestLeaderWatchdog``'s three cases run against the copy in
``tests/test_torch_parallel.py``; ``torch_entry.dryrun_multichip(2)`` runs
its two ranks on the CPU here.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Seconds the worker cluster may take to join the master and serve.
CLUSTER_DEADLINE_S = 90.0
#: The watchdog probes every 2 s and gives up after 3 misses (about 9 s); a
#: collective that fails when the leader dies ends the follower at once.
FOLLOWER_EXIT_BOUND_S = 15.0

TINY_CNN = dict(nodes=(2,), kernels_per_layer=(2,), kfold=2, epochs=(1,),
                learning_rate=(0.05,), batch_size=16, dense_units=8,
                compute_dtype="float32", seed=0, mesh="cpu")
#: Payload sizes across ``broadcast_payload``'s buckets (256, 512, ..., 2^17).
SIZES = (0, 100, 254, 300, 5000, 100_000)


def _images():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 2, size=32).astype(np.int32)
    return x, y


def _child_main(argv) -> int:
    """One rank of the worker: broadcasts, then ``GentunClient(multihost=True)``
    until the leader is killed."""
    rank, world, port, broker_port, outdir = (int(argv[0]), int(argv[1]), int(argv[2]),
                                              int(argv[3]), argv[4])
    torch.set_num_threads(1)
    from gentun_tpu_torch import GeneticCnnIndividual
    from gentun_tpu_torch.distributed import GentunClient
    from gentun_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    got = []
    for n in SIZES:
        obj = {"n": n, "s": "x" * max(0, n - 14)} if multihost.is_leader() else None
        got.append(multihost.broadcast_payload(obj) == {"n": n, "s": "x" * max(0, n - 14)})
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump({"broadcast": got, "leader": multihost.is_leader()}, fh)
    x, y = _images()
    client = GentunClient(GeneticCnnIndividual, x, y, host="127.0.0.1", port=broker_port,
                          capacity=4, heartbeat_interval=0.2, reconnect_delay=0.1,
                          multihost=True)
    client.work()
    return 0


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[sys.argv.index("--child") + 1:]))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread here and in the ranks: test workers share the
    cores (see ``tests/test_torch_cnn.py``)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _fitnesses(pop):
    return sorted((json.dumps(ind.get_genes(), sort_keys=True, default=list), ind.get_fitness())
                  for ind in pop)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A master's generation served by a two-rank worker, then its leader
    SIGKILLed; returns what every test below reads."""
    from gentun_tpu_torch import GeneticCnnIndividual, Population
    from gentun_tpu_torch.distributed import DistributedPopulation

    outdir = str(tmp_path_factory.mktemp("multihost"))
    x, y = _images()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, logs, out = [], [], {}
    try:
        with DistributedPopulation(GeneticCnnIndividual, size=4, seed=11, port=0,
                                   additional_parameters=dict(TINY_CNN), job_timeout=120) as pop:
            for rank in range(2):
                log = open(os.path.join(outdir, f"rank{rank}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--child", str(rank), "2",
                     str(port), str(pop.broker_address[1]), outdir],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + CLUSTER_DEADLINE_S
            # The one-process yardstick, while the ranks start.
            local = Population(GeneticCnnIndividual, x_train=x, y_train=y, size=4, seed=11,
                               additional_parameters=dict(TINY_CNN))
            local.evaluate()
            out["want"] = _fitnesses(local)
            while pop.broker.fleet_members() < 1:
                for p, log in zip(procs, logs):
                    if p.poll() is not None:
                        log.seek(0)
                        pytest.fail(f"a rank exited {p.returncode} before joining:\n"
                                    f"{log.read()[-3000:]}")
                if time.monotonic() > deadline:
                    pytest.fail(f"the worker did not join within {CLUSTER_DEADLINE_S} s")
                time.sleep(0.1)
            out["fleet_chips"] = pop.broker.fleet_chips()
            pop.evaluate()
            out["got"] = _fitnesses(pop)
            out["follower_alive"] = procs[1].poll() is None
            procs[0].send_signal(signal.SIGKILL)
            t0 = time.monotonic()
            try:
                out["follower_rc"] = procs[1].wait(timeout=FOLLOWER_EXIT_BOUND_S + 15.0)
            except subprocess.TimeoutExpired:
                out["follower_rc"] = None
            out["follower_exit_s"] = time.monotonic() - t0
        for rank in range(2):
            with open(os.path.join(outdir, f"rank{rank}.json")) as fh:
                out[f"rank{rank}"] = json.load(fh)
        logs[1].seek(0)
        out["follower_log"] = logs[1].read()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return out


def test_leader_and_follower_serve_a_generation_equal_to_one_process(served):
    """Rank 0 takes the window from the broker and broadcasts it; both ranks
    train their pop row of a ``(2, 1)`` mesh; the leader answers.  Every
    fitness is the one-process bits."""
    assert len(served["got"]) == 4 and served["got"] == served["want"]


def test_worker_advertises_every_rank_s_card(served):
    assert served["fleet_chips"] == 2


def test_broadcast_payload_round_trips_across_buckets(served):
    for rank in (0, 1):
        assert served[f"rank{rank}"]["broadcast"] == [True] * len(SIZES)
    assert [served[f"rank{r}"]["leader"] for r in (0, 1)] == [True, False]


def test_follower_exits_17_when_the_leader_is_sigkilled(served):
    """No shutdown sentinel can come: the follower must exit with the
    watchdog's code 17 within its bound, not hang in the collective."""
    assert served["follower_alive"]
    assert served["follower_rc"] == 17, served["follower_log"][-3000:]
    assert served["follower_exit_s"] < FOLLOWER_EXIT_BOUND_S


def test_bucket_sizes_are_powers_of_two_from_256():
    from gentun_tpu_torch.parallel.multihost import _bucket_bytes

    assert [_bucket_bytes(n) for n in (0, 256, 257, 5000)] == [256, 256, 512, 8192]


def test_one_process_helpers_without_a_group():
    """Never initialized: one rank, the leader, payloads pass through, a fetch
    is the value itself, and the rank has no card to name."""
    from gentun_tpu_torch.parallel import multihost

    assert (multihost.process_count(), multihost.process_index(), multihost.is_leader()) == (
        1, 0, True)
    assert multihost.broadcast_payload({"a": 1}) == {"a": 1}
    assert multihost.fetch(np.arange(3.0)).tolist() == [0.0, 1.0, 2.0]
    assert multihost.coordinator_reachable()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="mesh='cpu'"):
            multihost.local_device()


@pytest.mark.parametrize("kwargs, message", [
    (dict(num_processes=2, process_id=2), "not a rank"),
    (dict(num_processes=1, process_id=0, backend="mpi"), "nccl' or 'gloo"),
    (dict(num_processes=1, process_id=0, coordinator="nohost"), "host:port"),
])
def test_initialize_refuses_bad_arguments(kwargs, message):
    from gentun_tpu_torch.parallel import multihost

    args = {"coordinator": "127.0.0.1:0", **kwargs}
    with pytest.raises(ValueError, match=message):
        multihost.initialize(args.pop("coordinator"), args.pop("num_processes"),
                             args.pop("process_id"), **args)


def test_initialize_never_picks_gloo_by_itself():
    """A rank with no card and no backend named is refused: NCCL cannot run
    it, and gloo is the caller's to ask for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    from gentun_tpu_torch.parallel import multihost

    with pytest.raises(ValueError, match="backend='gloo'"):
        multihost.initialize("127.0.0.1:0", 1, 0)
    assert multihost.process_count() == 1


def test_dryrun_multichip_runs_two_ranks_on_the_cpu(monkeypatch, capfd):
    """``dryrun_multichip(2, device="cpu")`` spawns two rank processes over
    gloo; they train the tiny CV on a ``(1, 2)`` mesh and rank 0 reports."""
    import torch_entry

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    torch_entry.dryrun_multichip(2, device="cpu", timeout=CLUSTER_DEADLINE_S)
    out = capfd.readouterr().out
    assert "dryrun_multichip OK: 2 ranks, backend gloo, mesh 1x2 on cpu" in out
