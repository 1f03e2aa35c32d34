"""The port's steady-state engine and surrogate against the JAX package's,
and the thread safety of the port's evaluator state.

With a deterministic stub fitness and one in-flight slot both engines draw
the same randomness from the same seeds, so histories, rings, checkpoints
and surrogate state must agree bit for bit (the fitness protocol stamp
apart).  A real Genetic-CNN species on the CPU then runs two evaluation
threads at once: every genome must get the bits it gets in one batched
call, and a promotion's warm start the bits of a main-thread replay.
"""

import json
import threading

import numpy as np
import pytest
import torch

import gentun_tpu as ref
import gentun_tpu_torch as port
from gentun_tpu.distributed import FaultInjector, FaultPlan, FaultSpec
from gentun_tpu.distributed.faults import MasterKilled
from gentun_tpu.utils import Checkpointer as RefCheckpointer
from gentun_tpu_torch.models import cnn as port_cnn
from gentun_tpu_torch.telemetry import spans as port_spans
from gentun_tpu_torch.telemetry.registry import get_registry as port_registry
from gentun_tpu_torch.utils import Checkpointer
from gentun_tpu_torch.utils.fitness_store import FITNESS_PROTOCOL

#: Two rungs whose overlays fingerprint (and cache-key) differently.
LADDER = [{"kfold": 2, "epochs": (1,)}, {"kfold": 3, "epochs": (2,)}]


@pytest.fixture(autouse=True)
def _pristine_telemetry():
    port_spans.disable()
    port_spans.set_run_sink(None)
    port_registry().reset()
    yield
    port_spans.disable()
    port_spans.set_run_sink(None)
    port_registry().reset()


def _onemax(pkg):
    """OneMax plus a term of the rung's schedule, so the ladder's rungs
    measure different values; the same class body in either package."""

    class OneMax(pkg.Individual):
        def build_spec(self, **params):
            return pkg.genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

        def evaluate(self):
            epochs = self.additional_parameters.get("epochs", (1,))
            return float(sum(sum(g) for g in self.genes.values())) + 0.25 * sum(epochs)

    return OneMax


SPECIES = {ref: _onemax(ref), port: _onemax(port)}


def _engine(pkg, mode, **kw):
    pop = pkg.Population(SPECIES[pkg], x_train=np.zeros(1), y_train=np.zeros(1),
                         size=8, seed=11)
    opts = dict(tournament_size=3, max_in_flight=1, seed=5, checkpoint_every=4)
    if mode in ("ladder", "surrogate"):
        opts.update(fidelity_ladder=LADDER, eta=3)
    if mode == "surrogate":
        opts["surrogate"] = pkg.SurrogateGate(
            pkg.FitnessSurrogate(min_train=6, refit_every=4), eta=2, min_window=4)
    opts.update(kw)
    return pkg.AsyncEvolution(pop, **opts)


def _signature(eng):
    """History, ring, best and checkpoint state (as JSON writes it: a
    resumed ladder reads back lists where the constructor had tuples)."""
    state = json.loads(json.dumps(eng.state_dict()))
    state.pop("fitness_protocol")
    ring = [(i.get_genes(), i._fitness, getattr(i, "_rung", None)) for i in eng.population]
    return eng.history, ring, eng.best.get_genes(), eng.best.get_fitness(), state


@pytest.mark.parametrize("mode", ["ladderless", "ladder", "surrogate"])
def test_engine_bit_identical_to_reference(mode):
    want_eng, got_eng = _engine(ref, mode), _engine(port, mode)
    want_eng.run(max_evaluations=40)
    got_eng.run(max_evaluations=40)
    assert _signature(got_eng) == _signature(want_eng)
    assert got_eng.state_dict()["fitness_protocol"] == FITNESS_PROTOCOL
    if mode == "ladder":
        assert any(h.get("promotion") for h in got_eng.history)
    if mode == "surrogate":
        g, w = got_eng._surrogate, want_eng._surrogate
        assert g.rejected > 0 and (g.admitted, g.rejected) == (w.admitted, w.rejected)
        assert g.surrogate._weights == w.surrogate._weights


def test_surrogate_weights_and_decisions_equal_reference():
    """The same observation stream gives the same ridge weights, the same
    scores and the same admit/reject decisions in both packages."""
    rng = np.random.default_rng(3)
    spec = port.genetic_cnn_genome((4, 5))
    genomes = [spec.sample(rng) for _ in range(60)]
    gates = [pkg.SurrogateGate(pkg.FitnessSurrogate(min_train=8, refit_every=5),
                               eta=3, min_window=6) for pkg in (ref, port)]
    for gate in gates:
        gate.prepare(genomes[0], maximize=True)
    for i, genes in enumerate(genomes):
        decisions = [gate.decide(genes, rung=i % 2) for gate in gates]
        assert decisions[0] == decisions[1]
        fitness = float(sum(sum(g) for g in genes.values())) + 0.1 * (i % 7)
        for gate in gates:
            gate.observe_result(genes, i % 2, fitness)
        assert gates[0].surrogate._weights == gates[1].surrogate._weights
    assert gates[1].surrogate.trained and gates[1].rejected > 0
    assert gates[0].state_dict() == gates[1].state_dict()


class _KillAt:
    """A chaos hook for the port's engine: raise at the ``at``-th boundary
    (after its checkpoint save, as a crashed master would)."""

    def __init__(self, at):
        self.at, self.seen = at, 0

    def master_boundary(self, completed):
        self.seen += 1
        if self.seen == self.at:
            raise KeyboardInterrupt(f"killed at {completed} completions")


@pytest.mark.parametrize("mode", ["ladderless", "surrogate"])
def test_kill_and_resume_is_deterministic(mode, tmp_path):
    whole = _engine(port, mode)
    whole.run(max_evaluations=40)
    path = str(tmp_path / "ckpt.json")
    killed = _engine(port, mode)
    killed.set_fault_injector(_KillAt(3))
    with pytest.raises(KeyboardInterrupt):
        killed.run(max_evaluations=40, checkpointer=Checkpointer(path))
    state = json.load(open(path))
    assert state["schema_version"] == 4 and 0 < state["completed"] < 40
    assert state["fitness_protocol"] == FITNESS_PROTOCOL
    resumed = _engine(port, mode)
    resumed.run(max_evaluations=40, checkpointer=Checkpointer(path))
    assert resumed.completed == 40
    assert _signature(resumed) == _signature(whole)


def test_reference_checkpoint_resumes_without_its_fitnesses(tmp_path):
    """A v4 checkpoint of the reference's gated, laddered engine: the port
    resumes its ring, RNG and counters, and none of its measurements."""
    path = str(tmp_path / "ref.json")
    eng = _engine(ref, "surrogate")
    eng.set_fault_injector(FaultInjector(FaultPlan([
        FaultSpec(hook="master_boundary", kind="kill_master", at=4)])))
    with pytest.raises(MasterKilled):
        eng.run(max_evaluations=40, checkpointer=RefCheckpointer(path))
    state = json.load(open(path))
    assert state["schema_version"] == 4 and state["surrogate"]["model"]["samples"]
    assert state["fitness_protocol"] != FITNESS_PROTOCOL
    assert any(m["fitness"] is not None for m in state["population"]["individuals"])

    resumed = _engine(port, "surrogate")
    Checkpointer(path).resume(resumed)
    assert resumed.completed == state["completed"]
    assert all(not m.fitness_evaluated for m in resumed.population)
    assert [{k: list(v) for k, v in m.get_genes().items()} for m in resumed.population] == [
        ref_m["genes"] for ref_m in state["population"]["individuals"]]
    assert resumed.best is None and resumed._best_by_rung == {}
    assert resumed._rung_completions == [[], []]
    assert dict(resumed.population.fitness_cache) == {}
    gate = resumed._surrogate
    assert gate.surrogate.n_samples == 0 and not gate.surrogate.trained
    assert not gate._scores and not gate._pending and not gate._pairs
    children = [e for e in state["in_flight"] + state["queued"] if e["kind"] == "child"]
    assert len(resumed._restored_in_flight) == len(children)
    assert all(w.target is None for w in resumed._restored_in_flight)
    resumed.run(max_evaluations=state["completed"] + 10)
    assert resumed.completed == state["completed"] + 10 and resumed.best is not None


# ---------------------------------------------------------------------------
# Evaluator state under concurrency
# ---------------------------------------------------------------------------


def test_exact_numerics_holds_tf32_off_until_the_last_thread_leaves():
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    entered = [threading.Event(), threading.Event()]
    leave = [threading.Event(), threading.Event()]
    inside = []

    def worker(i):
        with port_cnn.exact_numerics():
            entered[i].set()
            leave[i].wait(5)
            inside.append(matmul.allow_tf32)

    try:
        matmul.allow_tf32 = True
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        threads[0].start()
        entered[0].wait(5)
        threads[1].start()
        entered[1].wait(5)
        leave[0].set()  # the first thread leaves while the second is inside
        threads[0].join(5)
        assert not threads[0].is_alive() and matmul.allow_tf32 is False
        leave[1].set()
        threads[1].join(5)
        assert not threads[1].is_alive() and inside == [False, False]
        assert matmul.allow_tf32 is True  # the caller's value, back after the last exit
    finally:
        matmul.allow_tf32 = saved


class _Slots(torch.nn.Module):
    """Two slots of params drawn from ``seed``: what a trained model hands
    the bank, at a size the test can hammer."""

    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = torch.nn.Parameter(torch.randn(2, 3, generator=g))
        self.b = torch.nn.Parameter(torch.randn(2, 2, generator=g))


def test_warm_bank_under_concurrent_deposit_and_overlay(monkeypatch):
    """Four threads deposit and overlay at once: no exception, the cap is
    kept, and every entry and every overlaid slot is one whole deposit.
    Key ``(t, k)`` is slot 0 and ``(t + 100, k)`` slot 1 of ``_Slots(k)``."""
    import sys

    monkeypatch.setattr(port_cnn, "_WARM_BANK_CAP", 8)
    port_cnn._WARM_BANK.clear()
    slots = {k: _Slots(k) for k in range(13)}
    want = {k: {n: p.detach().numpy() for n, p in m.named_parameters()} for k, m in slots.items()}
    errors = []
    start = threading.Barrier(4)

    def expect(key, slot_params):
        hi, lo = key
        slot = 0 if hi < 100 else 1
        for name, value in slot_params.items():
            np.testing.assert_array_equal(value, want[lo][name][slot])

    def worker(t):
        try:
            start.wait(5)
            for n in range(400):
                k = n % 13
                hashes = np.array([[t, k], [t + 100, k]], dtype=np.uint32)
                port_cnn._warm_bank_deposit(slots[k], hashes)
                read = np.array([[t, (n * 7) % 13], [(t + 1) % 4 + 100, k]], dtype=np.uint32)
                params = {"w": torch.zeros(2, 2, 3), "b": torch.zeros(2, 2, 2)}
                port_cnn._warm_start_overlay(params, read)
                for i, (hi, lo) in enumerate(read):
                    if params["w"][0, i].abs().sum() > 0:  # warmed from the bank
                        expect((int(hi), int(lo)),
                               {name: leaf[1, i].numpy() for name, leaf in params.items()})
        except Exception as exc:  # noqa: BLE001 - collected for the assert
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not any(th.is_alive() for th in threads)
        assert errors == []
        assert len(port_cnn._WARM_BANK) <= 8
        for key, entry in port_cnn._WARM_BANK.items():
            expect(key, entry)
    finally:
        port_cnn._WARM_BANK.clear()


def _separable(n=64, seed=0):
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(3, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 3, size=n).astype(np.int32)
    x = protos[y] + 0.3 * rng.normal(size=(n, 8, 8, 1)).astype(np.float32)
    return x, y


CNN = dict(nodes=(3,), kernels_per_layer=(4,), learning_rate=(0.05,), batch_size=8,
           dense_units=8, compute_dtype="float32", mesh="cpu", seed=3, warm_start=True)
CNN_LADDER = [{"kfold": 2, "epochs": (1,)}, {"kfold": 2, "epochs": (2,)}]


class _Recorded(port.GeneticCnnIndividual):
    """Records every evaluation (genes, config, fitness, thread)."""

    log = []
    lock = threading.Lock()

    def evaluate(self):
        fitness = super().evaluate()
        with self.lock:
            self.log.append((self.get_genes(), dict(self.additional_parameters), fitness,
                             threading.get_ident()))
        return fitness


def test_two_evaluation_threads_give_each_genome_its_batched_bits():
    """``AsyncEvolution`` over the real species on the CPU, two threads in
    flight, a ladder and the warm-start bank: every rung-0 fitness is the
    same bits as the genome's slot in one batched call (warm start off),
    and a promotion's fitness the bits of a main-thread replay."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _Recorded.log = []
    port_cnn._WARM_BANK.clear()
    x, y = _separable()
    try:
        pop = port.Population(_Recorded, x_train=x, y_train=y, size=6, seed=3,
                              additional_parameters=CNN)
        eng = port.AsyncEvolution(pop, tournament_size=3, max_in_flight=2, seed=5, eta=2,
                                  fidelity_ladder=CNN_LADDER)
        eng.run(max_evaluations=12)
        log = list(_Recorded.log)
        rung0 = [(g, f) for g, cfg, f, _ in log if cfg["epochs"] == (1,)]
        rung1 = [(g, f) for g, cfg, f, _ in log if cfg["epochs"] == (2,)]
        assert len(rung0) >= 4 and rung1, [cfg["epochs"] for _, cfg, _, _ in log]
        assert len({t for *_, t in log}) == 2  # both pool threads evaluated
        assert all(np.isfinite(f) for _, f in rung0 + rung1)

        cold = {**CNN, **CNN_LADDER[0], "warm_start": False}
        batched = port.GeneticCnnModel.cross_validate_population(
            x, y, [g for g, _ in rung0], **cold)
        np.testing.assert_array_equal(np.array([f for _, f in rung0], np.float32), batched)

        genes, promoted = rung1[0]
        port_cnn._WARM_BANK.clear()
        for rung in CNN_LADDER:
            replay = port.GeneticCnnModel(x, y, genes, **{**CNN, **rung}).cross_validate()
        assert replay == promoted
    finally:
        port_cnn._WARM_BANK.clear()
        torch.set_num_threads(torch_threads)
