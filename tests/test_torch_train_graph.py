"""The train step as one CUDA graph per CV call (``models/cnn.py::_StepGraph``).

On the CPU: which calls engage the graph (a single-card CUDA call of 3
steps or more; never the CPU, a mesh or a shorter call), that the fold
state the graph needs (momentum zeroed in place, dropout generators
re-seeded in place, the learning rate a 0-dim tensor in the update) gives
the same bits as fresh state each fold, the launch accounting of a
capture, and that a program whose capture failed builds no graph again.
Marked ``card`` (``python -m pytest tests/test_torch_train_graph.py -m
card`` on a machine with a CUDA card; they skip elsewhere): the graph
against the eager step, bit for bit, concurrent captures (with and
without telemetry), a failed capture and the planted faults.
"""

import contextlib
import threading
import weakref

import numpy as np
import pytest
import torch

from gentun_tpu_torch.genes import genetic_cnn_genome
from gentun_tpu_torch.models import cnn as port_cnn
from gentun_tpu_torch.models.cnn import GeneticCnnModel
from gentun_tpu_torch.ops import _build, pop_conv
from gentun_tpu_torch.parallel.mesh import Mesh
from gentun_tpu_torch.telemetry import spans

#: 192 rows in 2 folds: 96 train rows, 3 steps of 32 a fold, two epoch
#: groups so the learning rate changes inside a fold.
CPU_CFG = dict(nodes=(3, 4), kernels_per_layer=(4, 4), kfold=2, epochs=(1, 2),
               learning_rate=(0.05, 0.01), batch_size=32, dense_units=16, dropout_rate=0.5,
               compute_dtype="float32", seed=11, segment_steps=2, mesh="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _data(n, shape, n_classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, *shape)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    return x, y


def _genomes(nodes, n, seed):
    rng = np.random.default_rng(seed)
    spec = genetic_cnn_genome(nodes)
    return [spec.sample(rng) for _ in range(n)]


# ---------------------------------------------------------------------------
# CPU: the engagement rule, the fold state, the launch accounting
# ---------------------------------------------------------------------------


def _mesh(data_axis):
    return Mesh(1, data_axis, 0, torch.device("cuda", 0), object() if data_axis > 1 else None)


@pytest.mark.parametrize("device, mesh, steps, engaged", [
    ("cpu", None, 38, False),
    ("cuda", "data", 38, False),
    ("cuda", "pop", 38, False),
    ("cuda", None, 1, False),
    ("cuda", None, 2, False),
    ("cuda", None, 3, True),
    ("cuda", None, 38, True),
], ids=["cpu", "mesh-data-group", "mesh-pop-only", "cuda-1-step", "cuda-2-steps",
        "cuda-3-steps", "cuda-38-steps"])
def test_the_graph_engages_on_a_single_card_call_of_three_steps_or_more(device, mesh, steps,
                                                                         engaged):
    mesh = {None: None, "data": _mesh(2), "pop": _mesh(1)}[mesh]
    assert port_cnn._graph_eligible(torch.device(device), mesh, steps) is engaged


def test_a_cpu_call_asks_with_all_its_steps_and_stays_eager(monkeypatch):
    """The executor asks the rule with the device, the mesh and the steps of
    every fold, and on the CPU builds no graph."""
    asked = []
    real = port_cnn._graph_eligible

    def spy(device, mesh, steps):
        asked.append((device.type, mesh, steps))
        return real(device, mesh, steps)

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call built a step graph")

    monkeypatch.setattr(port_cnn, "_graph_eligible", spy)
    monkeypatch.setattr(port_cnn, "_StepGraph", refuse)
    x, y = _data(192, (8, 8, 1), 4, seed=0)
    GeneticCnnModel.cross_validate_population(x, y, _genomes((3, 4), 3, seed=1), **CPU_CFG)
    assert asked == [("cpu", None, 2 * 9)]  # 2 folds × 3 epochs × 3 steps


def test_a_program_whose_capture_failed_builds_no_graph_again(monkeypatch):
    """An eligible call looks its program, (``_oom_cap_key``, pop), up
    among those whose capture raised once, and builds no graph if it is
    there."""
    asked = []

    class Failed(set):
        def __contains__(self, key):
            asked.append(key)
            return True

    def refuse(*args, **kwargs):
        raise AssertionError("a step graph was built for a program whose capture failed")

    monkeypatch.setattr(port_cnn, "_graph_eligible", lambda *args: True)
    monkeypatch.setattr(port_cnn, "_NO_GRAPH", Failed())
    monkeypatch.setattr(port_cnn, "_StepGraph", refuse)
    x, y = _data(192, (8, 8, 1), 4, seed=0)
    GeneticCnnModel.cross_validate_population(x, y, _genomes((3, 4), 3, seed=1), **CPU_CFG)
    cfg = port_cnn._normalize_config(x, y, CPU_CFG)
    assert len(asked) == 1 and asked[0][0] == port_cnn._oom_cap_key(cfg)
    assert asked[0][1] >= 3  # the program's pop, padding included


class _HeldGraph:
    def __init__(self, last):
        self.last = last


def test_release_step_graphs_drops_every_threads_last_graph(monkeypatch):
    monkeypatch.setattr(port_cnn, "_ALL_THREAD_GRAPHS", weakref.WeakSet())
    held = [_HeldGraph(object()), _HeldGraph(None), _HeldGraph(object())]
    for h in held:
        port_cnn._ALL_THREAD_GRAPHS.add(h)
    assert port_cnn._release_step_graphs() is True
    assert [h.last for h in held] == [None, None, None]
    assert port_cnn._release_step_graphs() is False


@pytest.mark.parametrize("ooms, calls, cap", [(1, [8, 8], None), (2, [8, 8, 4, 4], 4)],
                         ids=["the-freed-pools-were-enough", "still-out-of-memory"])
def test_an_oom_beside_held_graph_pools_frees_them_before_a_cap_is_learned(monkeypatch, ooms,
                                                                           calls, cap):
    """An OOM while a thread holds its last graph's pool frees the pools and
    runs the same population again before it learns a cap, once."""
    freed = []
    monkeypatch.setattr(port_cnn, "_release_step_graphs", lambda: not freed and not freed.append(1))
    seen, key = [], ("test-held-graph-pools", ooms)

    def run(genomes):
        seen.append(len(genomes))
        if len(seen) <= ooms:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return np.ones(len(genomes), dtype=np.float32)

    try:
        out = port_cnn._chunked_by_cap(run, [{}] * 8, key)
        assert out.tolist() == [1.0] * 8 and seen == calls and freed == [1]
        assert port_cnn._POP_PROGRAM_CAP.get(key) == cap
    finally:
        port_cnn._POP_PROGRAM_CAP.pop(key, None)


def _fresh_state_run_segmented(record):
    """The executor's fold loop as it was before the step graph: fresh
    momentum buffers (``zeros_like``) and fresh dropout generators each
    fold, the learning rate a Python float, the update ``p + u·(−lr)``.
    Records the params and momentum buffers at each fold's eval."""

    def old_step(model, masks, x_full, y_full, idx, gens, momentum_bufs, lr, momentum, nesterov,
                 microbatch):
        params = list(model.parameters())
        grads = None
        for im in idx.view(microbatch, -1):
            logits = model(x_full.index_select(0, im), masks, dropout_gens=gens)
            loss = port_cnn._per_genome_loss(logits, y_full.index_select(0, im)).sum()
            g = torch.autograd.grad(loss, params)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
        with torch.no_grad():
            for p, g, t in zip(params, grads, momentum_bufs):
                if microbatch > 1:
                    g = g / microbatch
                t.mul_(momentum).add_(g)
                update = g + momentum * t if nesterov else t
                p.add_(update * -lr)

    def run(cfg, model, masks, params, hashes, x_full, y_full, val_idx, val_weight, batch_idx,
            steps_per_epoch, eval_batch_size, domain=0, warm_keys=None, mesh=None,
            batch_rows=None):
        assert mesh is None and warm_keys is None
        device = x_full.device
        lr_at = port_cnn._lr_schedule(cfg["epochs"], cfg["learning_rate"], steps_per_epoch)
        named = dict(model.named_parameters())
        accs = []
        for f in range(batch_idx.shape[0]):
            with torch.no_grad():
                for name, p in named.items():
                    p.copy_(params[name][f])
            bufs = [torch.zeros_like(p) for p in named.values()]
            gens = (port_cnn._dropout_generators(cfg["seed"], f, hashes, device, domain)
                    if cfg["dropout_rate"] > 0.0 else None)
            bidx = torch.as_tensor(batch_idx[f], device=device)
            with port_cnn.exact_numerics():
                for t in range(batch_idx.shape[1]):
                    old_step(model, masks, x_full, y_full, bidx[t], gens, bufs, lr_at(t),
                             cfg["momentum"], cfg["nesterov"], int(cfg["microbatch"]))
            record.append(({n: p.detach().clone() for n, p in named.items()},
                           [b.clone() for b in bufs]))
            vi = torch.as_tensor(val_idx[f], device=device)
            vw = torch.as_tensor(val_weight[f], device=device)
            accs.append(port_cnn._eval_fold(model, masks, x_full, y_full, vi, vw,
                                            eval_batch_size))
        return torch.stack(accs).cpu().numpy().astype(np.float32)

    return run


def _recording_fold_state(monkeypatch, record):
    """Record the params and momentum buffers the executor holds at each
    fold's eval: the buffers are the list every step of the call is given."""
    real_step, real_eval, bufs = port_cnn._train_step, port_cnn._eval_fold, []

    def step(model, masks, x, y, idx, gens, momentum_bufs, *rest, **kwargs):
        bufs[:] = [momentum_bufs]
        return real_step(model, masks, x, y, idx, gens, momentum_bufs, *rest, **kwargs)

    def eval_fold(model, *args, **kwargs):
        record.append(({n: p.detach().clone() for n, p in model.named_parameters()},
                       [b.clone() for b in bufs[0]]))
        return real_eval(model, *args, **kwargs)

    monkeypatch.setattr(port_cnn, "_train_step", step)
    monkeypatch.setattr(port_cnn, "_eval_fold", eval_fold)


@pytest.mark.parametrize("extra", [{}, {"microbatch": 2, "nesterov": True}, {"dropout_rate": 0.0}],
                         ids=["plain", "microbatch-2-nesterov", "no-dropout"])
def test_in_place_fold_state_gives_the_bits_of_fresh_state(monkeypatch, extra):
    """Momentum zeroed in place, generators re-seeded in place and the
    learning rate a 0-dim tensor give the params, the momentum buffers and
    the fitness of fresh state every fold, bit for bit."""
    x, y = _data(192, (8, 8, 1), 4, seed=2)
    genomes, cfg = _genomes((3, 4), 3, seed=3), {**CPU_CFG, **extra}
    new, old = [], []
    with monkeypatch.context() as m:
        _recording_fold_state(m, new)
        fit_new = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
    with monkeypatch.context() as m:
        m.setattr(port_cnn, "_run_segmented", _fresh_state_run_segmented(old))
        fit_old = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
    assert np.asarray(fit_new).tobytes() == np.asarray(fit_old).tobytes()
    assert len(new) == len(old) == 2
    for (p_new, b_new), (p_old, b_old) in zip(new, old):
        for name in p_old:
            torch.testing.assert_close(p_new[name], p_old[name], rtol=0, atol=0, msg=name)
        for a, b in zip(b_new, b_old):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_the_update_takes_a_tensor_learning_rate_to_the_same_bits():
    """``p − u·lr`` with lr a 0-dim float32 tensor is ``p + u·(−lr)`` with
    lr a float, including signed zeros."""
    gen = torch.Generator().manual_seed(0)
    p = torch.randn(4096, generator=gen) * torch.logspace(-30, 30, 4096)
    u = torch.randn(4096, generator=gen) * torch.logspace(30, -30, 4096)
    p[:4], u[:4] = torch.tensor([0.0, -0.0, 0.0, -0.0]), torch.tensor([0.0, 0.0, -0.0, -0.0])
    for lr in (0.05, float(np.float32(0.01)), 1e-4):
        want = p.clone().add_(u * -lr)
        got = p.clone().sub_(u * torch.tensor(lr, dtype=torch.float32))
        assert got.numpy().tobytes() == want.numpy().tobytes(), lr


def test_a_capture_records_its_launches_and_a_replay_counts_them(monkeypatch):
    """Launches on the stream being captured are recorded, not counted; on
    other streams they count; each replay adds the record."""
    stream = {"now": 7}
    monkeypatch.setattr(_build, "_current_stream", lambda: stream["now"])
    before = dict(_build.LAUNCHES)
    with _build.recording_launches() as rec:
        _build.count_launch("pop_conv3x3_fwd")
        _build.count_launch("pop_conv3x3_fwd")
        _build.count_launch("pop_dag_node_grad")
        stream["now"] = 8  # another thread's eager work on another stream
        _build.count_launch("pop_conv3x3_wgrad")
        stream["now"] = 7
    assert rec == {"pop_conv3x3_fwd": 2, "pop_dag_node_grad": 1}
    assert _build._recording == {}
    delta = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert delta == {**dict.fromkeys(before, 0), "pop_conv3x3_wgrad": 1}
    for _ in range(3):
        _build.add_launches(rec)
    delta = {k: _build.LAUNCHES[k] - before[k] for k in before}
    assert delta == {**dict.fromkeys(before, 0), "pop_conv3x3_fwd": 6, "pop_dag_node_grad": 3,
                     "pop_conv3x3_wgrad": 1}


def test_the_oom_path_empties_the_cache_only_when_nothing_is_captured(monkeypatch):
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    port_cnn._empty_cache()
    monkeypatch.setattr(port_cnn, "_captures_underway", 1)
    port_cnn._empty_cache()
    assert emptied == [1]


# ---------------------------------------------------------------------------
# The card: graph against eager, threads, a failed capture, the faults
# ---------------------------------------------------------------------------

#: Config #2 at the paper's widths, cut to 4 steps a fold.
C2 = dict(nodes=(3, 4, 5), kernels_per_layer=(8, 16, 32), kfold=2, epochs=(1,),
          learning_rate=(0.01,), batch_size=256, dense_units=500, dropout_rate=0.5,
          momentum=0.9, compute_dtype="bfloat16", seed=2024)


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@contextlib.contextmanager
def _train_spans():
    """Telemetry on in the block; yields a list that holds the ``train``
    spans' attributes once the block ends."""
    trains = []
    spans.enable()
    try:
        with spans.capture() as records:
            yield trains
    finally:
        spans.disable()
    trains.extend(r["attrs"] for r in records if r["kind"] == "train")


def _sums(trains, *keys):
    return tuple(sum(a[k] for a in trains) for k in keys)


class _Masks:
    """Each step's dropout keep masks, read from device buffers the step
    writes (the same writes captured into the graph): one buffer per
    micro-slice, cloned after every eager step and every replay."""

    def __init__(self):
        self.steps, self.bufs, self._n = [], [], 0

    def dropout(self, x, rate, gens, batch_rows=None):
        keep_prob = 1.0 - rate
        keep = torch.stack([torch.rand(x.shape[1:], generator=g, device=x.device) < keep_prob
                            for g in gens])
        if len(self.bufs) <= self._n:
            self.bufs.append(torch.empty_like(keep))
        self.bufs[self._n].copy_(keep)
        self._n += 1
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))

    def step_done(self):
        self.steps.append(torch.stack([b.clone() for b in self.bufs]))
        self._n = 0


@contextlib.contextmanager
def _recording(monkeypatch, masks, record):
    """Record the dropout masks of every step and the params and momentum
    buffers at each fold's eval."""
    real_replay = port_cnn._StepGraph.replay
    with monkeypatch.context() as m:
        _recording_fold_state(m, record)
        real_step = port_cnn._train_step

        def step(*args, **kwargs):
            real_step(*args, **kwargs)
            if not torch.cuda.is_current_stream_capturing():
                masks.step_done()
            else:
                masks._n = 0

        def replay(self, idx, lr):
            real_replay(self, idx, lr)
            masks.step_done()

        m.setattr(port_cnn, "_dropout", masks.dropout)
        m.setattr(port_cnn, "_train_step", step)
        m.setattr(port_cnn._StepGraph, "replay", replay)
        yield


@pytest.mark.card
@pytest.mark.parametrize("pop, microbatch", [(20, 1), (2, 2)], ids=["c2-p20", "p2-microbatch-2"])
def test_the_graph_gives_the_eager_bits(card, monkeypatch, pop, microbatch):
    """A 2-fold call with the graph and the same call eager: the same params
    and momentum buffers at each fold's end, the same dropout masks in every
    step of both folds, the same fitness."""
    x, y = _data(2048, (32, 32, 3), 10, seed=5)  # 4 steps a fold
    genomes, cfg = _genomes(C2["nodes"], pop, seed=6), {**C2, "microbatch": microbatch}
    runs = {}
    for graph in (True, False):
        masks, record = _Masks(), []
        with monkeypatch.context() as m:
            if not graph:
                m.setattr(port_cnn, "_graph_eligible", lambda *a: False)
            with _recording(m, masks, record), _train_spans() as trains:
                fit = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
        assert _sums(trains, "captures", "graph_steps", "fallbacks") == (
            (1, 7, 0) if graph else (0, 0, 0))
        runs[graph] = fit, masks.steps, record
    (fit_g, masks_g, rec_g), (fit_e, masks_e, rec_e) = runs[True], runs[False]
    assert len(masks_g) == len(masks_e) == 8
    for t, (a, b) in enumerate(zip(masks_g, masks_e)):
        assert torch.equal(a, b), f"dropout masks of step {t}"
    for (p_g, b_g), (p_e, b_e) in zip(rec_g, rec_e):
        for name in p_e:
            assert torch.equal(p_g[name], p_e[name]), name
        assert all(torch.equal(a, b) for a, b in zip(b_g, b_e))
    assert np.asarray(fit_g).tobytes() == np.asarray(fit_e).tobytes()
    # the recording dropout is the executor's own: the same bits unrecorded
    plain = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
    assert np.asarray(plain).tobytes() == np.asarray(fit_g).tobytes()


def _call(x, y, genomes, **extra):
    return np.asarray(GeneticCnnModel.cross_validate_population(x, y, genomes,
                                                                **{**C2, **extra}))


@pytest.mark.card
@pytest.mark.parametrize("telemetry", [False, True], ids=["spans-off", "spans-on"])
def test_two_threads_capture_at_once_beside_an_eager_call(card, monkeypatch, telemetry):
    """Two evaluation threads capture their graphs at the same moment while
    a third steps eagerly and starts its first eval then; each gets the
    fitness it gets alone.  With telemetry on, the eager thread's spans
    wait for its stream while the others capture."""
    x, y = _data(2048, (32, 32, 3), 10, seed=7)
    short = _data(512, (32, 32, 3), 10, seed=8)  # 1 step a fold: eager
    jobs = [(x, y, _genomes(C2["nodes"], 4, seed=s)) for s in (9, 10)]
    jobs.append((*short, _genomes(C2["nodes"], 4, seed=11)))
    alone = [_call(*job) for job in jobs]
    barrier = threading.Barrier(3, timeout=120)
    real_record, real_eval, real_capture = (_build.recording_launches, port_cnn._eval_fold,
                                            port_cnn._StepGraph._capture)
    took, took_eval = [], []

    @contextlib.contextmanager
    def at_once():
        barrier.wait()
        with real_record() as rec:
            yield rec

    def eval_fold(*args, **kwargs):
        if threading.current_thread().name == "eager" and not took_eval:
            took_eval.append(1)
            barrier.wait()
        return real_eval(*args, **kwargs)

    def capture(self, *args):
        took.append(real_capture(self, *args))
        return took[-1]

    monkeypatch.setattr(_build, "recording_launches", at_once)
    monkeypatch.setattr(port_cnn, "_eval_fold", eval_fold)
    monkeypatch.setattr(port_cnn._StepGraph, "_capture", capture)
    out, errors = [None] * 3, []

    def run(i):
        try:
            out[i] = _call(*jobs[i])
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,), name=("graph", "graph", "eager")[i])
               for i in range(3)]
    (spans.enable if telemetry else spans.disable)()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        spans.disable()
    assert not errors, errors
    assert took == [True, True]
    for got, want in zip(out, alone):
        assert got.tobytes() == want.tobytes()


@pytest.mark.card
@pytest.mark.parametrize("where", ["_train_step", "_per_genome_loss"],
                         ids=["before-the-step", "after-the-dropout-draws"])
def test_a_failed_capture_steps_eagerly_to_the_same_fitness(card, monkeypatch, caplog, where):
    """A capture that raises, before the step or once its dropout draws are
    captured, leaves the call to step eagerly to the graph's fitness, with
    one warning; later calls of that program step eagerly without trying
    again, and another program still captures."""
    monkeypatch.setattr(port_cnn, "_NO_GRAPH", set())
    x, y = _data(2048, (32, 32, 3), 10, seed=12)
    genomes = _genomes(C2["nodes"], 4, seed=13)
    want = _call(x, y, genomes)
    port_cnn._NO_GRAPH.clear()
    real = getattr(port_cnn, where)

    def failing(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise torch.cuda.OutOfMemoryError("forced in the capture")
        return real(*args, **kwargs)

    def warnings():
        return [r for r in caplog.records if "graph capture failed" in r.getMessage()]

    with monkeypatch.context() as m, _train_spans() as trains:
        m.setattr(port_cnn, where, failing)
        got = _call(x, y, genomes)
    assert _sums(trains, "captures", "graph_steps", "fallbacks") == (0, 0, 1)
    assert len(warnings()) == 1
    assert got.tobytes() == want.tobytes()
    with _train_spans() as trains:
        again = _call(x, y, genomes)
    assert _sums(trains, "captures", "graph_steps", "fallbacks") == (0, 0, 0)
    assert len(warnings()) == 1
    assert again.tobytes() == want.tobytes()
    with _train_spans() as trains:
        _call(x, y, genomes[:2])  # pop 2: another program
    assert _sums(trains, "captures", "fallbacks") == (1, 0)


@pytest.mark.card
@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_a_planted_fault_still_acts_with_the_graph_engaged(card, fault):
    from benchmark import faults

    x, y = _data(2048, (32, 32, 3), 10, seed=14)
    genomes = _genomes(C2["nodes"], 4, seed=15)
    sound = _call(x, y, genomes)
    spans.enable()
    try:
        with spans.capture() as records, faults.planted(fault, 10):
            broken = _call(x, y, genomes)
    finally:
        spans.disable()
    trains = [r["attrs"] for r in records if r["kind"] == "train"]
    assert sum(a["captures"] for a in trains) == 1
    assert sum(a["graph_steps"] for a in trains) == sum(a["steps"] for a in trains) - 1
    assert broken.tobytes() != sound.tobytes()


@pytest.mark.card
def test_threads_launch_the_kernels_at_other_shapes_at_once(card):
    """Eight threads launch the bf16 forward and weight gradient at once,
    each going round shapes of other shared-memory sizes: every launch runs
    (a kernel's shared-memory limit only rises, so no thread lowers it
    under another's launch) and gives the bits it gives alone."""
    gen = torch.Generator().manual_seed(0)
    cases = []
    for b, c, hw in ((32, 16, 32), (256, 16, 8), (8, 128, 16)):
        x = torch.randn(b, 2 * c, hw, hw, generator=gen).to("cuda", torch.bfloat16)
        w = (0.1 * torch.randn(2, 16, c, 3, 3, generator=gen)).to("cuda", torch.bfloat16)
        dy = torch.randn(b, 2 * 16, hw, hw, generator=gen).to("cuda", torch.bfloat16)
        cases.append((x, w, dy))

    def both(x, w, dy):
        return (pop_conv.pop_conv3x3_fwd(x, w), *pop_conv.pop_conv3x3_wgrad(x, dy, w.shape))

    alone = [both(*case) for case in cases]
    errors, wrong = [], []

    def run(k):
        try:
            for i in range(600):
                j = (i + k) % len(cases)
                got = both(*cases[j])
                if i % 100 == 0 and not all(map(torch.equal, got, alone[j])):
                    wrong.append((k, i, j))
            torch.cuda.current_stream().synchronize()
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert not wrong, wrong
