"""The executor's and the train step's phases as telemetry spans and profiler ranges, on the CPU.

A CV call with spans on gives one ``cv_call`` span over its ``setup``,
``init_draw``, ``upload``, ``fold_load``, ``train``, ``eval`` and ``fetch``
spans; ``init_draw`` carries its ``streams``, ``elements`` and
``draw_threads``, and each ``train`` span its steps' ``forward_s``,
``backward_s`` and ``update_s``.  Under ``torch.profiler`` every span is also a
``gentun.<kind>`` range that starts where the span's ``t_wall`` says, and
each step phase a ``gentun.<phase>`` range.  With spans off nothing of this
runs, and the fitnesses are the same bits either way.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gentun_tpu_torch.genes import genetic_cnn_genome
from gentun_tpu_torch.models.cnn import GeneticCnnModel
from gentun_tpu_torch.telemetry import spans

#: 192 rows in 2 folds: 96 train rows, 3 steps of 32 a fold, in segments
#: of 2 and 1 steps.
CFG = dict(nodes=(3,), kernels_per_layer=(4,), kfold=2, epochs=(1,), learning_rate=(0.05,),
           batch_size=32, dense_units=16, dropout_rate=0.5, compute_dtype="float32", seed=3,
           segment_steps=2, mesh="cpu")
EXECUTOR = {"setup", "init_draw", "upload", "fold_load", "train", "eval", "fetch"}


@pytest.fixture(autouse=True)
def _one_thread_spans_off_after():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    spans.disable()
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(192, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 4, size=192).astype(np.int32)
    rng = np.random.default_rng(1)
    genomes = [genetic_cnn_genome((3,)).sample(rng) for _ in range(3)]
    return x, y, genomes


def _call(data, on: bool):
    """The fitnesses of one call and the span records it emitted."""
    x, y, genomes = data
    (spans.enable if on else spans.disable)()
    with spans.capture() as records:
        fit = GeneticCnnModel.cross_validate_population(x, y, genomes, **CFG)
    return np.asarray(fit), records


def test_a_call_gives_the_executor_span_tree(data):
    _, records = _call(data, on=True)
    (call,) = [r for r in records if r["kind"] == "cv_call"]
    # 3 genomes pad to bucket 4; no ``reserved_bytes`` off a CUDA device
    assert call["attrs"] == {"pop": 4, "n_real": 3, "kfold": 2}
    children = [r for r in records if r is not call]
    assert {r["kind"] for r in children} == EXECUTOR
    assert all(r["parent_id"] == call["span_id"] and r["trace_id"] == call["trace_id"]
               for r in children)
    count = {k: sum(r["kind"] == k for r in children) for k in EXECUTOR}
    # 96 train rows of 32 a step: 3 steps a fold in segments of 2 and 1
    assert count == {"setup": 1, "init_draw": 1, "upload": 1, "fold_load": 2, "train": 4,
                     "eval": 2, "fetch": 1}
    trains = [r for r in children if r["kind"] == "train"]
    assert sorted(r["attrs"]["steps"] for r in trains) == [1, 1, 2, 2]
    for r in trains:
        phases = [r["attrs"][f"{p}_s"] for p in ("forward", "backward", "update")]
        assert all(s > 0 for s in phases)
        assert sum(phases) <= r["dur_s"]
    assert sum(r["dur_s"] for r in children) <= call["dur_s"]


def test_the_init_draw_span_carries_its_streams_elements_and_threads(data):
    """``streams``: kfold × the 4 slots; ``elements``: each stream's weights,
    36 + 3·144 (3×3 convs, 1 → 4 and 4 → 4 channels) + 64·16 + 16·4 (the
    dense layers after the 2×2 pool); ``draw_threads`` 1: streams of 1,556
    weights stay on the calling thread."""
    _, records = _call(data, on=True)
    (draw,) = [r for r in records if r["kind"] == "init_draw"]
    assert draw["attrs"] == {"streams": 8, "elements": 8 * 1556, "draw_threads": 1}


def test_fitnesses_are_the_same_bits_with_spans_on_and_off(data):
    off, records = _call(data, on=False)
    on, _ = _call(data, on=True)
    assert records == []
    assert off.tobytes() == on.tobytes()


@pytest.mark.parametrize("spans_on, profiled", [(False, True), (True, False)],
                         ids=["spans-off-profiled", "spans-on-unprofiled"])
def test_no_range_opens_without_both_spans_and_a_profiler(data, monkeypatch, spans_on, profiled):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"a range opened: {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    if not spans_on:
        assert spans.span("train") is spans.span("cv_call")  # the no-op singleton
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            _call(data, on=spans_on)
    else:
        _call(data, on=spans_on)


def test_every_span_is_a_range_on_the_same_clock(data):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, records = _call(data, on=True)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("gentun.") and "CPU" in str(e.device_type()):
            ranges.setdefault(e.name()[len("gentun."):], []).append(e.start_ns())
    kinds = {r["kind"] for r in records}
    assert kinds == EXECUTOR | {"cv_call"}
    for kind in kinds:
        walls = sorted(r["t_wall"] for r in records if r["kind"] == kind)
        starts = sorted(ranges.get(kind, []))
        assert len(starts) == len(walls), kind
        for wall, start in zip(walls, starts):
            assert abs(wall - start * 1e-9) < 1e-3, (kind, wall - start * 1e-9)
    steps = sum(r["attrs"]["steps"] for r in records if r["kind"] == "train")
    assert {p: len(ranges.get(p, [])) for p in ("forward", "backward", "update")} == dict.fromkeys(
        ("forward", "backward", "update"), steps)


def test_train_spans_on_the_cpu_replay_nothing(data):
    """The CPU steps eagerly: every ``train`` span carries ``graph_steps``,
    ``captures``, ``fallbacks`` and ``graph_skips`` 0 and ``replay_s`` 0, no
    ``gentun.replay`` range opens, and the phase ranges still count the steps."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, records = _call(data, on=True)
    trains = [r["attrs"] for r in records if r["kind"] == "train"]
    assert trains and all(a["graph_steps"] == 0 and a["captures"] == 0 and a["fallbacks"] == 0
                          and a["graph_skips"] == 0 and a["replay_s"] == 0.0 for a in trains)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    steps = sum(a["steps"] for a in trains)
    assert {p: names.count(f"gentun.{p}") for p in ("forward", "backward", "update", "replay")} \
        == {"forward": steps, "backward": steps, "update": steps, "replay": 0}


@pytest.mark.card
def test_a_call_on_the_card_gives_its_reserved_bytes(data):
    """On a CUDA card the ``cv_call`` span carries the allocator's reserved
    bytes at the call's end; the CPU test above shows it absent there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y, genomes = data
    spans.enable()
    with spans.capture() as records:
        GeneticCnnModel.cross_validate_population(x, y, genomes, **{**CFG, "mesh": "auto"})
    (call,) = [r for r in records if r["kind"] == "cv_call"]
    assert call["attrs"]["reserved_bytes"] > 0
    assert call["attrs"]["reserved_bytes"] == int(call["attrs"]["reserved_bytes"])
