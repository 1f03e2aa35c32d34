"""The system's phases in a profile and in its spans (``phases.py``), and the
readers of the phase metrics, on made-up events and runs; and the
timeline reduction's readings unchanged by the system's ``gentun.*`` ranges."""

import numpy as np
import pytest

from benchmark import devtrace, phases
from benchmark.cell import _load_module
from benchmark.record import Call, Run
from benchmark.tests.conftest import ROOT

US = 1000  # ns


class _Event:
    """A profiler event with what ``devtrace`` and ``phases`` read."""

    def __init__(self, name, start, end, device=False, thread=1, kind="cpu_op", corr=0):
        self._v = (name, start, end, device, thread, kind, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5] == "user_annotation"

    def activity_type(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]


def _range(kind, start, end, thread=1):
    return _Event("gentun." + kind, start * US, end * US, thread=thread, kind="user_annotation")


def _kernel(name, start, end, corr):
    return _Event(name, start * US, end * US, device=True, thread=7, kind="kernel", corr=corr)


def _launch(start, corr, thread=1):
    return _Event("cudaLaunchKernel", start * US, (start + 2) * US, thread=thread,
                  kind="cuda_runtime", corr=corr)


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def _step():
    """One marked call, 0–200 µs: set-up, one train step (forward, backward
    launched from autograd's thread 2, update) and a fetch, with the
    device busy 40–60, 90–100 (the backward's kernel) and 130–140.  A cpu
    op shares correlation id 5 with nothing that launched."""
    return [
        _Event(devtrace.MARK, 0, 200 * US, kind="user_annotation"),
        _Event(devtrace.MARK, 0, 200 * US, device=True, kind="gpu_user_annotation"),
        _range("cv_call", 0, 190),
        _range("setup", 5, 30),
        _range("train", 35, 150),
        _range("forward", 36, 70),
        _range("backward", 70, 120),
        _range("update", 120, 145),
        _range("fetch", 160, 185),
        _range("eval", 150, 155),
        _Event("gentun.train", 35 * US, 150 * US, device=True, kind="gpu_user_annotation"),
        _Event("aten::mm", 38 * US, 45 * US, corr=5),
        _launch(39, corr=11),
        _kernel("fwd_bf16_kernel", 40, 60, corr=11),
        _Event("autograd::engine::evaluate_function", 75 * US, 110 * US, thread=2),
        _launch(80, corr=12, thread=2),  # the backward, from autograd's thread
        _kernel("wgrad_bf16_kernel", 90, 100, corr=12),
        _launch(125, corr=13),
        _kernel("Memset (Device)", 130, 140, corr=13),
        _launch(165, corr=14),  # the fetch's copy, outside any train range
        _kernel("Memcpy DtoH", 170, 175, corr=14),
        _kernel("orphan_kernel", 141, 142, corr=5),  # id 5 is a cpu op's, not a launch's
    ]


def test_idle_gaps_go_to_the_innermost_phase_range_on_any_thread():
    gaps = phases.phase_gaps(_step())
    # idle: 0–40 (mid 20: setup), 60–90 (mid 75: backward, whose launches
    # come from thread 2 inside the caller's range), 100–130 (mid 115:
    # backward), 140–141 (update), 142–170 (mid 156: cv_call, between eval
    # and fetch), 175–200 (mid 187.5: cv_call), none outside
    assert gaps == {"setup": (1, pytest.approx(40e-6)),
                    "backward": (2, pytest.approx(60e-6)),
                    "update": (1, pytest.approx(1e-6)),
                    "cv_call": (2, pytest.approx(53e-6))}
    tl = devtrace.reduce(_Prof(_step()))
    assert sum(s for _, s in gaps.values()) == pytest.approx(tl.window_s - tl.busy_s)


def test_gaps_in_no_range_are_outside():
    events = [_Event(devtrace.MARK, 0, 100 * US, kind="user_annotation"),
              _range("cv_call", 10, 50), _kernel("k", 30, 70, corr=1)]
    assert phases.phase_gaps(events) == {"cv_call": (1, pytest.approx(30e-6)),
                                         "outside": (1, pytest.approx(30e-6))}
    assert phases.phase_gaps(events[1:]) == {}  # no marked call, no window


def test_train_launches_count_by_correlation_id():
    # the forward's and the backward's kernels and the update's set, not the
    # fetch's copy (launched outside) nor the kernel whose id is a cpu op's
    assert phases.train_launches(_step()) == (3, 1)
    two = _step() + [_range("update", 146, 148), _launch(147, corr=15),
                     _kernel("k", 149, 150, corr=15)]
    assert phases.train_launches(two) == (4, 2)


def test_launches_go_to_the_innermost_range_of_their_launching_call():
    assert phases.phase_launches(_step()) == {"forward": 1, "backward": 1, "update": 1,
                                              "fetch": 1}


def test_the_view_of_a_profile():
    v = phases.view(_Prof(_step()))
    assert v["launches_per_step"] == 3.0 and v["steps"] == 1
    assert v["idle_phases"][0] == ["backward (x2)", pytest.approx(60e-6)]
    assert v["idle_s"] == pytest.approx(154e-6)


def test_the_timeline_reads_the_same_with_and_without_the_system_ranges():
    with_ranges = devtrace.reduce(_Prof(_step()))
    without = devtrace.reduce(_Prof([e for e in _step()
                                     if not e.name().startswith(phases.PREFIX)]))
    assert with_ranges == without
    assert devtrace.breakdown(with_ranges) == devtrace.breakdown(without)
    assert not any(k.startswith(phases.PREFIX) for k in with_ranges.gaps)


def test_a_real_profile_reads_the_same_with_and_without_the_system_ranges():
    """On a CPU profile of a small call with spans on, the ranges the system
    opens are annotations: dropping them changes no reading."""
    import torch

    from gentun_tpu_torch.genes import genetic_cnn_genome
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.telemetry import spans

    rng = np.random.default_rng(0)
    x = rng.normal(size=(96, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 4, size=96).astype(np.int32)
    genomes = [genetic_cnn_genome((3,)).sample(rng) for _ in range(2)]
    spans.enable()
    try:
        with devtrace.profiler() as prof, torch.profiler.record_function(devtrace.MARK):
            GeneticCnnModel.cross_validate_population(
                x, y, genomes, nodes=(3,), kernels_per_layer=(4,), kfold=2, epochs=(1,),
                learning_rate=(0.05,),
                batch_size=16, dense_units=8, compute_dtype="float32", mesh="cpu")
    finally:
        spans.disable()
    events = prof.profiler.kineto_results.events()
    mine = [e for e in events if e.name().startswith(phases.PREFIX)]
    assert {e.name() for e in mine} >= {"gentun.cv_call", "gentun.train", "gentun.forward"}
    assert all(devtrace._annotation(e) for e in mine)
    others = [e for e in events if not e.name().startswith(phases.PREFIX)]
    assert devtrace.reduce(_Prof(events)) == devtrace.reduce(_Prof(others))


def _run(spans):
    call = Call(start=10.0, end=12.0, genomes=[{}] * 4, fitness=np.zeros(4), spans=spans)
    later = Call(start=12.5, end=14.5, genomes=[{}] * 4, fitness=np.zeros(4), spans=spans)
    return Run(config={}, traffic={}, seed=0, setup_s=1.0, calls=[call, later],
               x=None, y=None, call_seed=0)


def _read(metric, run):
    return _load_module(f"{ROOT}/benchmark", "metrics", metric).read(run)


def test_the_phase_readers_on_a_synthetic_run():
    spans = [
        {"kind": "cv_call", "dur_s": 1.9},
        {"kind": "init_draw", "dur_s": 0.3},
        {"kind": "train", "dur_s": 0.6, "attrs": {"steps": 20, "forward_s": 0.2,
                                                   "backward_s": 0.3, "update_s": 0.08}},
        {"kind": "train", "dur_s": 0.3, "attrs": {"steps": 10, "forward_s": 0.1,
                                                   "backward_s": 0.12, "update_s": 0.05}},
        {"kind": "eval", "dur_s": 0.2, "attrs": {"pop": 20}},
    ]
    run = _run(spans)
    assert _read("init_draw_share", run) == pytest.approx(100.0 * 0.6 / 4.0)
    assert _read("step_forward_ms", run) == pytest.approx(10.0)  # 0.6 s over 60 steps
    assert _read("step_backward_ms", run) == pytest.approx(14.0)
    assert _read("step_update_ms", run) == pytest.approx(13.0 / 3.0)
    assert (_read("step_forward_ms", run) + _read("step_backward_ms", run)
            + _read("step_update_ms", run)) <= _read("train_step_ms", run)


@pytest.mark.parametrize("metric", ["init_draw_share", "step_forward_ms", "step_backward_ms",
                                    "step_update_ms"])
def test_the_phase_readers_read_nothing_from_a_system_without_phases(metric):
    """A system whose spans are only ``train`` (with steps) and ``eval``."""
    run = _run([{"kind": "train", "dur_s": 0.5, "attrs": {"steps": 20}},
                {"kind": "eval", "dur_s": 0.2, "attrs": {}}])
    assert _read(metric, run) is None
