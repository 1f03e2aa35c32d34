"""The timeline reduction on made-up profiler events."""

import pytest

from benchmark import devtrace


class _Event:
    def __init__(self, name, start, end, device, thread=1, annotation=False):
        self._v = (name, start, end, device, thread, annotation)

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
        return self._v[5]


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


US = 1000  # ns


def test_busy_is_the_union_of_device_intervals_inside_the_marked_calls():
    events = [
        _Event(devtrace.MARK, 0, 100 * US, False, annotation=True),
        _Event(devtrace.MARK, 0, 100 * US, True, annotation=True),  # mirrored on the device
        _Event("fwd_bf16_kernel", 10 * US, 40 * US, True),
        _Event("dag_node_input_kernel", 30 * US, 50 * US, True),  # overlaps the first
        _Event("Memcpy HtoD", 90 * US, 120 * US, True),  # runs past the window
        _Event("aten::uniform_", 50 * US, 90 * US, False),
        _Event("cudaLaunchKernel", 5 * US, 9 * US, False),
        _Event("aten::other_thread", 0, 100 * US, False, thread=2),
    ]
    tl = devtrace.reduce(_Prof(events))
    assert tl.window_s == pytest.approx(100e-6)
    assert tl.busy_s == pytest.approx(50e-6)  # 10–50 and 90–100
    assert tl.seconds_matching("fwd_bf16|dag_node") == pytest.approx(50e-6)
    assert tl.device_s["Memcpy HtoD"] == pytest.approx(10e-6)
    assert devtrace.MARK not in tl.device_s
    # idle 0–10 (midpoint in cudaLaunchKernel) and 50–90 (in aten::uniform_)
    assert tl.gaps == {"cudaLaunchKernel": (1, pytest.approx(10e-6)),
                       "aten::uniform_": (1, pytest.approx(40e-6))}
    bd = devtrace.breakdown(tl)
    assert bd["idle_gaps"][0][0] == "aten::uniform_ (x1)"
    assert {name for name, _ in bd["device_ops"]} == {"fwd_bf16_kernel", "dag_node_input_kernel",
                                                      "Memcpy HtoD"}


def test_a_profile_without_marked_calls_gives_nothing():
    assert devtrace.reduce(_Prof([_Event("k", 0, 10, True)])) is None


def test_short_names_drop_templates_and_parameters():
    name = "void (anonymous namespace)::fwd_hop::fwd_bf16_kernel<64, 2>(__nv_bfloat16 const*, int)"
    assert devtrace.short_name(name) == "fwd_hop::fwd_bf16_kernel"
    assert devtrace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
