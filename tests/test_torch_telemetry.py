"""The port's telemetry plane against the JAX package's.

SLO evaluation, the run exporter, the flight recorder and the Chrome-trace
converter are the same host-side code in both packages: on the same input
they must give the same output.  The aggregator's wire is shared, so a port
pusher feeds a reference aggregator and the other way round.  The port's
metric names stay within the reference's documented catalog, and its
``build_info`` labels name torch and CUDA without initializing CUDA.
"""

import importlib.util
import json
import math
import time
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from gentun_tpu.telemetry import aggregator as ref_agg
from gentun_tpu.telemetry import export as ref_export
from gentun_tpu.telemetry import flight as ref_flight
from gentun_tpu.telemetry import registry as ref_registry
from gentun_tpu.telemetry import slo as ref_slo
from gentun_tpu.telemetry import traceviz as ref_traceviz

from gentun_tpu_torch.telemetry import aggregator as port_agg
from gentun_tpu_torch.telemetry import buildinfo as port_buildinfo
from gentun_tpu_torch.telemetry import export as port_export
from gentun_tpu_torch.telemetry import flight as port_flight
from gentun_tpu_torch.telemetry import registry as port_registry
from gentun_tpu_torch.telemetry import slo as port_slo
from gentun_tpu_torch.telemetry import spans as port_spans
from gentun_tpu_torch.telemetry import traceviz as port_traceviz

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _pristine_telemetry():
    port_spans.disable()
    port_spans.set_run_sink(None)
    port_registry.get_registry().reset()
    yield
    port_spans.disable()
    port_spans.set_run_sink(None)
    port_registry.get_registry().reset()


def _records():
    """A small run's records: spans of two processes and threads, events,
    a dispatch→evaluate→result flow, as ``telemetry.jsonl`` holds them."""
    rng = np.random.default_rng(4)
    out, t = [], 1_700_000_000.0
    for i in range(24):
        t += float(rng.uniform(0.01, 0.2))
        kind = ("train", "eval", "evaluate", "dispatch", "select")[i % 5]
        rec = {"type": "span", "kind": kind, "trace_id": "t%d" % (i // 6),
               "span_id": "s%d" % i, "parent_id": "s%d" % (i - 1) if i % 6 else None,
               "t_wall": t, "dur_s": float(rng.uniform(0.001, 0.5)),
               "pid": 100 + i % 2, "host": "h", "thread": "gentun-async-eval_%d" % (i % 2),
               "attrs": {"pop": 2, "fold": i % 2, "job_id": "j%d" % (i // 3)}}
        out.append(rec)
        if i % 7 == 3:
            out.append({"type": "event", "name": "straggler" if i % 2 else "oom_chunk",
                        "t_wall": t, "pid": 100, "attrs": {"n": i}})
    return out


def _view(points_by_name, pkg_slo):
    def view(pattern, **_):
        return [pkg_slo.SeriesPoints(name, {"instance": inst, "role": "worker"}, pts)
                for (name, inst), pts in points_by_name.items()
                if pkg_slo.match_series(pattern, name)]
    return view


def _fields(rule):
    """A rule's fields but its free-text description (the port's drops the
    reference's development-history tags)."""
    return {k: v for k, v in asdict(rule).items() if k != "description"}


def test_slo_rules_and_evaluation_equal_reference():
    for scale in (1.0, 0.05):
        assert [_fields(r) for r in port_slo.default_rules(scale)] == [
            _fields(r) for r in ref_slo.default_rules(scale)]
    series = {
        ("stragglers_detected_total", "w0"): [(900.0, 0.0)],
        ("fitness_service_degraded_total", "w1"): [(900.0, 0.0)],
        ("session_queue_depth", "w0"): [(900.0, 3.0)],
        ("compile_cache_hits_total", "w1"): [(900.0, 0.0)],
        ("compile_cache_misses_total", "w1"): [(900.0, 0.0)],
        ("jobs_completed_total", "w0"): [(900.0, 0.0)],
    }
    rules = port_slo.default_rules(scale=0.05) + [
        port_slo.SloRule(name="stall", kind="increase", series="stragglers_detected_total",
                         threshold=0.0, op=">", window_s=30.0, for_s=0.0, clear_for_s=20.0,
                         subject="instance"),
        port_slo.SloRule(name="depth", kind="gauge_growth", series="session_queue_depth",
                         threshold=8.0, op=">", window_s=30.0, for_s=10.0, clear_for_s=10.0,
                         subject="fleet")]
    # The same rules for both engines, each package's own rule type.
    engines = [pkg.SloEngine([pkg.SloRule(**asdict(r)) for r in rules])
               for pkg in (ref_slo, port_slo)]
    events = []
    for step in range(12):
        now = 1000.0 + 10.0 * step
        for (name, _), pts in series.items():
            grow = 4.0 * step if step < 6 else 0.0  # a burst, then quiet: fire, then clear
            pts.append((now, pts[-1][1] + (grow if name != "compile_cache_hits_total" else 0.0)))
        out = [eng.evaluate(_view(series, pkg), now=now)
               for eng, pkg in zip(engines, (ref_slo, port_slo))]
        assert out[1] == out[0]
        events += [t["event"] for t in out[0]]
    assert engines[1].snapshot() == engines[0].snapshot()
    assert "fire" in events and "clear" in events  # the input exercised the state machine


def test_run_export_equals_reference(tmp_path):
    records = _records()
    lines, summaries = [], []
    for pkg_export, pkg_registry, name in ((ref_export, ref_registry, "ref"),
                                           (port_export, port_registry, "port")):
        reg = pkg_registry.MetricsRegistry()
        reg.counter("jobs_completed_total", session="a").inc(3)
        reg.gauge("engine_best_fitness", session="a", mode="async").set(0.75)
        run = pkg_export.RunTelemetry(str(tmp_path / f"{name}.jsonl"), label="x", registry=reg)
        run.install()
        for rec in records:
            run.record(dict(rec))
        summ = run.close()
        summ.pop("wall_s")
        summaries.append(summ)
        got = [json.loads(line) for line in open(tmp_path / f"{name}.jsonl")]
        for rec in got:
            if rec["type"] in ("run_start", "summary"):
                for key in ("t_wall", "pid", "wall_s"):
                    rec.pop(key, None)
        lines.append(got)
    assert summaries[1] == summaries[0]
    assert lines[1] == lines[0]
    assert summaries[1]["spans"]["train"]["count"] == 5


def test_flight_recorder_equals_reference(tmp_path):
    outs = []
    for pkg in (ref_flight, port_flight):
        rec = pkg.FlightRecorder(capacity=16, path=str(tmp_path / "f.jsonl"))
        for r in _records():
            rec.record(dict(r))
        head, *body = rec.render_jsonl(reason="test").splitlines()
        head = json.loads(head)
        head.pop("t_wall"), head.pop("pid")
        outs.append((len(rec), rec.total, rec.snapshot(), head, body))
    assert outs[1] == outs[0]
    assert outs[0][0] == 16 and outs[0][1] > 16  # the ring dropped the oldest


def test_traceviz_equals_reference(tmp_path):
    path = tmp_path / "telemetry.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    want = ref_traceviz.convert(str(path), str(tmp_path / "ref.json"))
    got = port_traceviz.convert(str(path), str(tmp_path / "port.json"))
    assert got == want
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "ref.json").read_text())
    assert port_traceviz.to_trace_events(_records()) == ref_traceviz.to_trace_events(_records())


def _payload(pusher):
    body = pusher._build_payload()
    body.pop("boot_id"), body.pop("t")
    return body


def test_aggregator_wire_is_shared_both_ways():
    """The same registry makes the same push body in both packages, and
    each package's pusher feeds the other's aggregator over loopback."""
    assert port_agg.AGG_PROTOCOL == ref_agg.AGG_PROTOCOL
    regs = []
    for pkg_registry in (ref_registry, port_registry):
        reg = pkg_registry.MetricsRegistry()
        reg.counter("jobs_completed_total", session="s").inc(7)
        reg.gauge("jobs_in_flight").set(2)
        reg.histogram("span_seconds", kind="train").observe(0.25)
        regs.append(reg)
    pushers = [pkg.TelemetryPusher("http://127.0.0.1:1", role="worker", instance="w0",
                                   interval=60.0, registry=reg)
               for pkg, reg in zip((ref_agg, port_agg), regs)]
    assert _payload(pushers[1]) == _payload(pushers[0])

    for pusher_pkg, agg_pkg, reg in ((port_agg, ref_agg, regs[1]), (ref_agg, port_agg, regs[0])):
        with agg_pkg.MetricsAggregator("127.0.0.1", 0) as agg:
            pusher = pusher_pkg.TelemetryPusher(agg.url, role="worker", instance="w0",
                                                interval=60.0, cooldown=0.0, registry=reg)
            assert pusher.push_once()
            fleet = agg.statusz()["fleet"]
            assert fleet["counters"]["jobs_completed_total"] == 7.0
            assert 'jobs_in_flight{instance="w0",role="worker"} 2' in agg.render_prometheus()


def _check_metric_docs():
    spec = importlib.util.spec_from_file_location(
        "check_metric_docs", REPO / "scripts" / "check_metric_docs.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_port_metric_names_are_documented_reference_names(monkeypatch):
    docs = _check_metric_docs()
    monkeypatch.setattr(docs, "_LIBRARY_ROOTS", ("gentun_tpu_torch",))
    port_names = docs.code_metrics(str(REPO))
    assert len(port_names) > 20  # the scan found the port's registrations
    undocumented = {n: f for n, f in port_names.items() if n not in docs.doc_metrics()}
    assert undocumented == {}


def test_build_info_labels_name_torch_and_cuda_without_initializing_it(monkeypatch):
    import torch

    from gentun_tpu_torch.utils import device_state

    def refuse(*a, **k):
        raise AssertionError("build_info_labels initialized CUDA")

    monkeypatch.setattr(port_buildinfo, "_CACHED", None)
    monkeypatch.setattr(port_buildinfo, "_DEVICE", None)
    monkeypatch.setattr(device_state, "_backend_used", False)
    for name in ("init", "_lazy_init", "get_device_capability", "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    labels = port_buildinfo.build_info_labels()
    assert labels["torch"] == torch.__version__
    assert labels["cuda"] == str(torch.version.cuda or "none")
    assert labels["fitness_protocol"] == "torch-1" and labels["checkpoint_schema"] == "4"
    assert "driver" not in labels and "sm" not in labels
    assert not any(k.startswith("jax") for k in labels)

    # Once the fitness path has used the card, the device labels join.
    monkeypatch.setattr(device_state, "_backend_used", True)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))
    monkeypatch.setattr(port_buildinfo, "_driver_version", lambda: "12.8")
    labels = port_buildinfo.build_info_labels()
    assert labels["sm"] == "sm_90" and labels["driver"] == "12.8"
    reg = port_registry.MetricsRegistry()
    port_buildinfo.set_build_info(reg)
    assert 'build_info{' in reg.render_prometheus() and 'sm="sm_90"' in reg.render_prometheus()


def test_ga_run_flushes_active_pushers(monkeypatch):
    """``GeneticAlgorithm.run`` ends with the fleet push, as the
    reference's does; ``AsyncEvolution.run`` keeps its own."""
    import gentun_tpu_torch as port

    calls = []
    monkeypatch.setattr(port_agg, "flush_active_pushers", lambda: calls.append(1))

    class OneMax(port.Individual):
        def build_spec(self, **params):
            return port.genetic_cnn_genome((3,))

        def evaluate(self):
            return float(sum(sum(g) for g in self.genes.values()))

    pop = port.Population(OneMax, x_train=np.zeros(1), y_train=np.zeros(1), size=4, seed=0)
    port.GeneticAlgorithm(pop, seed=0).run(1)
    assert calls == [1]
    pop = port.Population(OneMax, x_train=np.zeros(1), y_train=np.zeros(1), size=4, seed=0)
    port.AsyncEvolution(pop, max_in_flight=1, seed=0).run(max_evaluations=6)
    assert calls == [1, 1]
    assert math.isfinite(pop.get_fittest().get_fitness())


def _connected_gauge(join_first: bool, tmp_path):
    """``broker_workers_connected`` in a run's summary, with two worker
    threads joining before ``RunTelemetry`` is entered or after it."""
    import threading

    from gentun_tpu_torch import GeneticAlgorithm, Individual, genetic_cnn_genome
    from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient
    from gentun_tpu_torch.telemetry import RunTelemetry

    class OneMax(Individual):
        def build_spec(self, **params):
            return genetic_cnn_genome((4, 4))

        def evaluate(self):
            return float(sum(sum(g) for g in self.genes.values()))

    data = (np.zeros(1, np.float32), np.zeros(1, np.float32))
    stops = []
    with DistributedPopulation(OneMax, size=4, seed=6, port=0) as pop:
        def start_workers():
            for i in range(2):
                stop = threading.Event()
                client = GentunClient(OneMax, *data, host="127.0.0.1",
                                      port=pop.broker_address[1], heartbeat_interval=0.2,
                                      reconnect_delay=0.1, worker_id=f"w{i}")
                threading.Thread(target=client.work, kwargs={"stop_event": stop},
                                 daemon=True).start()
                stops.append(stop)

        try:
            if join_first:
                start_workers()
                deadline = time.monotonic() + 10.0
                while pop.broker.fleet_members() < 2 and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert pop.broker.fleet_members() == 2
            with RunTelemetry(str(tmp_path / f"join_first_{join_first}.jsonl")) as run:
                if not join_first:
                    start_workers()
                GeneticAlgorithm(pop, seed=6).run(1)
            gauges = {g["name"]: g["value"] for g in run.summary()["gauges"]}
        finally:
            for stop in stops:
                stop.set()
    return gauges.get("broker_workers_connected")


def test_connected_gauge_is_set_by_joins_under_telemetry(monkeypatch, tmp_path):
    """The race in the reference's end-to-end telemetry case: workers that
    joined before the run installed its sink leave ``broker_workers_connected``
    unset for the run; workers that join under telemetry set it."""
    from gentun_tpu_torch.telemetry import registry as registry_mod

    monkeypatch.setattr(registry_mod, "_REGISTRY", registry_mod.MetricsRegistry())
    assert _connected_gauge(True, tmp_path) is None
    monkeypatch.setattr(registry_mod, "_REGISTRY", registry_mod.MetricsRegistry())
    assert _connected_gauge(False, tmp_path) == 2
