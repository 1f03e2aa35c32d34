"""The port's control-plane studies and ops CLIs (``scripts/torch_<name>.py``).

- Every committed study record ``scripts/torch_<name>.json`` has the
  reference record's top-level and second-level keys, plus a ``machine``
  block (the card's ``nvidia-smi`` line and the host's CPU count), and every
  ``true`` of the reference's record is ``true`` in the port's.
- The short studies run here on the CPU (each with ``--out`` in a temporary
  directory); ``broker_throughput``'s timing gates need a host to itself,
  so here it runs one measured pass and rebuilds the gate table from the
  committed record.
- The compile-cache study runs its host-only act 3 here and refuses acts
  1-2 loudly where ``nvcc`` and a card are missing.
- ``torch_gentun_top.py --once`` renders a frame of an in-process ops
  server of the port; ``torch_gentun_trace.py`` reads a run the port
  exported.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"

STUDIES = [
    "async_study", "autoscale_study", "broker_throughput", "cache_study", "canary_study",
    "chaos_run", "compile_cache_study", "fidelity_study", "forensics_study", "ha_study",
    "multitenant_study", "obsagg_study", "ops_smoke", "packing_study", "pipeline_study",
    "shard_study", "surrogate_study",
]
#: Second-level keys the port's record has beyond the reference's, and why:
#: the reference's ``cache_study.json`` predates its ``FitnessService.stats()``
#: gaining the surrogate dataset counters (its code returns them today).
EXTRA_KEYS = {("cache_study", "service"): {"dataset_rows", "dataset_puts"}}
#: Seconds a CPU study run may take here.
DEADLINE_S = 120.0


def _load(name):
    spec = importlib.util.spec_from_file_location(f"control_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference(name):
    with open(SCRIPTS / f"{name}.json") as fh:
        return json.load(fh)


def _records(name):
    with open(SCRIPTS / f"torch_{name}.json") as fh:
        return _reference(name), json.load(fh)


def _trues(d, path=()):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _trues(v, path + (k,))
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _trues(v, path + (i,))
    elif d is True:
        yield path


def _at(d, path):
    for k in path:
        try:
            d = d[k]
        except (KeyError, IndexError, TypeError):
            return "missing"
    return d


def _run(script, *argv, timeout=DEADLINE_S):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(SCRIPTS / script), *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _same_keys(name, ref, port):
    assert set(port) - {"machine"} == set(ref), name
    for key, block in ref.items():
        if isinstance(block, dict):
            assert isinstance(port[key], dict), (name, key)
            extra = EXTRA_KEYS.get((name, key), set())
            assert set(port[key]) - extra == set(block), (name, key)


@pytest.mark.parametrize("name", STUDIES)
def test_committed_record_has_the_reference_keys(name):
    ref, port = _records(name)
    _same_keys(name, ref, port)
    machine = port["machine"]
    assert "H100" in machine["nvidia_smi"] and machine["cpu_count"] >= 1


@pytest.mark.parametrize("name", STUDIES)
def test_committed_record_holds_the_reference_gates(name):
    ref, port = _records(name)
    failed = {"/".join(map(str, p)): _at(port, p) for p in _trues(ref) if _at(port, p) is not True}
    assert not failed, failed


@pytest.mark.parametrize("name", ["multitenant_study", "cache_study", "forensics_study"])
def test_short_study_runs_on_the_cpu(name, tmp_path):
    out = tmp_path / f"torch_{name}.json"
    proc = _run(f"torch_{name}.py", "--out", str(out))
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    ref = _reference(name)
    record = json.loads(out.read_text())
    _same_keys(name, ref, record)
    assert record["machine"]["cpu_count"] == os.cpu_count()
    failed = [p for p in _trues(ref) if _at(record, p) is not True]
    assert not failed, failed


def test_broker_throughput_pass_and_gate_table():
    bt = _load("torch_broker_throughput")
    # The card's proxy rate, not the TPU's: 16,353.0 individuals an hour.
    assert bt.CARD_PROXY_JOBS_PER_S == pytest.approx(4.5425, abs=1e-4)
    assert "6.2" not in (SCRIPTS / "torch_broker_throughput.py").read_text()
    one = bt.run(n_jobs=200, n_workers=2, capacity=8)
    assert one["n_jobs"] == 200 and one["jobs_per_sec"] > 0
    assert one["chips_fed_at_proxy_rate"] == int(200 / one["wall_s"] / bt.CARD_PROXY_JOBS_PER_S)
    _, port = _records("broker_throughput")
    assert bt.hot_path_table(port) == port["hot_path_table"]
    assert set(one) <= set(_reference("broker_throughput"))


def test_compile_cache_act_three_and_the_loud_refusal(tmp_path):
    out = tmp_path / "cc.json"
    proc = _run("torch_compile_cache_study.py", "--acts", "3", "--out", str(out))
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    record = json.loads(out.read_text())
    killed = record["service_killed"]
    assert killed["bit_identical_to_service_free_run"] and killed["degraded_events"] == 1
    assert set(killed) == set(_reference("compile_cache_study")["service_killed"])
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the refusal without one")
    refused = _run("torch_compile_cache_study.py", "--out", str(tmp_path / "no.json"))
    assert refused.returncode == 2 and "nvcc" in refused.stderr
    assert not (tmp_path / "no.json").exists()


def test_gentun_top_renders_an_ops_server_frame(tmp_path):
    from gentun_tpu_torch.telemetry.ops_server import start_ops_server, stop_ops_server
    from gentun_tpu_torch.telemetry.registry import get_registry

    get_registry().counter("jobs_completed_total").inc(3)
    srv = start_ops_server(port=0, flight_path=str(tmp_path / "flight.jsonl"))
    try:
        proc = _run("torch_gentun_top.py", "--url", srv.url, "--once", "--no-color",
                    timeout=60)
    finally:
        stop_ops_server()
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert srv.url.split("//")[1] in proc.stdout and "health" in proc.stdout.lower()


def test_gentun_trace_reads_an_exported_port_run(tmp_path):
    from gentun_tpu_torch import AsyncEvolution, Individual, Population, genetic_cnn_genome
    from gentun_tpu_torch.telemetry import RunTelemetry, lineage

    class OneMax(Individual):
        def build_spec(self, **params):
            return genetic_cnn_genome((3, 3))

        def evaluate(self):
            return float(sum(sum(g) for g in self.genes.values()))

    path = tmp_path / "telemetry.jsonl"
    lineage.reset_ledger()
    lineage.enable()
    try:
        with RunTelemetry(str(path), label="trace-cli"):
            pop = Population(OneMax, np.zeros(1), np.zeros(1), size=6, seed=1)
            AsyncEvolution(pop, tournament_size=2, seed=2).run(max_evaluations=12)
    finally:
        lineage.disable()
    report = _run("torch_gentun_trace.py", "report", str(path), "--json", timeout=60)
    assert report.returncode == 0, report.stderr[-3000:]
    rec = json.loads(report.stdout)
    assert rec["winner"]["genome"]
    trace = tmp_path / "trace.json"
    conv = _run("torch_gentun_trace.py", "convert", str(path), str(trace), timeout=60)
    assert conv.returncode == 0, conv.stderr[-3000:]
    assert json.loads(trace.read_text())["traceEvents"]


IMPORT_GUARD = """
import importlib.util, sys
from pathlib import Path
scripts = Path(sys.argv[1])
sys.path.insert(0, str(scripts))
for name in sys.argv[2:]:
    spec = importlib.util.spec_from_file_location(name, scripts / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gentun_tpu"))
print("BAD", bad)
"""


def test_the_scripts_import_no_jax_and_no_reference():
    names = [f"torch_{n}" for n in STUDIES] + [
        "torch_gentun_top", "torch_gentun_trace", "torch_check_metric_docs"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", IMPORT_GUARD, str(SCRIPTS), *names],
                         capture_output=True, text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
