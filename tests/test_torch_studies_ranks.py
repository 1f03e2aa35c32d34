"""``torch_meshscale_study`` and ``torch_bigmodel_study`` on one and two gloo
CPU ranks (real ``torch.distributed`` groups of worker processes): two ranks
give one process's bits, and the over-budget classes route over them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
#: Seconds a study may take here (each rank imports torch and the port).
DEADLINE_S = 240.0


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def rank_studies(tmp_path_factory):
    """``torch_meshscale_study`` over one and two gloo CPU ranks and
    ``torch_bigmodel_study``'s over-budget act on two, run at once."""
    d = tmp_path_factory.mktemp("ranks")
    runs = {
        "meshscale": ["torch_meshscale_study.py", "--tiny", "--ranks", "1", "2", "--no-e2e"],
        "bigmodel": ["torch_bigmodel_study.py", "--tiny", "--ranks", "2", "--acts", "2", "3"],
    }
    procs = {}
    for name, (script, *argv) in runs.items():
        procs[name] = subprocess.Popen(
            [sys.executable, str(SCRIPTS / script), *argv, "--workdir", str(d),
             "--out", str(d / f"{name}.json")],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        for name, p in procs.items():
            log, _ = p.communicate(timeout=DEADLINE_S)
            out[name] = (p.returncode, log, json.loads((d / f"{name}.json").read_text()))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_meshscale_two_ranks_give_one_process_bits(rank_studies):
    rc, log, record = rank_studies["meshscale"]
    assert rc == 0 and record["ok"], log[-3000:]
    one, two = record["sweep"]
    assert (one["devices_per_worker"], two["devices_per_worker"]) == (1, 2)
    assert two["bit_identical_to_1dev"] and two["backend"] == "gloo"
    assert (two["mesh"], two["derived_capacity"]) == ({"pop": 2, "data": 1}, 4)
    assert one["outstanding_total"] == two["outstanding_total"] == 0
    assert len(one["fitnesses"]) == one["evaluated"] > 0


def test_bigmodel_over_budget_routes_over_two_ranks(rank_studies):
    rc, log, record = rank_studies["bigmodel"]
    assert rc == 0 and record["ok"], log[-3000:]
    assert record["classify_big"] == ["big", 1] and record["classify_micro"] == ["micro", 2]
    for name in ("big", "micro"):
        assert record[name]["all_evaluated"] and record[name]["quiescent"], name
    assert record["big"]["max_abs_delta_vs_small_path"] <= record["big"]["delta_bound"]
    assert record["classifier"]["per_call_us"] > 0
