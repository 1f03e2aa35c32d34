"""``--tiny`` smokes of the port's longer studies and config #2's example, on
the CPU: each exits 0, and each record carries at least the keys of the
reference's committed record, where there is one."""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
DEADLINE_S = 240.0


def load_script(path: Path):
    spec = importlib.util.spec_from_file_location(f"smoke_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _reference_keys(name: str) -> set:
    return set(json.loads((SCRIPTS / name).read_text()))


def test_stage_exit_conv_study_tiny(tmp_path):
    out = tmp_path / "sec.json"
    rc = load_script(SCRIPTS / "torch_stage_exit_conv_study.py").main(
        ["--pop", "2", "--seeds", "0", "--tiny", "--out", str(tmp_path / "sec.md"),
         "--json-out", str(out)])
    record = json.loads(out.read_text())
    assert rc == 0 and record["card"] == "cpu"
    assert _reference_keys("stage_exit_conv_study.json") <= set(record)
    assert "## Decision" in (tmp_path / "sec.md").read_text()


def test_convergence_tiny(tmp_path):
    out = tmp_path / "conv.json"
    rc = load_script(SCRIPTS / "torch_convergence.py").main(
        ["--tiny", "--generations", "1", "--population", "4",
         "--out", str(tmp_path / "results.md"), "--json-out", str(out)])
    record = json.loads(out.read_text())
    assert rc == 0 and 0.0 <= record["holdout_test_accuracy"] <= 1.0
    assert len(record["history"]) == 1 and record["card"] == "cpu"


def test_search_efficacy_tiny(tmp_path):
    out = tmp_path / "search.json"
    rc = load_script(SCRIPTS / "torch_search_efficacy.py").main(
        ["--tiny", "--out", str(tmp_path / "search.md"), "--json-out", str(out)])
    record = json.loads(out.read_text())
    assert rc == 0 and record["backend"] == "cpu"
    assert _reference_keys("search_efficacy.json") - {"merged_from"} <= set(record)
    for arm in ("tournament", "roulette", "random"):
        assert record[arm][0]["rng_protocol"] == "torch-1"
        assert record[arm][0]["curve"][-1][0] >= 8


def test_entry_pad_study_tiny(tmp_path):
    out = tmp_path / "ep.json"
    rc = load_script(SCRIPTS / "torch_entry_pad_study.py").main(
        ["--tiny", "--reps", "1", "--no-warmup", "--out", str(out)])
    record = json.loads(out.read_text())
    assert rc == 0 and set(record["variants"]) == {"unpadded", "pad4", "pad8"}
    assert _reference_keys("entry_pad_study.json") <= set(record)
    assert all(v["mfu_useful"] is None for v in record["variants"].values())  # no card


def test_northstar_tiny_master_worker_and_holdout(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "ns.json"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    master = subprocess.Popen(
        [sys.executable, str(SCRIPTS / "torch_northstar_run.py"), "master", "--tiny",
         "--generations", "1", "--port", str(port), "--out", str(out)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    worker = None
    try:
        time.sleep(0.5)
        worker = subprocess.Popen(
            [sys.executable, "-m", "gentun_tpu_torch.distributed.worker", "--port", str(port),
             "--species", "genetic-cnn", "--dataset", "cifar10", "--n", "96",
             "--capacity", "20"],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        _, err = master.communicate(timeout=DEADLINE_S)
        assert master.returncode == 0, err[-3000:]
    finally:
        for p in (master, worker):
            if p is not None and p.poll() is None:
                p.terminate()
                p.wait(timeout=30)
    load_script(SCRIPTS / "torch_northstar_run.py").main(
        ["holdout", "--tiny", "--artifact", str(out)])
    record = json.loads(out.read_text())
    assert _reference_keys("northstar_run.json") <= set(record)
    assert record["master_jax_backend_used"] is False and record["generations"] == 1
    assert record["search"]["individuals_trained"] > 0
    assert len(record["holdout"]["top3_holdout_acc"]) == 3


def test_cifar10_example_on_the_cpu():
    example = load_script(REPO / "examples" / "torch_cifar10_genetic_cnn.py")
    result = example.main(["--generations", "1", "--population", "2", "--n-images", "64",
                           "--kernels", "2", "2", "2", "--batch-size", "16",
                           "--dense-units", "4", "--device", "cpu"])
    assert result["generation"] == 1 and np.isfinite(result["best_fitness"])
