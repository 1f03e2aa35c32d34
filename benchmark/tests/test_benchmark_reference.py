"""The plain reference against the system, and the check that decides
``correct`` against a timed path broken underneath.

On the CPU at a tiny size, in float32, the system and the reference compute
the same numbers, so a sound run reads a gap of 0; each fault a cell can
have must then read above the limits of the benchmark's configurations.
The ``card`` tests run the control (the reference in float8, one step of
precision below the configuration's bfloat16, in the system's place) at
config #2's widths on the card, and a short run of each cell."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import data, faults, genomes, judge, run
from benchmark.record import Call, Run
from benchmark.reference.gcnn import Reference
from benchmark.tests.conftest import ROOT, TINY


def _limits():
    """The tightest limit of each number over the benchmark's configurations."""
    out = {}
    for name in os.listdir(os.path.join(ROOT, "benchmark", "configs")):
        with open(os.path.join(ROOT, "benchmark", "configs", name)) as fh:
            for k, v in json.load(fh)["limits"].items():
                out[k] = min(v, out.get(k, v))
    return out


@pytest.mark.parametrize("seed", [5, 2**35 + 9])
def test_the_reference_is_the_system_in_float32(seed):
    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    x, y = data.images(TINY, seed)
    gs = genomes.sample_genomes(TINY["nodes"], 5, seed, 1)
    kw = {**data.call_kwargs(TINY, seed, os.path.join(ROOT, "build", "kernels")), "mesh": "cpu"}
    fit = GeneticCnnModel.cross_validate_population(x, y, gs, **kw)
    ref = Reference(x, y, TINY, kw["seed"], "cpu")
    assert np.array_equal(np.asarray(fit, np.float32),
                          np.asarray([ref.fitness(g) for g in gs], np.float32))


def test_the_judge_samples_from_the_seed_across_calls():
    calls = [Call(0, 1, [{}] * 20, np.zeros(20)) for _ in range(5)]
    r = Run(config={}, traffic={}, seed=3, setup_s=0, calls=calls, x=None, y=None, call_seed=0)
    a = judge.sample(r, 16)
    assert a == judge.sample(r, 16) and len(set(a)) == 16
    assert len({i for i, _ in a}) > 1
    assert judge.sample(Run(**{**r.__dict__, "seed": 4}), 16) != a


def _run(tiny_manifest):
    path, base = tiny_manifest(_limits(), pop=6, judged=100)
    return run.measure("tiny-cell", 2**33 + 17, 0.5, False, "cpu", time.monotonic(),
                       manifest=path, base=base)


def test_a_sound_run_is_correct(tiny_manifest):
    result = _run(tiny_manifest)
    assert result["correct"], result["checks"]
    assert all(result["checks"][k]["value"] == 0.0 for k in _limits())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_manifest, fault):
    with faults.planted(fault, TINY["n_classes"]):
        result = _run(tiny_manifest)
    assert not result["correct"], result["checks"]


def test_a_planted_fault_is_taken_out_after_its_block():
    from gentun_tpu_torch.models import cnn

    sound = (cnn._train_step, cnn._eval_fold, cnn.GeneticCnnModel.__dict__["cross_validate_population"])
    for fault in faults.FAULTS:
        with faults.planted(fault, TINY["n_classes"]):
            pass
    assert sound == (cnn._train_step, cnn._eval_fold,
                     cnn.GeneticCnnModel.__dict__["cross_validate_population"])


def test_the_numbers_of_known_gaps():
    ref = [0.1, 0.2, 0.3, 0.4, 0.5]
    got = judge.numbers({"answer": [0.2, 0.3, 0.4, 0.5, 0.6], "reference": ref})
    assert got["fitness_shift"] == pytest.approx(0.1) and got["mean_abs_gap"] == pytest.approx(0.1)
    assert got["max_abs_gap"] == pytest.approx(0.1)
    # answers moved round by one: gaps (0.4, -0.1, -0.1, -0.1, -0.1)
    moved = judge.numbers({"answer": list(np.roll(ref, 1)), "reference": ref})
    assert moved["fitness_shift"] == pytest.approx(0.1) and moved["mean_abs_gap"] == pytest.approx(0.16)


def test_the_readings_runner_drives_the_cell_with_its_control_and_faults(tiny_manifest):
    from benchmark import readings

    path, base = tiny_manifest(_limits(), pop=6, judged=12)
    got = readings.read("tiny-cell", 2**31 + 5, torch_cpu(), control=True,
                        faults=["answers_moved"], manifest=path, base=base)
    assert all(v == 0.0 for k, v in got["sound"].items())
    assert got["float8"]["mean_abs_gap"] > 0 and got["answers_moved"]["mean_abs_gap"] > 0


def torch_cpu():
    import torch

    return torch.device("cpu")


@pytest.mark.card
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_the_control_fails_at_the_cells_widths(card, seed):
    """float8 in the system's place, on as many genomes of config #2's first
    calls as a run judges."""
    from benchmark import cell, readings

    limits = cell.load("c2-proxy-p20").config["limits"]
    got = readings.read("c2-proxy-p20", seed, card, control=True)["float8"]
    assert any(got[k] > v for k, v in limits.items()), got


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in json.load(open(
    os.path.join(ROOT, "BENCHMARK.json")))["workloads"]])
def test_a_short_run_of_each_cell_is_correct(card, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                          "2147483659", "--seconds", "10", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
