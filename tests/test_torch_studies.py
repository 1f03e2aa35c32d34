"""The port's compute-path studies (``scripts/torch_*.py``), on the CPU at tiny shapes.

- ``torch_mfu_study``'s fenced decomposition trains what the executor
  trains: its accuracies are a plain ``cross_validate_population`` call's
  bits, and its FLOP count is the reference bench's;
- ``torch_distributed_run``: a master and one worker process give the
  fitnesses of the same search in one process (``single``);
- ``torch_tailgen_study``: speculative filling off and on follow the same
  GA trajectory;
- ``torch_bigmodel_study``'s budgets route as the reference's host math;
- every study that runs on the card by default refuses to start without one.

The rank studies run in ``test_torch_studies_ranks.py``, the longer smokes
in ``test_torch_studies_smokes.py``.
"""

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
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import bench_torch  # noqa: E402

#: Seconds a multi-process study may take here (each process imports torch
#: and the port; a few seconds each unloaded).
DEADLINE_S = 240.0


def load_script(name: str):
    path = SCRIPTS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"study_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work (see
    ``test_torch_cnn.py``), restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_forward_flops_match_the_reference_bench():
    assert bench_torch.forward_flops_per_image(bench_torch.COMMON) == bench.forward_flops_per_image()


def test_decomposition_accuracies_are_the_plain_call_s_bits():
    """Every fenced phase runs, in the executor's order, and the fold loop
    gives a plain call's accuracies bit for bit (float32, dropout on)."""
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.utils.datasets import synthetic_images

    mfu = load_script("torch_mfu_study")
    x, y, _ = synthetic_images(96, (16, 16, 3), 10, seed=0)
    genomes = bench_torch.random_population((3, 4, 5), 3, seed=2)
    cfg = dict(mfu.TINY, mesh="cpu", segment_steps=1, epochs=(3,))
    phases = mfu.decompose(x, y, genomes, cfg)
    plain = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
    assert np.array_equal(np.asarray(phases["accs"], np.float32), plain)
    assert all(phases[k] >= 0.0 for k in mfu.PHASES)
    assert phases["segments_per_fold"] == phases["steps_per_fold"] > 1
    assert phases["mfu_train_only"] is None and phases["n_cards"] == 0  # no card: no share
    fwd = bench_torch.forward_flops_per_image(dict(cfg, nodes=(3, 4, 5)), (16, 16, 3), 10)
    assert phases["train_flops"] == 4 * 2 * phases["steps_per_fold"] * 32 * 3.0 * fwd


def test_distributed_master_and_worker_equal_one_process(tmp_path):
    """``master --tiny`` served by one worker process: the same GA history
    and full-schedule fitnesses as ``single --tiny``, and the master never
    used a card."""
    port = _free_port()
    master_out, single_out = tmp_path / "master.json", tmp_path / "single.json"
    env = _env()
    master = subprocess.Popen(
        [sys.executable, str(SCRIPTS / "torch_distributed_run.py"), "master", "--tiny",
         "--port", str(port), "--generations", "2", "--out", str(master_out)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    worker = None
    try:
        time.sleep(0.5)
        worker = subprocess.Popen(
            [sys.executable, "-m", "gentun_tpu_torch.distributed.worker", "--port", str(port),
             "--species", "genetic-cnn", "--dataset", "cifar10", "--n", "96",
             "--capacity", "20"],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        load_script("torch_distributed_run").main(
            ["single", "--tiny", "--generations", "2", "--out", str(single_out)])
        _, err = master.communicate(timeout=DEADLINE_S)
        assert master.returncode == 0, err[-3000:]
    finally:
        for p in (master, worker):
            if p is not None and p.poll() is None:
                p.terminate()
                p.wait(timeout=30)
    got, want = json.loads(master_out.read_text()), json.loads(single_out.read_text())
    traj = lambda r: [(h["generation"], h["best_fitness"], h["best_genes"])
                      for h in r["proxy"]["history"]]
    assert traj(got) == traj(want) and len(traj(got)) == 2
    assert got["full"]["fitnesses"] == want["full"]["fitnesses"]
    assert got["master_jax_backend_used"] is False
    for ref, ours in (("distributed_tpu_run.json", got), ("distributed_tpu_single.json", want)):
        assert set(json.loads((SCRIPTS / ref).read_text())) <= set(ours), ref


def test_tailgen_variants_follow_one_trajectory(tmp_path):
    tailgen = load_script("torch_tailgen_study")
    out = tmp_path / "tailgen.json"
    rc = tailgen.main(["--tiny", "--generations", "2", "--workdir", str(tmp_path),
                       "--out", str(out)])
    record = json.loads(out.read_text())
    assert rc == 0 and record["trajectories_identical"] and record["best_fitness_identical"]
    assert set(record["variants"]) == {"off", "spec16"}
    assert set(json.loads((SCRIPTS / "tailgen_study.json").read_text())) <= set(record)
    first = json.loads((tmp_path / "torch_tailgen_off.json").read_text())["proxy"]["history"]
    second = json.loads((tmp_path / "torch_tailgen_spec16.json").read_text())["proxy"]["history"]
    assert tailgen.trajectory(first) == tailgen.trajectory(second) and len(first) == 2


def test_tailgen_trajectory_differs_when_a_fitness_does():
    tailgen = load_script("torch_tailgen_study")
    a = [{"generation": 0, "best_fitness": 0.5, "best_genes": {"S_1": [1]},
          "population_size": 4, "evaluated": 4, "eval_wall_s": 1.0}]
    b = [dict(a[0], evaluated=2, eval_wall_s=3.0)]
    c = [dict(a[0], best_fitness=0.25)]
    assert tailgen.trajectory(a) == tailgen.trajectory(b) != tailgen.trajectory(c)


@pytest.mark.parametrize("script", ["torch_mfu_study", "torch_entry_pad_study",
                                    "torch_stage_exit_conv_study", "torch_convergence",
                                    "torch_search_efficacy"])
def test_studies_refuse_a_missing_card(script):
    """No card and no ``--device cpu``/``--tiny``: exit 2 before any work,
    never a quiet run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    assert load_script(script).main([]) == 2


@pytest.mark.parametrize("script", ["torch_meshscale_study", "torch_bigmodel_study"])
def test_rank_studies_refuse_a_missing_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    with pytest.raises(SystemExit, match="no CUDA device"):
        load_script(script).main([])


def test_bigmodel_budgets_route_as_the_reference_s_host_math():
    """The study's budgets classify the same in the port and in the
    reference (``parallel/mesh.py``'s host math), for 2 to 8 ranks."""
    from gentun_tpu.parallel import mesh as ref_mesh

    big = load_script("torch_bigmodel_study")
    p = big.PARAMS
    ref_cost = ref_mesh.cnn_genome_cost(p["nodes"], p["kernels_per_layer"], (28, 28, 1),
                                        p["dense_units"], 10, p["compute_dtype"])
    assert (ref_cost.param_bytes, ref_cost.act_bytes_per_example) == (
        big.COST.param_bytes, big.COST.act_bytes_per_example)
    for n in (2, 3, 4, 8):
        for budget, want in zip(big.budgets(n), (("big", 1), ("micro", 2))):
            ours = big.classify_genome_cost(big.COST, p["batch_size"], n, budget)
            assert ours == ref_mesh.classify_genome_cost(ref_cost, p["batch_size"], n, budget)
            assert ours == want, (n, budget)
