"""The port's ``(pop, data)`` mesh over ``torch.distributed`` ranks, on the CPU.

The JAX package's ``tests/test_parallel.py`` runs against the port's copies
(``_torch_rerun.load``).  Its cases that count jax's 8 virtual devices are
left out, and each has a counterpart below that counts ranks instead: a
real gloo process group of two CPU ranks, started as subprocesses of this
file (``--child``) under a deadline and killed on exit; this process
computes the one-process values while the ranks run.

- On a ``(2, 1)`` mesh: ``auto_mesh``'s factoring and override rules over
  two ranks; the CV from injected initial params (given to the reference
  too, in its layout) equals the reference's one-process accuracies and
  the port's one-process bits exactly (a pop row trains its own genomes,
  and a genome's fitness does not depend on its batch); padding to the
  pop axis and its gauges.
- On a ``(1, 2)`` mesh: one train step with dropout on matches one process
  within a relative bound (same random stream, only the sum's grouping
  differs); the params are the same bits on both data ranks after every
  fold; the fold accuracies stay within two validation flips of one
  process; the ``big`` and ``micro`` classes route over the two ranks; an
  unevaluable budget raises on every rank.

Left out of the reference file, each replaced here: the ``auto_mesh``
shapes of ``TestMeshConstruction`` (8 devices → 2 ranks),
``test_single_device_returns_none`` (one process → ``None``),
``TestShardedTraining``'s mesh cases (sharded vs unsharded, padding, waste
metrics, the ``big`` path, the default mesh) and ``test_eight_devices_available``.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Seconds the cluster may take from spawn to exit (ranks import torch,
#: form the group and train a few tiny CVs; about 10 s unloaded).
CLUSTER_DEADLINE_S = 90.0

FAST_PORT = dict(nodes=(3,), kernels_per_layer=(8,), kfold=2, epochs=(2,),
                 learning_rate=(0.05,), batch_size=32, dense_units=32,
                 compute_dtype="float32", seed=0, mesh="cpu")
G4 = [{"S_1": (0, 0, 0)}, {"S_1": (1, 0, 1)}, {"S_1": (1, 1, 1)}, {"S_1": (0, 1, 1)}]
G3 = [{"S_1": (1, 0, 1)}, {"S_1": (0, 0, 0)}, {"S_1": (1, 1, 1)}]
#: One train step with dropout on (the data cluster's grad check).
STEP = dict(pop=2, batch=32, dropout=0.5, lr=0.05, momentum=0.9)


def _data():
    """The reference file's ``separable_data``: 4 classes of 8×8 images."""
    rng = np.random.default_rng(0)
    protos = rng.normal(size=(4, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 4, size=192).astype(np.int32)
    x = protos[y] + 0.3 * rng.normal(size=(192, 8, 8, 1)).astype(np.float32)
    return x, y


@contextlib.contextmanager
def _injected(cnn, npz_path):
    """Serve ``_init_population_params`` from a file of per-genome params
    (``"<hi>:<lo>:<leaf>"`` → ``(kfold, *slot shape)``) inside the block."""
    table = dict(np.load(npz_path))

    def init(model, kfold, seed, genome_hashes, domain=0):
        names = [n for n, _ in model.named_parameters()]
        return {n: torch.as_tensor(np.stack(
            [table[f"{int(hi)}:{int(lo)}:{n}"][:kfold] for hi, lo in genome_hashes], axis=1))
            for n in names}

    real, cnn._init_population_params = cnn._init_population_params, init
    try:
        yield
    finally:
        cnn._init_population_params = real


def _step_inputs(cnn):
    """Model, masks, data, batch and params of the one-step grad check."""
    from gentun_tpu_torch.ops.dag import stack_genome_masks

    x, y = _data()
    genomes = G4[1:1 + STEP["pop"]]
    model = cnn.MaskedGeneticCnn((3,), (8,), STEP["pop"], (8, 8, 1), 32, 4, STEP["dropout"],
                                 "float32", device=torch.device("cpu"))
    hashes = cnn._genome_hashes(genomes)
    init = cnn._init_population_params(model, 1, 0, hashes)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n][0])
    masks = [{k: torch.as_tensor(v) for k, v in st.items()}
             for st in stack_genome_masks(genomes, (3,))]
    xt = torch.as_tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    yt = torch.as_tensor(y.astype(np.int64))
    idx = torch.as_tensor(np.random.default_rng(4).permutation(192)[:STEP["batch"]])
    return model, masks, xt, yt, idx, hashes


def _one_step(cnn, model, masks, xt, yt, idx, hashes, batch_rows=None, group=None):
    """One ``_train_step`` with dropout on; returns ``{leaf: param after}``."""
    gens = cnn._dropout_generators(0, 0, hashes, torch.device("cpu"))
    bufs = [torch.zeros_like(p) for p in model.parameters()]
    with cnn.exact_numerics():
        cnn._train_step(model, masks, xt, yt, idx, gens, bufs, STEP["lr"], STEP["momentum"],
                        False, 1, batch_rows, group)
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# Cluster children (run as ``python tests/test_torch_parallel.py --child ...``)
# ---------------------------------------------------------------------------


def _child_pop(out: dict, npz: str) -> None:
    """Mesh factoring over two ranks; on a ``(2, 1)`` mesh the injected CV,
    padding and its gauges."""
    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.parallel.mesh import (SIZE_BIG, auto_mesh, mesh_axis_sizes,
                                                mesh_factor, set_mesh_override)
    from gentun_tpu_torch.telemetry.registry import get_registry

    cpu = torch.device("cpu")
    shape = lambda **kw: list(mesh_axis_sizes(auto_mesh(device=cpu, **kw)))  # noqa: E731
    out["shapes"] = {"pop16": shape(pop_size=16), "pop3": shape(pop_size=3),
                     "pop1": shape(pop_size=1), "explicit_1x2": shape(pop_axis=1, data_axis=2),
                     "factor": [list(mesh_factor(2, p)) == shape(pop_size=p)
                                for p in (None, 1, 3, 4, 16)]}
    try:
        auto_mesh(pop_axis=2, data_axis=2, device=cpu)
        out["shapes"]["explicit_2x2"] = "accepted"
    except ValueError as e:
        out["shapes"]["explicit_2x2"] = str(e)
    set_mesh_override((1, 2))
    try:
        out["override"] = {"pop16": shape(pop_size=16),
                           "explicit": shape(pop_axis=2, data_axis=1),
                           "big": shape(pop_size=16, size_class=SIZE_BIG)}
    finally:
        set_mesh_override(None)
    out["override"]["cleared"] = shape(pop_size=16)
    x, y = _data()
    reg = get_registry()
    reg.reset()
    cfg = dict(FAST_PORT, dropout_rate=0.0)
    deadline = time.monotonic() + CLUSTER_DEADLINE_S
    while not os.path.exists(npz):  # the parent writes it while the ranks start
        if time.monotonic() > deadline:
            raise TimeoutError(f"{npz} never appeared")
        time.sleep(0.05)
    with _injected(cnn, npz):
        out["g4"] = GeneticCnnModel.cross_validate_population(x, y, G4, **cfg).tolist()
        out["g4_waste"] = reg.counter("eval_pad_waste_total").value
        out["gauges"] = [reg.gauge("mesh_pop_axis").value, reg.gauge("mesh_data_axis").value]
        out["g3"] = GeneticCnnModel.cross_validate_population(x, y, G3, **cfg).tolist()
        out["g3_waste"] = reg.counter("eval_pad_waste_total").value


def _child_data(out: dict, npz: str) -> None:
    """On a ``(1, 2)`` mesh: one sharded step, a CV with dropout on and the
    params of every fold, the ``big`` and ``micro`` routes, an unevaluable
    budget."""
    import hashlib

    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.parallel.mesh import (auto_mesh, cnn_genome_cost, data_shard,
                                                set_mesh_override)
    from gentun_tpu_torch.telemetry.registry import get_registry

    mesh = auto_mesh(pop_axis=1, data_axis=2, device=torch.device("cpu"))
    model, masks, xt, yt, idx, hashes = _step_inputs(cnn)
    lo, hi = data_shard(len(idx), mesh)
    after = _one_step(cnn, model, masks, xt, yt, idx[lo:hi], hashes, (lo, hi, len(idx)),
                      mesh.data_group)
    np.savez(npz, **after)
    out["step_rows"] = [lo, hi]

    digests = []
    real_eval = cnn._eval_fold

    def eval_fold(model, *args, **kwargs):
        h = hashlib.sha256()
        for _, p in model.named_parameters():
            h.update(p.detach().numpy().tobytes())
        digests.append(h.hexdigest())
        return real_eval(model, *args, **kwargs)

    cnn._eval_fold = eval_fold
    x, y = _data()
    set_mesh_override((1, 2))
    try:
        out["cv_dropout"] = GeneticCnnModel.cross_validate_population(
            x, y, G4, **dict(FAST_PORT, dropout_rate=0.5)).tolist()
    finally:
        set_mesh_override(None)
        cnn._eval_fold = real_eval
    out["fold_param_digests"] = digests
    cost = cnn_genome_cost((3,), (8,), (8, 8, 1), 32, 4, "float32")
    reg = get_registry()
    reg.reset()
    big = cost.param_bytes + cost.act_bytes_per_example * 16
    out["big_class"] = list(cnn._genome_size_class(
        cnn._normalize_config(x, y, dict(FAST_PORT, device_budget=big))))
    out["big"] = GeneticCnnModel.cross_validate_population(
        x, y, G4[1:3], device_budget=big, **FAST_PORT).tolist()
    out["big_micro_steps"] = reg.counter("microbatch_steps_total").value
    out["big_gauges"] = [reg.gauge("mesh_pop_axis").value, reg.gauge("mesh_data_axis").value]
    micro = cost.param_bytes + cost.act_bytes_per_example * 2
    out["micro_class"] = list(cnn._genome_size_class(
        cnn._normalize_config(x, y, dict(FAST_PORT, device_budget=micro))))
    out["micro"] = GeneticCnnModel.cross_validate_population(
        x, y, G4[1:3], device_budget=micro, **FAST_PORT).tolist()
    out["micro_steps"] = reg.counter("microbatch_steps_total").value
    try:
        GeneticCnnModel.cross_validate_population(
            x, y, G4[1:2], device_budget=cost.param_bytes, **FAST_PORT)
        out["unevaluable"] = "accepted"
    except ValueError as e:
        out["unevaluable"] = str(e)


def _child_main(argv) -> int:
    rank, world, port, outdir = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    from gentun_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    out = {"rank": rank}
    try:
        _child_pop(out, os.path.join(outdir, "init.npz"))
        _child_data(out, os.path.join(outdir, f"step_{rank}.npz"))
    finally:
        multihost.shutdown()
    with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[sys.argv.index("--child") + 1:]))


# ---------------------------------------------------------------------------
# The parent: the reference's file against the copies, and the clusters
# ---------------------------------------------------------------------------

from _torch_rerun import load  # noqa: E402

load(globals(), "test_parallel.py",
     subs=[("from gentun_tpu_torch.models.cnn import _pop_bucket",
            "from gentun_tpu_torch.parallel.mesh import pop_bucket as _pop_bucket"),
           ("auto_mesh(pop_axis=0, devices=jax.devices()[:1])", "auto_mesh(pop_axis=0)"),
           ('    compute_dtype="float32",\n    seed=0,\n)',
            '    compute_dtype="float32",\n    seed=0,\n    mesh="cpu",\n)')],
     leave_out=["TestMeshConstruction::test_eight_devices_available",
                "TestMeshConstruction::test_auto_mesh_prefers_pop_axis",
                "TestMeshConstruction::test_auto_mesh_spills_to_data_axis",
                "TestMeshConstruction::test_auto_mesh_single_individual",
                "TestMeshConstruction::test_explicit_axes",
                "TestMeshConstruction::test_single_device_returns_none",
                "TestMeshConstruction::test_mesh_factor_matches_auto_mesh",
                "TestMeshConstruction::test_mesh_override_precedence",
                "TestShardedTraining::test_sharded_matches_unsharded",
                "TestShardedTraining::test_population_padding_roundtrip",
                "TestShardedTraining::test_pad_waste_metrics",
                "TestShardedTraining::test_big_genome_data_sharded_path",
                "TestShardedTraining::test_auto_mesh_is_default"])


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread here and in the ranks (``OMP_NUM_THREADS=1``):
    test workers share the cores (see ``tests/test_torch_cnn.py``)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _write_init(npz: str) -> None:
    """The port's initial params of ``G4`` (kfold 2), per genome hash, into
    ``npz``: the params both packages are given."""
    from gentun_tpu_torch.models import cnn as port_cnn

    model = port_cnn.MaskedGeneticCnn((3,), (8,), len(G4), (8, 8, 1), 32, 4, 0.0, "float32",
                                      device=torch.device("cpu"))
    hashes = port_cnn._genome_hashes(G4)
    params = port_cnn._init_population_params(model, 2, 0, hashes)
    tmp = npz[:-4] + ".tmp.npz"
    np.savez(tmp, **{f"{int(hi)}:{int(lo)}:{n}": leaf[:, i].numpy()
                     for i, (hi, lo) in enumerate(hashes) for n, leaf in params.items()})
    os.replace(tmp, npz)  # the ranks wait for this name


def _to_reference(leaves, input_shape=(8, 8, 1), nodes=(3,)):
    """The inverse of ``params_from_reference``: the port's ``{"<layer>.weight"
    |"<layer>.bias": (..., leaf)}`` → the reference's ``{layer: {"kernel",
    "bias"}}`` (OIHW → HWIO; ``Dense_0``'s rows (C, H, W) → (H, W, C))."""
    h, w = input_shape[0] // 2 ** len(nodes), input_shape[1] // 2 ** len(nodes)
    out = {}
    for name, leaf in leaves.items():
        layer, kind = name.split(".")
        if kind == "bias":
            out.setdefault(layer, {})["bias"] = leaf
            continue
        if layer.startswith("stage"):
            kernel = np.moveaxis(leaf, (-2, -1, -3, -4), (-4, -3, -2, -1))
        elif layer == "Dense_0":
            prefix, (d_in, units) = leaf.shape[:-2], leaf.shape[-2:]
            chw = leaf.reshape(*prefix, d_in // (h * w), h, w, units)
            kernel = np.moveaxis(chw, -4, -2).reshape(*prefix, d_in, units)
        else:
            kernel = leaf
        out.setdefault(layer, {})["kernel"] = np.ascontiguousarray(kernel)
    return out


def _one_process(npz: str):
    """This process's values of what the ranks compute: the reference's and
    the port's CV of ``G4`` from the injected params, the one-step update,
    the CV with dropout, and the ``big`` pair without a budget."""
    import jax.numpy as jnp

    from gentun_tpu.models import cnn as ref_cnn
    from gentun_tpu_torch.models import cnn as port_cnn

    table = dict(np.load(npz))

    def ref_init(model, masks, input_shape, pop, kfold, seed, hashes, domain=0):
        per = [{n.split(":", 2)[2]: v[:kfold] for n, v in table.items()
                if n.startswith(f"{int(hi)}:{int(lo)}:")} for hi, lo in hashes]
        tree = _to_reference({n: np.stack([g[n] for g in per], axis=1) for n in per[0]})
        return {layer: {k: jnp.asarray(v) for k, v in leaves.items()}
                for layer, leaves in tree.items()}

    x, y = _data()
    nodrop = dict(FAST_PORT, dropout_rate=0.0)
    real, ref_cnn._init_population_params = ref_cnn._init_population_params, ref_init
    try:
        out = {"ref_g4": np.asarray(ref_cnn.GeneticCnnModel.cross_validate_population(
            x, y, G4, **dict(nodrop, mesh=None)), dtype=np.float32)}
    finally:
        ref_cnn._init_population_params = real
    with _injected(port_cnn, npz):
        out["g4"] = port_cnn.GeneticCnnModel.cross_validate_population(x, y, G4, **nodrop)
    model, masks, xt, yt, idx, hashes = _step_inputs(port_cnn)
    out["before"] = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    out["step"] = _one_step(port_cnn, model, masks, xt, yt, idx, hashes)
    out["cv_dropout"] = port_cnn.GeneticCnnModel.cross_validate_population(
        x, y, G4, **dict(FAST_PORT, dropout_rate=0.5))
    out["pair"] = port_cnn.GeneticCnnModel.cross_validate_population(x, y, G4[1:3], **FAST_PORT)
    return out


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The two ranks' results (their JSON and their params after the
    sharded step) and this process's one-process values, computed while
    the ranks run (they wait for the initial params it writes first).  A rank that fails, or a cluster past its deadline, fails
    the tests with the ranks' output; every rank is killed on the way out."""
    outdir = str(tmp_path_factory.mktemp("cluster"))
    npz = os.path.join(outdir, "init.npz")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--child", str(r), "2",
                               str(port), outdir],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    deadline = time.monotonic() + CLUSTER_DEADLINE_S
    try:
        _write_init(npz)
        one = _one_process(npz)
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the cluster outlived its {CLUSTER_DEADLINE_S} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"rank exit {p.returncode}:\n{text.decode()[-3000:]}"
    ranks = []
    for r in range(2):
        with open(os.path.join(outdir, f"rank_{r}.json")) as fh:
            ranks.append(json.load(fh))
    steps = [dict(np.load(os.path.join(outdir, f"step_{r}.npz"))) for r in range(2)]
    return ranks, steps, one


# -- the (2, 1) mesh: the pop axis ----------------------------------------------


def test_auto_mesh_factors_two_ranks(cluster):
    """``TestMeshConstruction``'s shapes over 2 ranks: the pop axis first,
    spilling onto data below it; explicit axes must factor the world;
    ``mesh_factor`` is the authority."""
    shapes = cluster[0][0]["shapes"]
    assert shapes["pop16"] == [2, 1] and shapes["pop3"] == [2, 1]
    assert shapes["pop1"] == [1, 2]  # one genome: pure data parallelism
    assert shapes["explicit_1x2"] == [1, 2]
    assert "!= 2 ranks" in shapes["explicit_2x2"]
    assert all(shapes["factor"])


def test_mesh_override_precedence_over_ranks(cluster):
    """The ``--mesh`` override reaches ``auto_mesh``; explicit axes beat it; a
    big size class beats both; clearing restores the heuristic."""
    assert cluster[0][0]["override"] == {"pop16": [1, 2], "explicit": [2, 1],
                                         "big": [1, 2], "cleared": [2, 1]}


def test_auto_mesh_is_none_in_one_process():
    from gentun_tpu_torch.parallel.mesh import auto_mesh

    assert auto_mesh(pop_size=4) is None


def test_pop_axis_equals_reference_and_one_process_exactly(cluster):
    """Injected params (the reference runs the same ones), float32, dropout
    0: the ``(2, 1)`` mesh's accuracies are the reference's one-process
    accuracies and the port's one-process bits (max |Δ| = 0), on both
    ranks."""
    ranks, _, one = cluster
    for r in ranks:
        got = np.asarray(r["g4"], dtype=np.float32)
        assert got.shape == (4,)
        assert float(np.abs(got - one["ref_g4"]).max()) == 0.0
        assert got.tobytes() == one["g4"].tobytes()


def test_population_padding_roundtrip_over_ranks(cluster):
    """3 genomes on a ``(2, 1)`` mesh pad to 4 slots and slice back to 3: each
    the bits its genome has in one process (``G3`` is ``G4``'s genomes 1, 0
    and 2, and a fitness does not depend on its batch)."""
    ranks, _, one = cluster
    for r in ranks:
        got = np.asarray(r["g3"], dtype=np.float32)
        assert got.shape == (3,) and (got > 0.4).all()
        assert got.tobytes() == one["g4"][[1, 0, 2]].tobytes()


def test_pad_waste_metrics_over_ranks(cluster):
    """A pop-axis-aligned batch wastes no slot; 3 genomes waste the one slot
    sliced away; the gauges name the mesh the evaluation ran on."""
    for r in cluster[0]:
        assert r["g4_waste"] == 0 and r["g3_waste"] == 1
        assert r["gauges"] == [2, 1]


# -- the (1, 2) mesh: the data axis ----------------------------------------------


def test_data_axis_step_matches_one_process(cluster):
    """One step with dropout 0.5 split 16 + 16 over the data axis: each leaf's
    update (param before minus after) is within 1e-4 of the one-process
    update, relative to its largest magnitude (float32; the only difference
    is how the batch's sum is grouped; a different dropout stream or a
    missing all-reduce moves it by O(1))."""
    ranks, steps, one = cluster
    assert [r["step_rows"] for r in ranks] == [[0, 16], [16, 32]]
    for name, want in one["step"].items():
        upd_one = one["before"][name] - want
        for rank in steps:
            upd = one["before"][name] - rank[name]
            scale = float(np.abs(upd_one).max()) or 1.0
            assert float(np.abs(upd - upd_one).max()) <= 1e-4 * scale, name


def test_data_axis_params_equal_on_both_ranks(cluster):
    """After the one step and after every fold of the CV, both data ranks hold
    the same bits."""
    ranks, steps, _ = cluster
    for name in steps[0]:
        assert steps[0][name].tobytes() == steps[1][name].tobytes(), name
    digests = [r["fold_param_digests"] for r in ranks]
    assert len(digests[0]) == 2 and digests[0] == digests[1]


def test_data_axis_accuracies_within_two_flips(cluster):
    """A CV with dropout 0.5 over the ``(1, 2)`` mesh against one process: the
    same random stream, sums grouped differently, carried through 6 steps.
    Bound: two validation flips of the 2×96-row CV mean (2/192), tighter
    than the reference's own 0.06 for its sharded run."""
    ranks, _, one = cluster
    for r in ranks:
        got = np.asarray(r["cv_dropout"], dtype=np.float32)
        np.testing.assert_allclose(got, one["cv_dropout"], rtol=0, atol=2 / 192 + 1e-6)
    assert ranks[0]["cv_dropout"] == ranks[1]["cv_dropout"]


def test_big_class_spreads_each_genome_over_the_data_axis(cluster):
    """A budget that fits only half a batch per card routes ``big`` over 2
    ranks: one genome a program on a ``(1, 2)`` mesh, no accumulation, and
    the accuracies within the data axis's bound of the one-process pair."""
    ranks, _, one = cluster
    for r in ranks:
        assert r["big_class"] == ["big", 1]
        assert r["big_micro_steps"] == 0 and r["big_gauges"] == [1, 2]
        np.testing.assert_allclose(np.asarray(r["big"], np.float32), one["pair"],
                                   rtol=0, atol=2 / 192 + 1e-6)


def test_micro_class_accumulates_over_the_data_axis(cluster):
    """A budget under a 16-row share accumulates 8 micro-slices of 4 rows, 2
    on each rank; the fitnesses stay sane (accumulation changes the
    numerics legitimately)."""
    for r in cluster[0]:
        assert r["micro_class"] == ["micro", 8]
        assert r["micro_steps"] > 0
        assert len(r["micro"]) == 2 and min(r["micro"]) > 0.4


def test_unevaluable_budget_is_loud_on_every_rank(cluster):
    for r in cluster[0]:
        assert "unevaluable" in r["unevaluable"]
