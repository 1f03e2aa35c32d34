"""The port's Genetic-CNN fitness model held against the JAX package's, on the CPU.

Parity by injection: the reference draws its initial params
(``gentun_tpu.models.cnn._init_population_params``), they cross as numpy
through ``params_from_reference`` into the port, and both packages run the
same numpy inputs.  Dropout is 0 wherever values are compared, because the
two packages' random streams differ by design.  Each bound is stated where
it is used, with its reason.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gentun_tpu.models import cnn as ref_cnn
from gentun_tpu.ops.dag import stack_genome_masks as ref_stack

from gentun_tpu_torch.models import cnn as port_cnn
from gentun_tpu_torch.models.cnn import GeneticCnnModel, MaskedGeneticCnn, params_from_reference
from gentun_tpu_torch.ops.dag import stack_genome_masks
from gentun_tpu_torch.parallel.mesh import cnn_genome_cost

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work, restored after.

    The port's plain conv runs one small ``F.conv2d`` per slot; with several
    test workers on the same cores, each of those calls' thread-pool
    barriers waits on descheduled threads (on an 8-core host beside 7 busy
    processes, two small fitness calls took 28.6 s with 8 threads and 0.35 s
    with 1).  Nothing these tests compare depends on the thread count, except
    where a test sets its own.
    """
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

FAST = dict(
    nodes=(3,),
    kernels_per_layer=(8,),
    kfold=2,
    epochs=(2,),
    learning_rate=(0.05,),
    batch_size=32,
    dense_units=32,
    compute_dtype="float32",
    seed=0,
    mesh="cpu",
)


@pytest.fixture(scope="module")
def separable_data():
    """4 classes of 8×8 images with distinct mean patterns (the reference's
    own fixture in ``tests/test_cnn_model.py``)."""
    rng = np.random.default_rng(0)
    protos = rng.normal(size=(4, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 4, size=192).astype(np.int32)
    x = protos[y] + 0.3 * rng.normal(size=(192, 8, 8, 1)).astype(np.float32)
    return x, y


def _genomes(nodes, n, seed):
    from gentun_tpu_torch.genes import genetic_cnn_genome

    rng = np.random.default_rng(seed)
    spec = genetic_cnn_genome(nodes)
    out = [spec.sample(rng) for _ in range(n)]
    # always include an empty first stage (has_active=0: the pass-through)
    out[0] = {**out[0], "S_1": (0,) * len(out[0]["S_1"])}
    return out


def _ref_model(nodes, filters, dense, n_classes, dtype, exit_conv):
    return ref_cnn.MaskedGeneticCnn(
        nodes=nodes, filters=filters, dense_units=dense, n_classes=n_classes,
        dropout_rate=0.0, compute_dtype=jnp.dtype(dtype), stage_exit_conv=exit_conv,
    )


def _ref_init(model, genomes, nodes, input_shape, kfold, seed=0, domain=0):
    """The reference's (kfold, P)-prefixed initial params, as numpy."""
    stacked = [{k: jnp.asarray(v) for k, v in st.items()} for st in ref_stack(genomes, nodes)]
    hashes = ref_cnn._genome_hashes(genomes)
    params = ref_cnn._init_population_params(
        model, stacked, input_shape, len(genomes), kfold, seed, hashes, domain=domain)
    return jax.tree.map(np.asarray, params)


def _ref_logits(model, params_f, genomes, nodes, x_nhwc):
    """(P, B, C) float32 logits from the reference, one genome at a time."""
    masks = ref_stack(genomes, nodes)
    out = []
    for i in range(len(genomes)):
        p_i = jax.tree.map(lambda a: a[i], params_f)
        m_i = [{k: jnp.asarray(v[i]) for k, v in st.items()} for st in masks]
        out.append(np.asarray(model.apply({"params": p_i}, jnp.asarray(x_nhwc), m_i)))
    return np.stack(out)


def _port_model(nodes, filters, pop, input_shape, dense, n_classes, dtype, exit_conv, dropout=0.0):
    return MaskedGeneticCnn(nodes, filters, pop, input_shape, dense, n_classes,
                            dropout, dtype, exit_conv, device=CPU)


def _load(model, port_params, fold=None):
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = port_params[name] if fold is None else port_params[name][fold]
            p.copy_(torch.as_tensor(np.array(src)))


def _port_masks(genomes, nodes):
    return [{k: torch.as_tensor(v) for k, v in st.items()} for st in stack_genome_masks(genomes, nodes)]


def _nchw(x_nhwc):
    return torch.as_tensor(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


FORWARD_CASES = {
    # name: (nodes, filters, input HWC, stage_exit_conv)
    "one stage 16x16": ((3,), (4,), (16, 16, 1), False),
    "two stages, exit conv": ((3, 4), (4, 8), (16, 16, 1), True),
    "odd sizes 28->14->7->3": ((3, 4, 3), (4, 6, 8), (28, 28, 1), False),
    "entry_channel_pad 3->8": ((3, 4), (4, 8), (16, 16, 8), False),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_logits_match_reference_float32(case):
    nodes, filters, shape, exit_conv = FORWARD_CASES[case]
    genomes = _genomes(nodes, 4, seed=len(case))
    x = np.random.default_rng(1).normal(size=(6, *shape)).astype(np.float32)
    if case.startswith("entry_channel_pad"):
        x[..., 3:] = 0.0  # the padded channels are zero, as _prepare_data makes them
    ref_model = _ref_model(nodes, filters, 16, 5, "float32", exit_conv)
    ref_params = _ref_init(ref_model, genomes, nodes, shape, kfold=1)
    want = _ref_logits(ref_model, jax.tree.map(lambda a: a[0], ref_params), genomes, nodes, x)

    port = _port_model(nodes, filters, len(genomes), shape, 16, 5, "float32", exit_conv)
    _load(port, params_from_reference(ref_params, nodes, shape), fold=0)
    got = port(_nchw(x), _port_masks(genomes, nodes))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 6, 5)
    # float32 on both sides; XLA:CPU and oneDNN sum the 3x3xC products in
    # different orders, a few ulps per layer over up to 13 layers.
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_forward_logits_match_reference_bfloat16():
    nodes, filters, shape = (3, 4), (8, 8), (16, 16, 1)
    genomes = _genomes(nodes, 4, seed=3)
    x = np.random.default_rng(2).normal(size=(8, *shape)).astype(np.float32)
    ref_model = _ref_model(nodes, filters, 16, 5, "bfloat16", False)
    ref_params = _ref_init(ref_model, genomes, nodes, shape, kfold=1)
    want = _ref_logits(ref_model, jax.tree.map(lambda a: a[0], ref_params), genomes, nodes, x)
    port = _port_model(nodes, filters, len(genomes), shape, 16, 5, "bfloat16", False)
    port_params = params_from_reference(ref_params, nodes, shape)
    _load(port, port_params, fold=0)
    got = port(_nchw(x), _port_masks(genomes, nodes)).detach().numpy()
    assert got.dtype == np.float32
    # Both packages round to bf16 at the same places (params cast into each
    # layer, float32 accumulation, the result rounded once), so they agree to
    # float32 summation order: measured 1.5e-7 of the logit scale on these
    # inputs (at most that over five other seeds).  1e-6 of the scale leaves
    # room for order differences and none for a skipped or extra bf16 cast,
    # which moves a logit by a bf16 ulp (~4e-3) of its own size.
    scale = np.abs(want).max()
    bound = 1e-6 * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    # The bound can tell the dtypes apart: the same port in float32 sits
    # well outside it (measured 1.0e-2 of the scale), so a port that ignored
    # compute_dtype would fail above.
    port32 = _port_model(nodes, filters, len(genomes), shape, 16, 5, "float32", False)
    _load(port32, port_params, fold=0)
    got32 = port32(_nchw(x), _port_masks(genomes, nodes)).detach().numpy()
    assert np.abs(got32 - got).max() > 100 * bound


def test_params_from_reference_flatten_order():
    """Dense_0's rows move from (H, W, C) to (C, H, W) order; conv kernels
    from HWIO to OIHW; the leading prefix is kept."""
    h, w, c, u = 2, 3, 4, 5
    kernel = np.arange(h * w * c * u, dtype=np.float32).reshape(1, h * w * c, u)
    conv = np.arange(3 * 3 * 2 * 4, dtype=np.float32).reshape(1, 3, 3, 2, 4)
    tree = {
        "stage0_entry": {"kernel": conv, "bias": np.zeros((1, 4), np.float32)},
        "Dense_0": {"kernel": kernel, "bias": np.zeros((1, u), np.float32)},
    }
    out = params_from_reference(tree, nodes=(3,), input_shape=(2 * h, 2 * w, 1))
    np.testing.assert_array_equal(out["stage0_entry.weight"][0], conv[0].transpose(3, 2, 0, 1))
    hwc = kernel[0].reshape(h, w, c, u)
    for ci in range(c):
        for hi in range(h):
            for wi in range(w):
                np.testing.assert_array_equal(
                    out["Dense_0.weight"][0][ci * h * w + hi * w + wi], hwc[hi, wi, ci])


@pytest.mark.parametrize("nesterov", [False, True])
def test_params_after_sgd_steps_match_reference(nesterov):
    """Params after 4 SGD steps under a 2-stage LR (boundary at step 2)."""
    nodes, filters, shape, dense, n_classes = (3,), (4,), (8, 8, 1), 8, 4
    batch, n_train, epochs, lrs = 16, 32, (1, 1), (0.05, 0.01)
    genomes = _genomes(nodes, 2, seed=5)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(48, *shape)).astype(np.float32)
    y = rng.integers(0, n_classes, size=48).astype(np.int32)
    steps_per_epoch = n_train // batch
    batch_idx = rng.integers(0, 48, size=(sum(epochs) * steps_per_epoch, batch))

    ref_model = _ref_model(nodes, filters, dense, n_classes, "float32", False)
    ref_params = _ref_init(ref_model, genomes, nodes, shape, kfold=1)
    p0 = jax.tree.map(lambda a: jnp.asarray(a[0]), ref_params)
    _, tx, train_segment, _ = ref_cnn._training_primitives(
        nodes, filters, dense, n_classes, 0.0, "float32", epochs, lrs, 0.9, nesterov,
        batch, n_train, 16, False, 16)
    masks = [{k: jnp.asarray(v) for k, v in st.items()} for st in ref_stack(genomes, nodes)]
    keys = jax.random.split(jax.random.PRNGKey(0), len(genomes))
    opt = jax.vmap(tx.init)(p0)
    ref_after, _, _ = jax.vmap(train_segment, in_axes=(0, 0, 0, None, None, None, 0))(
        p0, opt, masks, jnp.asarray(x), jnp.asarray(y), jnp.asarray(batch_idx, jnp.int32), keys)
    want = params_from_reference(jax.tree.map(np.asarray, ref_after), nodes, shape)

    port = _port_model(nodes, filters, len(genomes), shape, dense, n_classes, "float32", False)
    _load(port, params_from_reference(ref_params, nodes, shape), fold=0)
    bufs = [torch.zeros_like(p) for p in port.parameters()]
    lr_at = port_cnn._lr_schedule(epochs, lrs, steps_per_epoch)
    assert [lr_at(t) for t in range(4)] == [np.float32(0.05)] * 2 + [
        float(np.float32(np.float32(0.01 / 0.05) * np.float32(0.05)))] * 2
    x_t, y_t = _nchw(x), torch.as_tensor(y.astype(np.int64))
    for t in range(batch_idx.shape[0]):
        port_cnn._train_step(port, _port_masks(genomes, nodes), x_t, y_t,
                             torch.as_tensor(batch_idx[t]), None, bufs, lr_at(t), 0.9, nesterov)
    # float32 both sides; the grads differ by summation order (a few ulps),
    # and 4 momentum steps carry that forward.
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5, atol=2e-6, err_msg=name)


def test_microbatch_averages_slice_gradients():
    """microbatch=2 gives the mean of the two half-batch gradients."""
    nodes, filters, shape = (3,), (4,), (8, 8, 1)
    genomes = _genomes(nodes, 2, seed=6)
    rng = np.random.default_rng(5)
    x = _nchw(rng.normal(size=(16, *shape)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 3, size=16))
    idx = torch.arange(16)
    masks = _port_masks(genomes, nodes)
    model = _port_model(nodes, filters, 2, shape, 8, 3, "float32", False)
    init = port_cnn._init_population_params(model, 1, 0, port_cnn._genome_hashes(genomes))
    _load(model, init, fold=0)
    names = [n for n, _ in model.named_parameters()]
    halves = []
    for part in (idx[:8], idx[8:]):
        loss = port_cnn._per_genome_loss(model(x.index_select(0, part), masks), y[part]).sum()
        halves.append(torch.autograd.grad(loss, list(model.parameters())))
    bufs = [torch.zeros_like(p) for p in model.parameters()]
    port_cnn._train_step(model, masks, x, y, idx, None, bufs, 1.0, 0.0, False, microbatch=2)
    # With lr=1 and momentum 0 the momentum buffer holds the applied gradient.
    for name, b, g0, g1 in zip(names, bufs, *halves):
        torch.testing.assert_close(b, (g0 + g1) / 2, rtol=0, atol=0, msg=name)


def _inject_reference_init(monkeypatch, genomes, cfg, input_shape, n_classes=4):
    """Make the port's init return the reference's draws for the same genomes.

    ``genomes`` are every genome a call may initialise (a padded slot
    repeats one of them); each call's genomes are found by their content
    hashes, so any pop, padding or one-genome-per-call routing is served.
    ``input_shape`` is the HWC shape the model is built for (after
    ``entry_channel_pad``)."""
    ref_model = _ref_model(cfg["nodes"], cfg["kernels_per_layer"], cfg["dense_units"],
                           n_classes, cfg.get("compute_dtype", "float32"),
                           cfg.get("stage_exit_conv", False))
    by_hash = {tuple(int(w) for w in h): g
               for g, h in zip(genomes, ref_cnn._genome_hashes(genomes))}

    def init(model, kfold, seed, genome_hashes, domain=0):
        these = [by_hash[tuple(int(w) for w in h)] for h in genome_hashes]
        ref = _ref_init(ref_model, these, cfg["nodes"], input_shape, kfold, seed, domain)
        return {k: torch.as_tensor(np.array(v)) for k, v in
                params_from_reference(ref, cfg["nodes"], input_shape).items()}

    monkeypatch.setattr(port_cnn, "_init_population_params", init)


_S1_GENOMES = [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 0)}, {"S_1": (1, 1, 1)}, {"S_1": (0, 0, 0)}]
_S34_GENOMES = [
    {"S_1": (1, 0, 1), "S_2": (1, 0, 0, 1, 1, 0)},
    {"S_1": (0, 0, 0), "S_2": (0, 1, 1, 0, 1, 1)},
    {"S_1": (1, 1, 1), "S_2": (0, 0, 0, 0, 0, 0)},
    {"S_1": (0, 1, 1), "S_2": (1, 1, 1, 1, 1, 1)},
]
#: ROADMAP §C's knobs: name → (config over FAST with dropout 0, genomes,
#: data form).  Every case is float32 except ``bf16``.  The reference's CPU
#: compile of a new program set takes most of a case's time (about 10 s), so
#: knobs share a case wherever they can: the flat input reuses the two-stage
#: LR case's programs; nesterov, microbatch 2 and fitness_reps 2 run as one
#: S=(3,) case; S=(3,4) with the exit conv also takes the padded entry and
#: three folds with the two-stage LR; S=(3,4) without it takes five folds of
#: batch 24 (folds of 38 rows, eval batches of 48) and pop_padding off (3
#: genomes run 3 wide, not 4).
_TWO_STAGE = dict(epochs=(1, 1), learning_rate=(0.05, 0.02))
_S34 = dict(nodes=(3, 4), kernels_per_layer=(4, 8))
PARITY_CASES = {
    "two-stage LR": (_TWO_STAGE, _S1_GENOMES, "nhwc"),
    "flat input": (dict(_TWO_STAGE, input_shape=(8, 8, 1)), _S1_GENOMES, "flat"),
    "nesterov, microbatch 2, fitness_reps 2": (
        dict(nesterov=True, momentum=0.9, microbatch=2, fitness_reps=2, epochs=(1,)),
        _S1_GENOMES, "nhwc"),
    "S=(3,4), exit conv, entry_channel_pad 4, kfold 3, two-stage LR": (
        dict(_S34, **_TWO_STAGE, stage_exit_conv=True, entry_channel_pad=4, kfold=3),
        _S34_GENOMES, "nhwc"),
    "S=(3,4), kfold 5, batch 24, pop_padding off": (
        dict(_S34, epochs=(1,), kfold=5, batch_size=24, pop_padding=False),
        _S34_GENOMES[:3], "nhwc"),
    "bf16": (dict(compute_dtype="bfloat16", epochs=(1,)), _S1_GENOMES, "nhwc"),
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_cv_accuracies_match_reference_with_injected_init(case, separable_data, monkeypatch):
    overrides, genomes, form = PARITY_CASES[case]
    x, y = separable_data
    if form == "flat":
        x = x.reshape(len(x), -1)
    cfg = dict(FAST, dropout_rate=0.0, **overrides)
    # The reference on one device, as the port runs (and it compiles in a
    # fraction of the time its 8-device test mesh takes).
    ref_cfg = dict(cfg, mesh=None)
    want = np.asarray(ref_cnn.GeneticCnnModel.cross_validate_population(x, y, genomes, **ref_cfg))
    model_shape = (8, 8, cfg.get("entry_channel_pad") or 1)
    _inject_reference_init(monkeypatch, genomes, cfg, model_shape)
    got = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
    assert got.shape == want.shape == (len(genomes),)
    if cfg["compute_dtype"] == "bfloat16":
        # Both packages round to bf16 at the same places; only float32
        # summation order differs, and training carries it forward.  A
        # validation sample whose top two logits lie within a bf16 ulp may
        # flip: one flip moves a genome's CV mean by 1/(2*96).  Allow two.
        np.testing.assert_allclose(got, want, rtol=0, atol=2 / 192 + 1e-6)
    else:
        # Same init, folds and batch orders (the host RNG is copied), no
        # dropout, float32: the same accuracies.
        assert float(np.abs(got - want).max()) == 0.0


class TestBatchCompositionPurity:
    """Port copy of the reference's ``TestBatchCompositionPurity``: fitness is
    a pure function of (genome, config, seed).  Exact on the CPU."""

    def test_fitness_invariant_to_slot_batch_and_bucket(self, separable_data):
        x, y = separable_data
        g = lambda bits: {"S_1": bits}
        a, b, c = g((1, 0, 1)), g((0, 1, 0)), g((1, 1, 1))
        batch = GeneticCnnModel.cross_validate_population(x, y, [a, b, c], **FAST)  # bucket 4
        alone = GeneticCnnModel.cross_validate_population(x, y, [b], **FAST)        # bucket 2
        swapped = GeneticCnnModel.cross_validate_population(x, y, [c, b, a, b, a], **FAST)  # bucket 8
        assert alone[0] == batch[1]
        assert (swapped[0], swapped[1], swapped[2]) == (batch[2], batch[1], batch[0])
        assert swapped[3] == batch[1] and swapped[4] == batch[0]

    def test_cross_session_packed_window_matches_solo_runs(self, separable_data):
        x, y = separable_data
        g = lambda bits: {"S_1": bits}
        sess_a = [g((1, 0, 1)), g((0, 1, 0))]
        sess_b = [g((1, 1, 0)), g((0, 0, 1))]
        packed = GeneticCnnModel.cross_validate_population(
            x, y, [sess_a[0], sess_b[0], sess_a[1], sess_b[1]], **FAST)
        solo_a = GeneticCnnModel.cross_validate_population(x, y, sess_a, **FAST)
        solo_b = GeneticCnnModel.cross_validate_population(x, y, sess_b, **FAST)
        assert (packed[0], packed[2]) == (solo_a[0], solo_a[1])
        assert (packed[1], packed[3]) == (solo_b[0], solo_b[1])

    def test_stream_domains_are_separated(self):
        """Init and dropout streams differ for one (seed, fold, genome), and
        init is the same whatever the slot."""
        h = port_cnn._genome_hashes([{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 1)}])
        hi, lo = h[0]
        assert port_cnn._stream_seed(0, 0, hi, lo) != port_cnn._stream_seed(
            0, port_cnn._INIT_DOMAIN, 0, 0, hi, lo)
        model = _port_model((3,), (4,), 2, (8, 8, 1), 8, 2, "float32", False)
        a = port_cnn._init_population_params(model, 1, 0, h)
        b = port_cnn._init_population_params(model, 1, 0, h[::-1])
        for name in a:
            torch.testing.assert_close(a[name][0, 0], b[name][0, 1], rtol=0, atol=0)


def test_executor_runs_exact_numerics_and_restores_flags(separable_data, monkeypatch):
    """Inside a fitness call float32 matmuls are IEEE float32 (TF32 off);
    the port calls no cuDNN convolution, so cuDNN's flags are left as the
    caller set them, and the caller's matmul flag comes back after it."""
    x, y = separable_data
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    seen = []
    real_step = port_cnn._train_step

    def spy(*args, **kwargs):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic))
        return real_step(*args, **kwargs)

    monkeypatch.setattr(port_cnn, "_train_step", spy)
    saved = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    try:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = True, True, False
        GeneticCnnModel.cross_validate_population(x, y, _genomes((3,), 2, seed=8), **FAST)
        after = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = saved
    assert seen and set(seen) == {(True, False, False)}
    assert after == (True, True, False)


def test_init_matches_lecun_normal_moments():
    """Weights: truncated normal on [-2, 2]·σ with σ = 1/sqrt(fan_in); biases 0."""
    model = _port_model((3,), (64,), 2, (8, 8, 3), 256, 10, "float32", False)
    params = port_cnn._init_population_params(model, 1, 0, port_cnn._genome_hashes(
        [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 1)}]))
    for name, t in params.items():
        if name.endswith(".bias"):
            assert not t.any()
            continue
        w = t[0, 0]
        fan_in = w.shape[1] * 9 if w.dim() == 4 else w.shape[0]
        std = 1.0 / np.sqrt(fan_in)
        assert float(w.abs().max()) <= 2 * std / port_cnn._TRUNC_NORMAL_STD + 1e-6
        # ≥1,728 samples per leaf: the sample std is within 10% of σ
        assert abs(float(w.std()) / std - 1.0) < 0.1, name


def test_dropout_streams_are_per_genome():
    """A genome's keep mask depends on its own generator only."""
    gens = lambda seeds: [torch.Generator().manual_seed(s) for s in seeds]
    x = torch.ones(3, 64, 32)
    both = port_cnn._dropout(x, 0.5, gens([1, 2, 3]))
    alone = port_cnn._dropout(x[1:2], 0.5, gens([2]))
    torch.testing.assert_close(both[1], alone[0], rtol=0, atol=0)
    assert set(both.unique().tolist()) == {0.0, 2.0}
    assert port_cnn._dropout(x, 0.0, gens([1, 2, 3])) is x


def test_fitness_reps_average_independent_seeds(separable_data):
    x, y = separable_data
    g = [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 1)}]
    cfg = dict(FAST, epochs=(1,))
    r0 = GeneticCnnModel.cross_validate_population(x, y, g, **cfg)
    r1 = GeneticCnnModel.cross_validate_population(x, y, g, **{**cfg, "seed": 7919})
    both = GeneticCnnModel.cross_validate_population(x, y, g, **{**cfg, "fitness_reps": 2})
    np.testing.assert_allclose(both, (r0.astype(np.float64) + r1) / 2, rtol=0, atol=1e-7)


def test_oom_chunking_splits_and_remembers(separable_data):
    """A CUDA OOM splits the batch to a power-of-two chunk, remembers the cap
    and retries outside the handler."""
    x, y = separable_data
    genomes = [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 0)}, {"S_1": (1, 1, 1)}]
    seen = []

    def run(gs):
        seen.append(len(gs))
        if len(gs) > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return GeneticCnnModel.cross_validate_population(x, y, gs, **FAST)

    key = ("test-oom-cap",)
    try:
        got = port_cnn._chunked_by_cap(run, genomes, key)
        assert port_cnn._POP_PROGRAM_CAP[key] == 1 or port_cnn._POP_PROGRAM_CAP[key] == 2
    finally:
        port_cnn._POP_PROGRAM_CAP.pop(key, None)
    assert seen[0] == 3 and max(seen[1:]) <= 2
    want = GeneticCnnModel.cross_validate_population(x, y, genomes, **FAST)
    np.testing.assert_array_equal(got, want)  # purity: chunking changes nothing


def test_non_oom_errors_propagate():
    def run(gs):
        raise ValueError("not a memory error")

    with pytest.raises(ValueError):
        port_cnn._chunked_by_cap(run, [{"S_1": (1, 0, 1)}], ("test-non-oom",))


class TestPurityAtWidth:
    """At 32×32×3, batch 64, S=(3,4), filters (16,32) the grouped conv's
    weight and bias gradients on the CPU depended on the group count (with
    4 or more intra-op threads; equal with 1 or 2), so a genome's gradient
    depended on its batch.  The port's conv runs every slot at the same shapes: slot 0's
    gradient leaves are the same bits at P=2 and P=12."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_slot0_grad_leaves_equal_alone_and_in_batch(self, dtype):
        from gentun_tpu_torch.parallel.mesh import pad_population

        rng = np.random.default_rng(0)
        x = _nchw(rng.normal(size=(64, 32, 32, 3)).astype(np.float32))
        y = torch.as_tensor(rng.integers(0, 10, size=64))
        genomes = _genomes((3, 4), 12, seed=1)

        def leaves(gs, pop):
            gs, _ = pad_population(gs, pop)
            model = _port_model((3, 4), (16, 32), pop, (32, 32, 3), 64, 10, dtype, False)
            _load(model, port_cnn._init_population_params(model, 1, 0, port_cnn._genome_hashes(gs)),
                  fold=0)
            loss = port_cnn._per_genome_loss(model(x, _port_masks(gs, (3, 4))), y).sum()
            grads = torch.autograd.grad(loss, list(model.parameters()))
            return {n: g[0] for (n, _), g in zip(model.named_parameters(), grads)}

        threads = torch.get_num_threads()
        torch.set_num_threads(4)  # where the grouped conv's reduction split by P
        try:
            alone, in_batch = leaves(genomes[:1], 2), leaves(genomes, 12)
        finally:
            torch.set_num_threads(threads)
        differ = [n for n in alone if not torch.equal(alone[n], in_batch[n])]
        assert not differ


class TestFoldParallel:
    """``fold_parallel=True``: the reference's fused-folds knob, which the
    port accepts and runs fold after fold, as without it."""

    @pytest.mark.parametrize("microbatch", [1, 2])
    def test_equals_segmented_bit_for_bit(self, separable_data, microbatch):
        x, y = separable_data
        genomes = _genomes((3,), 3, seed=11)
        cfg = dict(FAST, kfold=3, dropout_rate=0.5, microbatch=microbatch)
        seg = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
        fused = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg, fold_parallel=True)
        np.testing.assert_array_equal(fused, seg)

    def test_matches_reference_fold_parallel(self, separable_data, monkeypatch):
        x, y = separable_data
        genomes = [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 0)}, {"S_1": (1, 1, 1)}, {"S_1": (0, 0, 0)}]
        cfg = dict(FAST, dropout_rate=0.0, fold_parallel=True)
        ref_cfg = {k: v for k, v in cfg.items() if k != "mesh"}
        want = ref_cnn.GeneticCnnModel.cross_validate_population(x, y, genomes, **ref_cfg)
        _inject_reference_init(monkeypatch, genomes, cfg, (8, 8, 1))
        got = GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
        # As for the segmented executor: same init and batches, float32 sums
        # in other orders may flip two validation samples of 96 per fold.
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2 / 192 + 1e-6)


class TestTrainAndScore:
    """The holdout evaluation: train on all of x_train, score on x_test."""

    def test_matches_reference_with_injected_init(self, separable_data, monkeypatch):
        x, y = separable_data
        genomes = [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 0)}, {"S_1": (1, 1, 1)}]
        cfg = dict(FAST, dropout_rate=0.0, epochs=(1, 1), learning_rate=(0.05, 0.02))
        ref_cfg = {k: v for k, v in cfg.items() if k != "mesh"}
        args = (x[:128], y[:128], x[128:], y[128:], genomes)
        want = ref_cnn.GeneticCnnModel.train_and_score(*args, **ref_cfg)
        seen_domains = []
        _inject_reference_init(monkeypatch, genomes, cfg, (8, 8, 1))
        real_init = port_cnn._init_population_params

        def spy(model, kfold, seed, hashes, domain=0):
            seen_domains.append(domain)
            return real_init(model, kfold, seed, hashes, domain)

        monkeypatch.setattr(port_cnn, "_init_population_params", spy)
        got = GeneticCnnModel.train_and_score(*args, **cfg)
        assert got.shape == (3,) and seen_domains == [port_cnn._HOLDOUT_DOMAIN]
        # Same init (the reference's own holdout-domain draws), same batch
        # order, no dropout, float32: two of the 64 test samples may flip.
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2 / 64 + 1e-6)

    def test_holdout_streams_differ_from_cv_streams(self):
        hashes = port_cnn._genome_hashes([{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 1)}])
        model = _port_model((3,), (4,), 2, (8, 8, 1), 8, 2, "float32", False)
        cv = port_cnn._init_population_params(model, 1, 0, hashes)
        holdout = port_cnn._init_population_params(model, 1, 0, hashes,
                                                   domain=port_cnn._HOLDOUT_DOMAIN)
        assert not torch.equal(cv["stage0_entry.weight"], holdout["stage0_entry.weight"])
        draw = lambda gens: [float(torch.rand(1, generator=g)) for g in gens]
        cv_gens = port_cnn._dropout_generators(0, 0, hashes, CPU)
        ho_gens = port_cnn._dropout_generators(0, 0, hashes, CPU, port_cnn._HOLDOUT_DOMAIN)
        assert set(draw(cv_gens)).isdisjoint(draw(ho_gens))

    def test_fitness_reps_and_purity(self, separable_data):
        x, y = separable_data
        args = (x[:128], y[:128], x[128:], y[128:])
        a, b = {"S_1": (1, 0, 1)}, {"S_1": (0, 1, 0)}
        cfg = dict(FAST, epochs=(1,), dropout_rate=0.5)
        batch = GeneticCnnModel.train_and_score(*args, [a, b], **cfg)
        alone = GeneticCnnModel.train_and_score(*args, [b], **cfg)
        assert alone[0] == batch[1]
        r1 = GeneticCnnModel.train_and_score(*args, [a, b], **{**cfg, "seed": 7919})
        both = GeneticCnnModel.train_and_score(*args, [a, b], **{**cfg, "fitness_reps": 2})
        np.testing.assert_allclose(both, (batch.astype(np.float64) + r1) / 2, rtol=0, atol=1e-7)


class TestWarmStartBank:
    """The multi-fidelity warm-start bank (``warm_start=True``)."""

    @pytest.fixture(autouse=True)
    def _empty_banks(self):
        port_cnn._WARM_BANK.clear()
        ref_cnn._WARM_BANK.clear()
        yield
        port_cnn._WARM_BANK.clear()
        ref_cnn._WARM_BANK.clear()

    def test_deposited_and_overlaid_params_match_reference(self, separable_data, monkeypatch):
        x, y = separable_data
        genomes = [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 1)}, {"S_1": (1, 1, 1)}]
        cfg = dict(FAST, dropout_rate=0.0, warm_start=True)
        # The reference banks only without a device mesh (one device).
        ref_cnn.GeneticCnnModel.cross_validate_population(x, y, genomes, **{**cfg, "mesh": None})
        _inject_reference_init(monkeypatch, genomes, cfg, (8, 8, 1))
        GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
        hashes = port_cnn._genome_hashes(genomes)
        keys = [(int(hi), int(lo)) for hi, lo in hashes]
        assert list(port_cnn._WARM_BANK) == keys == list(ref_cnn._WARM_BANK)
        # The banks: each genome's fold-0 params after 6 float32 SGD steps
        # from the same init and batches; summation order differs by a few
        # ulps per step, which momentum carries forward.
        for key in keys:
            want = params_from_reference(jax.tree.map(np.asarray, ref_cnn._WARM_BANK[key]),
                                         (3,), (8, 8, 1))
            for name, leaf in port_cnn._WARM_BANK[key].items():
                np.testing.assert_allclose(leaf, want[name], rtol=1e-4, atol=1e-5, err_msg=name)
        # The overlay on a fresh 2-fold init of the banked genomes plus one
        # the bank has never seen: banked slots take their bank entry on both
        # folds, the other slot keeps its fresh init.
        fresh_genomes = [genomes[1], {"S_1": (0, 0, 1)}]
        ref_model = _ref_model((3,), (8,), 32, 4, "float32", False)
        fresh = _ref_init(ref_model, fresh_genomes, (3,), (8, 8, 1), kfold=2)
        fresh_hashes = port_cnn._genome_hashes(fresh_genomes)
        ref_out, ref_warmed = ref_cnn._warm_start_overlay(
            jax.tree.map(jnp.asarray, fresh), ref_cnn._genome_hashes(fresh_genomes))
        port_in = {k: torch.as_tensor(np.array(v)) for k, v in
                   params_from_reference(fresh, (3,), (8, 8, 1)).items()}
        port_out, port_warmed = port_cnn._warm_start_overlay(port_in, fresh_hashes)
        assert port_warmed == ref_warmed == 1
        want = params_from_reference(jax.tree.map(np.asarray, ref_out), (3,), (8, 8, 1))
        for name, leaf in port_out.items():
            np.testing.assert_allclose(leaf[:, 0].numpy(), want[name][:, 0], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
            np.testing.assert_array_equal(leaf[:, 1].numpy(), want[name][:, 1], err_msg=name)

    def test_off_by_default_and_with_fold_parallel(self, separable_data):
        x, y = separable_data
        GeneticCnnModel.cross_validate_population(x, y, [{"S_1": (1, 0, 1)}], **FAST)
        GeneticCnnModel.cross_validate_population(
            x, y, [{"S_1": (1, 0, 1)}], **FAST, warm_start=True, fold_parallel=True)
        assert not port_cnn._WARM_BANK

    def test_inherit_moves_fitness_and_skips_shape_mismatch(self, separable_data):
        x, y = separable_data
        genomes = [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 1)}]
        cfg = dict(FAST, epochs=(1,), warm_start=True)
        GeneticCnnModel.cross_validate_population(x, y, genomes, **cfg)
        assert len(port_cnn._WARM_BANK) == 2
        longer = {**cfg, "epochs": (2,)}
        warm = GeneticCnnModel.cross_validate_population(x, y, genomes, **longer)
        port_cnn._WARM_BANK.clear()
        cold = GeneticCnnModel.cross_validate_population(x, y, genomes, **longer)
        assert not np.array_equal(warm, cold)
        # Another width: every banked leaf mismatches, fresh inits run.
        wider = GeneticCnnModel.cross_validate_population(
            x, y, genomes[:1], **{**cfg, "kernels_per_layer": (16,), "dense_units": 16})
        assert wider.shape == (1,)


class TestConfig:
    """``_normalize_config``: the same 25 keys, defaults and errors."""

    BAD = [
        dict(kernels_per_layer=(8, 8)),
        dict(epochs=(1, 2), learning_rate=(0.1,)),
        dict(segment_steps=0),
        dict(fitness_reps=0),
        dict(device_budget=0),
        dict(microbatch=0),
        dict(entry_channel_pad=0),
        dict(bogus_knob=1),
    ]

    @pytest.mark.parametrize("bad", BAD, ids=lambda d: ",".join(d))
    def test_same_errors_for_bad_inputs(self, bad, separable_data):
        x, y = separable_data
        cfg = {**{k: v for k, v in FAST.items() if k != "mesh"}, **bad}
        with pytest.raises((TypeError, ValueError)) as ref_err:
            ref_cnn._normalize_config(x, y, dict(cfg))
        with pytest.raises(ref_err.type) as port_err:
            port_cnn._normalize_config(x, y, dict(cfg))
        assert str(port_err.value) == str(ref_err.value)

    def test_flat_input_without_shape_raises_the_same(self):
        x, y = np.zeros((8, 64), np.float32), np.zeros(8, np.int32)
        with pytest.raises(ValueError) as ref_err:
            ref_cnn._normalize_config(x, y, {})
        with pytest.raises(ValueError) as port_err:
            port_cnn._normalize_config(x, y, {})
        assert str(port_err.value) == str(ref_err.value)

    def test_same_keys_and_defaults(self, separable_data):
        x, y = separable_data
        ref = ref_cnn._normalize_config(x, y, {})
        port = port_cnn._normalize_config(x, y, {})
        assert ref == port
        assert len(set(ref) - {"raw_input_shape"}) == 25
        padded = dict(entry_channel_pad=4, input_shape=(8, 8, 1))
        assert ref_cnn._normalize_config(x, y, padded) == port_cnn._normalize_config(x, y, padded)

    @pytest.mark.parametrize("knob", [dict(fold_parallel=True), dict(warm_start=True)])
    def test_unported_executors_refuse(self, knob, separable_data, monkeypatch):
        """With either executor knob on, a budget that puts the genome off
        the wide-pop path routes it (the micro class: one genome per call,
        unpadded, microbatch 4) in both entry points instead of refusing."""
        x, y = separable_data
        big = {**FAST, **knob, "device_budget": 200_000}
        calls = _spy_calls(monkeypatch)
        genomes = [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 1)}]
        cv = GeneticCnnModel.cross_validate_population(x, y, genomes, **big)
        holdout = GeneticCnnModel.train_and_score(x, y, x[:32], y[:32], genomes, **big)
        assert cv.shape == holdout.shape == (2,)
        assert calls == [("cv", 1, False, 4)] * 2 + [("holdout", 1, False, 4)] * 2

    def test_big_genome_budget_refuses(self, separable_data):
        """A budget below one genome's parameter state and one example
        refuses in both entry points, before any work."""
        x, y = separable_data
        cost = cnn_genome_cost((3,), (8,), (8, 8, 1), 32, 4, "float32")
        tiny = {**FAST, "device_budget": cost.param_bytes}
        with pytest.raises(ValueError, match="unevaluable"):
            GeneticCnnModel.cross_validate_population(x, y, [{"S_1": (1, 0, 1)}], **tiny)
        with pytest.raises(ValueError, match="unevaluable"):
            GeneticCnnModel.train_and_score(x, y, x[:32], y[:32], [{"S_1": (1, 0, 1)}], **tiny)


def _spy_calls(monkeypatch):
    """Record (entry point, genomes, pop_padding, microbatch) of every call
    of the one-program evaluators."""
    calls = []
    for name, tag in (("_cross_validate_population_one", "cv"), ("_train_and_score_one", "holdout")):
        real = getattr(GeneticCnnModel, name).__func__

        def spy(cls, *args, _real=real, _tag=tag, **cfg):
            calls.append((_tag, len(args[-1]), cfg.get("pop_padding", True), cfg.get("microbatch", 1)))
            return _real(cls, *args, **cfg)

        monkeypatch.setattr(GeneticCnnModel, name, classmethod(spy))
    return calls


@pytest.mark.parametrize("fault", ["one input channel of four", "float64 leaf"])
def test_mismatched_initial_param_leaf_raises(fault, separable_data, monkeypatch):
    """A leaf of the wrong shape or dtype is refused by name before any
    step, not broadcast into the parameter."""
    x, y = separable_data
    cfg = dict(FAST, epochs=(1,), entry_channel_pad=4)
    real = port_cnn._init_population_params

    def faulty(model, kfold, seed, hashes, domain=0):
        params = real(model, kfold, seed, hashes, domain)
        if fault == "float64 leaf":
            params["Dense_1.bias"] = params["Dense_1.bias"].double()
        else:
            params["stage0_entry.weight"] = params["stage0_entry.weight"][:, :, :, :1]
        return params

    monkeypatch.setattr(port_cnn, "_init_population_params", faulty)
    ran = []
    monkeypatch.setattr(port_cnn, "_train_step", lambda *a, **k: ran.append(1))
    leaf = "Dense_1.bias" if fault == "float64 leaf" else "stage0_entry.weight"
    with pytest.raises(ValueError, match=leaf):
        GeneticCnnModel.cross_validate_population(x, y, [{"S_1": (1, 0, 1)}], **cfg)
    assert not ran


class TestSizeClassRouting:
    """Port copies of the reference's ``TestShardedTraining`` budget tests,
    on one device (a data axis of 1), plus the micro route held against the
    reference's explicit-microbatch run and the cost-model gauges."""

    GENOMES = [{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 1)}]

    @staticmethod
    def _cost():
        return cnn_genome_cost((3,), (8,), (8, 8, 1), 32, 4, "float32")

    def test_generous_budget_keeps_small_path_bit_identical(self, separable_data):
        x, y = separable_data
        ref = GeneticCnnModel.cross_validate_population(x, y, self.GENOMES, **FAST)
        on = GeneticCnnModel.cross_validate_population(
            x, y, self.GENOMES, device_budget=10**12, **FAST)
        assert np.array_equal(ref, on)

    def test_big_genome_data_sharded_path(self, separable_data, monkeypatch):
        """With a data axis of 1 the budget that the reference's 8 devices
        route ``big`` (param_bytes + 8 examples) is ``micro`` here: the
        batch of 32 needs a factor of 4.  Each genome runs alone, unpadded,
        with gradient accumulation, the same bits as the explicit run."""
        from gentun_tpu_torch.telemetry.registry import get_registry

        x, y = separable_data
        cost = self._cost()
        budget = cost.param_bytes + cost.act_bytes_per_example * 8
        assert port_cnn._genome_size_class(port_cnn._normalize_config(
            x, y, dict(FAST, device_budget=budget))) == ("micro", 4)
        reg = get_registry()
        reg.reset()
        calls = _spy_calls(monkeypatch)
        micro = GeneticCnnModel.cross_validate_population(
            x, y, self.GENOMES, device_budget=budget, **FAST)
        assert calls == [("cv", 1, False, 4)] * 2
        assert reg.counter("microbatch_steps_total").value > 0
        reg.reset()
        explicit = np.concatenate([
            GeneticCnnModel.cross_validate_population(
                x, y, [g], **{**FAST, "microbatch": 4, "pop_padding": False})
            for g in self.GENOMES])
        assert np.array_equal(micro, explicit)

    def test_unevaluable_budget_is_loud(self, separable_data):
        x, y = separable_data
        with pytest.raises(ValueError, match="unevaluable"):
            GeneticCnnModel.cross_validate_population(
                x, y, [{"S_1": (1, 0, 1)}], device_budget=self._cost().param_bytes, **FAST)

    def test_micro_route_matches_reference_explicit_microbatch(self, separable_data, monkeypatch):
        """The port's micro route (factor 4) against the reference run with
        ``microbatch=4``, ``pop_padding=False``, one genome per call, on one
        device, from the same injected init; float32, dropout 0.  (The
        reference's own budget classification sees 8 test devices and is not
        compared.)"""
        x, y = separable_data
        cost = self._cost()
        cfg = dict(FAST, dropout_rate=0.0, epochs=(1,))
        ref_cfg = dict(cfg, mesh=None, microbatch=4, pop_padding=False)
        want = np.concatenate([
            np.asarray(ref_cnn.GeneticCnnModel.cross_validate_population(x, y, [g], **ref_cfg))
            for g in self.GENOMES])
        _inject_reference_init(monkeypatch, self.GENOMES, cfg, (8, 8, 1))
        got = GeneticCnnModel.cross_validate_population(
            x, y, self.GENOMES, device_budget=cost.param_bytes + cost.act_bytes_per_example * 8,
            **cfg)
        # Same init, folds, batches and microbatch slices, float32: the same
        # accuracies.
        assert float(np.abs(got - want).max()) == 0.0

    def test_cost_calibration_gauges(self, separable_data):
        """The cost model's prediction beside the params this call drew: the
        supergraph's parameter count is the model's, so the two agree; the
        allocator's bytes are absent on the CPU."""
        from gentun_tpu_torch.telemetry.registry import get_registry

        x, y = separable_data
        reg = get_registry()
        reg.reset()
        cost = self._cost()
        GeneticCnnModel.cross_validate_population(x, y, self.GENOMES, **FAST)
        gauges = {(g["labels"]["size_class"], g["labels"]["source"]): g["value"]
                  for g in reg.snapshot()["gauges"] if g["name"] == "genome_cost_calibration"}
        assert gauges == {
            ("small", "predicted_param_bytes"): cost.param_bytes,
            ("small", "measured_param_bytes"): cost.param_bytes,
            ("small", "predicted_act_bytes_batch"): cost.act_bytes_per_example * 32,
        }
        reg.reset()

    def test_cache_dir_points_the_kernel_build(self, separable_data, tmp_path):
        from gentun_tpu_torch.ops import _build

        x, y = separable_data
        before = _build.build_dir()
        try:
            GeneticCnnModel.cross_validate_population(
                x, y, self.GENOMES[:1], **FAST, cache_dir=str(tmp_path / "kernels"))
            assert _build.build_dir() == tmp_path / "kernels"
            assert _build.library_path().parent == tmp_path / "kernels"
            GeneticCnnModel.cross_validate_population(x, y, self.GENOMES[:1], **FAST)
            assert _build.build_dir() == _build.BUILD_DIR
        finally:
            _build.use_build_dir(before)


def test_auto_mesh_without_cuda_raises_and_runs_nothing(separable_data, monkeypatch):
    """No hidden CPU: with no CUDA device, mesh='auto' raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(port_cnn, "_run_segmented", lambda *a, **k: ran.append(1))
    x, y = separable_data
    cfg = {k: v for k, v in FAST.items() if k != "mesh"}
    for mesh in ("auto", None):
        with pytest.raises(RuntimeError, match="CUDA"):
            GeneticCnnModel.cross_validate_population(x, y, [{"S_1": (1, 0, 1)}], **cfg, mesh=mesh)
    with pytest.raises(RuntimeError, match="CUDA"):
        GeneticCnnModel.cross_validate_population(x, y, [{"S_1": (1, 0, 1)}], **cfg)
    assert not ran


def test_dataset_cache_hits_and_detects_mutation(separable_data):
    x, y = separable_data
    x, y = x.copy(), y.copy()
    cfg = port_cnn._normalize_config(x, y, dict(FAST))
    perm = np.arange(len(x))
    a = port_cnn._device_dataset(x, y, x, y, perm, cfg, CPU)
    b = port_cnn._device_dataset(x, y, x, y, perm, cfg, CPU)
    assert a[0] is b[0] and a[1] is b[1]
    assert tuple(a[0].shape) == (192, 1, 8, 8) and a[1].dtype == torch.int64
    x[::2] += 1.0
    c = port_cnn._device_dataset(x, y, x, y, perm, cfg, CPU)
    assert c[0] is not a[0]
    torch.testing.assert_close(c[0], _nchw(x))
