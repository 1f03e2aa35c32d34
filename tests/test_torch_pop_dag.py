"""The stage DAG's kernels' plain versions and :class:`PopStageFn`, held on the CPU.

On a CPU tensor every wrapper of ``ops/pop_dag.py`` runs its plain version,
so these tests hold the arithmetic the CUDA kernels repeat (``chip_smoke.py``
phase K holds each kernel against its plain version on the card, bit for
bit): the whole model against the JAX package's ``MaskedGeneticCnn`` (logits
and every parameter leaf's gradient), the stage function against
``gradcheck`` in float64 and against autograd of the eager chain it replaced
(bit for bit, which decides ``FITNESS_PROTOCOL``), a slot's bits at any pop
width, and the wrappers' refusals.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from gentun_tpu.models import cnn as ref_cnn
from gentun_tpu.ops.dag import stack_genome_masks as ref_stack

from gentun_tpu_torch.models.cnn import MaskedGeneticCnn, params_from_reference
from gentun_tpu_torch.ops import _build, pop_dag
from gentun_tpu_torch.ops.dag import stack_genome_masks
from gentun_tpu_torch.ops.pop_conv import PopConv3x3Fn
from gentun_tpu_torch.ops.pop_dag import (
    DagMasks,
    PopStageFn,
    pool_reference,
    pop_dag_node_grad,
    pop_dag_node_input,
    pop_dag_stage_out,
    pop_stage,
    stage_masks,
    unpool_reference,
)
from gentun_tpu_torch.utils.fitness_store import FITNESS_PROTOCOL


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for this module's torch work, restored after (see
    ``tests/test_torch_cnn.py``: small per-slot convs beside other test
    workers wait on descheduled threads otherwise)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


#: Stage bit strings with the edge cases the stage function must take: a
#: stage that decodes empty (has_active = 0: the pass-through), isolated
#: nodes (only the edge 0 -> 1 of four nodes), a chain and a full DAG.
GENOMES_43 = [
    {"S_1": (0, 0, 0, 0, 0, 0), "S_2": (1, 1, 0)},
    {"S_1": (1, 0, 0, 0, 0, 0), "S_2": (0, 0, 0)},
    {"S_1": (1, 0, 0, 1, 0, 1), "S_2": (1, 0, 0)},
    {"S_1": (1, 1, 1, 1, 1, 1), "S_2": (0, 1, 1)},
]


def _masks(genomes, nodes):
    return [{k: torch.as_tensor(v) for k, v in st.items()} for st in stack_genome_masks(genomes, nodes)]


def _nchw(x_nhwc):
    return torch.as_tensor(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _chain_forward(model: MaskedGeneticCnn, x, masks):
    """The model's forward as it ran before the stage function: the eager
    chain of torch ops around :class:`PopConv3x3Fn`, which autograd
    differentiates."""
    dtype, pop, b = model.compute_dtype, model.pop, x.shape[0]
    scale = lambda v, t: v.view(1, -1, 1, 1, 1) * t

    def conv(name, inp):
        layer = model[name]
        return PopConv3x3Fn.apply(inp, layer.weight.to(dtype), layer.bias.to(dtype),
                                  layer.shared_input)

    x = x.to(dtype)
    for s, k in enumerate(model.nodes):
        m = {n: v.to(dtype) for n, v in masks[s].items()}
        a0 = F.relu(conv(f"stage{s}_entry", x))
        hh, ww = a0.shape[-2:]
        a0 = a0.reshape(b, pop, -1, hh, ww)
        outs = []
        for j in range(k):
            inp = scale(m["entry"][:, j], a0)
            for i in range(j):
                inp = inp + scale(m["adj"][:, i, j], outs[i])
            h = F.relu(conv(f"stage{s}_node{j}", inp.reshape(b, -1, hh, ww)))
            outs.append(scale(m["active"][:, j], h.reshape(b, pop, -1, hh, ww)))
        if k:
            out = scale(m["exit"][:, 0], outs[0])
            for i in range(1, k):
                out = out + scale(m["exit"][:, i], outs[i])
            x = scale(m["has_active"], out) + scale(1.0 - m["has_active"], a0)
        else:
            x = a0
        x = x.reshape(b, -1, hh, ww)
        if model.stage_exit_conv:
            x = F.relu(conv(f"stage{s}_exit", x))
        x = F.max_pool2d(x, 2)
    x = x.reshape(b, pop, -1).transpose(0, 1)
    x = F.relu(model["Dense_0"](x, dtype))
    return model["Dense_1"](x.float(), torch.float32)


def _random_model(nodes, filters, pop, shape, dtype, exit_conv, seed=0):
    model = MaskedGeneticCnn(nodes, filters, pop, shape, 16, 5, 0.0, dtype, exit_conv)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return model


# ---------------------------------------------------------------------------
# The slice as a whole against the JAX package
# ---------------------------------------------------------------------------

PARITY_CASES = {
    # name: (nodes, filters, input HWC, stage_exit_conv)
    "S=(4,3), odd 15x13 -> 7x6 -> 3x3": ((4, 3), (4, 6), (15, 13, 2), False),
    "S=(4,3), exit conv, 12x12": ((4, 3), (4, 5), (12, 12, 1), True),
}


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_logits_and_every_grad_leaf_match_reference_float32(case):
    """The model, every stage through :class:`PopStageFn`, against the
    reference's ``MaskedGeneticCnn`` in float32 on params injected with
    ``params_from_reference``: logits and the gradient of every parameter
    leaf of ``sum(logits · cotangent)`` (``jax.grad`` per genome)."""
    nodes, filters, shape, exit_conv = PARITY_CASES[case]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(5, *shape)).astype(np.float32)
    cot = rng.normal(size=(len(GENOMES_43), 5, 5)).astype(np.float32)
    ref_model = ref_cnn.MaskedGeneticCnn(nodes=nodes, filters=filters, dense_units=16,
                                         n_classes=5, dropout_rate=0.0,
                                         compute_dtype=jnp.float32, stage_exit_conv=exit_conv)
    stacked = [{k: jnp.asarray(v) for k, v in st.items()} for st in ref_stack(GENOMES_43, nodes)]
    params = ref_cnn._init_population_params(
        ref_model, stacked, shape, len(GENOMES_43), 1, 0, ref_cnn._genome_hashes(GENOMES_43))
    params = jax.tree.map(lambda a: np.asarray(a)[0], params)

    @jax.jit
    def value_and_grad(p, m, c):
        loss = lambda q: jnp.sum(ref_model.apply({"params": q}, jnp.asarray(x), m) * c)
        return jax.value_and_grad(loss)(p), ref_model.apply({"params": p}, jnp.asarray(x), m)

    want_logits, want_grads = [], []
    for i in range(len(GENOMES_43)):
        (_, g), logits = value_and_grad(jax.tree.map(lambda a: a[i], params),
                                        [{k: v[i] for k, v in st.items()} for st in stacked],
                                        jnp.asarray(cot[i]))
        want_logits.append(np.asarray(logits))
        want_grads.append(jax.tree.map(np.asarray, g))
    want_grads = params_from_reference(
        jax.tree.map(lambda *a: np.stack(a), *want_grads), nodes, shape)

    model = MaskedGeneticCnn(nodes, filters, len(GENOMES_43), shape, 16, 5, 0.0, "float32",
                             exit_conv)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.as_tensor(np.array(params_from_reference(params, nodes, shape)[name])))
    logits = model(_nchw(x), _masks(GENOMES_43, nodes))
    grads = torch.autograd.grad((logits * torch.as_tensor(cot)).sum(), list(model.parameters()))
    # float32 both sides; XLA:CPU and the port's per-slot F.conv2d sum each
    # conv's 3x3xC products in different orders, a few ulps per layer over
    # up to 10 layers; the gradients go through as many layers again.
    np.testing.assert_allclose(logits.detach().numpy(), np.stack(want_logits),
                               rtol=1e-5, atol=1e-5)
    for (name, _), got in zip(model.named_parameters(), grads):
        want = want_grads[name]
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The stage function
# ---------------------------------------------------------------------------


def _stage_inputs(slots, k, c, f, b, h, w, dtype, exit_conv, seed=0, requires_grad=True):
    """A stage's input, decoded masks (slot 0 empty, slot 1 with isolated
    nodes when k >= 3) and params, drawn with numpy."""
    from gentun_tpu_torch.genes import genetic_cnn_genome

    rng = np.random.default_rng(seed)
    spec = genetic_cnn_genome((k,))
    genomes = [spec.sample(rng) for _ in range(slots)]
    genomes[0] = {"S_1": (0,) * (k * (k - 1) // 2)}
    if slots > 1 and k >= 3:
        genomes[1] = {"S_1": (1,) + (0,) * (k * (k - 1) // 2 - 1)}
    masks = stage_masks(_masks(genomes, (k,))[0])
    t = lambda *shape: torch.tensor(rng.normal(size=shape), dtype=dtype,
                                    requires_grad=requires_grad)
    params = [t(slots, f, c, 3, 3), t(slots, f)]
    for _ in range(k + (1 if exit_conv else 0)):
        params += [t(slots, f, f, 3, 3), t(slots, f)]
    return t(b, slots * c, h, w), masks, params


@pytest.mark.parametrize("exit_conv", [False, True], ids=["pool", "exit conv"])
def test_stage_fn_passes_gradcheck_float64(exit_conv):
    """The hand-written backward of :class:`PopStageFn` against finite
    differences in float64, with respect to the stage input and every
    weight and bias, on odd 5x7 images (a floored pool)."""
    x, masks, params = _stage_inputs(3, 3, 2, 2, 2, 5, 7, torch.float64, exit_conv, seed=3)
    fn = lambda xx, *pp: PopStageFn.apply(xx, False, True, *masks, *pp)
    assert torch.autograd.gradcheck(fn, (x, *params), eps=1e-6, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("exit_conv", [False, True], ids=["pool", "exit conv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_model_equals_autograd_of_the_eager_chain_bit_for_bit(dtype, exit_conv):
    """The model's logits and every parameter's gradient through the stage
    function are the bits autograd of the eager chain gave (the
    ``FITNESS_PROTOCOL`` case): the forward rounds where the chain rounds,
    and each node's gradient sums its terms in the order autograd
    accumulated them (the stage term, then the successors in descending
    order).  So fitness stores, caches and canary goldens keep ``torch-1``.
    Three stages of 4, 3 and 2 nodes on 15x13 images (floored pools), one
    genome's first stage empty."""
    nodes, filters, shape = (4, 3, 2), (4, 6, 5), (15, 13, 3)
    rng = np.random.default_rng(0)
    from gentun_tpu_torch.genes import genetic_cnn_genome

    spec = genetic_cnn_genome(nodes)
    genomes = [spec.sample(rng) for _ in range(5)]
    genomes[0] = {**genomes[0], "S_1": (0,) * 6}
    masks = _masks(genomes, nodes)
    model = _random_model(nodes, filters, 5, shape, str(dtype).split(".")[1], exit_conv)
    x = torch.as_tensor(rng.normal(size=(6, 3, 15, 13)).astype(np.float32))
    cot = torch.as_tensor(rng.normal(size=(5, 6, 5)).astype(np.float32))
    params = list(model.parameters())
    got = model(x, masks)
    got_grads = torch.autograd.grad((got * cot).sum(), params)
    want = _chain_forward(model, x, masks)
    want_grads = torch.autograd.grad((want * cot).sum(), params)
    assert torch.equal(got, want)
    differ = [n for (n, _), a, b in zip(model.named_parameters(), got_grads, want_grads)
              if not torch.equal(a, b)]
    assert not differ
    assert FITNESS_PROTOCOL == "torch-1"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_a_slot_has_the_same_bits_at_p1_and_p5(dtype):
    """Slot 3's stage output and gradients (its input's and its weights')
    are the same bits when it runs alone as when it runs as slot 3 of 5."""
    slots, k, c, f, b, h, w = 5, 4, 3, 4, 2, 9, 8
    for exit_conv in (False, True):
        x, masks, params = _stage_inputs(slots, k, c, f, b, h, w, dtype, exit_conv, seed=7)
        z = pop_stage(x, masks, params)
        gz = torch.as_tensor(np.random.default_rng(1).normal(size=z.shape)).to(dtype)
        grads = torch.autograd.grad(z, [x, *params], gz)
        s = 3
        x1 = x.detach().view(b, slots, c, h, w)[:, s].contiguous().requires_grad_()
        m1 = DagMasks(*(m[s:s + 1].contiguous() for m in masks))
        p1 = [p.detach()[s:s + 1].contiguous().requires_grad_() for p in params]
        z1 = pop_stage(x1, m1, p1)
        g1 = torch.autograd.grad(z1, [x1, *p1],
                                 gz.view(b, slots, f, h // 2, w // 2)[:, s].contiguous())
        assert torch.equal(z1, z.view(b, slots, f, h // 2, w // 2)[:, s])
        assert torch.equal(g1[0], grads[0].view(b, slots, c, h, w)[:, s])
        for got, full in zip(g1[1:], grads[1:]):
            assert torch.equal(got[0], full[s])


def test_eval_keeps_nothing_and_cpu_calls_launch_nothing():
    """Under ``no_grad`` the stage function keeps nothing for a backward,
    and no CPU call counts a launch."""
    before = dict(pop_dag.LAUNCHES)
    x, masks, params = _stage_inputs(2, 3, 2, 3, 2, 6, 6, torch.float32, True, seed=2)
    z = pop_stage(x, masks, params)
    torch.autograd.grad(z.sum(), params)
    with torch.no_grad():
        z2 = pop_stage(x, masks, params)
    assert z2.grad_fn is None and torch.equal(z2, z.detach())
    assert pop_dag.LAUNCHES == before
    assert set(before) >= {"pop_dag_node_input", "pop_dag_stage_out", "pop_dag_node_grad"}
    assert pop_dag.LAUNCHES is _build.LAUNCHES


@pytest.mark.parametrize("exit_conv", [False, True], ids=["pool", "exit conv"])
def test_stage_frees_its_intermediates_after_its_backward(exit_conv):
    """A stage keeps its intermediates (raw conv outputs, node inputs, the
    exit conv's input and output, the argmax) through ``save_for_backward``,
    so autograd frees them once the stage's backward is done, not when the
    whole graph goes."""
    k = 3
    x, masks, params = _stage_inputs(2, k, 2, 3, 2, 6, 6, torch.float32, exit_conv, seed=4)
    z = pop_stage(x, masks, params)
    saved = z.grad_fn.saved_tensors
    # x, the five masks, the params; y_entry, k ys, k node inputs; the exit
    # conv's input and output (None without it) and the argmax.
    assert len(saved) == 1 + 5 + len(params) + 1 + 2 * k + 3
    assert (saved[-3] is None) == (not exit_conv) and saved[-1].dtype == torch.uint8
    del saved
    torch.autograd.grad(z.sum(), params)
    with pytest.raises(RuntimeError, match="freed"):
        z.grad_fn.saved_tensors


# ---------------------------------------------------------------------------
# The kernels' plain versions
# ---------------------------------------------------------------------------


def test_pool_picks_the_first_maximum_and_a_nan_as_max_pool2d_does():
    """The window rule the kernel and its plain version share, against
    ``F.max_pool2d``'s values, indices and gradient: ties (all-zero windows
    after ReLU, and tied maxima) go to the first in window order, a NaN wins,
    and a floored pool drops the odd last row and column."""
    x = torch.tensor([[0.0, 0.0, 1.0, 2.0, 5.0],
                      [0.0, 0.0, 2.0, 0.5, 5.0],
                      [3.0, 3.0, float("nan"), 1.0, 5.0],
                      [0.0, 3.0, 7.0, float("nan"), 5.0],
                      [9.0, 9.0, 9.0, 9.0, 9.0]]).view(1, 1, 5, 5)
    z, arg = pool_reference(x)
    want, idx = F.max_pool2d(x, 2, return_indices=True)
    assert torch.equal(z.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(z), torch.nan_to_num(want))
    # window position (2·dh + dw) of each argmax, as F.max_pool2d's flat index
    ho, wo = torch.meshgrid(torch.arange(2), torch.arange(2), indexing="ij")
    flat = (2 * ho + arg[0, 0].long() // 2) * 5 + 2 * wo + arg[0, 0].long() % 2
    assert torch.equal(flat, idx[0, 0])
    gz = torch.tensor([[1.0, 2.0], [3.0, 4.0]]).view(1, 1, 2, 2)
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(F.max_pool2d(xg, 2), xg, gz)
    assert torch.equal(unpool_reference(gz, arg, 5, 5), g)


def test_a_zero_scalar_still_reads_its_tensor():
    """``0·inf = NaN``, as in the chain: a predecessor whose mask scalar is 0
    is read all the same."""
    s, k = 1, 2
    masks = DagMasks(torch.zeros(s, k, k), torch.tensor([[0.0, 0.0]]), torch.ones(s, k),
                     torch.tensor([[0.0, 1.0]]), torch.ones(s))
    y_entry = torch.full((1, 2, 2, 2), float("inf"))
    ys = [torch.ones(1, 2, 2, 2), torch.ones(1, 2, 2, 2)]
    ys[0][0, 0, 0, 0] = float("inf")
    assert pop_dag_node_input(y_entry, ys, 1, masks).isnan().all()
    out = pop_dag_stage_out(y_entry, ys, masks, pool=False)
    assert out.isnan().all()  # (1 - has)·inf = NaN in every element


def test_wrappers_refuse_shapes_and_dtypes_the_kernels_do_not_take():
    x, masks, params = _stage_inputs(2, 3, 2, 3, 2, 6, 6, torch.float32, False,
                                     requires_grad=False)
    y = torch.randn(2, 6, 6, 6)
    ys = [torch.randn(2, 6, 6, 6) for _ in range(3)]
    with pytest.raises(TypeError):  # float16 is none of bf16, float32, float64
        pop_dag_node_input(y.half(), [t.half() for t in ys], 1, masks)
    with pytest.raises(ValueError):  # masks not float32
        pop_dag_node_input(y, ys, 1, DagMasks(*(m.double() for m in masks)))
    with pytest.raises(TypeError):  # masks not DagMasks
        pop_dag_node_input(y, ys, 1, tuple(masks))
    with pytest.raises(ValueError):  # S·F channels not a multiple of the slots
        pop_dag_node_input(torch.randn(2, 5, 6, 6), ys, 0, masks)
    with pytest.raises(ValueError):  # a predecessor of another shape
        pop_dag_node_input(y, [ys[0], torch.randn(2, 6, 5, 6)], 2, masks)
    with pytest.raises(ValueError):  # node index outside the stage
        pop_dag_node_input(y, ys, 3, masks)
    with pytest.raises(ValueError):  # some but not all node outputs
        pop_dag_stage_out(y, ys[:2], masks, pool=True)
    with pytest.raises(ValueError):  # a 1-row image has no 2x2 window
        pop_dag_stage_out(torch.randn(2, 6, 1, 6), [], masks, pool=True)
    z, arg = pop_dag_stage_out(y, ys, masks, pool=True)
    with pytest.raises(ValueError):  # the argmax must be uint8
        pop_dag_node_grad(y, z, arg.long(), "entry", -1, ys, masks)
    with pytest.raises(ValueError):  # a node's successors' gradients missing
        pop_dag_node_grad(y, z, arg, "node", 0, [None, None, ys[2]], masks)
    with pytest.raises(ValueError):
        pop_dag_node_grad(y, z, arg, "sum", 0, ys, masks)
    with pytest.raises(ValueError):  # more nodes than a launch takes pointers for
        k = pop_dag.MAX_NODES + 1
        big = DagMasks(torch.zeros(2, k, k), *(torch.zeros(2, k) for _ in range(3)), torch.ones(2))
        pop_dag_node_input(y, [], 0, big)
    with pytest.raises(RuntimeError):  # neither a CPU nor a CUDA tensor
        pop_dag_node_input(y.to("meta"), [t.to("meta") for t in ys], 1, masks)
    with pytest.raises(ValueError):  # a shared stage input gets no gradient
        pop_stage(x[:, :2].contiguous().requires_grad_(), masks, params, shared=True)


def test_profile_tool_files_the_dag_kernels_in_a_group_of_their_own():
    """The step profile's groups: the DAG kernels' mangled names (their
    ``mul``/``add`` would match the elementwise pattern) land in "port DAG",
    torch's own elementwise and pooling kernels where they were."""
    from gentun_tpu_torch.tools.profile_train_step import _group

    for kernel in ("dag_node_input_kernel", "dag_stage_out_kernel", "dag_node_grad_kernel"):
        name = f"_ZN43_GLOBAL__N__83f3f693_10_pop_dag_cu_6540908620{kernel}I13__nv_bfloat16Li8EEEv"
        assert _group(name) == "port DAG"
    assert _group("void at::native::vectorized_elementwise_kernel<4, MulFunctor<float>>") == \
        "elementwise"
    assert _group("void at::native::max_pool_forward_nchw<c10::BFloat16>") == "pooling"
