"""The port's population-batched 3×3 conv (``gentun_tpu_torch.ops.pop_conv``) on the CPU.

On a CPU tensor the wrappers compute with the plain PyTorch version, so these
tests hold that version, and :class:`PopConv3x3Fn`'s backward (the input
gradient as the forward on ``dY`` with the weights turned 180°, the weight
and bias gradients as the weight-gradient wrapper), against the JAX
package's conv under ``vmap`` and ``jax.vjp``, with the same numpy inputs.
The kernels themselves run only on the card (``chip_smoke.py`` holds each
against this plain version there).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gentun_tpu_torch.ops import _build
from gentun_tpu_torch.ops import pop_conv
from gentun_tpu_torch.ops.pop_conv import (
    PopConv3x3Fn,
    pop_conv3x3_reference,
    pop_conv3x3_wgrad,
)


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


def _inputs(rng, slots, c, f, b, h, w, shared=False, dtype=np.float32):
    """x ((B, S·C, H, W), or (B, C, H, W) when ``shared``), weight, bias, dy."""
    x_shape = (b, c, h, w) if shared else (b, slots * c, h, w)
    x = rng.normal(size=x_shape).astype(dtype)
    wt = (rng.normal(size=(slots, f, c, 3, 3)) / np.sqrt(9 * c)).astype(dtype)
    bias = rng.normal(size=(slots, f)).astype(dtype)
    dy = rng.normal(size=(b, slots * f, h, w)).astype(dtype)
    return x, wt, bias, dy


def _jax_conv(x, wt, bias, dy, shared):
    """y, dx, dW, db from the JAX package's arithmetic: ``lax.conv`` SAME with
    bias per slot under ``vmap``, differentiated with ``jax.vjp``."""
    slots, f, c = wt.shape[:3]
    if shared:
        xs = jnp.repeat(jnp.asarray(x)[None], slots, axis=0)  # (S, B, C, H, W)
    else:
        b, _, h, w = x.shape
        xs = jnp.asarray(x).reshape(b, slots, c, h, w).transpose(1, 0, 2, 3, 4)

    def one(xi, wi, bi):
        y = jax.lax.conv_general_dilated(
            xi, wi, (1, 1), "SAME", dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST)
        return y + bi[None, :, None, None]

    def full(xs_, w_, b_):
        y = jax.vmap(one)(xs_, w_, b_)  # (S, B, F, H, W)
        return y.transpose(1, 0, 2, 3, 4).reshape(y.shape[1], slots * f, *y.shape[3:])

    y, vjp = jax.vjp(full, xs, jnp.asarray(wt), jnp.asarray(bias))
    dxs, dw, db = vjp(jnp.asarray(dy))
    if shared:
        dx = None
    else:
        dx = np.asarray(dxs).transpose(1, 0, 2, 3, 4).reshape(x.shape)
    return np.asarray(y), dx, np.asarray(dw), np.asarray(db)


CASES = {
    # name: (slots, C, F, B, H, W, shared input)
    "C=3 7x7": (3, 3, 4, 2, 7, 7, False),
    "C=1 3x3": (2, 1, 5, 3, 3, 3, False),
    "shared C=3 7x7": (3, 3, 4, 2, 7, 7, True),
    "shared C=1 3x3": (4, 1, 3, 2, 3, 3, True),
    "shared C=4 F=2 6x9": (4, 4, 2, 2, 6, 9, True),
    "C=5 F=6 8x5": (2, 5, 6, 2, 8, 5, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_conv_matches_jax_reference(case):
    slots, c, f, b, h, w, shared = CASES[case]
    x, wt, bias, dy = _inputs(np.random.default_rng(len(case)), slots, c, f, b, h, w, shared)
    want_y, want_dx, want_dw, want_db = _jax_conv(x, wt, bias, dy, shared)

    xt = torch.tensor(x, requires_grad=not shared)
    wt_t = torch.tensor(wt, requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    y = PopConv3x3Fn.apply(xt, wt_t, bt, shared)
    inputs = [wt_t, bt] if shared else [xt, wt_t, bt]
    grads = torch.autograd.grad(y, inputs, torch.tensor(dy))
    dx = None if shared else grads[0]
    dw, db = grads[-2:]

    # float32 on both sides, sums of at most 9·C products per output and
    # B·H·W per weight, taken in other orders: 1e-5 of each result's scale.
    def close(got, want, what):
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.detach().numpy() - want).max())
        assert err <= 1e-5 * scale, f"{what}: {err:.3e} of scale {scale:.3e}"

    close(y, want_y, "forward")
    close(dw, want_dw, "weight gradient")
    close(db, want_db, "bias gradient")
    if not shared:
        close(dx, want_dx, "input gradient (flipped-weight forward)")
    # The plain forward is the same function as the Function's forward.
    torch.testing.assert_close(
        pop_conv3x3_reference(torch.tensor(x), torch.tensor(wt), torch.tensor(bias), shared),
        y.detach(), rtol=0, atol=0)


def _embed(rng, slot, slots, xp, wp, bp, dyp, shared):
    """Slot ``slot`` of an S-slot problem holds (xp, wp, bp, dyp); the other
    slots hold other random values."""
    c, f = wp.shape[1], wp.shape[0]
    b, _, h, w = dyp.shape
    x = rng.normal(size=(b, c, h, w) if shared else (b, slots, c, h, w)).astype(np.float32)
    if shared:
        x[:] = xp
    else:
        x[:, slot] = xp
    wt = rng.normal(size=(slots, f, c, 3, 3)).astype(np.float32)
    bias = rng.normal(size=(slots, f)).astype(np.float32)
    dy = rng.normal(size=(b, slots, f, h, w)).astype(np.float32)
    wt[slot], bias[slot], dy[:, slot] = wp, bp, dyp
    if not shared:
        x = x.reshape(b, slots * c, h, w)
    return x, wt, bias, dy.reshape(b, slots * f, h, w)


@pytest.mark.parametrize("shared", [False, True], ids=["own input", "shared input"])
def test_plain_conv_slot_is_bit_equal_at_any_width(shared):
    """A slot's output and gradients are the same bits at S = 1, 2 and 5 and
    in slots 0 and 3: nothing the plain version sums depends on S or on the
    other slots."""
    rng = np.random.default_rng(7)
    c, f, b, h, w = 6, 8, 4, 12, 12
    xp = rng.normal(size=(b, c, h, w)).astype(np.float32)
    wp = rng.normal(size=(f, c, 3, 3)).astype(np.float32)
    bp = rng.normal(size=(f,)).astype(np.float32)
    dyp = rng.normal(size=(b, f, h, w)).astype(np.float32)
    seen = []
    for slots, slot in ((1, 0), (2, 0), (5, 0), (5, 3)):
        x, wt, bias, dy = (torch.tensor(a) for a in
                           _embed(rng, slot, slots, xp, wp, bp, dyp, shared))
        x.requires_grad_(not shared)
        wt.requires_grad_(True)
        bias.requires_grad_(True)
        y = PopConv3x3Fn.apply(x, wt, bias, shared)
        grads = torch.autograd.grad(y, [wt, bias] if shared else [x, wt, bias], dy)
        one = [y.view(b, slots, f, h, w)[:, slot], grads[-2][slot], grads[-1][slot]]
        if not shared:
            one.append(grads[0].view(b, slots, c, h, w)[:, slot])
        seen.append(one)
    for other in seen[1:]:
        for a, o in zip(seen[0], other):
            assert torch.equal(a, o)


@pytest.mark.parametrize("shared", [False, True], ids=["own input", "shared input"])
def test_pop_conv_fn_gradcheck_float64(shared):
    rng = np.random.default_rng(3)
    x, wt, bias, _ = _inputs(rng, 2, 2, 3, 2, 4, 5, shared=shared, dtype=np.float64)
    x = torch.tensor(x, requires_grad=not shared)
    wt = torch.tensor(wt, requires_grad=True)
    bias = torch.tensor(bias, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda xx, ww, bb: PopConv3x3Fn.apply(xx, ww, bb, shared),
        (x, wt, bias), eps=1e-6, atol=1e-7)


def test_cpu_calls_launch_nothing():
    """The launch counts move only where a kernel is launched: a CPU call
    computes with the plain version and counts nothing."""
    before = dict(pop_conv.LAUNCHES)
    rng = np.random.default_rng(0)
    x, wt, bias, dy = (torch.tensor(a) for a in _inputs(rng, 2, 3, 4, 2, 5, 5))
    pop_conv.pop_conv3x3_fwd(x, wt, bias)
    pop_conv3x3_wgrad(x, dy, wt.shape)
    assert pop_conv.LAUNCHES == before


def test_wrappers_refuse_shapes_the_kernels_do_not_take():
    rng = np.random.default_rng(0)
    x, wt, bias, dy = (torch.tensor(a) for a in _inputs(rng, 2, 3, 4, 2, 5, 5))
    with pytest.raises(ValueError):
        pop_conv.pop_conv3x3_fwd(x[:, :5], wt, bias)  # channels are not S·C
    with pytest.raises(ValueError):
        pop_conv.pop_conv3x3_fwd(x, wt, bias, True)  # a shared input has C, not S·C, channels
    with pytest.raises(ValueError):
        pop_conv.pop_conv3x3_fwd(x, wt[..., :2], bias)  # not 3×3
    with pytest.raises(ValueError):
        pop_conv3x3_wgrad(x, dy[:, :4], wt.shape)
    with pytest.raises(ValueError):  # a shared input is data: no gradient
        PopConv3x3Fn.apply(x[:, :3].contiguous().requires_grad_(), wt, bias, True)


@pytest.mark.parametrize("wrapper", ["fwd", "wgrad"])
def test_wrappers_refuse_more_slots_than_the_grid_takes(wrapper):
    """The slot is the kernels' grid z axis (at most 65,535); the wrappers
    refuse one slot more on the CPU as on the card, before any work."""
    slots = pop_conv.MAX_SLOTS + 1
    x = torch.zeros(1, slots, 1, 1)
    with pytest.raises(ValueError, match="at most 65535"):
        if wrapper == "fwd":
            pop_conv.pop_conv3x3_fwd(x, torch.zeros(slots, 1, 1, 3, 3), torch.zeros(slots, 1))
        else:
            pop_conv3x3_wgrad(x, torch.zeros(1, slots, 1, 1), (slots, 1, 1, 3, 3))


@pytest.mark.parametrize("c", [1, 3, 8, 20])
def test_tap_major_is_the_plain_layout(c):
    """The bf16 forward kernel's weights, laid out by the wrapper:
    ``[s, 3·kh + kw, o, c] = weight[s, o, c, kh, kw]``, C zero-padded to the
    next multiple of 8, contiguous, in the weights' dtype."""
    rng = np.random.default_rng(c)
    slots, f = 2, 5
    w = rng.normal(size=(slots, f, c, 3, 3)).astype(np.float32)
    cp = -(-c // 8) * 8
    want = np.zeros((slots, 9, f, cp), np.float32)
    for s in range(slots):
        for kh in range(3):
            for kw in range(3):
                for o in range(f):
                    for ci in range(c):
                        want[s, 3 * kh + kw, o, ci] = w[s, o, ci, kh, kw]
    got = pop_conv.tap_major(torch.tensor(w))
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got16 = pop_conv.tap_major(torch.tensor(w).to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(),
                                  torch.tensor(want).to(torch.bfloat16).float().numpy())


def test_build_is_keyed_by_the_sources_and_needs_no_compiler_to_import():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libgentun_kernels_")
    assert path == _build.library_path()
    names = [p.name for p in _build._sources()]
    assert "pop_conv3x3.cu" in names
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


#: The weight gradient's split counts at config #2's convs (pop 20, batch 256,
#: 32×32×3, filters 32/64/128) and config #1's (pop 10, batch 128, 28×28×1,
#: filters 20/50), as PERF.md states them: (B, H, C, F) -> (bf16, float32).
SPLITS = {
    "config #2 stage0 entry": ((256, 32, 3, 32), (64, 64)),
    "config #2 stage0 node": ((256, 32, 32, 32), (64, 64)),
    "config #2 stage1 entry": ((256, 16, 32, 64), (16, 16)),
    "config #2 stage1 node": ((256, 16, 64, 64), (16, 16)),
    "config #2 stage2 entry": ((256, 8, 64, 128), (3, 4)),
    "config #2 stage2 node": ((256, 8, 128, 128), (2, 4)),
    "config #1 stage0 entry": ((128, 28, 1, 20), (22, 25)),
    "config #1 stage0 node": ((128, 28, 20, 20), (22, 25)),
    "config #1 stage1 entry": ((128, 14, 20, 50), (7, 7)),
    "config #1 stage1 node": ((128, 14, 50, 50), (7, 7)),
}


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_wgrad_split_counts_of_the_config_shapes(case):
    (b, h, c, f), (bf16, f32) = SPLITS[case]
    assert pop_conv.wgrad_split(b, h, h, c, f, torch.bfloat16)[0] == bf16
    assert pop_conv.wgrad_split(b, h, h, c, f, torch.float32)[0] == f32
    assert pop_conv.wgrad_split(b, h, h, c, f, torch.float64)[0] == f32


#: (B, H, W, C, F) of the split-coverage cases: the config shapes, the
#: kernels' edge shapes (rows that are not whole 16-byte chunks, 300-wide
#: rows, one image), and batches that are not whole splits.
COVER = [(b, h, h, c, f) for (b, h, c, f), _ in SPLITS.values()] + [
    (9, 7, 7, 16, 24), (5, 5, 5, 8, 8), (1, 3, 300, 8, 8), (3, 8, 8, 128, 64),
    (512, 32, 32, 3, 4), (300, 16, 16, 64, 64), (1000, 8, 8, 128, 128), (2, 24, 24, 32, 32),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "float32"])
@pytest.mark.parametrize("shape", COVER, ids=[str(s) for s in COVER])
def test_wgrad_split_covers_every_pixel_once_in_whole_chunks(shape, dtype):
    """Split sp sums pixels [sp·pps, (sp+1)·pps) of B·H·W: together the
    splits cover every pixel exactly once, no split is empty, and a split is
    whole chunks: whole images for bf16 (the kernel walks a split's images
    in tiles of whole rows), 16-pixel chunks for the FMA kernel."""
    b, h, w, c, f = shape
    splits, pps = pop_conv.wgrad_split(b, h, w, c, f, dtype)
    chunk = h * w if dtype == torch.bfloat16 else 16
    assert splits >= 1 and pps >= chunk and pps % chunk == 0
    seen = np.zeros(b * h * w, np.int64)
    for sp in range(splits):
        lo, hi = sp * pps, min((sp + 1) * pps, b * h * w)
        assert lo < hi, f"split {sp} is empty"
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if dtype == torch.bfloat16:  # at least MIN_PIX_PER_SPLIT, unless the batch is smaller
        assert pps >= min(pop_conv.MIN_PIX_PER_SPLIT, b * h * w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64],
                         ids=["bf16", "float32", "float64"])
@pytest.mark.parametrize("shared", [False, True], ids=["own input", "shared input"])
def test_wgrad_split_depends_on_the_shape_alone(shared, dtype):
    """The split the weight-gradient wrapper takes (and so every sum's order)
    is the same at S = 1, 3, 20 and 600 slots: a slot's dW and db cannot
    depend on how many genomes share its call."""
    b, c, f, h, w = 256, 3 if shared else 32, 32, 32, 32
    plans = set()
    for slots in (1, 3, 20, 600):
        x = torch.empty((b, c, h, w) if shared else (b, slots * c, h, w), dtype=dtype,
                        device="meta")
        plans.add(pop_conv._wgrad_plan(x, (slots, f, c, 3, 3), shared))
    assert plans == {pop_conv.wgrad_split(b, h, w, c, f, dtype)}


def test_build_signatures_declare_every_exported_entry_point():
    """Every function of the sources' C interface (the conv's and the stage
    DAG's) has a ctypes signature in ``_build._SIGNATURES`` with one argument
    type per parameter, pointers as ``c_void_p`` (a missing one would pass
    pointers as 32-bit ints), and every signature names a function the
    sources export."""
    import ctypes
    import re

    exported = {}
    for src in _build._sources():
        text = src.read_text()
        for block in re.findall(r'extern "C" \{(.*)\}\s*//\s*extern "C"', text, re.S):
            for name, params in re.findall(r"^[\w\s\*]*?\b(gentun_\w+)\(([^)]*)\)", block,
                                           re.M):
                exported[name] = [p.strip() for p in params.split(",") if p.strip()]
    assert set(exported) == set(_build._SIGNATURES)
    assert {"gentun_pop_dag_node_input", "gentun_pop_dag_stage_out",
            "gentun_pop_dag_node_grad"} <= set(exported)
    for name, params in exported.items():
        argtypes = _build._SIGNATURES[name][1]
        assert len(argtypes) == len(params), name
        for param, argtype in zip(params, argtypes):
            if "*" in param:
                assert argtype is ctypes.c_void_p, (name, param)
            elif param.startswith("long long"):
                assert argtype is ctypes.c_longlong, (name, param)
            else:
                assert argtype is ctypes.c_int, (name, param)


def test_tuning_tool_times_every_config2_weight_gradient():
    """The tuning tool's weight-gradient sweep covers config #2's 15 calls a
    train step (6 shapes), as the train step runs them."""
    from gentun_tpu_torch.tools import tune_pop_conv

    shapes = tune_pop_conv.wgrad_shapes()
    assert sum(calls for *_, calls in shapes) == 15
    assert [(shared, c, f, h) for _, shared, c, f, h, _, _ in shapes] == [
        (True, 3, 32, 32), (False, 32, 32, 32), (False, 32, 64, 16),
        (False, 64, 64, 16), (False, 64, 128, 8), (False, 128, 128, 8)]
