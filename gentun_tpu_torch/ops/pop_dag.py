"""The stage DAG around the conv: the hand-written kernels, their plain versions and :class:`PopStageFn`.

One stage of the Genetic-CNN supergraph for S genome slots at once, in the
port's layout: activations NCHW ``(B, S·F, H, W)`` (slot-major channels),
masks ``adj (S, k, k)``, ``entry/active/exit (S, k)`` and ``has_active
(S,)``, float32 (every value 0 or 1, from the decode).

- :func:`pop_dag_node_input`, :func:`pop_dag_stage_out` and
  :func:`pop_dag_node_grad` are the wrappers of the three CUDA kernels in
  ``csrc/pop_dag.cu`` (built at first use by :mod:`._build`).  They take the
  **raw** conv outputs ``y`` and apply ReLU and the ``active`` selection on
  load, so neither product is ever written.  On a CUDA tensor they launch the
  kernel or raise; on a CPU tensor they compute the same function with the
  plain version beside them (``*_reference``), the eager chain of torch ops
  the model ran before.  Each counts its launches in :data:`LAUNCHES`.
- :class:`PopStageFn` is one stage, forward and backward: the entry, node and
  (optional) exit convs through ``pop_conv``'s kernels and the DAG kernels
  between them, with the backward written out, so autograd adds back none of
  the passes the kernels fuse.  :func:`pop_stage` is how the model calls it.

Numerics: the kernels repeat the chain's arithmetic, each product and sum
rounded to the compute type where the chain rounds, in the chain's order, so
the forward is the chain's bits.  The gradient of a node's output sums the
stage term first and then its successors' input gradients in descending
order, the order in which autograd of the chain accumulates it.  A mask
value of 0 still reads its tensor (``0·inf = NaN`` survives).  The pool
takes the first maximum of each 2×2 window in window order, a NaN winning,
as torch's CUDA ``max_pool2d`` does, and routes the gradient to it.
"""

from __future__ import annotations

import ctypes
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build
from .pop_conv import MAX_SLOTS, pop_conv3x3_fwd, pop_conv3x3_wgrad, turned

__all__ = [
    "LAUNCHES",
    "MAX_NODES",
    "DagMasks",
    "PopStageFn",
    "pop_stage",
    "stage_masks",
    "pop_dag_node_input",
    "pop_dag_stage_out",
    "pop_dag_node_grad",
    "pop_dag_node_input_reference",
    "pop_dag_stage_out_reference",
    "pop_dag_node_grad_reference",
    "pool_reference",
    "unpool_reference",
]

#: Kernel launches per wrapper (the library's one table, ``pop_conv.LAUNCHES``
#: too), counted where a kernel is launched and nowhere else.
LAUNCHES = _build.LAUNCHES
#: Most nodes a stage may have: the kernels take their tensors' pointers in
#: a launch argument of this many.
MAX_NODES = 32

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_MODES = {"plain": 0, "entry": 1, "node": 2}


class DagMasks(NamedTuple):
    """One stage's masks for S slots, float32 and contiguous."""

    adj: torch.Tensor  # (S, k, k)
    entry: torch.Tensor  # (S, k)
    active: torch.Tensor  # (S, k)
    exit: torch.Tensor  # (S, k)
    has_active: torch.Tensor  # (S,)

    @property
    def slots(self) -> int:
        return int(self.has_active.shape[0])

    @property
    def k(self) -> int:
        return int(self.adj.shape[-1])


def stage_masks(m: Mapping[str, torch.Tensor], device=None) -> DagMasks:
    """A stage's mask dict (``adj``, ``entry``, ``active``, ``exit``,
    ``has_active``) as :class:`DagMasks`: float32, contiguous, on ``device``
    (default: where they are)."""
    return DagMasks(*(torch.as_tensor(m[key]).to(device=device, dtype=torch.float32).contiguous()
                      for key in ("adj", "entry", "active", "exit", "has_active")))


def _check_masks(masks: DagMasks) -> Tuple[int, int]:
    """(S, k) of the masks; raises on what the kernels do not take."""
    if not isinstance(masks, DagMasks):
        raise TypeError("masks must be DagMasks (see stage_masks)")
    s, k = masks.slots, masks.k
    want = {"adj": (s, k, k), "entry": (s, k), "active": (s, k), "exit": (s, k),
            "has_active": (s,)}
    for name, shape in want.items():
        t = getattr(masks, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"mask {name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"mask {name} must be contiguous float32 (see stage_masks)")
    if not 1 <= s <= MAX_SLOTS:
        raise ValueError(f"{s} slots; the kernels take 1 to {MAX_SLOTS}")
    if k > MAX_NODES:
        raise ValueError(f"{k} nodes in a stage; the kernels take at most {MAX_NODES}")
    return s, k


def _geometry(what: str, y: torch.Tensor, slots: int, others: Sequence[Optional[torch.Tensor]] = ()):
    """(B, F, H, W) of a call whose tensors are all ``y``'s shape
    ``(B, S·F, H, W)``; raises on a shape or dtype the kernels do not take."""
    if y.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {y.dtype} is not one of bfloat16, float32, float64")
    if y.dim() != 4 or y.shape[1] % slots or y.shape[1] == 0:
        raise ValueError(f"{what}: tensors must be (B, {slots}·F, H, W), got {tuple(y.shape)}")
    for t in others:
        if t is None:
            continue
        if t.shape != y.shape or t.dtype != y.dtype or t.device != y.device:
            raise ValueError(f"{what}: every tensor must be {y.dtype} {tuple(y.shape)} on {y.device}")
    b, sf, h, w = y.shape
    return b, sf // slots, h, w


def _pooled_shape(y: torch.Tensor) -> Tuple[int, int, int, int]:
    b, sf, h, w = y.shape
    if h < 2 or w < 2:
        raise ValueError(f"a 2x2 pool needs H, W >= 2, got {h}x{w}")
    return b, sf, h // 2, w // 2


def _on_card(what: str, y: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one
    (the kernel runs); raises for any other device."""
    if y.device.type == "cpu":
        return False
    if y.device.type != "cuda":
        raise RuntimeError(f"{what} runs on a CUDA or a CPU tensor, not {y.device}")
    return True


def _check_cuda(what: str, masks: DagMasks, tensors: Sequence[Optional[torch.Tensor]]) -> None:
    for t in (*masks, *tensors):
        if t is None:
            continue
        if t.device != tensors[0].device:
            raise ValueError(f"{what}: every tensor must be on {tensors[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def _ptrs(tensors: Sequence[Optional[torch.Tensor]]):
    """A C array of the tensors' device pointers (null for None)."""
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# The plain versions: the eager chain, op for op
# ---------------------------------------------------------------------------


def _scale(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-slot scalar ``v (S,)`` times ``t (B, S·F, H, W)``."""
    b, sf, h, w = t.shape
    return (v.view(1, -1, 1, 1, 1) * t.view(b, v.shape[0], -1, h, w)).view(b, sf, h, w)


def _cast(masks: DagMasks, dtype: torch.dtype) -> DagMasks:
    return DagMasks(*(m.to(dtype) for m in masks))


def pop_dag_node_input_reference(y_entry: torch.Tensor, ys: Sequence[torch.Tensor], j: int,
                                 masks: DagMasks) -> torch.Tensor:
    """Node ``j``'s conv input: ``entry[j]·relu(y_entry) + Σ_{i<j}
    adj[i, j]·(active[i]·relu(y_i))``, each op rounded to the compute type."""
    m = _cast(masks, y_entry.dtype)
    inp = _scale(m.entry[:, j], torch.relu(y_entry))
    for i in range(j):
        inp = inp + _scale(m.adj[:, i, j], _scale(m.active[:, i], torch.relu(ys[i])))
    return inp


def pool_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """2×2 max-pool, floored, and each window's argmax (uint8, ``2·dh + dw``):
    the first maximum in window order, a NaN winning."""
    b, c, ho, wo = _pooled_shape(x)
    win = (x[:, :, :2 * ho, :2 * wo].reshape(b, c, ho, 2, wo, 2)
           .permute(0, 1, 2, 4, 3, 5).reshape(b, c, ho, wo, 4))
    best = torch.full((b, c, ho, wo), float("-inf"), dtype=x.dtype, device=x.device)
    arg = torch.zeros((b, c, ho, wo), dtype=torch.uint8, device=x.device)
    for t in range(4):
        v = win[..., t]
        take = (v > best) | v.isnan()
        best = torch.where(take, v, best)
        arg = torch.where(take, torch.full_like(arg, t), arg)
    return best, arg


def unpool_reference(gz: torch.Tensor, arg: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The pool's gradient: ``gz (B, C, H//2, W//2)`` at each window's argmax
    of a ``(B, C, H, W)`` input, 0 elsewhere."""
    b, c, ho, wo = gz.shape
    hit = arg.long().unsqueeze(-1) == torch.arange(4, device=gz.device)
    win = torch.where(hit, gz.unsqueeze(-1), torch.zeros((), dtype=gz.dtype, device=gz.device))
    full = gz.new_zeros((b, c, h, w))
    full[:, :, :2 * ho, :2 * wo] = (win.view(b, c, ho, wo, 2, 2).permute(0, 1, 2, 4, 3, 5)
                                    .reshape(b, c, 2 * ho, 2 * wo))
    return full


def pop_dag_stage_out_reference(y_entry: torch.Tensor, ys: Sequence[torch.Tensor], masks: DagMasks,
                                pool: bool):
    """The stage output ``has·Σ_i exit[i]·(active[i]·relu(y_i)) + (1 −
    has)·relu(y_entry)`` (``relu(y_entry)`` for a stage of no nodes); with
    ``pool``, ``(pooled, argmax)`` of it."""
    a0 = torch.relu(y_entry)
    if ys:
        m = _cast(masks, y_entry.dtype)
        out = _scale(m.exit[:, 0], _scale(m.active[:, 0], torch.relu(ys[0])))
        for i in range(1, len(ys)):
            out = out + _scale(m.exit[:, i], _scale(m.active[:, i], torch.relu(ys[i])))
        x = _scale(m.has_active, out) + _scale(1.0 - m.has_active, a0)
    else:
        x = a0
    return pool_reference(x) if pool else x


def pop_dag_node_grad_reference(y: torch.Tensor, g: torch.Tensor, gidx: Optional[torch.Tensor],
                                mode: str, node: int, d: Sequence[Optional[torch.Tensor]],
                                masks: DagMasks) -> torch.Tensor:
    """The gradient of a conv output ``y`` (see :func:`pop_dag_node_grad`)."""
    if gidx is not None:
        g = unpool_reference(g, gidx, y.shape[-2], y.shape[-1])
    m, k = _cast(masks, y.dtype), masks.k
    if mode == "node":
        acc = _scale(m.exit[:, node], _scale(m.has_active, g))
        for j in range(k - 1, node, -1):
            acc = acc + _scale(m.adj[:, node, j], d[j])
        acc = _scale(m.active[:, node], acc)
    elif mode == "entry":
        acc = _scale(1.0 - m.has_active, g)
        for j in range(k - 1, -1, -1):
            acc = acc + _scale(m.entry[:, j], d[j])
    else:
        acc = g
    # ReLU's gradient as torch takes it: 0 where the output is <= 0.
    return acc.masked_fill(y <= 0, 0)


# ---------------------------------------------------------------------------
# The wrappers: the kernel on a CUDA tensor, the plain version on a CPU one
# ---------------------------------------------------------------------------


def pop_dag_node_input(y_entry: torch.Tensor, ys: Sequence[torch.Tensor], j: int,
                       masks: DagMasks) -> torch.Tensor:
    """Node ``j``'s conv input ``(B, S·F, H, W)`` from the raw conv outputs
    ``y_entry`` and ``ys[:j]``."""
    slots, k = _check_masks(masks)
    if not 0 <= j < k or len(ys) < j:
        raise ValueError(f"node {j} of a stage of {k} needs the outputs of nodes 0..{j - 1}")
    ys = list(ys[:j])
    b, f, h, w = _geometry("pop_dag_node_input", y_entry, slots, ys)
    if not _on_card("pop_dag_node_input", y_entry):
        return pop_dag_node_input_reference(y_entry, ys, j, masks)
    _check_cuda("pop_dag_node_input", masks, [y_entry, *ys])
    out = torch.empty_like(y_entry)
    with torch.cuda.device(y_entry.device):
        rc = _build.library().gentun_pop_dag_node_input(
            _DTYPE_CODE[y_entry.dtype], y_entry.data_ptr(), _ptrs(ys), j,
            masks.entry.data_ptr(), masks.adj.data_ptr(), masks.active.data_ptr(), k,
            out.data_ptr(), slots, b, f, h, w, _stream(y_entry))
    _build.check(rc, "pop_dag_node_input")
    _build.count_launch("pop_dag_node_input")
    return out


def pop_dag_stage_out(y_entry: torch.Tensor, ys: Sequence[torch.Tensor], masks: DagMasks,
                      pool: bool):
    """The stage output from the raw conv outputs ``y_entry`` and ``ys`` (all
    k nodes, or none: then ``relu(y_entry)``): ``(B, S·F, H, W)``, or with
    ``pool`` the 2×2-pooled ``(B, S·F, H//2, W//2)`` and its uint8 window
    argmax."""
    slots, k = _check_masks(masks)
    if len(ys) not in (0, k):
        raise ValueError(f"a stage of {k} nodes takes all {k} node outputs or none")
    b, f, h, w = _geometry("pop_dag_stage_out", y_entry, slots, ys)
    shape = _pooled_shape(y_entry) if pool else tuple(y_entry.shape)
    if not _on_card("pop_dag_stage_out", y_entry):
        return pop_dag_stage_out_reference(y_entry, ys, masks, pool)
    _check_cuda("pop_dag_stage_out", masks, [y_entry, *ys])
    out = torch.empty(shape, dtype=y_entry.dtype, device=y_entry.device)
    arg = torch.empty(shape, dtype=torch.uint8, device=y_entry.device) if pool else None
    with torch.cuda.device(y_entry.device):
        rc = _build.library().gentun_pop_dag_stage_out(
            _DTYPE_CODE[y_entry.dtype], y_entry.data_ptr(), _ptrs(ys), len(ys),
            masks.active.data_ptr(), masks.exit.data_ptr(), masks.has_active.data_ptr(),
            out.data_ptr(), None if arg is None else arg.data_ptr(), int(pool),
            slots, b, f, h, w, _stream(y_entry))
    _build.check(rc, "pop_dag_stage_out")
    _build.count_launch("pop_dag_stage_out")
    return (out, arg) if pool else out


def pop_dag_node_grad(y: torch.Tensor, g: torch.Tensor, gidx: Optional[torch.Tensor], mode: str,
                      node: int, d: Sequence[Optional[torch.Tensor]],
                      masks: DagMasks) -> torch.Tensor:
    """The gradient ``(B, S·F, H, W)`` of a raw conv output ``y``:
    ``[relu(y) > 0]·a·(c2·(c1·g) + Σ_t w_t·d_t)``.

    ``g`` is the stage's gradient: the pooled one with its window argmax
    ``gidx`` (scattered on the fly), or, with ``gidx`` None, a full-size one
    (the exit conv's input gradient).  ``mode``: ``"node"`` (node ``node``:
    c1 = has, c2 = exit[node], a = active[node], terms adj[node, j]·d[j] for
    j = k−1 down to node+1), ``"entry"`` (the entry conv of a stage of k ≥ 1
    nodes: c1 = 1 − has, terms entry[j]·d[j] for j = k−1 down to 0) or
    ``"plain"`` (``[relu(y) > 0]·g``: the pool-only form and a stage of no
    nodes).  ``d[j]`` is node j's conv-input gradient.
    """
    slots, k = _check_masks(masks)
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    lo = {"plain": k, "entry": 0, "node": node + 1}[mode]
    if mode == "node" and not 0 <= node < k:
        raise ValueError(f"node {node} of a stage of {k}")
    if mode == "entry" and k == 0:
        raise ValueError("a stage of no nodes takes the plain gradient")
    terms = list(d) + [None] * (k - len(d))
    if len(terms) != k or any(terms[j] is None for j in range(lo, k)):
        raise ValueError(f"{mode} gradient needs d[j] for j = {lo}..{k - 1}")
    b, f, h, w = _geometry("pop_dag_node_grad", y, slots, [terms[j] for j in range(lo, k)])
    if gidx is None:
        _geometry("pop_dag_node_grad", y, slots, [g])
    else:
        pooled = _pooled_shape(y)
        if tuple(g.shape) != pooled or g.dtype != y.dtype or g.device != y.device:
            raise ValueError(f"pooled gradient must be {y.dtype} {pooled}, got {tuple(g.shape)}")
        if tuple(gidx.shape) != pooled or gidx.dtype != torch.uint8 or gidx.device != y.device:
            raise ValueError(f"window argmax must be uint8 {pooled}, got {tuple(gidx.shape)}")
    if not _on_card("pop_dag_node_grad", y):
        return pop_dag_node_grad_reference(y, g, gidx, mode, node, terms, masks)
    _check_cuda("pop_dag_node_grad", masks, [y, g, gidx, *terms[lo:]])
    dy = torch.empty_like(y)
    with torch.cuda.device(y.device):
        rc = _build.library().gentun_pop_dag_node_grad(
            _DTYPE_CODE[y.dtype], y.data_ptr(), g.data_ptr(),
            None if gidx is None else gidx.data_ptr(),
            _ptrs([t if j >= lo else None for j, t in enumerate(terms)]), k, _MODES[mode],
            node, masks.adj.data_ptr(), masks.entry.data_ptr(), masks.active.data_ptr(),
            masks.exit.data_ptr(), masks.has_active.data_ptr(), dy.data_ptr(),
            slots, b, f, h, w, _stream(y))
    _build.check(rc, "pop_dag_node_grad")
    _build.count_launch("pop_dag_node_grad")
    return dy


# ---------------------------------------------------------------------------
# One stage, forward and backward
# ---------------------------------------------------------------------------


class PopStageFn(torch.autograd.Function):
    """One stage of the supergraph for S slots: its pooled output
    ``(B, S·F, H//2, W//2)``.

    ``apply(x, shared, save, adj, entry, active, exit, has_active, *params)``
    with the masks as :class:`DagMasks` holds them and ``params`` the
    stage's conv weights and biases, already in the compute dtype: entry,
    then node 0..k−1, then (with ``stage_exit_conv``) exit, each ``weight
    (S, F, C, 3, 3), bias (S, F)``.  ``shared``: ``x`` is ``(B, C, H, W)``,
    read by every slot (stage 0's images; no gradient).  ``save``: keep what
    the backward needs (False under ``no_grad``: nothing is kept).

    Forward: the entry conv, then per node the DAG input kernel and its
    conv, then the stage-output kernel with the pool (or the sum, the exit
    conv and the pool-only form).  Backward: the pool's gradient is
    scattered inside the gradient kernel, each node's conv-output gradient
    is one kernel from the stage's gradient and its successors' input
    gradients, each conv's input gradient is the forward kernel on the
    turned weights and its weight gradient the weight-gradient kernel.
    """

    @staticmethod
    def forward(ctx, x, shared, save, adj, entry, active, exit_, has_active, *params):
        masks = DagMasks(adj, entry, active, exit_, has_active)
        k = masks.k
        if len(params) not in (2 * k + 2, 2 * k + 4):
            raise ValueError(f"a stage of {k} nodes takes {2 * k + 2} or {2 * k + 4} params, "
                             f"got {len(params)}")
        exit_conv = len(params) == 2 * k + 4
        y_entry = pop_conv3x3_fwd(x, params[0], params[1], shared)
        ys: List[torch.Tensor] = []
        inps: List[torch.Tensor] = []
        for j in range(k):
            inp = pop_dag_node_input(y_entry, ys, j, masks)
            ys.append(pop_conv3x3_fwd(inp, params[2 + 2 * j], params[3 + 2 * j]))
            if save:
                inps.append(inp)
            del inp
        x_sum = y_exit = None
        if exit_conv:
            x_sum = pop_dag_stage_out(y_entry, ys, masks, pool=False)
            y_exit = pop_conv3x3_fwd(x_sum, params[-2], params[-1])
            z, arg = pop_dag_stage_out(y_exit, [], masks, pool=True)
        else:
            z, arg = pop_dag_stage_out(y_entry, ys, masks, pool=True)
        if save:
            # Every tensor through save_for_backward, the intermediates too:
            # autograd frees them once this stage's backward is done, not
            # when the whole graph goes.
            ctx.save_for_backward(x, *masks, *params, y_entry, *ys, *inps, x_sum, y_exit, arg)
            ctx.shared, ctx.exit_conv, ctx.n_params = shared, exit_conv, len(params)
        return z

    @staticmethod
    def backward(ctx, gz):
        x, *rest = ctx.saved_tensors
        masks = DagMasks(*rest[:5])
        k, n = masks.k, ctx.n_params
        params, rest = rest[5:5 + n], rest[5 + n:]
        y_entry, ys, inps = rest[0], rest[1:1 + k], rest[1 + k:1 + 2 * k]
        x_sum, y_exit, arg = rest[1 + 2 * k:]
        gz = gz.contiguous()
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        if ctx.exit_conv:
            dy = pop_dag_node_grad(y_exit, gz, arg, "plain", -1, (), masks)
            g, gidx = pop_conv3x3_fwd(dy, turned(params[-2]), None), None
            grads[-2], grads[-1] = pop_conv3x3_wgrad(x_sum, dy, params[-2].shape)
        else:
            g, gidx = gz, arg
        d: List[Optional[torch.Tensor]] = [None] * k
        for i in range(k - 1, -1, -1):
            dy = pop_dag_node_grad(ys[i], g, gidx, "node", i, d, masks)
            w = params[2 + 2 * i]
            d[i] = pop_conv3x3_fwd(dy, turned(w), None)
            grads[2 + 2 * i], grads[3 + 2 * i] = pop_conv3x3_wgrad(inps[i], dy, w.shape)
        dy = pop_dag_node_grad(y_entry, g, gidx, "entry" if k else "plain", -1, d, masks)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = pop_conv3x3_fwd(dy, turned(params[0]), None)
        grads[0], grads[1] = pop_conv3x3_wgrad(x, dy, params[0].shape, ctx.shared)
        return (dx, None, None, None, None, None, None, None, *grads)


def pop_stage(x: torch.Tensor, masks: DagMasks, params: Sequence[torch.Tensor],
              shared: bool = False) -> torch.Tensor:
    """One stage through :class:`PopStageFn`; keeps nothing for the backward
    where no gradient is wanted (under ``no_grad``, or nothing requires one)."""
    if shared and x.requires_grad:
        raise ValueError("a shared stage input gets no gradient; detach it first")
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params))
    return PopStageFn.apply(x, shared, save, *masks, *params)
