"""Population-batched 3×3 SAME convolution: the hand-written kernels and their plain version.

The conv of the Genetic-CNN supergraph for S genome slots at once, in the
port's layout: activations NCHW ``(B, S·C, H, W)``, weights
``(S, F, C, 3, 3)``, bias ``(S, F)``.  A *shared* input (the stage-0 image
batch) is ``(B, C, H, W)``, read in place by every slot.

- :func:`pop_conv3x3_fwd` and :func:`pop_conv3x3_wgrad` are the wrappers of
  the two CUDA kernels in ``csrc/pop_conv3x3.cu`` (built at first use by
  :mod:`._build`).  On a CUDA tensor they launch the kernel or raise; on a
  CPU tensor they compute the same function with plain PyTorch.  Each counts
  its launches in :data:`LAUNCHES`.  The bf16 forward kernel reads its
  weights tap-major; :func:`tap_major` lays them out (one copy per call).
- :class:`PopConv3x3Fn` is the autograd function the model calls on any
  device (its wrappers pick the kernel or the plain version): forward
  is the forward kernel, the input gradient is the forward kernel run on
  ``dY`` with the weights turned 180° and in/out swapped, and the weight and
  bias gradients are the weight-gradient kernel.
- :func:`pop_conv3x3_reference` is the plain version: a loop of per-slot
  ``F.conv2d`` calls, whose shapes do not depend on S (the grouped conv's
  algorithm, and so its sums, do on the CPU as on the card).

Every sum the kernels take has an order fixed by (B, H, W, C, F, dtype), so a
slot's outputs and gradients are the same bits whatever S, the slot or the
other slots are.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "LAUNCHES",
    "MAX_SLOTS",
    "PopConv3x3Fn",
    "pop_conv3x3_fwd",
    "pop_conv3x3_wgrad",
    "pop_conv3x3_reference",
    "pop_conv3x3_wgrad_reference",
    "tap_major",
    "turned",
    "wgrad_split",
]

#: Kernel launches per wrapper, counted where the kernel is launched and
#: nowhere else (a CPU call launches nothing): the library's one table,
#: shared with ``pop_dag.LAUNCHES``.
LAUNCHES: Dict[str, int] = _build.LAUNCHES


#: Pixels per split of the float32 and float64 weight gradient, whose FMA
#: kernel walks a split in chunks of 16 pixels.
FMA_PIX_PER_SPLIT = 4096
#: The bf16 weight gradient's floor on pixels per split: 16 tiles of 256
#: pixels, so each CTA's pipeline of tile loads runs long enough to hide them.
MIN_PIX_PER_SPLIT = 4096
#: Pixels per split at least WGRAD_SCRATCH_FACTOR·C·F/(C+F) keeps the float32
#: partials (written, then read by the second pass: 2·splits·F·9C·4 bytes) at
#: most 36/WGRAD_SCRATCH_FACTOR = 0.28 of the inputs x and dY
#: (B·H·W·(C+F)·2 bytes).
WGRAD_SCRATCH_FACTOR = 128


def wgrad_split(b: int, h: int, w: int, c: int, f: int, dtype) -> Tuple[int, int]:
    """``(splits, pixels per split)`` of the weight gradient's reduction over
    B·H·W pixels, from the shape alone (never the slot count): split ``sp``
    sums pixels ``[sp·pps, (sp+1)·pps)`` of the order (b, h, w), the kernels
    write one float partial per split and a second pass adds them in split
    order, so the count fixes every sum's order.

    bf16: whole images per split (the kernel walks a split's images in tiles
    of whole rows), at least ``MIN_PIX_PER_SPLIT`` pixels and at least
    ``WGRAD_SCRATCH_FACTOR·C·F/(C+F)``, rounded up to whole images and
    capped at the batch.  float32 and float64: ``FMA_PIX_PER_SPLIT``.
    """
    if dtype != torch.bfloat16:
        return -(-(b * h * w) // FMA_PIX_PER_SPLIT), FMA_PIX_PER_SPLIT
    want = max(MIN_PIX_PER_SPLIT, WGRAD_SCRATCH_FACTOR * c * f // (c + f))
    images = min(b, -(-want // (h * w)))
    return -(-b // images), images * h * w


#: Most slots one call takes: the slot is the kernels' grid z axis.  The
#: wrappers refuse more on any device, so a CPU run takes what the card takes.
MAX_SLOTS = 65535

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}


def _geometry(x: torch.Tensor, weight_shape, shared: bool):
    """(B, C, H, W, slot stride, image stride) of the conv input, in
    elements; raises on a shape the kernels do not take."""
    if len(weight_shape) != 5 or tuple(weight_shape[-2:]) != (3, 3):
        raise ValueError(f"weight must be (S, F, C, 3, 3), got {tuple(weight_shape)}")
    slots, _, c = (int(d) for d in weight_shape[:3])
    if slots > MAX_SLOTS:
        raise ValueError(f"{slots} slots in one call; the kernels take at most {MAX_SLOTS}")
    if shared:
        if x.dim() != 4 or x.shape[1] != c:
            raise ValueError(f"shared input must be (B, {c}, H, W), got {tuple(x.shape)}")
        b, _, h, w = x.shape
        return b, c, h, w, 0, c * h * w
    if x.dim() != 4 or x.shape[1] != slots * c:
        raise ValueError(f"input must be (B, {slots}·{c}, H, W), got {tuple(x.shape)}")
    b, _, h, w = x.shape
    return b, c, h, w, c * h * w, slots * c * h * w


def _wgrad_plan(x: torch.Tensor, weight_shape, shared: bool) -> Tuple[int, int]:
    """:func:`wgrad_split` of the weight gradient whose conv input is ``x``."""
    b, c, h, w, _, _ = _geometry(x, weight_shape, shared)
    return wgrad_split(b, h, w, c, int(weight_shape[1]), x.dtype)


def _check_cuda(what: str, *tensors: Optional[torch.Tensor]) -> None:
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: dtype {dtype} is not one of bfloat16, float32, float64")
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what}: every tensor must be {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def _slot_input(x: torch.Tensor, s: int, slots: int, c: int, shared: bool) -> torch.Tensor:
    """Slot s's input ``(B, C, H, W)``, contiguous."""
    if shared:
        return x
    b, _, h, w = x.shape
    return x.view(b, slots, c, h, w)[:, s].contiguous()


def pop_conv3x3_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, shared: bool = False
) -> torch.Tensor:
    """The plain version of the forward: ``(B, S·F, H, W)`` from one
    ``F.conv2d`` per slot; autograd supplies its backward."""
    slots, c = weight.shape[0], weight.shape[2]
    _geometry(x, weight.shape, shared)
    outs = [
        F.conv2d(_slot_input(x, s, slots, c, shared), weight[s],
                 None if bias is None else bias[s], padding=1)
        for s in range(slots)
    ]
    return torch.cat(outs, dim=1)


def pop_conv3x3_wgrad_reference(
    x: torch.Tensor, dy: torch.Tensor, weight_shape, shared: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the weight gradient: ``(dW (S, F, C, 3, 3), db (S, F))``."""
    slots, f, c = (int(d) for d in weight_shape[:3])
    b, _, h, w = dy.shape
    dys = dy.view(b, slots, f, h, w)
    dws, dbs = [], []
    for s in range(slots):
        dy_s = dys[:, s].contiguous()
        xs = _slot_input(x, s, slots, c, shared)
        dws.append(torch.nn.grad.conv2d_weight(xs, (f, c, 3, 3), dy_s, padding=1))
        dbs.append(dy_s.sum(dim=(0, 2, 3)))
    return torch.stack(dws), torch.stack(dbs)


def tap_major(weight: torch.Tensor) -> torch.Tensor:
    """Weights ``(S, F, C, 3, 3)`` as the bf16 forward kernel reads them:
    ``(S, 9, F, Cp)``, ``[s, 3·kh + kw, o, c] = weight[s, o, c, kh, kw]``, with
    C zero-padded to Cp, the next multiple of 8, so that each (tap, output
    channel) row is whole 16-byte chunks."""
    slots, f, c = weight.shape[:3]
    cp = -(-c // 8) * 8
    taps = weight.permute(0, 3, 4, 1, 2).reshape(slots, 9, f, c)
    if cp == c:
        return taps.contiguous()
    out = weight.new_zeros((slots, 9, f, cp))
    out[..., :c] = taps
    return out


def pop_conv3x3_fwd(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, shared: bool = False
) -> torch.Tensor:
    """``y (B, S·F, H, W)``: the forward kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    b, c, h, w, sstride, bstride = _geometry(x, weight.shape, shared)
    if x.device.type == "cpu":
        return pop_conv3x3_reference(x, weight, bias, shared)
    if x.device.type != "cuda":
        raise RuntimeError(f"pop_conv3x3_fwd runs on a CUDA or a CPU tensor, not {x.device}")
    _check_cuda("pop_conv3x3_fwd", x, weight, bias)
    slots, f = weight.shape[:2]
    y = torch.empty((b, slots * f, h, w), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:  # the bf16 kernel reads its weights tap-major
        weight = tap_major(weight)
    with torch.cuda.device(x.device):  # the launch goes to the tensors' card
        rc = _build.library().gentun_pop_conv3x3_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), weight.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            slots, b, c, f, h, w, sstride, bstride,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "pop_conv3x3_fwd")
    _build.count_launch("pop_conv3x3_fwd")
    return y


def pop_conv3x3_wgrad(
    x: torch.Tensor, dy: torch.Tensor, weight_shape, shared: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW, db)`` of the conv whose input was ``x`` and output gradient
    ``dy``: the weight-gradient kernel on CUDA tensors, the plain version on
    CPU tensors."""
    b, c, h, w, sstride, bstride = _geometry(x, weight_shape, shared)
    slots, f = int(weight_shape[0]), int(weight_shape[1])
    if tuple(dy.shape) != (b, slots * f, h, w):
        raise ValueError(f"dy must be {(b, slots * f, h, w)}, got {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return pop_conv3x3_wgrad_reference(x, dy, weight_shape, shared)
    if x.device.type != "cuda":
        raise RuntimeError(f"pop_conv3x3_wgrad runs on a CUDA or a CPU tensor, not {x.device}")
    _check_cuda("pop_conv3x3_wgrad", x, dy)
    splits, pix_per_split = _wgrad_plan(x, weight_shape, shared)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    part = torch.empty((slots, splits, f, c * 9), dtype=acc, device=x.device)
    dbpart = torch.empty((slots, splits, f), dtype=acc, device=x.device)
    dw = torch.empty((slots, f, c, 3, 3), dtype=x.dtype, device=x.device)
    db = torch.empty((slots, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().gentun_pop_conv3x3_wgrad(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(), part.data_ptr(),
            dbpart.data_ptr(), dw.data_ptr(), db.data_ptr(), slots, b, c, f, h, w, splits,
            pix_per_split, sstride, bstride,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "pop_conv3x3_wgrad")
    _build.count_launch("pop_conv3x3_wgrad")
    return dw, db


def turned(weight: torch.Tensor) -> torch.Tensor:
    """The weights whose forward conv is the input gradient: turned 180°,
    in and out channels swapped."""
    return weight.flip(-1, -2).transpose(1, 2).contiguous()


class PopConv3x3Fn(torch.autograd.Function):
    """``y = conv3x3(x, weight) + bias`` per slot, with the kernels' backward.

    A shared input is data and gets no gradient.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, shared: bool = False):
        if shared and x.requires_grad:
            raise ValueError("a shared conv input gets no gradient; detach it first")
        ctx.save_for_backward(x, weight)
        ctx.shared = shared
        ctx.has_bias = bias is not None
        return pop_conv3x3_fwd(x, weight, bias, shared)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = pop_conv3x3_fwd(dy, turned(weight), None)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = pop_conv3x3_wgrad(x, dy, weight.shape, ctx.shared)
        return dx, dw, db if ctx.has_bias else None, None
