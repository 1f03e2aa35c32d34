"""Genetic-CNN fitness model on PyTorch: one masked supergraph, a whole population per step.

The PyTorch counterpart of the JAX package's ``models/cnn.py``.  What it
computes is the same: decode binary genes into a per-stage DAG of
Conv(3×3)+ReLU nodes, sum-merge fan-in, 2×2 max-pool between stages, a dense
head with dropout, staged-LR SGD with momentum, k-fold cross-validation,
fitness = mean validation accuracy.  How it runs differs:

- **The population is a tensor axis, not a ``vmap``.**  Activations are
  ``(B, P·C, H, W)``; every conv after the stage-0 entry conv is one
  ``F.conv2d(..., groups=P)``, so genome ``p`` only ever sees its own
  channels.  The stage-0 entry conv reads the input that every genome
  shares, so it is one conv with ``P·F`` output channels.  The dense head is
  per genome through ``torch.bmm`` over ``(P, B, D)``.
- **Masks are data.**  Every genome runs the same supergraph; the mask
  scalars (``adj``, ``entry``, ``active``, ``exit``, ``has_active``) multiply
  in the compute dtype exactly where the reference multiplies them.
- **bfloat16 compute, float32 params and logits** by explicit casts that
  follow flax's ``dtype=`` semantics (params are cast to the compute dtype
  inside each layer; the last Dense and the logits are float32).  No
  autocast.  float32 means IEEE float32 on a CUDA card too, and the card
  gives the same bits for the same call: the executor turns TF32 off for
  cuDNN convs and cuBLAS matmuls and keeps cuDNN to deterministic
  algorithms while it runs (``exact_numerics``), and gives the caller's
  settings back after.
- **The executor is a host loop.**  Folds and steps are a Python loop over
  device-resident carries (params, momentum, per-genome dropout generators);
  the dataset uploads once and is cached across evaluations.  Nothing is
  compiled: PyTorch runs eagerly.
- **Fitness is a pure function of (genome, config, seed).**  Init is drawn
  on the CPU from one generator per (fold, genome) seeded from the genome's
  content hash, then moved to the device, so a CPU run and a CUDA run start
  from the same weights; dropout draws from one device generator per
  (fold, genome), so no genome's draws depend on its slot, its batch or the
  padding.  On a CUDA card the arithmetic is exact across slots and calls
  within one pop bucket; across buckets cuDNN picks its conv algorithm by
  shape, so bf16 and float32 fitnesses may differ there (a float64 body
  does not).

Left out of this slice (they raise ``NotImplementedError`` where a knob asks
for them): the fused ``fold_parallel`` executor, ``train_and_score``, the
warm-start bank, multi-device placement and the big-genome routing that
``device_budget`` turns on.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import logging
import time
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dag import stack_genome_masks
from ..parallel.mesh import (
    SIZE_SMALL,
    classify_genome_cost,
    cnn_genome_cost,
    pad_population,
    pop_bucket,
)
from ..telemetry import spans as _tele
from ..telemetry.registry import get_registry as _get_registry
from ..utils.device_state import mark_backend_used
from .generic import GentunModel

__all__ = ["MaskedGeneticCnn", "GeneticCnnModel", "exact_numerics", "params_from_reference"]

logger = logging.getLogger("gentun_tpu_torch")

#: Stage masks as the forward pass takes them: one dict per stage with
#: ``adj (P, k, k)``, ``entry/active/exit (P, k)`` and ``has_active (P,)``.
Masks = List[Dict[str, torch.Tensor]]


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype must name a torch floating dtype, got {name!r}")
    return dtype


class _PopConv3x3(nn.Module):
    """P independent 3×3 SAME convs (+bias) as one conv call.

    ``weight`` is ``(P, F, C, 3, 3)`` (OIHW per genome), ``bias`` ``(P, F)``.
    With ``shared_input`` the input is ``(B, C, H, W)``, read by every genome
    (one conv with ``P·F`` outputs); otherwise it is ``(B, P·C, H, W)`` and
    the conv is grouped over P.  Params are cast to the compute dtype inside
    the call, as flax's ``nn.Conv(dtype=...)`` does.
    """

    def __init__(self, pop: int, c_in: int, features: int, shared_input: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(pop, features, c_in, 3, 3, device=device))
        self.bias = nn.Parameter(torch.empty(pop, features, device=device))
        self.shared_input = shared_input

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        pop, f, c = self.weight.shape[:3]
        w = self.weight.to(dtype).reshape(pop * f, c, 3, 3)
        b = self.bias.to(dtype).reshape(pop * f)
        return F.conv2d(x, w, b, padding=1, groups=1 if self.shared_input else pop)


class _PopDense(nn.Module):
    """P independent Dense layers: ``(P, B, D_in) @ (P, D_in, D_out) + (P, D_out)``.

    The kernel keeps flax's ``(in, out)`` layout per genome.
    """

    def __init__(self, pop: int, d_in: int, d_out: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(pop, d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.empty(pop, d_out, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = torch.bmm(x, self.weight.to(dtype))
        return y + self.bias.to(dtype)[:, None, :]


def _scale(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-genome scalar ``v (P,)`` times ``t (B, P, C, H, W)``."""
    return v.view(1, -1, 1, 1, 1) * t


class MaskedGeneticCnn(nn.ModuleDict):
    """The stage-DAG supergraph for P genomes at once.

    The same recipe as the JAX package's ``MaskedGeneticCnn``: an entry
    Conv3×3(F_s)+ReLU makes the stage's default input node; each supergraph
    node is Conv3×3(F_s)+ReLU over the masked sum of its predecessors (plus
    the stage input for entry nodes) and is zeroed when inactive; the default
    output node sums the exit nodes (the stage input passes through when the
    stage decodes empty); ``stage_exit_conv`` adds a Conv3×3(F_s)+ReLU after
    that sum; a 2×2 max-pool (floored) closes the stage.  Head:
    Dense(dense_units)+ReLU → Dropout → Dense(n_classes) in float32.

    Input ``x`` is NCHW ``(B, C, H, W)`` float32 and shared by all genomes;
    the output is float32 logits ``(P, B, n_classes)``.  Before the head the
    activation is flattened per genome in (C, H, W) order; the reference
    flattens (H, W, C), which :func:`params_from_reference` accounts for.
    Parameter names follow the reference's layer names: ``stage{s}_entry``,
    ``stage{s}_node{j}``, ``stage{s}_exit``, ``Dense_0``, ``Dense_1``, each with
    ``weight`` and ``bias`` carrying the leading population axis; the module
    is a ``ModuleDict`` of those layers.
    """

    def __init__(
        self,
        nodes: Sequence[int],
        filters: Sequence[int],
        pop: int,
        input_shape: Sequence[int],
        dense_units: int = 500,
        n_classes: int = 10,
        dropout_rate: float = 0.5,
        compute_dtype: str = "bfloat16",
        stage_exit_conv: bool = False,
        device=None,
    ):
        super().__init__()
        self.nodes = tuple(int(k) for k in nodes)
        self.filters = tuple(int(f) for f in filters)
        self.pop = int(pop)
        self.dropout_rate = float(dropout_rate)
        self.compute_dtype = _torch_dtype(compute_dtype)
        self.stage_exit_conv = bool(stage_exit_conv)
        h, w, c = (int(d) for d in input_shape)
        for s, (k, f) in enumerate(zip(self.nodes, self.filters)):
            self[f"stage{s}_entry"] = _PopConv3x3(pop, c, f, shared_input=(s == 0), device=device)
            for j in range(k):
                self[f"stage{s}_node{j}"] = _PopConv3x3(pop, f, f, False, device=device)
            if self.stage_exit_conv:
                self[f"stage{s}_exit"] = _PopConv3x3(pop, f, f, False, device=device)
            h, w, c = h // 2, w // 2, f
        self.flat_shape = (c, h, w)
        self["Dense_0"] = _PopDense(pop, c * h * w, int(dense_units), device=device)
        self["Dense_1"] = _PopDense(pop, int(dense_units), int(n_classes), device=device)

    def forward(
        self,
        x: torch.Tensor,
        masks: Masks,
        dropout_gens: Optional[Sequence[torch.Generator]] = None,
    ) -> torch.Tensor:
        """Logits ``(P, B, n_classes)``; dropout runs only when ``dropout_gens``
        (one generator per genome, on ``x``'s device) is given."""
        dtype = self.compute_dtype
        pop, b = self.pop, x.shape[0]
        x = x.to(dtype)
        for s, k in enumerate(self.nodes):
            m = masks[s]
            a0 = F.relu(self[f"stage{s}_entry"](x, dtype))
            hh, ww = a0.shape[-2:]
            a0 = a0.reshape(b, pop, -1, hh, ww)
            adj = m["adj"].to(dtype)
            entry = m["entry"].to(dtype)
            active = m["active"].to(dtype)
            exit_ = m["exit"].to(dtype)
            has_active = m["has_active"].to(dtype)
            outs: List[torch.Tensor] = []
            for j in range(k):
                inp = _scale(entry[:, j], a0)
                for i in range(j):
                    inp = inp + _scale(adj[:, i, j], outs[i])
                h = F.relu(self[f"stage{s}_node{j}"](inp.reshape(b, -1, hh, ww), dtype))
                # Zero inactive nodes so they cannot leak into any sum.
                outs.append(_scale(active[:, j], h.reshape(b, pop, -1, hh, ww)))
            if k:
                out = _scale(exit_[:, 0], outs[0])
                for i in range(1, k):
                    out = out + _scale(exit_[:, i], outs[i])
                x = _scale(has_active, out) + _scale(1.0 - has_active, a0)
            else:
                x = a0
            x = x.reshape(b, -1, hh, ww)
            if self.stage_exit_conv:
                x = F.relu(self[f"stage{s}_exit"](x, dtype))
            x = F.max_pool2d(x, 2)
        x = x.reshape(b, pop, -1).transpose(0, 1)
        x = F.relu(self["Dense_0"](x, dtype))
        if dropout_gens is not None:
            x = _dropout(x, self.dropout_rate, dropout_gens)
        # Final projection + logits in float32, as the reference does.
        return self["Dense_1"](x.float(), torch.float32)


def _dropout(x: torch.Tensor, rate: float, gens: Sequence[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` semantics with one random stream per genome.

    ``x`` is ``(P, B, U)``; genome ``p`` draws its own ``(B, U)`` keep mask
    from ``gens[p]``, so its draws never depend on P, its slot or padding.
    """
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.stack(
        [torch.rand(x.shape[1:], generator=g, device=x.device) < keep_prob for g in gens]
    )
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def params_from_reference(
    flax_params: Mapping[str, Any],
    nodes: Sequence[int],
    input_shape: Sequence[int],
) -> Dict[str, np.ndarray]:
    """Carry the JAX package's param tree across into this module's layout.

    ``flax_params`` is the reference's ``params`` tree as numpy, every leaf
    with the same leading prefix (``(kfold, P)`` or ``(P,)``).  Conv kernels go
    from HWIO to OIHW; the rows of ``Dense_0``'s kernel go from the reference's
    (H, W, C) flatten order to this module's (C, H, W); biases and ``Dense_1``
    are unchanged.  Returns ``{"<layer>.weight"|"<layer>.bias": array}`` with
    the prefix kept.  ``input_shape`` is the HWC shape the model was built for.
    """
    h, w = int(input_shape[0]), int(input_shape[1])
    for _ in nodes:
        h, w = h // 2, w // 2
    out: Dict[str, np.ndarray] = {}
    for layer, leaves in flax_params.items():
        kernel = np.asarray(leaves["kernel"])
        if layer.startswith("stage"):
            weight = np.moveaxis(kernel, (-4, -3, -2, -1), (-2, -1, -3, -4))
        elif layer == "Dense_0":
            prefix, (d_in, units) = kernel.shape[:-2], kernel.shape[-2:]
            c = d_in // (h * w)
            hwc = kernel.reshape(*prefix, h, w, c, units)
            weight = np.moveaxis(hwc, -2, -4).reshape(*prefix, d_in, units)
        else:
            weight = kernel
        out[f"{layer}.weight"] = np.ascontiguousarray(weight)
        out[f"{layer}.bias"] = np.asarray(leaves["bias"])
    return out


# ---------------------------------------------------------------------------
# Training primitives
# ---------------------------------------------------------------------------


def _lr_schedule(
    epochs: Tuple[int, ...], learning_rate: Tuple[float, ...], steps_per_epoch: int
) -> Callable[[int], float]:
    """``optax.piecewise_constant_schedule`` for gentun's staged LR, in float32.

    Boundaries sit at epoch-group ends, in optimizer steps.  A boundary's
    scale ``lr_next / lr_prev`` applies from ``count >= boundary``, and scales
    compound (a zero-epoch group lands two transitions on one step).  The
    value is rounded to float32 after every product, as optax computes it.
    """
    boundaries_and_scales: Dict[int, float] = {}
    step_mark = 0
    for n_ep, lr_prev, lr_next in zip(epochs[:-1], learning_rate[:-1], learning_rate[1:]):
        step_mark += n_ep * steps_per_epoch
        boundaries_and_scales[step_mark] = (
            boundaries_and_scales.get(step_mark, 1.0) * lr_next / lr_prev
        )
    if any(scale < 0.0 for scale in boundaries_and_scales.values()):
        raise ValueError("`piecewise_constant_schedule` expects non-negative scale factors")
    stages = sorted(boundaries_and_scales.items())
    init = np.float32(learning_rate[0])

    def schedule(count: int) -> float:
        v = init
        for threshold, scale in stages:
            if count >= threshold:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


def _per_genome_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy, mean over the batch, one value per genome."""
    pop, b, n_classes = logits.shape
    ce = F.cross_entropy(logits.reshape(pop * b, n_classes), y.repeat(pop), reduction="none")
    return ce.view(pop, b).mean(dim=1)


def _train_step(
    model: MaskedGeneticCnn,
    masks: Masks,
    x_full: torch.Tensor,
    y_full: torch.Tensor,
    idx: torch.Tensor,
    gens: Optional[Sequence[torch.Generator]],
    momentum_bufs: List[torch.Tensor],
    lr: float,
    momentum: float,
    nesterov: bool,
    microbatch: int = 1,
) -> None:
    """One SGD step for all genomes, ``optax.sgd`` arithmetic.

    The loss is the sum over genomes of each genome's batch mean, so each
    genome's params get exactly their own gradient.  ``microbatch > 1``
    splits the batch and averages the slices' gradients before the one
    update (dropout then draws per slice).  Momentum: ``t = g + m·t``; the
    update is ``t`` (or ``g + m·t`` with nesterov), scaled by ``-lr`` and
    added to the param.  Params and momentum buffers update in place.
    """
    params = list(model.parameters())
    grads: Optional[List[torch.Tensor]] = None
    for im in idx.view(microbatch, -1):
        logits = model(x_full.index_select(0, im), masks, dropout_gens=gens)
        loss = _per_genome_loss(logits, y_full.index_select(0, im)).sum()
        g = torch.autograd.grad(loss, params)
        grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
    with torch.no_grad():
        for p, g, t in zip(params, grads, momentum_bufs):
            if microbatch > 1:
                g = g / microbatch
            t.mul_(momentum).add_(g)
            update = g + momentum * t if nesterov else t
            p.add_(update * -lr)


@torch.no_grad()
def _eval_fold(
    model: MaskedGeneticCnn,
    masks: Masks,
    x_full: torch.Tensor,
    y_full: torch.Tensor,
    val_idx: torch.Tensor,
    val_weight: torch.Tensor,
    eval_batch_size: int,
) -> torch.Tensor:
    """Weighted validation accuracy per genome, ``(P,)`` float32, on device.

    ``argmax`` takes the first maximum, as ``jnp.argmax`` does; padded rows
    carry weight 0.
    """
    correct = torch.zeros(model.pop, dtype=torch.float32, device=x_full.device)
    for start in range(0, val_idx.shape[0], eval_batch_size):
        idx = val_idx[start : start + eval_batch_size]
        logits = model(x_full.index_select(0, idx), masks)
        hits = (logits.argmax(dim=-1) == y_full.index_select(0, idx)).float()
        correct += (hits * val_weight[start : start + eval_batch_size]).sum(dim=1)
    return correct / val_weight.sum().clamp(min=1.0)


def _eval_batch_size(batch_size: int, n_val: int) -> Tuple[int, int]:
    """(eval_batch_size, n_val_padded) for a validation block of n_val rows.

    Forward-only eval takes up to 4× the train batch, sized by dividing the
    block into the fewest ≤4×batch segments so padding stays small.
    """
    if n_val <= 0:
        return batch_size, 0
    rounded = int(np.ceil(n_val / batch_size)) * batch_size
    n_seg = max(1, int(np.ceil(rounded / (4 * batch_size))))
    eval_bs = int(np.ceil(rounded / n_seg))
    return eval_bs, eval_bs * n_seg


def _segment_bounds(total_steps: int, segment_steps) -> List[Tuple[int, int]]:
    """Chop ``total_steps`` into bounded segments of the host loop."""
    if not segment_steps or segment_steps >= total_steps:
        return [(0, total_steps)]
    seg = int(segment_steps)
    return [(s, min(s + seg, total_steps)) for s in range(0, total_steps, seg)]


@contextlib.contextmanager
def exact_numerics():
    """IEEE float32 and deterministic cuDNN algorithms inside the block.

    PyTorch lets cuDNN convolutions run float32 in TF32 by default (10-bit
    mantissa); the reference's float32 is IEEE float32, so TF32 is off for
    convs and matmuls.  cuDNN may also pick float32 algorithms whose sums
    land in a different order on every call; ``cudnn.deterministic`` keeps it
    to algorithms that give the same bits for the same call, so a fitness is
    a function of (genome, config, seed, pop bucket).  The executor runs every
    fold inside this block; the caller's three flags are restored on exit.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = saved


def _device_span(kind: str, t0: float, device: torch.device, attrs: Dict[str, Any]) -> None:
    """End a telemetry span around device work: wait for the device (only
    reached when telemetry is enabled), then record the span."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    _tele.record_span(kind, t0, time.monotonic() - t0, attrs=attrs)


def _run_segmented(
    cfg: Dict[str, Any],
    model: MaskedGeneticCnn,
    masks: Masks,
    params: Dict[str, torch.Tensor],
    hashes: np.ndarray,
    x_full: torch.Tensor,
    y_full: torch.Tensor,
    val_idx: np.ndarray,
    val_weight: np.ndarray,
    batch_idx: np.ndarray,
    steps_per_epoch: int,
    eval_batch_size: int,
) -> np.ndarray:
    """Host loop over folds × segments of train steps; returns (kfold, P) accs.

    Per fold: load that fold's initial params into ``model``, zero the
    momentum, seed the per-genome dropout generators, run the schedule's
    steps, then the weighted eval.  Each fold's accuracies stay on the
    device until every fold is queued.
    """
    device = x_full.device
    kfold, total_steps = batch_idx.shape[0], batch_idx.shape[1]
    lr_at = _lr_schedule(cfg["epochs"], cfg["learning_rate"], steps_per_epoch)
    bounds = _segment_bounds(total_steps, cfg["segment_steps"])
    microbatch = int(cfg["microbatch"])
    dropout = cfg["dropout_rate"] > 0.0
    tele = _tele.enabled()
    named = dict(model.named_parameters())
    accs = []
    for f in range(kfold):
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(params[name][f])
        momentum_bufs = [torch.zeros_like(p) for p in named.values()]
        gens = _dropout_generators(cfg["seed"], f, hashes, device) if dropout else None
        bidx = torch.as_tensor(batch_idx[f], device=device)
        with exact_numerics():
            for s, e in bounds:
                t0 = time.monotonic()
                for t in range(s, e):
                    _train_step(
                        model, masks, x_full, y_full, bidx[t], gens, momentum_bufs,
                        lr_at(t), cfg["momentum"], cfg["nesterov"], microbatch,
                    )
                if tele:
                    _device_span("train", t0, device, {"steps": e - s, "pop": model.pop, "fold": f})
            t0 = time.monotonic()
            vi = torch.as_tensor(val_idx[f], device=device)
            vw = torch.as_tensor(val_weight[f], device=device)
            accs.append(_eval_fold(model, masks, x_full, y_full, vi, vw, eval_batch_size))
            if tele:
                _device_span("eval", t0, device, {"pop": model.pop, "fold": f})
    return torch.stack(accs).cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# Init and random streams
# ---------------------------------------------------------------------------


def _genome_hashes(genomes: Sequence[Mapping[str, Any]]) -> np.ndarray:
    """Stable per-genome 64-bit content hash, shape (n, 2) uint32 (hi, lo).

    Bit for bit the JAX package's ``_genome_hashes``: blake2b over the sorted
    gene names, shapes and int64/float64 bytes.  Seeding every per-genome
    stream from the genome's CONTENT, not its slot, makes fitness a pure
    function of (architecture, config, seed).
    """
    out = np.empty((len(genomes), 2), dtype=np.uint32)
    for i, g in enumerate(genomes):
        h = hashlib.blake2b(digest_size=8)
        for k in sorted(g):
            arr = np.asarray(g[k])
            arr = arr.astype(np.int64) if arr.dtype.kind in "biu" else arr.astype(np.float64)
            h.update(str(k).encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        digest = int.from_bytes(h.digest(), "little")
        out[i, 0] = digest >> 32  # hi word
        out[i, 1] = digest & 0xFFFFFFFF  # lo word
    return out


#: Domain constant for stream separation, the reference's value: it keeps
#: parameter-init streams disjoint from dropout streams under one seed.
_INIT_DOMAIN = 0x1217

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _stream_seed(*words: int) -> int:
    """A stable 64-bit generator seed from a tuple of integers (splitmix64
    chained over the words), the same on every platform and run."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h


def _dropout_generators(
    seed: int, fold: int, hashes: np.ndarray, device: torch.device
) -> List[torch.Generator]:
    """One device generator per genome slot, seeded from (seed, fold, hash)."""
    gens = []
    for hi, lo in hashes:
        g = torch.Generator(device=device)
        g.manual_seed(_stream_seed(seed, fold, hi, lo))
        gens.append(g)
    return gens


#: flax ``lecun_normal``: the stddev of a standard normal truncated to
#: [-2, 2] is this, so samples are divided by it to reach 1/sqrt(fan_in).
_TRUNC_NORMAL_STD = 0.87962566103423978


def _init_population_params(
    model: MaskedGeneticCnn, kfold: int, seed: int, genome_hashes: np.ndarray, domain: int = 0
) -> Dict[str, torch.Tensor]:
    """Per-(fold, genome) initial params on the CPU, each ``(kfold, *shape)``.

    flax's ``lecun_normal`` for every weight (truncated normal on [-2, 2]
    with stddev ``1/sqrt(fan_in)``) and zero biases; torch's default init is
    not used.  Each (fold, genome) draws from its own CPU generator seeded
    from ``(seed, _INIT_DOMAIN, domain, fold, hash hi, hash lo)``, so a genome
    starts from the same weights whatever its slot, batch or device.
    """
    named = dict(model.named_parameters())
    out = {
        name: torch.zeros((kfold, *p.shape), dtype=torch.float32) for name, p in named.items()
    }
    weights = [name for name in named if name.endswith(".weight")]
    for f in range(kfold):
        for i, (hi, lo) in enumerate(genome_hashes):
            g = torch.Generator()
            g.manual_seed(_stream_seed(seed, _INIT_DOMAIN, domain, f, hi, lo))
            for name in weights:
                w = out[name][f, i]
                # conv (F, C, 3, 3): fan_in = C·9; dense (D_in, D_out): fan_in = D_in
                fan_in = w.shape[-3] * 9 if w.dim() == 4 else w.shape[0]
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                w.mul_(float(np.sqrt(1.0 / fan_in)) / _TRUNC_NORMAL_STD)
    return out


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

#: (id(x_key), id(y_key), fingerprints, seed, n_use, input_shape, device) →
#: (weakref(x_key), weakref(y_key), x_dev, y_dev).  Kept tiny; entries are
#: validated by object identity through the weakrefs, so a recycled id can
#: never alias, and by a strided content fingerprint, so in-place mutation
#: is detected instead of silently training on stale device data.
_DATASET_CACHE: Dict[Tuple, Tuple[Any, Any, Any, Any]] = {}


def _content_fingerprint(a) -> Tuple[Any, ...]:
    """Cheap content hash: shape/dtype + a ≤1024-element strided sample."""
    arr = np.asarray(a)
    flat = arr.ravel()
    step = max(1, flat.size // 1024)
    sample = np.ascontiguousarray(flat[::step][:1024])
    return (arr.shape, str(arr.dtype), hash(sample.tobytes()))


def _device_dataset(key_x, key_y, xp: np.ndarray, yp: np.ndarray, perm: np.ndarray,
                    cfg: Dict[str, Any], device: torch.device):
    """Device-resident permuted dataset (x NCHW float32, y int64), cached
    across evaluate() calls.

    Keyed by the identity of the CALLER's arrays plus a strided content
    fingerprint, so a GA pays the upload once per search, and a caller that
    mutates its arrays in place near-certainly misses the cache.  LRU of 4.
    """
    for k in [k for k, (xr, yr, *_dv) in _DATASET_CACHE.items() if xr() is None or yr() is None]:
        del _DATASET_CACHE[k]
    key = (
        id(key_x),
        id(key_y),
        _content_fingerprint(key_x),
        _content_fingerprint(key_y),
        int(cfg["seed"]),
        int(len(perm)),
        cfg["input_shape"],
        str(device),
    )
    hit = _DATASET_CACHE.get(key)
    if hit is not None:
        xref, yref, xd, yd = hit
        if xref() is key_x and yref() is key_y:
            _DATASET_CACHE[key] = _DATASET_CACHE.pop(key)  # LRU: refresh recency
            return xd, yd
    # Same arrays, different fingerprint ⇒ mutated in place: drop the stale
    # entries now instead of pinning device copies until LRU catches up.
    for k in [
        k for k in _DATASET_CACHE
        if k[0] == key[0] and k[1] == key[1] and (k[2], k[3]) != (key[2], key[3])
    ]:
        del _DATASET_CACHE[k]
    xd = torch.from_numpy(np.ascontiguousarray(xp[perm])).to(device)
    xd = xd.permute(0, 3, 1, 2).contiguous()  # NHWC → NCHW, once per upload
    yd = torch.from_numpy(yp[perm].astype(np.int64)).to(device)
    try:
        xref, yref = weakref.ref(key_x), weakref.ref(key_y)
    except TypeError:
        return xd, yd  # un-weakref-able input (e.g. a list): don't cache
    while len(_DATASET_CACHE) >= 4:  # datasets are big; keep device memory bounded
        _DATASET_CACHE.pop(next(iter(_DATASET_CACHE)))
    _DATASET_CACHE[key] = (xref, yref, xd, yd)
    return xd, yd


# ---------------------------------------------------------------------------
# Memory-cap chunking and population setup
# ---------------------------------------------------------------------------

#: Per-config cap on how many genomes one program may carry, learned from
#: device OOMs (see _chunked_by_cap).
_POP_PROGRAM_CAP: Dict[Any, int] = {}

#: cap_keys whose cap=1 exact-size routing has already been warned about.
_EXACT_ROUTE_WARNED: set = set()


def _oom_cap_key(cfg: Dict[str, Any]):
    """Every config field that changes a program's per-genome memory."""
    return (
        tuple(cfg["nodes"]),
        tuple(cfg["kernels_per_layer"]),
        int(cfg["batch_size"]),
        int(cfg["dense_units"]),
        str(cfg["compute_dtype"]),
        tuple(cfg["input_shape"]),
        int(cfg["n_classes"]),
        bool(cfg["fold_parallel"]),
        cfg["segment_steps"],
        int(cfg["kfold"]) if cfg.get("kfold") else None,
        int(cfg.get("microbatch", 1) or 1),
    )


def _chunked_by_cap(run, genomes, cap_key, run_exact=None):
    """Run the batched evaluator, splitting the population on device OOM.

    On ``torch.cuda.OutOfMemoryError`` the population is split to a
    power-of-two chunk (so chunks reuse the standard bucket shapes) and the
    cap is REMEMBERED for this config, so later generations pre-chunk.  A
    singleton that still does not fit in its padded 2-wide program retries
    through ``run_exact`` (unpadded); once cap=1 is learned every evaluation
    of that config runs 1-wide, and batch-composition purity no longer holds
    across that boundary (warned once per config).
    """
    cap = _POP_PROGRAM_CAP.get(cap_key)
    if cap is not None and len(genomes) > cap:
        return np.concatenate(
            [_chunked_by_cap(run, genomes[i : i + cap], cap_key, run_exact)
             for i in range(0, len(genomes), cap)]
        )
    if cap == 1 and len(genomes) == 1 and run_exact is not None:
        if cap_key not in _EXACT_ROUTE_WARNED:
            _EXACT_ROUTE_WARNED.add(cap_key)
            logger.warning(
                "config with learned memory cap=1: all its evaluations now "
                "run 1-wide unpadded — fitnesses measured before this "
                "boundary came from numerically distinct multi-slot "
                "programs (batch-composition purity does not hold across "
                "the cap=1 boundary)",
            )
        return run_exact(genomes)
    fallback = None
    try:
        return run(genomes)
    except torch.cuda.OutOfMemoryError:
        if len(genomes) <= 1:
            if run_exact is None:
                raise
            _POP_PROGRAM_CAP[cap_key] = 1
            logger.warning(
                "singleton population batch exhausted device memory in its "
                "padded (2-wide) program; retrying exact-size (1-wide, "
                "unpadded — batch-composition purity does not hold for "
                "this genome)",
            )
            fallback = run_exact
        else:
            half = max(1, len(genomes) // 2)
            b = 1
            while b * 2 <= half:
                b *= 2
            _POP_PROGRAM_CAP[cap_key] = b
            logger.warning(
                "population batch of %d genomes exhausted device memory; "
                "chunking to <=%d genomes per program (remembered for this "
                "config in this process)", len(genomes), b,
            )
    # Retry OUTSIDE the except block, deliberately: the exception's
    # traceback pins the frames (and so the device tensors) of the failed
    # attempt.  Leaving the handler drops it; collect and hand the cached
    # blocks back before the smaller chunks run.
    gc.collect()
    torch.cuda.empty_cache()
    if fallback is not None:
        return fallback(genomes)
    return _chunked_by_cap(run, genomes, cap_key, run_exact)


def _genome_size_class(cfg: Dict[str, Any]) -> Tuple[str, int]:
    """(size_class, microbatch) for this config against its device budget.

    No budget configured → the wide-pop path.  The port runs on one device,
    so the cost model is classified for one.
    """
    budget = cfg.get("device_budget")
    if not budget:
        return SIZE_SMALL, 1
    cost = cnn_genome_cost(
        cfg["nodes"],
        cfg["kernels_per_layer"],
        cfg["input_shape"],
        cfg["dense_units"],
        cfg["n_classes"],
        cfg["compute_dtype"],
        bool(cfg["stage_exit_conv"]),
    )
    return classify_genome_cost(cost, int(cfg["batch_size"]), 1, int(budget))


def _fit_microbatch(cfg: Dict[str, Any], batch_size: int, steps: int) -> None:
    """Clamp ``cfg['microbatch']`` to the actual step batch and bump it to the
    next divisor, so the accumulation split is always exact; count the
    micro-gradient passes when accumulation is active."""
    micro = int(cfg.get("microbatch", 1) or 1)
    if micro > 1:
        micro = min(micro, batch_size)
        while batch_size % micro:
            micro += 1
        cfg["microbatch"] = micro
        _get_registry().counter("microbatch_steps_total").inc(steps * micro)


def _resolve_device(mesh) -> torch.device:
    """The device an evaluation runs on.

    ``"auto"`` (the default) and ``None`` mean the CUDA device and raise when
    there is none: the port never falls back to the CPU by itself.  ``"cpu"``,
    another device string, or a ``torch.device`` name the device explicitly.
    """
    if mesh is None or mesh == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mesh='auto' runs on the CUDA device and none is available; "
                "pass mesh='cpu' to run on the CPU explicitly"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    elif isinstance(mesh, (str, torch.device)):
        device = torch.device(mesh)
    else:
        raise TypeError(f"mesh must be 'auto', a device string or a torch.device, got {mesh!r}")
    if device.type == "cuda":
        mark_backend_used()
    return device


def _prepare_population_setup(cfg: Dict[str, Any], genomes: Sequence[Mapping[str, Any]]):
    """Resolve the device, pad the population to its bucket, stack the genome
    masks onto the device and build the module."""
    device = _resolve_device(cfg["mesh"])
    if cfg["pop_padding"]:
        genomes, n_real = pad_population(genomes, pop_bucket(len(genomes)))
    else:
        genomes, n_real = list(genomes), len(genomes)
    if len(genomes) > n_real:
        _get_registry().counter("eval_pad_waste_total").inc(len(genomes) - n_real)
    masks = [
        {k: torch.as_tensor(v, device=device) for k, v in stage.items()}
        for stage in stack_genome_masks(genomes, cfg["nodes"])
    ]
    model = MaskedGeneticCnn(
        nodes=cfg["nodes"],
        filters=cfg["kernels_per_layer"],
        pop=len(genomes),
        input_shape=cfg["input_shape"],
        dense_units=cfg["dense_units"],
        n_classes=cfg["n_classes"],
        dropout_rate=cfg["dropout_rate"],
        compute_dtype=cfg["compute_dtype"],
        stage_exit_conv=bool(cfg["stage_exit_conv"]),
        device=device,
    )
    return device, genomes, n_real, masks, model, _genome_hashes(genomes)


def _refuse_unported(cfg: Dict[str, Any]) -> None:
    """Raise for knobs whose executor is not ported yet, instead of silently
    running something else."""
    if cfg["fold_parallel"]:
        raise NotImplementedError("fold_parallel=True (the fused executor) is not ported yet")
    if cfg["warm_start"]:
        raise NotImplementedError("warm_start=True (the warm-start bank) is not ported yet")


class GeneticCnnModel(GentunModel):
    """Train the decoded CNN under k-fold CV; fitness = mean val accuracy.

    The knobs are the JAX package's, with the same defaults: ``nodes``,
    ``input_shape``, ``kernels_per_layer``, ``kfold``, ``epochs``,
    ``learning_rate``, ``batch_size``, ``dense_units``, ``dropout_rate``,
    ``n_classes``, ``momentum``, ``nesterov``, ``compute_dtype``, ``seed``,
    ``stage_exit_conv``, ``pop_padding``, ``fitness_reps``,
    ``entry_channel_pad`` and ``microbatch`` mean what they mean there.  The
    TPU-side knobs take a meaning on this device:

    - ``mesh``: ``"auto"`` (default) runs on the CUDA device and raises when
      there is none; ``"cpu"`` (or any device string, or a ``torch.device``)
      runs there.  There is no multi-device placement yet.
    - ``segment_steps``: the length of one segment of the host loop (the
      unit a telemetry ``train`` span covers); validated as in the reference.
    - ``cache_dir``: accepted and unused: nothing is compiled.
    - ``fold_parallel``, ``warm_start`` and a ``device_budget`` that routes a
      genome off the wide-pop path raise ``NotImplementedError``.

    Data contract: ``x_train``/``y_train`` are treated as immutable; the
    permuted dataset is cached on the device across ``evaluate()`` calls,
    keyed by array identity plus a strided content fingerprint.
    """

    def __init__(
        self,
        x_train,
        y_train,
        genes: Mapping[str, Any],
        nodes: Sequence[int] = (3, 5),
        input_shape: Optional[Sequence[int]] = None,
        kernels_per_layer: Sequence[int] = (20, 50),
        kfold: int = 5,
        epochs: Sequence[int] = (20, 4, 1),
        learning_rate: Sequence[float] = (1e-2, 1e-3, 1e-4),
        batch_size: int = 128,
        dense_units: int = 500,
        dropout_rate: float = 0.5,
        n_classes: Optional[int] = None,
        momentum: float = 0.9,
        nesterov: bool = False,
        compute_dtype: str = "bfloat16",
        seed: int = 0,
        mesh="auto",
        cache_dir: Optional[str] = None,
        fold_parallel: bool = False,
        stage_exit_conv: bool = False,
        segment_steps: Optional[int] = 96,
        pop_padding: bool = True,
        fitness_reps: int = 1,
        entry_channel_pad: Optional[int] = None,
        device_budget: Optional[int] = None,
        microbatch: int = 1,
    ):
        super().__init__(x_train, y_train, genes)
        self.config = dict(
            nodes=tuple(int(k) for k in nodes),
            input_shape=tuple(input_shape) if input_shape is not None else None,
            kernels_per_layer=tuple(int(f) for f in kernels_per_layer),
            kfold=int(kfold),
            epochs=tuple(int(e) for e in epochs),
            learning_rate=tuple(float(r) for r in learning_rate),
            batch_size=int(batch_size),
            dense_units=int(dense_units),
            dropout_rate=float(dropout_rate),
            n_classes=n_classes,
            momentum=float(momentum),
            nesterov=bool(nesterov),
            compute_dtype=str(compute_dtype),
            seed=int(seed),
            mesh=mesh,
            cache_dir=cache_dir,
            fold_parallel=bool(fold_parallel),
            stage_exit_conv=bool(stage_exit_conv),
            segment_steps=segment_steps,
            pop_padding=bool(pop_padding),
            fitness_reps=int(fitness_reps),
            entry_channel_pad=entry_channel_pad,
            device_budget=device_budget,
            microbatch=int(microbatch),
        )

    def cross_validate(self) -> float:
        return float(
            self.cross_validate_population(self.x_train, self.y_train, [self.genes], **self.config)[0]
        )

    @classmethod
    def cross_validate_population(
        cls,
        x_train,
        y_train,
        genomes: Sequence[Mapping[str, Any]],
        **config,
    ) -> np.ndarray:
        """k-fold CV fitness for P genomes trained together; returns P mean
        validation accuracies.

        ``fitness_reps > 1`` averages each genome over that many independent
        trainings, one call per rep with seed ``seed + 7919·r``.  A
        population too large for the device's memory is chunked
        (``_chunked_by_cap``).
        """
        reps_raw = config.get("fitness_reps", 1)
        reps = 1 if reps_raw is None else int(reps_raw)
        # reps < 1 falls through to _normalize_config, which raises.
        if reps > 1:
            inner = {**config, "fitness_reps": 1}
            base_seed = int(config.get("seed", 0) or 0)
            per_rep = [
                cls.cross_validate_population(
                    x_train, y_train, genomes, **{**inner, "seed": base_seed + 7919 * r}
                )
                for r in range(reps)
            ]
            return np.mean(per_rep, axis=0, dtype=np.float64).astype(np.float32)
        cfg0 = _normalize_config(x_train, y_train, config)
        _refuse_unported(cfg0)
        size_class, _ = _genome_size_class(cfg0)
        if size_class != SIZE_SMALL:
            raise NotImplementedError(
                f"device_budget puts this config in size class {size_class!r}; "
                "big-genome routing is not ported yet"
            )
        return _chunked_by_cap(
            lambda gs: cls._cross_validate_population_one(x_train, y_train, gs, **config),
            list(genomes),
            _oom_cap_key(cfg0),
            run_exact=lambda gs: cls._cross_validate_population_one(
                x_train, y_train, gs, **{**config, "pop_padding": False}
            ),
        )

    @classmethod
    def _cross_validate_population_one(
        cls,
        x_train,
        y_train,
        genomes: Sequence[Mapping[str, Any]],
        **config,
    ) -> np.ndarray:
        cfg = _normalize_config(x_train, y_train, config)
        x, y = _prepare_data(x_train, y_train, cfg)
        if len(genomes) == 0:
            return np.zeros((0,), dtype=np.float32)
        device, genomes, n_real, masks, model, hashes = _prepare_population_setup(cfg, genomes)

        kfold = cfg["kfold"]
        n = x.shape[0]
        if kfold < 2:
            raise ValueError("kfold must be >= 2")
        fold_size = n // kfold
        if fold_size == 0:
            raise ValueError(f"kfold={kfold} exceeds dataset size {n}")
        # Host-side RNG exactly as the reference draws it: the same seed gives
        # the same fold permutation and the same batch orders.
        n_use = fold_size * kfold
        rng = np.random.default_rng(cfg["seed"])
        perm = rng.permutation(n)[:n_use]
        folds = np.arange(n_use, dtype=np.int32).reshape(kfold, fold_size)

        batch_size = min(cfg["batch_size"], n_use - fold_size)
        n_tr = n_use - fold_size
        steps_per_epoch = max(n_tr // batch_size, 1)
        total_steps = sum(cfg["epochs"]) * steps_per_epoch
        eval_bs, n_val_padded = _eval_batch_size(batch_size, fold_size)
        pad = n_val_padded - fold_size
        _fit_microbatch(cfg, batch_size, total_steps * kfold)

        batch_idx = np.zeros((kfold, total_steps, batch_size), dtype=np.int64)
        val_idx = np.zeros((kfold, n_val_padded), dtype=np.int64)
        val_weight = np.zeros((kfold, n_val_padded), dtype=np.float32)
        for f in range(kfold):
            tr_idx = np.concatenate([folds[g] for g in range(kfold) if g != f])
            order = np.concatenate(
                [rng.permutation(n_tr) for _ in range(sum(cfg["epochs"]))]
            )[: total_steps * batch_size]
            batch_idx[f] = tr_idx[order].reshape(total_steps, batch_size)
            val_idx[f] = np.concatenate([folds[f], np.full(pad, folds[f][0])])
            val_weight[f] = np.concatenate(
                [np.ones(fold_size, np.float32), np.zeros(pad, np.float32)]
            )

        params = _init_population_params(model, kfold, cfg["seed"], hashes)
        x_dev, y_dev = _device_dataset(x_train, y_train, x, y, perm, cfg, device)
        accs = _run_segmented(
            cfg, model, masks, params, hashes, x_dev, y_dev,
            val_idx, val_weight, batch_idx, steps_per_epoch, eval_bs,
        )
        return accs.mean(axis=0)[:n_real]


def _normalize_config(x_train, y_train, config: Dict[str, Any]) -> Dict[str, Any]:
    """Fill inferred fields (input_shape, n_classes) and canonicalise types.

    The same 25 keys, defaults and errors as the JAX package's."""
    defaults = dict(
        nodes=(3, 5),
        input_shape=None,
        kernels_per_layer=(20, 50),
        kfold=5,
        epochs=(20, 4, 1),
        learning_rate=(1e-2, 1e-3, 1e-4),
        batch_size=128,
        dense_units=500,
        dropout_rate=0.5,
        n_classes=None,
        momentum=0.9,
        nesterov=False,
        compute_dtype="bfloat16",
        seed=0,
        mesh="auto",
        cache_dir=None,
        fold_parallel=False,
        stage_exit_conv=False,
        segment_steps=96,
        pop_padding=True,
        fitness_reps=1,
        entry_channel_pad=None,
        warm_start=False,
        device_budget=None,
        microbatch=1,
    )
    unknown = set(config) - set(defaults)
    if unknown:
        raise TypeError(f"unknown GeneticCnnModel parameters: {sorted(unknown)}")
    cfg = {**defaults, **config}
    cfg["nodes"] = tuple(int(k) for k in cfg["nodes"])
    cfg["kernels_per_layer"] = tuple(int(f) for f in cfg["kernels_per_layer"])
    if len(cfg["kernels_per_layer"]) != len(cfg["nodes"]):
        raise ValueError("kernels_per_layer must have one entry per stage")
    cfg["epochs"] = tuple(int(e) for e in cfg["epochs"])
    cfg["learning_rate"] = tuple(float(r) for r in cfg["learning_rate"])
    if len(cfg["epochs"]) != len(cfg["learning_rate"]):
        raise ValueError("epochs and learning_rate must be parallel tuples")
    if cfg["segment_steps"] is not None:
        cfg["segment_steps"] = int(cfg["segment_steps"])
        if cfg["segment_steps"] < 1:
            raise ValueError("segment_steps must be a positive int or None")
    cfg["fitness_reps"] = 1 if cfg["fitness_reps"] is None else int(cfg["fitness_reps"])
    if cfg["fitness_reps"] < 1:
        raise ValueError("fitness_reps must be a positive int")
    cfg["warm_start"] = bool(cfg["warm_start"])
    if cfg["device_budget"] is not None:
        cfg["device_budget"] = int(cfg["device_budget"])
        if cfg["device_budget"] < 1:
            raise ValueError("device_budget must be positive bytes or None")
    cfg["microbatch"] = 1 if cfg["microbatch"] is None else int(cfg["microbatch"])
    if cfg["microbatch"] < 1:
        raise ValueError("microbatch must be a positive int")
    if cfg["entry_channel_pad"] is not None:
        cfg["entry_channel_pad"] = int(cfg["entry_channel_pad"])
        if cfg["entry_channel_pad"] < 1:
            raise ValueError("entry_channel_pad must be a positive int or None")
    x = np.asarray(x_train)
    if cfg["input_shape"] is None:
        if x.ndim == 4:
            cfg["input_shape"] = tuple(x.shape[1:])
        elif x.ndim == 3:
            cfg["input_shape"] = (*x.shape[1:], 1)
        else:
            raise ValueError(
                "input_shape is required for flat inputs (cannot infer HWC from "
                f"array of shape {x.shape})"
            )
    else:
        cfg["input_shape"] = tuple(int(d) for d in cfg["input_shape"])
    # Optional entry padding: zero-pad the input CHANNEL dim up to
    # entry_channel_pad at data-prep level.  The extra channels are all-zero,
    # so they change nothing the entry conv computes.  raw_input_shape keeps
    # the pre-pad shape for flat-input reshaping.
    cfg["raw_input_shape"] = cfg["input_shape"]
    if cfg["entry_channel_pad"] and cfg["entry_channel_pad"] > cfg["input_shape"][-1]:
        h_, w_ = cfg["input_shape"][0], cfg["input_shape"][1]
        cfg["input_shape"] = (h_, w_, cfg["entry_channel_pad"])
    if cfg["n_classes"] is None:
        cfg["n_classes"] = int(np.max(np.asarray(y_train))) + 1
    cfg["n_classes"] = int(cfg["n_classes"])
    return cfg


def _prepare_data(x_train, y_train, cfg: Dict[str, Any]):
    """float32 NHWC images + int32 labels, reshaping flat inputs if needed,
    with the entry_channel_pad zero channels applied."""
    x = np.asarray(x_train, dtype=np.float32)
    if x.ndim != 4:
        x = x.reshape((x.shape[0], *cfg.get("raw_input_shape", cfg["input_shape"])))
    target_c = cfg["input_shape"][-1]
    if x.shape[-1] < target_c:
        x = np.concatenate(
            [x, np.zeros((*x.shape[:-1], target_c - x.shape[-1]), np.float32)], axis=-1
        )
    y = np.asarray(y_train, dtype=np.int32)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"x/y length mismatch: {x.shape[0]} vs {y.shape[0]}")
    return x, y
