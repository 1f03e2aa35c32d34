"""Genetic-CNN fitness model on PyTorch: one masked supergraph, a whole population per step.

The PyTorch counterpart of the JAX package's ``models/cnn.py``.  What it
computes is the same: decode binary genes into a per-stage DAG of
Conv(3×3)+ReLU nodes, sum-merge fan-in, 2×2 max-pool between stages, a dense
head with dropout, staged-LR SGD with momentum, k-fold cross-validation,
fitness = mean validation accuracy.  How it runs differs:

- **The population is a tensor axis, not a ``vmap``.**  Activations are
  ``(B, P·C, H, W)``.  Every 3×3 conv is the port's own population-batched
  kernel (``ops/pop_conv.py``, CUDA source in ``csrc/pop_conv3x3.cu``)
  with the genome as a grid axis, so genome ``p`` only ever sees its own
  channels.  The stage-0 entry conv reads the input that every genome
  shares.  The dense head is per genome: one ``torch.mm`` per genome.
- **Masks are data.**  Every genome runs the same supergraph; the mask
  scalars (``adj``, ``entry``, ``active``, ``exit``, ``has_active``) multiply
  in the compute dtype exactly where the reference multiplies them.  Each
  stage is one :class:`~..ops.pop_dag.PopStageFn`: its convs, the masked
  node sums, ReLU, the stage output and the 2×2 max-pool run in the port's
  hand-written kernels (``ops/pop_dag.py``, ``csrc/pop_dag.cu``), forward
  and backward, with the eager chain's rounding.
- **bfloat16 compute, float32 params and logits** by explicit casts that
  follow flax's ``dtype=`` semantics (params are cast to the compute dtype
  inside each layer; the last Dense and the logits are float32).  No
  autocast.  float32 means IEEE float32 on a CUDA card too: the conv
  kernels run float32 as plain FMA loops, and the executor turns TF32 off
  for cuBLAS matmuls while it runs (``exact_numerics``).
- **The executor is a host loop.**  Folds and steps are a Python loop over
  device-resident carries (params, momentum, per-genome dropout generators);
  the dataset uploads once and is cached across evaluations.  Nothing is
  compiled: PyTorch runs eagerly, but on one card a call captures its train
  step once as a CUDA graph and replays it for every later step, so the
  host does not pace the kernels (``_StepGraph``).
- **Fitness is a pure function of (genome, config, seed).**  Init is drawn
  on the CPU from one generator per (fold, genome) seeded from the genome's
  content hash, then moved to the device, so a CPU run and a CUDA run start
  from the same weights; dropout draws from one device generator per
  (fold, genome), so no genome's draws depend on its slot, its batch or the
  padding.  And no sum a slot's arithmetic takes depends on how many slots
  run beside it: the conv kernels fix their tiles and the order of every
  reduction from the layer's shape alone, and the dense head runs one
  product per genome at the same shape whatever P is.  So a genome's
  fitness is the same bits alone, in any slot of any batch and in any pop
  bucket, on the CPU and on the card (the
  learned cap=1 route of ``_chunked_by_cap`` runs unpadded, still at the
  same per-slot shapes).

Several cards run one evaluation as the ranks of a ``torch.distributed``
group, one process per card (``parallel/multihost.py``), laid out as a
``(pop, data)`` mesh (``parallel/mesh.py``).  Each pop row trains its own
slice of the (padded) population with no communication, so by the purity
above its fitnesses are the one-process bits.  The ranks of a row split
every step's batch: each divides its genomes' losses by the whole batch,
draws each genome's full-batch dropout mask and keeps its own rows (the
one-process stream), and one ``all_reduce`` of the flattened gradients over
the row's group precedes the SGD update, which leaves the params equal on
every rank of the row.  Eval deals whole validation batches out over the
row's ranks and sums the hit counts, which is exact.  Every rank ends with
the whole ``(kfold, P)`` accuracy table (``multihost.fetch``).

A ``device_budget`` that the cost model says one genome's program cannot
fit routes the batch one genome per call: the ``big`` class spreads that
batch over every rank of a ``(1, world)`` mesh, and the ``micro`` class adds
gradient accumulation.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import logging
import os
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _build
from ..ops.dag import stack_genome_masks
from ..ops.pop_dag import pop_stage, stage_masks
from ..parallel import multihost
from ..parallel.mesh import (
    SIZE_SMALL,
    Mesh,
    auto_mesh,
    classify_genome_cost,
    cnn_genome_cost,
    mesh_axis_sizes,
    pad_population,
    pop_bucket,
    shard_cv_args,
)
from ..telemetry import lineage as _lineage
from ..telemetry import spans as _tele
from ..telemetry.registry import get_registry as _get_registry
from ..utils import profiling as _profiling
from ..utils.device_state import mark_backend_used
from ..utils.kernel_cache import default_cache_dir, enable_compilation_cache, run_publish_hooks
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
    """The params of P independent 3×3 SAME convs (+bias), which
    :class:`PopStageFn` runs.

    ``weight`` is ``(P, F, C, 3, 3)`` (OIHW per genome), ``bias`` ``(P, F)``.
    With ``shared_input`` the input is ``(B, C, H, W)``, read by every
    genome; otherwise it is ``(B, P·C, H, W)``.  :meth:`cast` gives them in
    the compute dtype, as flax's ``nn.Conv(dtype=...)`` casts them.
    """

    def __init__(self, pop: int, c_in: int, features: int, shared_input: bool, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(pop, features, c_in, 3, 3, device=device))
        self.bias = nn.Parameter(torch.empty(pop, features, device=device))
        self.shared_input = shared_input

    def cast(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.weight.to(dtype), self.bias.to(dtype)


class _PopDense(nn.Module):
    """P independent Dense layers: genome ``p`` computes ``x[p] @ W[p] + b[p]``.

    The kernel keeps flax's ``(in, out)`` layout per genome.  One ``torch.mm``
    per genome rather than one ``bmm`` over P: a product's shape, and so the
    library's choice of algorithm and its sums, is then the same at any P,
    and the bias gradient reduces over one genome's batch at a time.
    """

    def __init__(self, pop: int, d_in: int, d_out: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(pop, d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.empty(pop, d_out, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        slots = zip(x.contiguous().unbind(0), self.weight.to(dtype).unbind(0),
                    self.bias.to(dtype).unbind(0))
        return torch.stack([torch.mm(xp, wp) + bp for xp, wp, bp in slots])


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
        batch_rows: Optional[Tuple[int, int, int]] = None,
    ) -> torch.Tensor:
        """Logits ``(P, B, n_classes)``; dropout runs only when ``dropout_gens``
        (one generator per genome, on ``x``'s device) is given.  ``batch_rows``
        ``(lo, hi, n)`` says ``x`` holds rows ``[lo, hi)`` of a batch of ``n``
        (a data-axis shard): dropout then draws the whole batch's mask and
        keeps those rows."""
        dtype = self.compute_dtype
        pop, b = self.pop, x.shape[0]
        x = x.to(dtype)
        for s, k in enumerate(self.nodes):
            layers = [f"stage{s}_entry", *(f"stage{s}_node{j}" for j in range(k))]
            if self.stage_exit_conv:
                layers.append(f"stage{s}_exit")
            params = [p for name in layers for p in self[name].cast(dtype)]
            x = pop_stage(x, stage_masks(masks[s], x.device), params, shared=(s == 0))
        x = x.reshape(b, pop, -1).transpose(0, 1)
        x = F.relu(self["Dense_0"](x, dtype))
        if dropout_gens is not None:
            x = _dropout(x, self.dropout_rate, dropout_gens, batch_rows)
        # Final projection + logits in float32, as the reference does.
        return self["Dense_1"](x.float(), torch.float32)


def _dropout(x: torch.Tensor, rate: float, gens: Sequence[torch.Generator],
             batch_rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` semantics with one random stream per genome.

    ``x`` is ``(P, B, U)``; genome ``p`` draws its own ``(B, U)`` keep mask
    from ``gens[p]``, so its draws never depend on P, its slot or padding.
    With ``batch_rows = (lo, hi, n)`` it draws the ``(n, U)`` mask of the
    whole batch and keeps rows ``[lo, hi)``: a data shard sees the mask one
    process would.
    """
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    shape, rows = x.shape[1:], slice(None)
    if batch_rows is not None:
        shape, rows = (batch_rows[2], *x.shape[2:]), slice(batch_rows[0], batch_rows[1])
    keep = torch.stack(
        [(torch.rand(shape, generator=g, device=x.device) < keep_prob)[rows] for g in gens]
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


def _per_genome_loss(logits: torch.Tensor, y: torch.Tensor,
                     batch: Optional[int] = None) -> torch.Tensor:
    """Softmax cross-entropy, mean over the batch, one value per genome; a
    data shard passes the whole ``batch`` it is a share of and gets its
    share of that mean (the shares sum to it)."""
    pop, b, n_classes = logits.shape
    ce = F.cross_entropy(logits.reshape(pop * b, n_classes), y.repeat(pop), reduction="none")
    if batch is None:
        return ce.view(pop, b).mean(dim=1)
    return ce.view(pop, b).sum(dim=1) / batch


#: The phases of a train step that ``_train_step`` times when asked.
_PHASES = ("forward", "backward", "update")
_NO_PHASE = contextlib.nullcontext()


class _Phase:
    """Add a train-step phase's host seconds (``time.perf_counter``) to
    ``phases[name]``, inside its ``gentun.<name>`` range while a profiler
    runs."""

    __slots__ = ("phases", "name", "_t0", "_range")

    def __init__(self, phases: Dict[str, float], name: str):
        self.phases, self.name = phases, name

    def __enter__(self):
        self._range = _profiling.profiler_range(self.name)
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.phases[self.name] += time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def _phase(phases: Optional[Dict[str, float]], name: str):
    return _NO_PHASE if phases is None else _Phase(phases, name)


def _train_step(
    model: MaskedGeneticCnn,
    masks: Masks,
    x_full: torch.Tensor,
    y_full: torch.Tensor,
    idx: torch.Tensor,
    gens: Optional[Sequence[torch.Generator]],
    momentum_bufs: List[torch.Tensor],
    lr,
    momentum: float,
    nesterov: bool,
    microbatch: int = 1,
    batch_rows: Optional[Tuple[int, int, int]] = None,
    data_group=None,
    phases: Optional[Dict[str, float]] = None,
) -> None:
    """One SGD step for all genomes, ``optax.sgd`` arithmetic.

    The loss is the sum over genomes of each genome's batch mean, so each
    genome's params get exactly their own gradient.  ``microbatch > 1``
    splits the batch and averages the slices' gradients before the one
    update (dropout then draws per slice).  Momentum: ``t = g + m·t``; the
    update is ``t`` (or ``g + m·t`` with nesterov), scaled by ``lr`` and
    taken from the param.  Params and momentum buffers update in place.
    ``lr`` is a float or a 0-dim float32 tensor (the executor's, on the
    device, which a graph of the step reads at each replay): ``p − u·lr`` is
    the same bits either way, and the same as ``p + u·(−lr)``.

    On a data axis ``idx`` holds this rank's rows ``batch_rows = (lo, hi,
    n)`` of each micro-slice of ``n``: each loss is divided by ``n``, and the
    flattened gradients are summed over ``data_group`` in one ``all_reduce``
    before the update, so every rank of the row applies the same bits.

    With a ``phases`` dict (keys ``_PHASES``) the step adds the host
    seconds of its phases to it: ``forward`` (model and loss, each
    micro-slice), ``backward`` (``autograd.grad`` and the gradient sums)
    and ``update`` (the all-reduce and the SGD loop).
    """
    params = list(model.parameters())
    grads: Optional[List[torch.Tensor]] = None
    whole = None if batch_rows is None else batch_rows[2]
    for im in idx.view(microbatch, -1):
        with _phase(phases, "forward"):
            logits = model(x_full.index_select(0, im), masks, dropout_gens=gens,
                           batch_rows=batch_rows)
            loss = _per_genome_loss(logits, y_full.index_select(0, im), whole).sum()
        with _phase(phases, "backward"):
            g = torch.autograd.grad(loss, params)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
    with _phase(phases, "update"):
        if data_group is not None:
            import torch.distributed as dist

            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=data_group)
            grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        with torch.no_grad():
            for p, g, t in zip(params, grads, momentum_bufs):
                if microbatch > 1:
                    g = g / microbatch
                t.mul_(momentum).add_(g)
                update = g + momentum * t if nesterov else t
                p.sub_(update * lr)


@torch.no_grad()
def _eval_fold(
    model: MaskedGeneticCnn,
    masks: Masks,
    x_full: torch.Tensor,
    y_full: torch.Tensor,
    val_idx: torch.Tensor,
    val_weight: torch.Tensor,
    eval_batch_size: int,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Weighted validation accuracy per genome, ``(P,)`` float32, on device.

    ``argmax`` takes the first maximum, as ``jnp.argmax`` does; padded rows
    carry weight 0.  On a data axis the row's ranks take every ``data``-th
    eval batch (each batch the shape it has in one process) and sum their
    hit counts over the row's group: whole numbers, so the sum is exact.
    """
    correct = torch.zeros(model.pop, dtype=torch.float32, device=x_full.device)
    starts = range(0, val_idx.shape[0], eval_batch_size)
    group = None if mesh is None else mesh.data_group
    if group is not None:
        starts = starts[mesh.col::mesh.shape["data"]]
    for start in starts:
        idx = val_idx[start : start + eval_batch_size]
        logits = model(x_full.index_select(0, idx), masks)
        hits = (logits.argmax(dim=-1) == y_full.index_select(0, idx)).float()
        correct += (hits * val_weight[start : start + eval_batch_size]).sum(dim=1)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(correct, group=group)
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


#: ``exact_numerics`` state.  The TF32 flag is process-global and
#: evaluations run on several threads at once (``AsyncEvolution``'s thread
#: pool): the flag stays off while ANY thread is inside, and the value the
#: first thread found comes back when the last one leaves.
_NUMERICS_LOCK = threading.Lock()
_numerics_depth = 0
_numerics_saved = False


@contextlib.contextmanager
def exact_numerics():
    """IEEE float32 matmuls inside the block.

    PyTorch lets cuBLAS matmuls run float32 in TF32 when its flag says so
    (10-bit mantissa); the reference's float32 is IEEE float32, so TF32 is
    off for the dense head's products.  The port's own convs never use TF32
    and sum in an order fixed by the layer's shape, and the dense head runs
    one product per genome, so a fitness is a function of (genome, config,
    seed) alone: the same bits in any slot, batch or pop bucket.  The
    executor runs every fold inside this block; the caller's flag is
    restored when the last block open in the process (on any thread) exits.
    """
    global _numerics_depth, _numerics_saved
    matmul = torch.backends.cuda.matmul
    with _NUMERICS_LOCK:
        if _numerics_depth == 0:
            _numerics_saved = matmul.allow_tf32
        _numerics_depth += 1
        matmul.allow_tf32 = False
    try:
        yield
    finally:
        with _NUMERICS_LOCK:
            _numerics_depth -= 1
            if _numerics_depth == 0:
                matmul.allow_tf32 = _numerics_saved


@contextlib.contextmanager
def _device_span(kind: str, device: torch.device, attrs: Dict[str, Any]):
    """A telemetry span around device work, with the name of the thread that
    ran the work (evaluations may run on several): it opens (with its
    profiler range) on entry and, before it closes, waits for the thread's
    current stream.  That is the default stream, which the threads share,
    so a span of one thread also covers work that another thread queued
    there before it; the whole device is not waited for, which CUDA forbids
    while another thread captures a graph.  With telemetry off it is the
    no-op span and nothing waits."""
    if not _tele.enabled():
        yield _tele.span(kind)
        return
    with _tele.span(kind, {**attrs, "thread": threading.current_thread().name}) as sp:
        yield sp
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()


def _check_initial_params(
    named: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor], kfold: int
) -> None:
    """Refuse initial params that do not fit the model: every leaf must be
    ``(≥ kfold, *the parameter's shape)`` in the parameter's dtype, or
    ``copy_`` would broadcast it silently."""
    for name, p in named.items():
        leaf = params[name]
        if (tuple(leaf.shape[1:]) != tuple(p.shape) or leaf.shape[0] < kfold
                or leaf.dtype != p.dtype):
            raise ValueError(
                f"initial param {name!r} has shape {tuple(leaf.shape)} {leaf.dtype}; "
                f"the model needs ({kfold}, *{tuple(p.shape)}) {p.dtype}")


# ---------------------------------------------------------------------------
# The train step as a CUDA graph
# ---------------------------------------------------------------------------

#: Fewest train steps (over all folds) a call needs for its step to run as
#: a CUDA graph: the first runs eagerly as the capture's warm-up, and the
#: capture is then replayed for every later step, at least twice.
_GRAPH_MIN_STEPS = 3


def _graph_eligible(device: torch.device, mesh: Optional[Mesh], steps: int) -> bool:
    """Does a call of ``steps`` train steps replay its step as a CUDA graph?
    On a CUDA device, off a mesh (whose ranks all-reduce every step), with
    at least ``_GRAPH_MIN_STEPS`` steps; everything else steps eagerly."""
    return device.type == "cuda" and mesh is None and steps >= _GRAPH_MIN_STEPS


#: A train step's memory over ``cnn_genome_cost``'s activations of one
#: batch (one live copy per conv output), as measured on an H100 at
#: config #5, pop 50: the eager step's peak above its parameter state was
#: 1.99, 1.86 and 1.81 times the activations at batch 64, 128 and 256, and
#: the graph's pool 2.93 and 2.75 times at batch 64 and 128 (at 256 the
#: capture ran out of memory).
_EAGER_BYTES_PER_ACT_BYTE = 2.0
_POOL_BYTES_PER_ACT_BYTE = 3.0


def _graph_fits(cfg: Dict[str, Any], pop: int, batch: int, device: torch.device) -> bool:
    """Do the eager step's blocks and the graph's memory pool fit together
    in the memory the device has free or holds unused in the allocator's
    cache?  The capture draws its pool from neither the cache nor the eager
    step's blocks, and runs out of memory where the two do not fit (config
    #5 at pop 50 and batch 256 on an 80 GB card, where the failed capture
    fills the card and costs its call ≈ 1.2 s).  A later call of the same
    shapes finds both in the cache, and then the CUDA runtime is not asked
    for free memory: on an H100 that query holds the host ≈ 2 ms while the
    device waits."""
    cost = cnn_genome_cost(cfg["nodes"], cfg["kernels_per_layer"], cfg["input_shape"],
                           cfg["dense_units"], cfg["n_classes"], cfg["compute_dtype"],
                           bool(cfg["stage_exit_conv"]))
    rows = batch // max(1, int(cfg["microbatch"]))
    need = ((_EAGER_BYTES_PER_ACT_BYTE + _POOL_BYTES_PER_ACT_BYTE)
            * cost.act_bytes_per_example * rows * pop)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return need <= cached or need <= cached + torch.cuda.mem_get_info(device)[0]


#: The programs, by (``_oom_cap_key``, pop), whose capture raised once: their
#: later calls step eagerly without trying again.
_NO_GRAPH: set = set()
#: Captures under way in the process: ``_empty_cache`` waits for none.
_CAPTURE_LOCK = threading.Lock()
_captures_underway = 0


class _ThreadGraphs:
    """An evaluating thread's capture stream on one device, and the graph it
    captured last there.

    The stream is kept because the eager steps run on it make its cuBLAS
    workspace outside any graph's pool: one made inside a capture stays
    allocated in that pool, so a new stream a call pins one pool a call
    (on an H100, config #2 at pop 20: +64 MiB allocated and +2.05 GiB
    reserved a call).  The last graph, never replayed again, is kept for
    its pool, which the thread's next capture shares: a dead graph's pool
    stays reserved until the allocator's cache is emptied, so a pool a call
    piles up (+1.98 GiB a call), and emptying the cache after every call
    costs more than the graph saves (87-517 ms a call).
    :func:`_release_step_graphs` drops every thread's last graph.
    """

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.last: Optional[torch.cuda.CUDAGraph] = None


_THREAD_GRAPHS = threading.local()
#: Every thread's ``_ThreadGraphs``, for :func:`_release_step_graphs`; a
#: thread's go when it ends.
_ALL_THREAD_GRAPHS: "weakref.WeakSet[_ThreadGraphs]" = weakref.WeakSet()


def _thread_graphs(device: torch.device) -> _ThreadGraphs:
    mine = _THREAD_GRAPHS.__dict__.setdefault("by_device", {})
    if device.index not in mine:
        mine[device.index] = _ThreadGraphs(device)
        with _CAPTURE_LOCK:
            _ALL_THREAD_GRAPHS.add(mine[device.index])
    return mine[device.index]


def _release_step_graphs() -> bool:
    """Drop every thread's last graph, so that the next ``_empty_cache``
    frees its pool; True if there was one."""
    with _CAPTURE_LOCK:
        held = [t for t in _ALL_THREAD_GRAPHS if t.last is not None]
        for t in held:
            t.last = None
    return bool(held)


def _empty_cache() -> None:
    """``torch.cuda.empty_cache``, unless a train step is being captured on
    another thread: the caching allocator may not empty its cache then."""
    with _CAPTURE_LOCK:
        if not _captures_underway:
            torch.cuda.empty_cache()


class _StepGraph:
    """A CV call's train step as one CUDA graph: captured once, after the
    call's first step, and replayed for every later step of every fold.

    What changes from step to step reaches the graph through two static
    device buffers that :meth:`replay` fills before each launch: ``idx``,
    the batch's rows, and ``lr``, a 0-dim float32.  All else lives as long
    as the call and changes in place: the params (each fold copies its own
    in), the momentum buffers (zeroed in place), the dataset and the masks,
    and the per-genome dropout generators, which are registered with the
    graph, so a replay draws from each one's state at that moment and moves
    it on as the eager step does (each fold re-seeds them in place).  The
    graph is the call's; its memory pool is the thread's (``_ThreadGraphs``).
    """

    def __init__(self, device: torch.device, batch: int, key: Tuple):
        self.key = key
        self.mine = _thread_graphs(device)
        self.failed = False
        self.idx = torch.empty(batch, dtype=torch.int64, device=device)
        self.lr = torch.empty((), dtype=torch.float32, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}

    def first_step(self, step: Callable, idx: torch.Tensor, lr: torch.Tensor,
                   phases: Optional[Dict[str, float]],
                   gens: Optional[List[torch.Generator]]) -> bool:
        """Run ``step(idx, lr, phases)`` eagerly on the thread's capture
        stream, then capture ``step(self.idx, self.lr, None)`` there; True
        if the capture took, else (``failed``) the caller steps on eagerly."""
        stream = self.mine.stream
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        try:
            with torch.cuda.stream(stream):
                step(idx, lr, phases)
                self.failed = not self._capture(step, gens)
        finally:
            current.wait_stream(stream)
        if self.failed:
            _empty_cache()  # the failed capture's pool
        return not self.failed

    def _capture(self, step: Callable, gens: Optional[List[torch.Generator]]) -> bool:
        """A capture that raises (an op a graph cannot hold, a CUDA OOM)
        drops the graph and the thread's pool, puts the program in
        ``_NO_GRAPH``, logs and returns False.  The generators are then new
        ones in the state the capture found: a failed capture can leave a
        registered state marked as capturing."""
        global _captures_underway
        states = [g.get_state() for g in gens or ()]
        graph, last = torch.cuda.CUDAGraph(), self.mine.last
        with _CAPTURE_LOCK:
            _captures_underway += 1
        try:
            for g in gens or ():
                graph.register_generator_state(g)
            with _build.recording_launches() as launches:
                graph.capture_begin(pool=None if last is None else last.pool(),
                                    capture_error_mode="thread_local")
                try:
                    step(self.idx, self.lr, None)
                finally:
                    graph.capture_end()
        except Exception as err:  # noqa: BLE001 - any failure steps on eagerly
            self.mine.last = None
            if gens:
                gens[:] = [_generator_in_state(g.device, st) for g, st in zip(gens, states)]
            _NO_GRAPH.add(self.key)
            logger.warning("the train step's CUDA graph capture failed (%s: %s); this "
                           "program steps eagerly from now on", type(err).__name__, err)
            return False
        finally:
            with _CAPTURE_LOCK:
                _captures_underway -= 1
        self.graph, self.launches, self.mine.last = graph, launches, graph
        return True

    def replay(self, idx: torch.Tensor, lr: torch.Tensor) -> None:
        """One step: the batch's rows and the learning rate into the static
        buffers, then the graph, on the current stream."""
        self.idx.copy_(idx)
        self.lr.copy_(lr)
        self.graph.replay()
        _build.add_launches(self.launches)


def _generator_in_state(device: torch.device, state: torch.Tensor) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


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
    domain: int = 0,
    warm_keys: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
    batch_rows: Optional[Tuple[int, int, int]] = None,
) -> np.ndarray:
    """Host loop over folds × segments of train steps; returns (kfold, P) accs.

    Per fold: load that fold's initial params into ``model``, zero the
    momentum, seed the per-genome dropout generators (of stream domain
    ``domain``), all in place, run the schedule's steps, then the weighted
    eval.  The learning rate of each step is a 0-dim tensor of a per-call
    table on the device.  Where ``_graph_eligible`` says so, the call's
    first step runs eagerly and every later step of every fold is a replay
    of one CUDA graph of the step (:class:`_StepGraph`), unless
    ``_graph_fits`` says the graph's pool would not fit beside the eager
    step: then the call steps eagerly without trying.  With telemetry on,
    the fold's preamble is a ``fold_load`` span, each segment a ``train``
    span carrying its eager steps' phase seconds (``forward_s``,
    ``backward_s``, ``update_s``), its replays' (``replay_s``), the steps
    it replayed (``graph_steps``), the captures it made (``captures``),
    those that raised (``fallbacks``) and those skipped for want of memory
    (``graph_skips``), each eval an ``eval`` span, and the
    final gather a ``fetch`` span.  Each fold's accuracies stay on the
    device until every fold is queued.  With
    ``warm_keys`` (the real genomes' hashes) fold 0's trained params go into
    the warm-start bank.

    On a ``mesh`` the inputs are this rank's share (``shard_cv_args``:
    ``batch_rows`` says which rows of each batch it holds); the steps
    all-reduce over the row's group, and every rank returns the whole
    ``(kfold, P)`` table, gathered from each row's first rank.
    """
    device = x_full.device
    kfold, total_steps = batch_idx.shape[0], batch_idx.shape[1]
    lr_at = _lr_schedule(cfg["epochs"], cfg["learning_rate"], steps_per_epoch)
    lr_table = torch.tensor([lr_at(t) for t in range(total_steps)], dtype=torch.float32,
                            device=device)
    bounds = _segment_bounds(total_steps, cfg["segment_steps"])
    microbatch = int(cfg["microbatch"])
    data_group = None if mesh is None else mesh.data_group
    tele = _tele.enabled()
    named = dict(model.named_parameters())
    _check_initial_params(named, params, kfold)
    momentum_bufs = [torch.empty_like(p) for p in named.values()]
    gens = ([torch.Generator(device=device) for _ in hashes]
            if cfg["dropout_rate"] > 0.0 else None)
    graph, skips = None, 0
    if _graph_eligible(device, mesh, kfold * total_steps):
        key = (_oom_cap_key(cfg), model.pop)
        if key not in _NO_GRAPH:
            if _graph_fits(cfg, model.pop, batch_idx.shape[2], device):
                graph = _StepGraph(device, batch_idx.shape[2], key)
            else:
                skips = 1

    def step(idx, lr, phases):
        # _train_step is looked up at each call: the capture takes whatever
        # step the module holds then.
        _train_step(model, masks, x_full, y_full, idx, gens, momentum_bufs, lr,
                    cfg["momentum"], cfg["nesterov"], microbatch, batch_rows, data_group, phases)

    accs = []
    for f in range(kfold):
        with _tele.span("fold_load", {"fold": f}):
            with torch.no_grad():
                for name, p in named.items():
                    p.copy_(params[name][f])
                for t in momentum_bufs:
                    t.zero_()
            if gens is not None:
                _seed_dropout_generators(gens, cfg["seed"], f, hashes, domain)
            bidx = torch.as_tensor(batch_idx[f], device=device)
        with exact_numerics():
            for s, e in bounds:
                phases = dict.fromkeys((*_PHASES, "replay"), 0.0) if tele else None
                graph_steps = captures = fallbacks = 0
                with _device_span("train", device,
                                  {"steps": e - s, "pop": model.pop, "fold": f}) as sp:
                    for t in range(s, e):
                        if graph is None or graph.failed:
                            step(bidx[t], lr_table[t], phases)
                        elif graph.graph is not None:
                            with _phase(phases, "replay"):
                                graph.replay(bidx[t], lr_table[t])
                            graph_steps += 1
                        elif graph.first_step(step, bidx[t], lr_table[t], phases, gens):
                            captures += 1
                        else:
                            fallbacks += 1
                    if phases is not None:
                        sp.set(**{f"{k}_s": v for k, v in phases.items()},
                               graph_steps=graph_steps, captures=captures, fallbacks=fallbacks,
                               graph_skips=skips)
                skips = 0  # the skip belongs to the call's first segment
            with _device_span("eval", device, {"pop": model.pop, "fold": f}):
                vi = torch.as_tensor(val_idx[f], device=device)
                vw = torch.as_tensor(val_weight[f], device=device)
                accs.append(_eval_fold(model, masks, x_full, y_full, vi, vw, eval_batch_size,
                                       mesh))
        if f == 0 and warm_keys is not None:
            _warm_bank_deposit(model, warm_keys)
    with _tele.span("fetch"):
        out = torch.stack(accs).cpu()
        if mesh is not None:
            return multihost.fetch(out, ranks=mesh.row_leaders, dim=1).astype(np.float32)
        return out.numpy().astype(np.float32)


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


#: Domain constants for stream separation, the reference's values:
#: _INIT_DOMAIN keeps parameter-init streams disjoint from dropout streams
#: under one seed; _HOLDOUT_DOMAIN keeps train_and_score's init and dropout
#: streams disjoint from CV fold 0's, so a holdout training under the
#: search's own seed never replicates the CV training it checks.
_INIT_DOMAIN = 0x1217
_HOLDOUT_DOMAIN = 0x5C04E

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


def _seed_dropout_generators(
    gens: Sequence[torch.Generator], seed: int, fold: int, hashes: np.ndarray, domain: int = 0
) -> None:
    """Seed one generator per genome slot, in place, from (seed, fold, hash),
    or from (seed, domain, fold, hash) for a separate stream domain."""
    head = (seed,) if not domain else (seed, domain)
    for g, (hi, lo) in zip(gens, hashes):
        g.manual_seed(_stream_seed(*head, fold, hi, lo))


def _dropout_generators(
    seed: int, fold: int, hashes: np.ndarray, device: torch.device, domain: int = 0
) -> List[torch.Generator]:
    """One device generator per genome slot, seeded as
    :func:`_seed_dropout_generators` seeds them."""
    gens = [torch.Generator(device=device) for _ in hashes]
    _seed_dropout_generators(gens, seed, fold, hashes, domain)
    return gens


#: flax ``lecun_normal``: the stddev of a standard normal truncated to
#: [-2, 2] is this, so samples are divided by it to reach 1/sqrt(fan_in).
_TRUNC_NORMAL_STD = 0.87962566103423978


#: A stream's weight elements (one genome's, one fold) from which the init
#: draw runs its streams on host threads (:func:`_draw_plan`).  Below it a
#: stream's ops are too short for threads to win back the interpreter lock
#: they pass around: on an H100's 8-core host (torch 2.11), 40 streams drew
#: 0.99× as fast on 8 threads as on one at 1.43 M weights a stream, 1.36× at
#: 2.16 M and 4.0× at config #5's 6.39 M; config #2's 0.32 M drew 0.37×.
_POOL_MIN_STREAM_ELEMENTS = 1_500_000

#: ``(pid, workers, pool)`` of the init draw's host threads, made on first
#: use and again in a forked child (which inherits no live threads) or when
#: the process's intra-op thread budget, which sets ``workers``, changed.
#: Concurrent callers share it; a task never submits to it, so a call never
#: waits on itself.
_DRAW_POOL: Optional[Tuple[int, int, ThreadPoolExecutor]] = None
_DRAW_POOL_LOCK = threading.Lock()


def _draw_plan(model: MaskedGeneticCnn, kfold: int, n: int) -> Tuple[int, int, int]:
    """``(streams, elements, threads)`` of a draw of ``kfold`` folds × ``n``
    genomes: its (fold, genome) streams, all their weight elements, and the
    host threads :func:`_init_population_params` draws them on,
    ``min(streams, torch.get_num_threads())`` once a stream holds
    ``_POOL_MIN_STREAM_ELEMENTS``, else 1 (the calling thread)."""
    per_stream = sum(p[0].numel() for name, p in model.named_parameters()
                     if name.endswith(".weight"))
    streams = kfold * n
    threads = 1
    if per_stream >= _POOL_MIN_STREAM_ELEMENTS:
        threads = max(1, min(streams, torch.get_num_threads()))
    return streams, streams * per_stream, threads


def _draw_worker_init() -> None:
    """Run a pool thread's torch ops on that thread alone, so the pool's
    workers together stay within the process's intra-op budget: each sets
    its own OpenMP team to 1 (a per-thread setting; ``torch.set_num_threads``
    would also change the process's).  torch's per-thread init runs first,
    since it would set the team back.  Where the process has no OpenMP
    runtime, the thread keeps its default; the bits are the same either way."""
    torch.get_num_threads()
    set_team = getattr(ctypes.CDLL(None), "omp_set_num_threads", None)
    if set_team is not None:
        set_team(1)


def _draw_pool() -> ThreadPoolExecutor:
    """The pool, with one worker for each of the process's intra-op threads."""
    global _DRAW_POOL
    key = (os.getpid(), torch.get_num_threads())
    with _DRAW_POOL_LOCK:
        if _DRAW_POOL is None or _DRAW_POOL[:2] != key:
            if _DRAW_POOL is not None and _DRAW_POOL[0] == key[0]:
                _DRAW_POOL[2].shutdown(wait=False)
            _DRAW_POOL = (*key, ThreadPoolExecutor(key[1], thread_name_prefix="gentun-init-draw",
                                                   initializer=_draw_worker_init))
        return _DRAW_POOL[2]


def _draw_stream(out: Dict[str, torch.Tensor], weights: Sequence[str], f: int, i: int,
                 stream_seed: int) -> None:
    """Fill slot ``i`` of fold ``f`` of every weight in ``weights``, in that
    order, from one CPU generator seeded with ``stream_seed``."""
    g = torch.Generator()
    g.manual_seed(stream_seed)
    for name in weights:
        w = out[name][f, i]
        # conv (F, C, 3, 3): fan_in = C·9; dense (D_in, D_out): fan_in = D_in
        fan_in = w.shape[-3] * 9 if w.dim() == 4 else w.shape[0]
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
        w.mul_(float(np.sqrt(1.0 / fan_in)) / _TRUNC_NORMAL_STD)


def _init_population_params(
    model: MaskedGeneticCnn, kfold: int, seed: int, genome_hashes: np.ndarray, domain: int = 0
) -> Dict[str, torch.Tensor]:
    """Per-(fold, genome) initial params on the CPU, each ``(kfold, n, *slot_shape)``
    for the ``n`` genomes of ``genome_hashes`` and the model's per-slot shapes.

    flax's ``lecun_normal`` for every weight (truncated normal on [-2, 2]
    with stddev ``1/sqrt(fan_in)``) and zero biases; torch's default init is
    not used.  Each (fold, genome) draws from its own CPU generator seeded
    from ``(seed, _INIT_DOMAIN, domain, fold, hash hi, hash lo)``, so a genome
    starts from the same weights whatever its slot, batch or device.  The
    streams write disjoint slices, so where :func:`_draw_plan` says so
    they run as tasks on a pool of host threads, with the same bits.
    """
    named = dict(model.named_parameters())
    n = len(genome_hashes)
    weights = [name for name in named if name.endswith(".weight")]
    # every weight element is drawn over, so only the biases start zeroed
    out = {
        name: (torch.empty if name in weights else torch.zeros)(
            (kfold, n, *p.shape[1:]), dtype=torch.float32)
        for name, p in named.items()
    }
    streams = [(f, i, _stream_seed(seed, _INIT_DOMAIN, domain, f, hi, lo))
               for f in range(kfold) for i, (hi, lo) in enumerate(genome_hashes)]
    if _draw_plan(model, kfold, n)[2] == 1:
        for stream in streams:
            _draw_stream(out, weights, *stream)
        return out
    pool = _draw_pool()
    tasks = [pool.submit(_draw_stream, out, weights, *stream) for stream in streams]
    wait(tasks)
    for task in tasks:
        task.result()
    return out


#: Parent→child weight bank for multi-fidelity warm starts (the
#: ``warm_start`` knob), as in the reference.  Keyed by the 64-bit genome
#: content hash (both ``_genome_hashes`` words), so a promoted genome finds
#: exactly ITS lower-rung parameters, whatever its batch or slot.  Values
#: are ``{param name: (slot_shape) float32 numpy}``, the trained fold-0
#: params, insertion-ordered for LRU eviction.  Process-local by design: a
#: promotion that lands elsewhere cold-starts, which is always correct.
_WARM_BANK: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
_WARM_BANK_CAP = 64
#: Guards every read-modify-write of the bank: promotions deposit and
#: overlay from several evaluation threads at once.  Never held across a
#: device call: the host copy is taken before it, the tensor writes after.
_WARM_BANK_LOCK = threading.Lock()


def _warm_bank_deposit(model: MaskedGeneticCnn, hashes: np.ndarray) -> None:
    """Bank slot ``i``'s trained params under ``hashes[i]``, for each row of
    ``hashes`` (the real genomes, slots ``0..len-1``)."""
    host = {name: p.detach().cpu().numpy() for name, p in model.named_parameters()}
    entries = [((int(hi), int(lo)), {name: leaf[i].copy() for name, leaf in host.items()})
               for i, (hi, lo) in enumerate(hashes)]
    with _WARM_BANK_LOCK:
        for key, entry in entries:
            _WARM_BANK.pop(key, None)
            _WARM_BANK[key] = entry
        while len(_WARM_BANK) > _WARM_BANK_CAP:
            del _WARM_BANK[next(iter(_WARM_BANK))]


def _warm_start_overlay(
    params: Dict[str, torch.Tensor], hashes: np.ndarray
) -> Tuple[Dict[str, torch.Tensor], int]:
    """Overlay banked lower-rung params onto fresh inits, where shapes match.

    ``params`` leaves are ``(kfold, P, ...)`` CPU tensors, changed in place:
    a banked genome's params go into its slot across the WHOLE fold axis
    (each fold still has its own batches and dropout stream).  A bank entry
    of another layer set is skipped; a leaf whose shape or dtype disagrees
    keeps its fresh init.  Returns (params, slots_warmed).
    """
    keys = [(int(hi), int(lo)) for hi, lo in hashes]
    with _WARM_BANK_LOCK:  # a deposit replaces an entry whole, never edits one
        found = {}
        for key in keys:
            banked = _WARM_BANK.get(key)
            if banked is not None:
                _WARM_BANK[key] = _WARM_BANK.pop(key)  # LRU touch
                found[key] = banked
    warmed = 0
    for i, key in enumerate(keys):
        banked = found.get(key)
        if banked is None or set(banked) != set(params):
            continue
        hit = False
        for name, leaf in params.items():
            src = torch.from_numpy(banked[name])
            if tuple(src.shape) == tuple(leaf.shape[2:]) and src.dtype == leaf.dtype:
                leaf[:, i] = src
                hit = True
        if hit:
            warmed += 1
            _lineage.record("warm_started", "bank:%x:%x" % key, slot=i)
    return params, warmed


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

#: (id(x_key), id(y_key), fingerprints, seed, n_use, input_shape, device) →
#: (weakref(x_key), weakref(y_key), x_dev, y_dev).  Kept tiny; entries are
#: validated by object identity through the weakrefs, so a recycled id can
#: never alias, and by a strided content fingerprint, so in-place mutation
#: is detected instead of silently training on stale device data.
_DATASET_CACHE: Dict[Tuple, Tuple[Any, Any, Any, Any]] = {}
#: Guards the cache's read-modify-writes (evaluation threads look it up at
#: once).  The upload runs outside it, so two threads that miss at first
#: use may both upload: each trains on its own copy of the same bits, the
#: later insert replaces the earlier, and the extra copy is freed when its
#: evaluation ends.
_DATASET_LOCK = threading.Lock()


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
    On a mesh every rank holds the whole dataset (the data axis splits the
    batches' indices, not the rows): each rank uploads it once to its own
    card, the device in the key.
    """
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
    with _DATASET_LOCK:
        for k in [k for k, (xr, yr, *_dv) in _DATASET_CACHE.items()
                  if xr() is None or yr() is None]:
            del _DATASET_CACHE[k]
        hit = _DATASET_CACHE.get(key)
        if hit is not None:
            xref, yref, xd, yd = hit
            if xref() is key_x and yref() is key_y:
                _DATASET_CACHE[key] = _DATASET_CACHE.pop(key)  # LRU: refresh recency
                return xd, yd
        # Same arrays, different fingerprint ⇒ mutated in place: drop the
        # stale entries now instead of pinning device copies until LRU
        # catches up.
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
    with _DATASET_LOCK:
        _DATASET_CACHE.pop(key, None)  # another thread's upload of the same data
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
#: Guards the cap's read-modify-write: two evaluation threads may run out of
#: memory at once, and the smaller cap either learns is the one kept.
_POP_CAP_LOCK = threading.Lock()


def _learn_pop_cap(cap_key, cap: int) -> None:
    with _POP_CAP_LOCK:
        _POP_PROGRAM_CAP[cap_key] = min(cap, _POP_PROGRAM_CAP.get(cap_key, cap))


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
        cfg["segment_steps"],
        int(cfg["kfold"]) if cfg.get("kfold") else None,
        int(cfg.get("microbatch", 1) or 1),
    )


def _chunked_by_cap(run, genomes, cap_key, run_exact=None, release_graphs=True):
    """Run the batched evaluator, splitting the population on device OOM.

    An OOM while some thread holds the pool of its last train-step graph
    (``_release_step_graphs``) first frees those pools and runs the same
    population again: the memory they held may be what ran out.  On a
    further ``torch.cuda.OutOfMemoryError`` the population is split to a
    power-of-two chunk (so chunks reuse the standard bucket shapes) and the
    cap is REMEMBERED for this config, so later generations pre-chunk.  A
    singleton that still does not fit in its padded 2-wide program retries
    through ``run_exact`` (unpadded); once cap=1 is learned every evaluation
    of that config runs 1-wide.  None of this moves a fitness: a slot's
    arithmetic is the same at any width, padded or not.
    """
    cap = _POP_PROGRAM_CAP.get(cap_key)
    if cap is not None and len(genomes) > cap:
        return np.concatenate(
            [_chunked_by_cap(run, genomes[i : i + cap], cap_key, run_exact)
             for i in range(0, len(genomes), cap)]
        )
    if cap == 1 and len(genomes) == 1 and run_exact is not None:
        return run_exact(genomes)
    fallback = again = None
    try:
        return run(genomes)
    except torch.cuda.OutOfMemoryError:
        if release_graphs and _release_step_graphs():
            again = True
        elif len(genomes) <= 1:
            if run_exact is None:
                raise
            _learn_pop_cap(cap_key, 1)
            logger.warning(
                "singleton population batch exhausted device memory in its "
                "padded (2-wide) program; retrying exact-size (1-wide, unpadded)",
            )
            fallback = run_exact
        else:
            half = max(1, len(genomes) // 2)
            b = 1
            while b * 2 <= half:
                b *= 2
            _learn_pop_cap(cap_key, b)
            logger.warning(
                "population batch of %d genomes exhausted device memory; "
                "chunking to <=%d genomes per program (remembered for this "
                "config in this process)", len(genomes), b,
            )
    # Retry OUTSIDE the except block, deliberately: the exception's
    # traceback pins the frames (and so the device tensors) of the failed
    # attempt.  Leaving the handler drops it; collect and hand the cached
    # blocks back before the smaller chunks run.  With other threads
    # evaluating, their live tensors stay where they are (``empty_cache``
    # frees only unused cached blocks), so the cap learned beside them is
    # the conservative one.
    gc.collect()
    _empty_cache()
    if again:
        return _chunked_by_cap(run, genomes, cap_key, run_exact, release_graphs=False)
    if fallback is not None:
        return fallback(genomes)
    return _chunked_by_cap(run, genomes, cap_key, run_exact)


def _mesh_devices(spec) -> int:
    """Cards an evaluation of mesh ``spec`` spreads over: a :class:`Mesh`'s
    ranks, else the world's (1 for one process)."""
    if isinstance(spec, Mesh):
        return spec.shape["pop"] * spec.shape["data"]
    return multihost.process_count()


def _genome_size_class(cfg: Dict[str, Any]) -> Tuple[str, int]:
    """(size_class, microbatch) for this config against its device budget.

    No budget configured → the wide-pop path.  The cost model is classified
    for the cards the evaluation spreads over: one process classifies for
    one card, where ``big`` cannot occur.
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
    return classify_genome_cost(
        cost, int(cfg["batch_size"]), _mesh_devices(cfg["mesh"]), int(budget))


def _account_sharded_batch(cfg: Dict[str, Any], mesh: Optional[Mesh], batch_size: int,
                           steps: int) -> None:
    """Fit the microbatch factor to the ACTUAL step batch and account waste.

    - ``cfg['microbatch']`` is clamped to the batch and bumped to the next
      divisor, so the accumulation split is always exact;
    - ``microbatch_steps_total`` counts the micro-gradient passes this
      evaluation will run (train steps × factor) when accumulation is on;
    - ``eval_data_pad_waste_total`` counts the batch slots a data axis
      that does not divide the batch leaves idle per step (the shares then
      differ by one row), summed over the evaluation's steps.
    """
    micro = int(cfg.get("microbatch", 1) or 1)
    if micro > 1:
        micro = min(micro, batch_size)
        while batch_size % micro:
            micro += 1
        cfg["microbatch"] = micro
        _get_registry().counter("microbatch_steps_total").inc(steps * micro)
    _, data_ax = mesh_axis_sizes(mesh)
    shard_rem = batch_size % data_ax
    if shard_rem:
        _get_registry().counter("eval_data_pad_waste_total").inc((data_ax - shard_rem) * steps)


def _record_cost_calibration(
    cfg: Dict[str, Any], params: Mapping[str, torch.Tensor], n_slots: int, device: torch.device
) -> None:
    """Record the cost model's prediction beside what this call built, as
    ``genome_cost_calibration{size_class,source}`` gauges:

    - ``predicted_param_bytes`` and ``predicted_act_bytes_batch``: the cost
      model's claim (params ×3 in float32; one full batch of activations in
      the compute dtype);
    - ``measured_param_bytes``: the bytes of the freshly drawn initial
      params ×3 (params, momentum, grads: the model's convention), over the
      ``(kfold, P)`` slots they stack;
    - ``device_bytes_in_use``: the CUDA allocator's bytes in use
      (``torch.cuda.memory_stats``); absent on the CPU.

    Diagnostics only: a failure here is logged and never stops an evaluation.
    """
    try:
        size_class, _ = _genome_size_class(cfg)
        cost = cnn_genome_cost(
            cfg["nodes"],
            cfg["kernels_per_layer"],
            cfg["input_shape"],
            cfg["dense_units"],
            cfg["n_classes"],
            cfg["compute_dtype"],
            bool(cfg["stage_exit_conv"]),
        )
        reg = _get_registry()

        def gauge(source: str, value: float) -> None:
            reg.gauge("genome_cost_calibration", size_class=size_class, source=source).set(
                float(value))

        gauge("predicted_param_bytes", cost.param_bytes)
        gauge("predicted_act_bytes_batch", cost.act_bytes_per_example * int(cfg["batch_size"]))
        leaf_bytes = sum(t.numel() * t.element_size() for t in params.values())
        gauge("measured_param_bytes", 3 * leaf_bytes / max(1, n_slots))
        if device.type == "cuda":
            stats = torch.cuda.memory_stats(device)
            gauge("device_bytes_in_use", stats["allocated_bytes.all.current"])
    except Exception:  # noqa: BLE001 - diagnostics must never stop an evaluation
        logger.debug("cost calibration skipped", exc_info=True)


def _resolve_device(mesh) -> torch.device:
    """The device an evaluation runs on.

    ``"auto"`` (the default) and ``None`` mean the CUDA device (a rank's own
    card) and raise when there is none: the port never falls back to the
    CPU by itself.  ``"cpu"``, another device string, or a ``torch.device``
    name the device explicitly; a :class:`Mesh` names its own.
    """
    if isinstance(mesh, Mesh):
        device = torch.device(mesh.device)
    elif mesh is None or mesh == "auto":
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


def _runs_over_ranks(spec) -> bool:
    """Does an evaluation of mesh ``spec`` run as the ranks of a mesh?"""
    return isinstance(spec, Mesh) or multihost.process_count() > 1


#: Mesh shape of the previous evaluation in this process, for the
#: ``mesh_reshapes_total`` counter: each change is a new layout, and size
#: classes interleaved carelessly show up as churn.
_LAST_MESH_SHAPE: Optional[Tuple[int, int]] = None


def _prepare_population_setup(cfg: Dict[str, Any], genomes: Sequence[Mapping[str, Any]]):
    """Point the kernel build at ``cache_dir``, resolve the device and the
    mesh, pad the population to its bucket and to the pop axis, stack the
    genome masks (host arrays, all slots) and build the module for this
    rank's slots.

    Returns ``(device, mesh, genomes, n_real, masks, model, hashes)``; the
    padded ``genomes``, ``masks`` and ``hashes`` cover every slot, the
    module one pop row's.  Records the ``mesh_pop_axis``/``mesh_data_axis``
    gauges, ``mesh_reshapes_total`` and ``eval_pad_waste_total``.
    """
    global _LAST_MESH_SHAPE
    cache_dir = cfg["cache_dir"]
    enable_compilation_cache(default_cache_dir() if cache_dir is None else cache_dir)
    run_publish_hooks()
    device = _resolve_device(cfg["mesh"])
    # A Mesh is taken as given; otherwise, in a world of several ranks, the
    # mesh over them derives from the BUCKETED size (so small batches that
    # pad to one shape share one factoring), on each rank's device.
    target = pop_bucket(len(genomes)) if cfg["pop_padding"] else len(genomes)
    mesh = cfg["mesh"] if isinstance(cfg["mesh"], Mesh) else auto_mesh(
        pop_size=target, size_class=_genome_size_class(cfg)[0], device=device)
    multiple = mesh.shape["pop"] if mesh is not None else 1
    if cfg["pop_padding"]:
        if target % multiple:  # the mesh's multiple on top of the bucket
            target += multiple - target % multiple
        genomes, n_real = pad_population(genomes, target)
    else:
        genomes, n_real = pad_population(genomes, multiple)
    reg = _get_registry()
    pop_ax, data_ax = mesh_axis_sizes(mesh)
    reg.gauge("mesh_pop_axis").set(pop_ax)
    reg.gauge("mesh_data_axis").set(data_ax)
    if _LAST_MESH_SHAPE is not None and (pop_ax, data_ax) != _LAST_MESH_SHAPE:
        reg.counter("mesh_reshapes_total").inc()
    _LAST_MESH_SHAPE = (pop_ax, data_ax)
    if len(genomes) > n_real:
        reg.counter("eval_pad_waste_total").inc(len(genomes) - n_real)
    masks = stack_genome_masks(genomes, cfg["nodes"])
    model = MaskedGeneticCnn(
        nodes=cfg["nodes"],
        filters=cfg["kernels_per_layer"],
        pop=len(genomes) // multiple,
        input_shape=cfg["input_shape"],
        dense_units=cfg["dense_units"],
        n_classes=cfg["n_classes"],
        dropout_rate=cfg["dropout_rate"],
        compute_dtype=cfg["compute_dtype"],
        stage_exit_conv=bool(cfg["stage_exit_conv"]),
        device=device,
    )
    return device, mesh, genomes, n_real, masks, model, _genome_hashes(genomes)


def _cv_indices(cfg: Dict[str, Any], n: int):
    """The host side of a CV call over ``n`` rows: ``(perm, batch_idx,
    val_idx, val_weight, steps_per_epoch, eval_batch_size)``.

    The host-side numpy RNG draws exactly as the reference draws it: the
    same seed gives the same fold permutation and the same batch orders.
    ``batch_idx`` is ``(kfold, steps, batch)`` and the validation arrays
    ``(kfold, n_val_padded)``, padded rows weighted 0.
    """
    kfold = cfg["kfold"]
    if kfold < 2:
        raise ValueError("kfold must be >= 2")
    fold_size = n // kfold
    if fold_size == 0:
        raise ValueError(f"kfold={kfold} exceeds dataset size {n}")
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
    return perm, batch_idx, val_idx, val_weight, steps_per_epoch, eval_bs


def _local_share(mesh: Optional[Mesh], masks, hashes: np.ndarray, batch_idx: np.ndarray,
                 microbatch: int, device: torch.device):
    """This rank's masks (on ``device``), slot hashes, batch rows and
    ``batch_rows`` (``shard_cv_args``); everything whole on one process."""
    batch_rows = None
    if mesh is not None:
        _, masks, hashes, batch_idx, batch_rows = shard_cv_args(
            mesh, None, masks, hashes, batch_idx, microbatch)
    return [multihost.place_tree(stage, device) for stage in masks], hashes, batch_idx, batch_rows


def _one_genome_per_call(run_one, genomes, config: Dict[str, Any], micro: int) -> np.ndarray:
    """The big-genome route: the cost model says one program cannot hold
    the population, so each genome runs alone, unpadded (the 1-wide program
    is the intended shape here, not an OOM fallback), with the size class's
    microbatch factor.  No ``_chunked_by_cap``: it splits populations, and
    this program is already one genome wide."""
    sub = {**config, "pop_padding": False, "microbatch": micro}
    outs = [run_one([g], **sub) for g in genomes]
    return np.concatenate(outs) if outs else np.zeros((0,), dtype=np.float32)


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
      runs there.  In a ``torch.distributed`` world of several ranks
      (``parallel.multihost.initialize``) every rank makes the same call and
      the evaluation runs over a ``(pop, data)`` mesh of the ranks
      (``parallel.mesh.auto_mesh``, honouring the ``--mesh`` override), each
      rank on its card (or on the named device); a ``Mesh`` pins the
      layout.  Every rank returns every fitness.
    - ``segment_steps``: the length of one segment of the host loop (the
      unit a telemetry ``train`` span covers); validated as in the reference.
    - ``cache_dir``: the directory the conv kernels' library is built into
      and loaded from (``utils/kernel_cache.py``); ``None`` means
      ``build/kernels/`` of the checkout.
    - ``fold_parallel``: accepted for the reference's API; the folds run one
      after another as without it, and a fitness is the same bits either
      way (``PERF.md`` records why the port has no fused-folds executor).
    - ``warm_start``: the reference's process-local warm-start bank; off
      with ``fold_parallel``, as in the reference.  Accepted here by the
      one-genome constructor too (the reference's takes it only in
      ``cross_validate_population``), so a species evaluated one
      individual at a time, as ``AsyncEvolution`` evaluates, can use it.
    - ``device_budget``: bytes one card may spend on one genome.  A config
      over it runs one genome per call: ``big`` spreads the batch over every
      rank of a ``(1, world)`` mesh, ``micro`` adds the smallest
      gradient-accumulation factor that fits (on one card ``big`` cannot
      occur); one whose parameter state and one example exceed it raises
      ``ValueError``.

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
        warm_start: bool = False,
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
            warm_start=bool(warm_start),
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
        (``_chunked_by_cap``), in one process only: over a mesh a CUDA OOM
        raises, since one rank's chunking would part it from the others'
        collectives.
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
        size_class, micro = _genome_size_class(cfg0)
        if size_class != SIZE_SMALL:
            return _one_genome_per_call(
                lambda gs, **sub: cls._cross_validate_population_one(x_train, y_train, gs, **sub),
                genomes, config, micro,
            )
        if _runs_over_ranks(cfg0["mesh"]):
            return cls._cross_validate_population_one(x_train, y_train, genomes, **config)
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
        """One program's CV call; with telemetry on, a ``cv_call`` span
        (``pop``, ``n_real``, ``kfold`` and, on a CUDA device, the
        allocator's ``reserved_bytes`` at the call's end, graph pools
        included) over its ``setup``, ``init_draw`` (``streams``,
        ``elements``, ``draw_threads``: :func:`_draw_plan`) and ``upload``
        spans and ``_run_segmented``'s."""
        with _tele.span("cv_call") as call:
            with _tele.span("setup"):
                cfg = _normalize_config(x_train, y_train, config)
                x, y = _prepare_data(x_train, y_train, cfg)
                if len(genomes) == 0:
                    return np.zeros((0,), dtype=np.float32)
                device, mesh, genomes, n_real, masks, model, hashes = _prepare_population_setup(
                    cfg, genomes)

                kfold = cfg["kfold"]
                perm, batch_idx, val_idx, val_weight, steps_per_epoch, eval_bs = _cv_indices(
                    cfg, x.shape[0])
                _account_sharded_batch(cfg, mesh, batch_idx.shape[2], batch_idx.shape[1] * kfold)

                masks, local, batch_idx, batch_rows = _local_share(
                    mesh, masks, hashes, batch_idx, cfg["microbatch"], device)
            call.set(pop=len(genomes), n_real=n_real, kfold=kfold)
            with _tele.span("init_draw") as draw:
                streams, elements, threads = _draw_plan(model, kfold, len(local))
                draw.set(streams=streams, elements=elements, draw_threads=threads)
                params = _init_population_params(model, kfold, cfg["seed"], local)
            _record_cost_calibration(cfg, params, kfold * len(local), device)
            with _tele.span("upload"):
                x_dev, y_dev = _device_dataset(x_train, y_train, x, y, perm, cfg, device)
            # Parent→child weight inheritance (multi-fidelity ladder): overlay
            # each real slot's own lower-rung trained params where shapes match,
            # and bank fold 0's results for the next rung.  Off with
            # fold_parallel, as in the reference, whose fused executor has no
            # per-fold boundary, and on a mesh, where the bank is per process
            # (a cold start is always correct).
            warm = cfg["warm_start"] and not cfg["fold_parallel"] and mesh is None
            warm_keys = hashes[:n_real] if warm else None
            if warm_keys is not None:
                _, warmed = _warm_start_overlay(params, warm_keys)
                if warmed:
                    logger.debug("warm start: %d/%d slots inherited banked params", warmed,
                                 n_real)
            accs = _run_segmented(
                cfg, model, masks, params, local, x_dev, y_dev, val_idx, val_weight,
                batch_idx, steps_per_epoch, eval_bs, warm_keys=warm_keys, mesh=mesh,
                batch_rows=batch_rows,
            )
            if device.type == "cuda" and _tele.enabled():
                call.set(reserved_bytes=torch.cuda.memory_reserved(device))
            return accs.mean(axis=0)[:n_real]

    # -- final holdout evaluation (not part of the reference's API) --------

    @classmethod
    def train_and_score(
        cls,
        x_train,
        y_train,
        x_test,
        y_test,
        genomes: Sequence[Mapping[str, Any]],
        **config,
    ) -> np.ndarray:
        """Train each genome on all of ``x_train`` and score it on the held-out
        ``x_test``: P test accuracies, the paper-style final number (the search
        itself uses :meth:`cross_validate_population`).  ``fitness_reps`` and
        OOM chunking work as there."""
        reps_raw = config.get("fitness_reps", 1)
        reps = 1 if reps_raw is None else int(reps_raw)
        # reps < 1 falls through to _normalize_config, which raises.
        if reps > 1:
            inner = {**config, "fitness_reps": 1}
            base_seed = int(config.get("seed", 0) or 0)
            per_rep = [
                cls.train_and_score(
                    x_train, y_train, x_test, y_test, genomes,
                    **{**inner, "seed": base_seed + 7919 * r},
                )
                for r in range(reps)
            ]
            return np.mean(per_rep, axis=0, dtype=np.float64).astype(np.float32)
        cfg0 = _normalize_config(x_train, y_train, config)
        size_class, micro = _genome_size_class(cfg0)
        if size_class != SIZE_SMALL:
            return _one_genome_per_call(
                lambda gs, **sub: cls._train_and_score_one(
                    x_train, y_train, x_test, y_test, gs, **sub),
                genomes, config, micro,
            )
        if _runs_over_ranks(cfg0["mesh"]):
            return cls._train_and_score_one(x_train, y_train, x_test, y_test, genomes, **config)
        return _chunked_by_cap(
            lambda gs: cls._train_and_score_one(x_train, y_train, x_test, y_test, gs, **config),
            list(genomes),
            _oom_cap_key(cfg0),
            run_exact=lambda gs: cls._train_and_score_one(
                x_train, y_train, x_test, y_test, gs, **{**config, "pop_padding": False}
            ),
        )

    @classmethod
    def _train_and_score_one(
        cls,
        x_train,
        y_train,
        x_test,
        y_test,
        genomes: Sequence[Mapping[str, Any]],
        **config,
    ) -> np.ndarray:
        """The holdout as one "fold" of the segmented executor: its train
        rows are the whole train block and its validation rows the test block
        of one device-resident array (train first).  Init and dropout draw
        from the ``_HOLDOUT_DOMAIN`` streams, so a holdout training under the
        search's own seed never replicates CV fold 0's."""
        cfg = _normalize_config(x_train, y_train, config)
        x_tr, y_tr = _prepare_data(x_train, y_train, cfg)
        x_te, y_te = _prepare_data(x_test, y_test, cfg)
        if len(genomes) == 0:
            return np.zeros((0,), dtype=np.float32)
        device, mesh, genomes, n_real, masks, model, hashes = _prepare_population_setup(
            cfg, genomes)

        n_tr, n_te = x_tr.shape[0], x_te.shape[0]
        batch_size = min(cfg["batch_size"], n_tr)
        steps_per_epoch = max(n_tr // batch_size, 1)
        total_steps = sum(cfg["epochs"]) * steps_per_epoch
        eval_bs, n_val_padded = _eval_batch_size(batch_size, n_te)
        pad = n_val_padded - n_te
        _account_sharded_batch(cfg, mesh, batch_size, total_steps)

        # Host-side RNG exactly as the reference draws it.
        rng = np.random.default_rng(cfg["seed"])
        order = np.concatenate(
            [rng.permutation(n_tr) for _ in range(sum(cfg["epochs"]))]
        )[: total_steps * batch_size]
        batch_idx = order.astype(np.int64).reshape(1, total_steps, batch_size)
        val_idx = (n_tr + np.concatenate([np.arange(n_te), np.zeros(pad)])).astype(np.int64)[None]
        val_weight = np.concatenate([np.ones(n_te, np.float32), np.zeros(pad, np.float32)])[None]

        masks, local, batch_idx, batch_rows = _local_share(
            mesh, masks, hashes, batch_idx, cfg["microbatch"], device)
        params = _init_population_params(model, 1, cfg["seed"], local, domain=_HOLDOUT_DOMAIN)
        _record_cost_calibration(cfg, params, len(local), device)
        # The combined array is built per call: a holdout runs once per
        # search, so it is not cached.
        x_full = torch.from_numpy(np.concatenate([x_tr, x_te])).to(device)
        x_full = x_full.permute(0, 3, 1, 2).contiguous()
        y_full = torch.from_numpy(np.concatenate([y_tr, y_te]).astype(np.int64)).to(device)
        accs = _run_segmented(
            cfg, model, masks, params, local, x_full, y_full, val_idx, val_weight,
            batch_idx, steps_per_epoch, eval_bs, domain=_HOLDOUT_DOMAIN, mesh=mesh,
            batch_rows=batch_rows,
        )
        return accs[0][:n_real]


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
