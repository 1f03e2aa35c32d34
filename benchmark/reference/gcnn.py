"""Genetic-CNN fitness in plain PyTorch: one genome at a time, float32.

The network a genome decodes to (Xie & Yuille, arXiv:1703.01513): per stage
an entry Conv3×3+ReLU makes the stage's input node; each kept node is a
Conv3×3+ReLU over the sum of its sources (the input node for a node with no
source); the stage output is the sum of the nodes with no successor (the
input node when no node is kept), then a 2×2 max-pool.  Head: Dense+ReLU,
dropout, Dense to the logits.  Training: softmax cross-entropy over the
batch, SGD with momentum (``t ← m·t + g``, ``p ← p − lr·t``) at the staged
learning rate.  Fitness: the mean over k folds of the validation accuracy
(the first maximum of the logits).

Only the kept nodes are computed.  What the system derives inside its call
is worked out again here from the same inputs (the images, the labels, the
genome and the seed): the fold permutation and batch order (numpy's
``default_rng(seed)``: one permutation of the rows, then per fold one
permutation of the training rows an epoch); the initial weights (per fold a
CPU generator seeded from the seed and the genome's content hash, LeCun
normal truncated to two standard deviations, zero biases, drawn for every
layer of the stage supergraph in order); the dropout masks (per fold a
generator on the device, seeded from the seed, the fold and the hash, one
uniform draw of the batch's mask a step).

Precision: ``float32`` is IEEE float32 (TF32 off for convolutions and
matrix products).  ``float8``, the control one step of precision below the
bfloat16 the configuration states, rounds every tensor where a bfloat16
program computes in bfloat16 (images, conv and first dense weights, biases
and outputs, node and stage sums, the dropped-out activations) to e4m3, and
the gradient flowing back through each such point to e5m2, each tensor
scaled by its largest magnitude; the last dense layer and the loss stay
float32.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..genomes import INIT_DOMAIN, decode, genome_hash, stream_seed

#: The standard deviation of a standard normal truncated to [-2, 2]: draws
#: are divided by it to reach LeCun's 1/sqrt(fan_in).
TRUNC_NORMAL_STD = 0.87962566103423978


def cv_indices(seed: int, n: int, kfold: int, batch_size: int, epochs: Sequence[int]):
    """``(perm, batch_idx (kfold, steps, batch), val_idx (kfold, fold), steps_per_epoch)``;
    the rows of ``batch_idx`` and ``val_idx`` index ``x[perm]``."""
    fold = n // kfold
    n_use = fold * kfold
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)[:n_use]
    folds = np.arange(n_use).reshape(kfold, fold)
    n_tr = n_use - fold
    batch = min(batch_size, n_tr)
    per_epoch = max(n_tr // batch, 1)
    steps = sum(epochs) * per_epoch
    batch_idx = np.zeros((kfold, steps, batch), dtype=np.int64)
    for f in range(kfold):
        tr = np.concatenate([folds[g] for g in range(kfold) if g != f])
        order = np.concatenate([rng.permutation(n_tr) for _ in range(sum(epochs))])
        batch_idx[f] = tr[order[:steps * batch]].reshape(steps, batch)
    return perm, batch_idx, folds, per_epoch


def learning_rate(epochs: Sequence[int], rates: Sequence[float], per_epoch: int, step: int) -> float:
    """The staged rate at ``step``: each group's rate from its first step,
    as a product of float32 ratios."""
    v, mark = np.float32(rates[0]), 0
    for n_ep, prev, nxt in zip(epochs[:-1], rates[:-1], rates[1:]):
        mark += n_ep * per_epoch
        if step >= mark:
            v = np.float32(np.float32(nxt / prev) * v)
    return float(v)


class _Round(torch.autograd.Function):
    """Round to ``fwd`` going forward and the gradient to ``bwd`` coming back."""

    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        return fwd(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _scaled(dtype, largest: float):
    def q(t):
        amax = t.detach().abs().amax()
        scale = torch.where(amax > 0, amax / largest, torch.ones_like(amax))
        return (t / scale).to(dtype).to(t.dtype) * scale
    return q


def _rounding(precision: str):
    if precision == "float32":
        return lambda t: t
    if precision != "float8":
        raise ValueError(f"precision must be float32 or float8, got {precision!r}")
    fwd, bwd = _scaled(torch.float8_e4m3fn, 448.0), _scaled(torch.float8_e5m2, 57344.0)
    return lambda t: _Round.apply(t, fwd, bwd)


@contextlib.contextmanager
def ieee_float32():
    """TF32 off for cuDNN convolutions and cuBLAS products inside the block,
    and cuDNN left to pick its fastest float32 algorithm for each shape."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    cudnn.benchmark = True
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark = saved


class Reference:
    """The fitness of genomes under one configuration, data set and seed.

    ``config`` holds ``nodes``, ``kernels_per_layer``, ``input_shape``,
    ``dense_units``, ``n_classes``, ``kfold``, ``epochs``, ``learning_rate``,
    ``batch_size``, ``momentum``, ``dropout_rate``; ``seed`` is the seed the
    system's call was given.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, config: Mapping[str, Any], seed: int,
                 device, eval_rows: int = 2500):
        self.cfg, self.seed, self.device = config, int(seed), torch.device(device)
        self.eval_rows = eval_rows
        perm, self.batch_idx, self.val_idx, self.per_epoch = cv_indices(
            self.seed, len(x), int(config["kfold"]), int(config["batch_size"]),
            [int(e) for e in config["epochs"]])
        self.x = torch.from_numpy(np.ascontiguousarray(x[perm])).to(self.device)
        self.x = self.x.permute(0, 3, 1, 2).contiguous()
        self.y = torch.from_numpy(y[perm].astype(np.int64)).to(self.device)

    def _layer_shapes(self) -> List[tuple]:
        """(name, weight shape) of every layer of the supergraph, in order."""
        h, w, c = (int(d) for d in self.cfg["input_shape"])
        out = []
        for s, (k, f) in enumerate(zip(self.cfg["nodes"], self.cfg["kernels_per_layer"])):
            out.append((f"stage{s}_entry", (f, c, 3, 3)))
            out += [(f"stage{s}_node{j}", (f, f, 3, 3)) for j in range(k)]
            h, w, c = h // 2, w // 2, f
        units = int(self.cfg["dense_units"])
        return out + [("dense0", (c * h * w, units)), ("dense1", (units, int(self.cfg["n_classes"])))]

    def initial_params(self, fold: int, hashes) -> Dict[str, List[torch.Tensor]]:
        """``{layer: [weight, bias]}`` float32 on the device."""
        g = torch.Generator()
        g.manual_seed(stream_seed(self.seed, INIT_DOMAIN, 0, fold, *hashes))
        params = {}
        for name, shape in self._layer_shapes():
            w = torch.zeros(shape, dtype=torch.float32)
            fan_in = shape[1] * 9 if len(shape) == 4 else shape[0]
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
            w.mul_(float(np.sqrt(1.0 / fan_in)) / TRUNC_NORMAL_STD)
            params[name] = [w.to(self.device).requires_grad_(),
                            torch.zeros(shape[0] if len(shape) == 4 else shape[1],
                                        device=self.device, requires_grad=True)]
        return params

    def forward(self, params, stages, x, rnd, keep: torch.Tensor = None) -> torch.Tensor:
        """Logits ``(B, n_classes)`` float32; ``keep`` is the dropout mask."""
        h = rnd(x)
        for s, st in enumerate(stages):
            def conv(t, name):
                w, b = params[name]
                return rnd(F.conv2d(t, rnd(w), rnd(b), padding=1))

            a0 = torch.relu(conv(h, f"stage{s}_entry"))
            act = {}
            for j in range(st.k):
                if not st.active[j]:
                    continue
                srcs = ([a0] if st.entry[j] else []) + [act[i] for i in st.sources(j)]
                inp = srcs[0] if len(srcs) == 1 else rnd(sum(srcs[1:], srcs[0]))
                act[j] = torch.relu(conv(inp, f"stage{s}_node{j}"))
            outs = [act[j] for j in range(st.k) if st.exit[j]]
            z = (outs[0] if len(outs) == 1 else rnd(sum(outs[1:], outs[0]))) if outs else a0
            h = F.max_pool2d(z, 2)
        w0, b0 = params["dense0"]
        d = torch.relu(rnd(h.reshape(h.shape[0], -1) @ rnd(w0) + rnd(b0)))
        if keep is not None:
            kp = 1.0 - float(self.cfg["dropout_rate"])
            d = rnd(torch.where(keep, d / kp, torch.zeros((), device=d.device)))
        w1, b1 = params["dense1"]
        return d @ w1 + b1

    def fitness(self, genome: Mapping[str, Sequence[int]], precision: str = "float32") -> float:
        """The genome's mean validation accuracy over the folds (float32)."""
        cfg, rnd = self.cfg, _rounding(precision)
        stages = decode(genome, cfg["nodes"])
        hashes = genome_hash(genome)
        rate, m = float(cfg["dropout_rate"]), float(cfg["momentum"])
        units = int(cfg["dense_units"])
        accs = []
        with ieee_float32():
            for f in range(int(cfg["kfold"])):
                params = self.initial_params(f, hashes)
                used = [f"stage{s}_entry" for s in range(len(stages))] + [
                    f"stage{s}_node{j}" for s, st in enumerate(stages)
                    for j in range(st.k) if st.active[j]] + ["dense0", "dense1"]
                leaves = [t for name in used for t in params[name]]
                moms = [torch.zeros_like(t) for t in leaves]
                gen = torch.Generator(device=self.device)
                gen.manual_seed(stream_seed(self.seed, f, *hashes))
                for step, rows in enumerate(self.batch_idx[f]):
                    idx = torch.from_numpy(rows).to(self.device)
                    keep = None
                    if rate > 0.0:
                        u = torch.rand((len(rows), units), generator=gen, device=self.device)
                        keep = u < 1.0 - rate
                    logits = self.forward(params, stages, self.x[idx], rnd, keep)
                    loss = F.cross_entropy(logits, self.y[idx])
                    grads = torch.autograd.grad(loss, leaves)
                    lr = learning_rate(cfg["epochs"], cfg["learning_rate"], self.per_epoch, step)
                    with torch.no_grad():
                        for p, g, t in zip(leaves, grads, moms):
                            t.mul_(m).add_(g)
                            p.add_(t * -lr)
                accs.append(self._accuracy(params, stages, f, rnd))
        return float(np.mean(np.asarray(accs, dtype=np.float32), dtype=np.float32))

    @torch.no_grad()
    def _accuracy(self, params, stages, fold: int, rnd) -> np.float32:
        val = torch.from_numpy(self.val_idx[fold]).to(self.device)
        hits = 0
        for lo in range(0, len(val), self.eval_rows):
            rows = val[lo:lo + self.eval_rows]
            pred = self.forward(params, stages, self.x[rows], rnd).argmax(dim=-1)
            hits += int((pred == self.y[rows]).sum())
        return np.float32(hits) / np.float32(len(val))
