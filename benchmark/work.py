"""The work a call needs: operations and bytes, counted from the genomes.

What is counted is what each genome's decoded network needs, not what the
system executes: a node a genome leaves unconnected costs nothing, whatever
the supergraph runs for it, and only real validation rows are evaluated.

- **Convs** (3×3, SAME): the entry conv of every stage and the conv of every
  kept node.  Forward ``2·B·H·W·9·C·F`` operations; in training also the
  weight gradient (the same count) and the input gradient (the same count,
  except for stage 0's entry conv, whose input is the images).  Bytes: each
  input read once and each output written once, in the compute dtype
  (weights and bias included; stage 0's images are read once for the whole
  population).
- **Stage DAG** (the elementwise work between the convs): each kept node's
  input sum reads its sources (with ReLU on load) and writes the sum; the
  stage output reads its exit nodes (or the entry conv's output, for a stage
  with no kept node) and writes the 2×2-pooled output, in training also a
  one-byte window argmax.  Backward: each kept node's gradient and the entry
  conv's read the conv output (for ReLU's mask), the pooled gradient and
  argmax where they feed the stage output, each successor's input gradient,
  and write one gradient.  About two operations an element read.
- **Dense head**: ``2·in·out`` a row a layer; backward twice the forward.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Sequence

from .genomes import decode

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


@dataclass
class Work:
    """Operations and bytes of one kind of work, and its least time on the
    chip: each piece's ``max(ops / op peak, bytes / byte peak)``, summed."""

    ops: float = 0.0
    bytes: float = 0.0
    bound_s: float = 0.0

    def add(self, ops: float, nbytes: float, op_peak: float, byte_peak: float) -> None:
        self.ops += ops
        self.bytes += nbytes
        self.bound_s += max(ops / op_peak, nbytes / byte_peak)


@dataclass
class CallWork:
    """The needed work of one call, by kind and phase."""

    conv: Dict[str, Work] = field(default_factory=lambda: {"train": Work(), "eval": Work()})
    dag: Dict[str, Work] = field(default_factory=lambda: {"train": Work(), "eval": Work()})
    dense: Dict[str, Work] = field(default_factory=lambda: {"train": Work(), "eval": Work()})

    def flops(self, phase: str) -> float:
        """Matrix operations (convs and dense head) of a phase."""
        return self.conv[phase].ops + self.dense[phase].ops


def schedule(config: Mapping[str, Any]) -> Dict[str, int]:
    """Rows of one call per fold: train steps, batch and validation rows."""
    n, kfold, batch = int(config["n_train_images"]), int(config["kfold"]), int(config["batch_size"])
    fold = n // kfold
    n_tr = fold * kfold - fold
    batch = min(batch, n_tr)
    steps = sum(int(e) for e in config["epochs"]) * max(n_tr // batch, 1)
    return {"kfold": kfold, "steps": steps, "batch": batch, "val_rows": fold}


def call_work(config: Mapping[str, Any], genomes: Sequence[Mapping[str, Any]], peaks) -> CallWork:
    """The needed work of one ``cross_validate_population`` call of ``genomes``."""
    sch = schedule(config)
    es = _DTYPE_BYTES[config["compute_dtype"]]
    mm_peak = peaks.MATMUL_FLOPS[config["compute_dtype"]]
    ew_peak, hbm = peaks.VECTOR_FLOPS, peaks.HBM_BYTES_PER_S
    out = CallWork()
    kf = sch["kfold"]
    phases = {"train": (sch["batch"], sch["steps"] * kf), "eval": (sch["val_rows"], kf)}
    nodes, filters = config["nodes"], config["kernels_per_layer"]
    h0, w0, c0 = (int(d) for d in config["input_shape"])
    for phase, (rows, reps) in phases.items():
        train = phase == "train"
        # stage 0's images: read once a call for every genome, by the entry
        # conv's forward and (in training) its weight gradient
        out.conv[phase].add(0.0, (2 if train else 1) * reps * rows * h0 * w0 * c0 * es,
                            mm_peak, hbm)
        for genome in genomes:
            h, w, c = h0, w0, c0
            for s, st in enumerate(decode(genome, nodes)):
                f = int(filters[s])
                e = rows * f * h * w  # elements of one activation
                convs = [c] + [f] * sum(st.active)  # input channels of each needed conv
                for i, cin in enumerate(convs):
                    fl = 2.0 * rows * h * w * 9 * cin * f
                    wbytes = (f * cin * 9 + f) * es
                    images = s == 0 and i == 0
                    x_bytes = 0 if images else rows * cin * h * w * es
                    out.conv[phase].add(reps * fl, reps * (x_bytes + wbytes + e * es), mm_peak, hbm)
                    if train:  # weight gradient; input gradient past stage 0's images
                        out.conv[phase].add(reps * fl, reps * (x_bytes + e * es + wbytes),
                                            mm_peak, hbm)
                        if not images:
                            out.conv[phase].add(reps * fl, reps * (e * es + wbytes
                                                                   + rows * cin * h * w * es),
                                                mm_peak, hbm)
                ops, nbytes = _dag(st, e, es, train)
                out.dag[phase].add(reps * ops, reps * nbytes, ew_peak, hbm)
                h, w, c = h // 2, w // 2, f
            d_in, units, classes = c * h * w, int(config["dense_units"]), int(config["n_classes"])
            fl = 2.0 * rows * (d_in * units + units * classes)
            nbytes = (rows * (d_in + units) + d_in * units + units) * es + (
                rows * (units + classes) + units * classes + classes) * 4
            mult = 3 if train else 1
            out.dense[phase].add(reps * mult * fl, reps * mult * nbytes, mm_peak, hbm)
    return out


def _dag(st, e: int, es: int, train: bool):
    """Operations and bytes of one stage's DAG work for one genome, where one
    activation has ``e`` elements of ``es`` bytes."""
    reads = writes = 0.0  # in elements of the compute dtype
    argmax = 0.0  # one byte an element
    k, pooled = st.k, e / 4
    for j in range(k):
        if st.active[j]:
            reads += (int(st.entry[j]) + len(st.sources(j))) * e
            writes += e
    reads += (sum(st.exit) if st.has_active else 1) * e
    writes += pooled
    if train:
        argmax += pooled  # the stage output keeps its window argmax
        for i in range(k):
            if st.active[i]:
                reads += e + len(st.successors(i)) * e
                if st.exit[i]:
                    reads += pooled
                    argmax += pooled
                writes += e
        reads += e + sum(st.entry) * e  # the entry conv's gradient
        if not st.has_active:
            reads += pooled
            argmax += pooled
        writes += e
    return 2.0 * reads, (reads + writes) * es + argmax


def total(works: List[CallWork]) -> CallWork:
    out = CallWork()
    for w in works:
        for kind in ("conv", "dag", "dense"):
            for phase in ("train", "eval"):
                a, b = getattr(out, kind)[phase], getattr(w, kind)[phase]
                a.ops += b.ops
                a.bytes += b.bytes
                a.bound_s += b.bound_s
    return out
