"""Genetic-CNN DAG decoding: bit-strings → stage mask arrays.

Reference parity: gentun decodes each stage's bit-string into a Keras graph of
``Conv+ReLU`` nodes at model-build time (``gentun/models/keras_models.py``
[PUB]; SURVEY.md §2.3 "Encoding", §3.4).  The decode rules are the Xie &
Yuille (ICCV 2017) rules the reference implements:

- gene ``S_s`` has ``K_s * (K_s - 1) / 2`` bits, one per ordered node pair
  ``(i, j)`` with ``i < j``, grouped by target node: the first bit is edge
  1→2, the next two are 1→3 and 2→3, and so on;
- a node with neither in- nor out-edges is *isolated* and dropped entirely;
- every non-isolated node with no in-edges is fed by the stage's default
  input node;
- every non-isolated node with no out-edges feeds the stage's default
  output node;
- multi-input nodes element-wise **sum** their inputs.

TPU-first departure (the core architectural decision of this rebuild,
SURVEY.md §7 "hard parts" #1): instead of building a different program per
genome — which would pay an XLA compile per individual — the decode produces
fixed-shape **mask arrays** over a stage *supergraph* of all ``K_s`` nodes.
The masks are plain data: one jitted train step serves every genome in the
search space, and a population axis can be ``vmap``-ed over the masks so the
whole population trains as a single batched XLA program.

Everything in this module is pure numpy (no jax import): it runs on the host,
once per genome, and is trivially testable by exhaustive enumeration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = [
    "StageMasks",
    "triangular_index",
    "bits_to_adjacency",
    "adjacency_to_bits",
    "decode_stage",
    "decode_genome",
    "stack_genome_masks",
    "canonical_key",
]


def triangular_index(i: int, j: int) -> int:
    """Position of edge ``i → j`` (``i < j``) in the stage bit-string.

    Bits are grouped by target node j: edges into node j occupy positions
    ``j*(j-1)/2 ... j*(j-1)/2 + j - 1``, ordered by source i.  (Nodes are
    0-indexed here; the paper's node 1 is index 0.)
    """
    if not 0 <= i < j:
        raise ValueError(f"need 0 <= i < j, got ({i}, {j})")
    return j * (j - 1) // 2 + i


def bits_to_adjacency(bits: Sequence[int], k: int) -> np.ndarray:
    """Bit-string → strictly-upper-triangular adjacency matrix ``(k, k)``."""
    bits = np.asarray(bits, dtype=np.int64)
    expected = k * (k - 1) // 2
    if bits.shape != (expected,):
        raise ValueError(f"stage with {k} nodes needs {expected} bits, got {bits.shape}")
    adj = np.zeros((k, k), dtype=np.float32)
    for j in range(1, k):
        base = j * (j - 1) // 2
        adj[:j, j] = bits[base : base + j]
    return adj


def adjacency_to_bits(adj: np.ndarray) -> Tuple[int, ...]:
    """Inverse of :func:`bits_to_adjacency` (used by tests / canonicalization)."""
    k = adj.shape[0]
    out: List[int] = []
    for j in range(1, k):
        out.extend(int(adj[i, j]) for i in range(j))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class StageMasks:
    """Fixed-shape masks describing one stage's DAG on the node supergraph.

    Attributes (all float32, shapes fixed by the node count ``k`` alone):

    - ``adj``: ``(k, k)`` strictly upper triangular; ``adj[i, j] == 1`` ⇒
      node i's output is summed into node j's input.
    - ``active``: ``(k,)``; 0 for isolated (dropped) nodes.  An inactive
      node's output is forced to zero so it cannot leak into any sum.
    - ``entry``: ``(k,)``; 1 ⇒ the stage input feeds this node.
    - ``exit``: ``(k,)``; 1 ⇒ this node's output is summed into the stage
      output.
    - ``has_active``: scalar; 0 ⇒ the stage has no active nodes and the
      stage output is the *default input node* (in the consumer,
      ``models/cnn.py``, that is the stage-entry Conv+ReLU output — not the
      raw stage input); pooling still applies.
    """

    adj: np.ndarray
    active: np.ndarray
    entry: np.ndarray
    exit: np.ndarray
    has_active: np.ndarray

    @property
    def k(self) -> int:
        return int(self.adj.shape[0])


def decode_stage(bits: Sequence[int], k: int) -> StageMasks:
    """Apply the Xie & Yuille decode rules to one stage's bit-string."""
    adj = bits_to_adjacency(bits, k)
    in_deg = adj.sum(axis=0)
    out_deg = adj.sum(axis=1)
    isolated = (in_deg == 0) & (out_deg == 0)
    active = (~isolated).astype(np.float32)
    entry = ((in_deg == 0) & ~isolated).astype(np.float32)
    exit_ = ((out_deg == 0) & ~isolated).astype(np.float32)
    has_active = np.float32(1.0 if active.any() else 0.0)
    # Zero out edges touching inactive nodes (defensive: by construction an
    # edge implies both endpoints active, so this is a no-op; it guarantees
    # the invariant for hand-built adjacency matrices too).
    adj = adj * active[:, None] * active[None, :]
    return StageMasks(adj=adj, active=active, entry=entry, exit=exit_, has_active=has_active)


def decode_genome(
    genes: Mapping[str, Any],
    nodes: Sequence[int],
) -> List[StageMasks]:
    """Decode a full genome dict ``{"S_1": bits, ...}`` into per-stage masks.

    Gene naming matches :func:`gentun_tpu_torch.genes.genetic_cnn_genome`: stage
    ``s`` (1-based) has gene ``S_s`` with ``K_s(K_s-1)/2`` bits.
    """
    masks = []
    for s, k in enumerate(nodes):
        name = f"S_{s + 1}"
        if name not in genes:
            raise KeyError(f"genome missing gene {name!r} for stage {s + 1}")
        masks.append(decode_stage(genes[name], k))
    return masks


def stack_genome_masks(
    genomes: Sequence[Mapping[str, Any]],
    nodes: Sequence[int],
) -> List[Dict[str, np.ndarray]]:
    """Stack P genomes' masks along a leading population axis, per stage.

    Returns one dict per stage with keys ``adj (P,k,k)``, ``active (P,k)``,
    ``entry (P,k)``, ``exit (P,k)``, ``has_active (P,)`` — the exact pytree
    the population-batched (vmapped) train step consumes (``models/cnn.py``).
    """
    per_stage: List[Dict[str, np.ndarray]] = []
    decoded = [decode_genome(g, nodes) for g in genomes]
    for s in range(len(nodes)):
        stage = [d[s] for d in decoded]
        per_stage.append(
            {
                "adj": np.stack([m.adj for m in stage]),
                "active": np.stack([m.active for m in stage]),
                "entry": np.stack([m.entry for m in stage]),
                "exit": np.stack([m.exit for m in stage]),
                "has_active": np.stack([m.has_active for m in stage]),
            }
        )
    return per_stage


def _canonical_stage_bits(bits: Sequence[int], k: int, max_brute_k: int = 6) -> Tuple[int, ...]:
    """Lexicographically-smallest bit-string over DAG-preserving relabelings.

    Distinct bit-strings can decode to *architecturally identical* networks:
    every stage node is the same Conv+ReLU block, so any relabeling of nodes
    that keeps edges pointing from lower to higher index (a linear extension
    of the DAG) yields the same computation.  E.g. for k=3, the single-edge
    graphs 1→2 and 2→3 are both "a 2-node chain plus one isolated node".
    Canonicalising collapses these so the fitness cache / dedup layer never
    trains the same architecture twice (SURVEY.md §7 "hard parts" #1).

    Brute force over all k! permutations, keeping those that preserve
    upper-triangularity; fine for the reference's stage sizes (k ≤ 5 ⇒ ≤120
    permutations).  Stages larger than ``max_brute_k`` fall back to the raw
    bits (correct, just less dedup).
    """
    if k > max_brute_k:
        return tuple(int(b) for b in bits)
    import itertools

    adj = bits_to_adjacency(bits, k).astype(np.int64)
    best: Tuple[int, ...] | None = None
    for perm in itertools.permutations(range(k)):
        p = np.asarray(perm)
        relabeled = adj[np.ix_(p, p)]
        if np.any(np.tril(relabeled)):  # not a linear extension
            continue
        candidate = adjacency_to_bits(relabeled)
        if best is None or candidate < best:
            best = candidate
    assert best is not None  # identity permutation always qualifies
    return best


def canonical_key(genes: Mapping[str, Any], nodes: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """A hashable key identifying the *effective* architecture of a genome.

    Two genomes get the same key iff their decoded stages are identical up to
    the node relabelings of :func:`_canonical_stage_bits`.  Used for fitness
    caching across generations and population-level dedup.
    """
    out = []
    for s, k in enumerate(nodes):
        out.append(_canonical_stage_bits(genes[f"S_{s + 1}"], k))
    return tuple(out)
