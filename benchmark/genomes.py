"""Genomes and random streams, written out again for the benchmark.

- :func:`sample_genomes` draws a call's population from ``--seed`` and the
  call's index: Bernoulli(0.5) per bit, one gene ``S_s`` of ``k(k-1)/2``
  bits per stage, as a Genetic-CNN GA draws its first generation.
- :func:`decode` applies Xie & Yuille's rules (arXiv:1703.01513, §3.1) to a
  genome: bit ``j(j-1)/2 + i`` is the edge ``i → j``; a node with no edge is
  dropped; a kept node with no input reads the stage input; a kept node with
  no output feeds the stage output; inputs are summed.
- :func:`genome_hash` and :func:`stream_seed` are the arithmetic by which the
  system seeds its per-genome streams (a blake2b content hash; splitmix64
  chained over words), frozen here so that the plain reference can draw the
  same initial weights and dropout masks without importing the system.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

_MASK64 = (1 << 64) - 1


def seed_words(seed: int) -> Tuple[int, int]:
    """Any whole number as two unsigned 32-bit words (negative ones too)."""
    s = int(seed) & _MASK64
    return s >> 32, s & 0xFFFFFFFF


def rng_for(seed: int, *words: int) -> np.random.Generator:
    """A numpy generator for one purpose of one run: ``--seed`` plus words."""
    return np.random.default_rng([*seed_words(seed), *(int(w) & 0xFFFFFFFF for w in words)])


def sample_genomes(nodes: Sequence[int], pop: int, seed: int, call: int) -> List[Dict[str, tuple]]:
    """The ``pop`` genomes of call ``call`` (0 is the warm-up call)."""
    rng = rng_for(seed, 0x6E0, call)
    return [{f"S_{s + 1}": tuple(int(b) for b in rng.integers(0, 2, size=k * (k - 1) // 2))
             for s, k in enumerate(nodes)} for _ in range(pop)]


@dataclass(frozen=True)
class Stage:
    """One decoded stage: ``adj[i][j]`` is the edge ``i → j``; ``entry[j]``:
    node j reads the stage input; ``exit[j]``: node j feeds the stage
    output; ``active[j]``: node j is kept.  A stage with no kept node
    passes its input node (the entry conv's ReLU) to the pool."""

    adj: Tuple[Tuple[bool, ...], ...]
    active: Tuple[bool, ...]
    entry: Tuple[bool, ...]
    exit: Tuple[bool, ...]

    @property
    def k(self) -> int:
        return len(self.active)

    @property
    def has_active(self) -> bool:
        return any(self.active)

    def sources(self, j: int) -> List[int]:
        """The nodes whose outputs node ``j`` sums (the stage input not included)."""
        return [i for i in range(j) if self.adj[i][j]]

    def successors(self, i: int) -> List[int]:
        return [j for j in range(i + 1, self.k) if self.adj[i][j]]


def decode_stage(bits: Sequence[int], k: int) -> Stage:
    bits = [int(b) for b in bits]
    if len(bits) != k * (k - 1) // 2:
        raise ValueError(f"a stage of {k} nodes has {k * (k - 1) // 2} bits, got {len(bits)}")
    adj = [[False] * k for _ in range(k)]
    for j in range(1, k):
        for i in range(j):
            adj[i][j] = bool(bits[j * (j - 1) // 2 + i])
    has_in = [any(adj[i][j] for i in range(k)) for j in range(k)]
    has_out = [any(adj[i][j] for j in range(k)) for i in range(k)]
    active = [has_in[j] or has_out[j] for j in range(k)]
    return Stage(
        adj=tuple(tuple(r) for r in adj),
        active=tuple(active),
        entry=tuple(active[j] and not has_in[j] for j in range(k)),
        exit=tuple(active[j] and not has_out[j] for j in range(k)),
    )


def decode(genome: Mapping[str, Sequence[int]], nodes: Sequence[int]) -> List[Stage]:
    return [decode_stage(genome[f"S_{s + 1}"], k) for s, k in enumerate(nodes)]


def genome_hash(genome: Mapping[str, Sequence[int]]) -> Tuple[int, int]:
    """(hi, lo) 32-bit words of the genome's 64-bit content hash: blake2b
    over the sorted gene names, shapes and int64 bytes."""
    h = hashlib.blake2b(digest_size=8)
    for name in sorted(genome):
        arr = np.asarray(genome[name]).astype(np.int64)
        h.update(str(name).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    digest = int.from_bytes(h.digest(), "little")
    return digest >> 32, digest & 0xFFFFFFFF


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def stream_seed(*words: int) -> int:
    """A 64-bit generator seed from integers: splitmix64 chained over them."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h


#: The word that keeps the initial-weight streams apart from the dropout
#: streams under one seed.
INIT_DOMAIN = 0x1217
