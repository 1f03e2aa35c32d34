"""Surrogate rung −1: a ledger-trained fitness ranker that gates dispatch.

The port's copy of the JAX package's module (numpy only; the same
weights and decisions on the same samples).  Beyond the compute path,
the remaining wins are *search efficiency per chip-hour* — and the
lineage ledger plus the shared fitness service already accumulate exactly
a surrogate's training set: genome encoding → fitness at every rung,
across runs and tenants.  This module grafts a learned predictor UNDER
the ASHA ladder (Li et al. 2020) inside the aging-evolution engine
(Real et al. 2019) as **rung −1**: every bred child is scored on the
host in microseconds, and only the top ``1/eta`` fraction (by a
rolling-window quantile of recent scores) ever touches a device at
rung 0.  Rejected children cost one lineage event and a re-breed — no
dispatch, no chip-seconds.

Two classes, both dependency-free (numpy only, already a core dep):

- :class:`FitnessSurrogate` — a tiny ridge regressor over the fixed-width
  binary stage-DAG genome encoding plus a rung feature, fit closed-form
  (``w = solve(XᵀX + λI, Xᵀy)``), refit every ``refit_every``
  completions.  Below ``min_train`` samples it refuses to score
  (``score() → None``) — the minimum-training-set gate: an untrained
  surrogate must never veto a child.
- :class:`SurrogateGate` — the rung −1 admission policy around it:
  rolling-window quantile cut, pending-decision ledger (admitted score →
  realized fitness, resolved on completion into a precision@k telemetry
  gauge), a reject-streak cap so a badly-calibrated model can only stall
  breeding for ``max_reject_streak`` draws, and an optional dataset
  plane on the shared fitness service (warm-start + refit-boundary sync)
  with fail-open degradation: a gate whose training-set sync fails
  cannot trust its score distribution, so it degrades to **admit-all**
  (exactly ONE ``surrogate_degraded`` event per up→down transition) —
  admitting everything costs chip-time, never correctness.

Every existing invariant holds: the gate is off by default and
bit-identical when off (``AsyncEvolution`` reads one attribute per site);
``decide``/``score`` draw no randomness, so the
gated trajectory is a pure function of (seed, ledger state); the whole
gate — model weights, training samples, score window, pending
decisions — serializes into checkpoint schema v4 so kill/resume is
bit-identical; and the dataset space key is prefixed with the session
namespace, so one tenant's surrogate never trains on (or scores)
another tenant's genomes.  See DISTRIBUTED.md "Surrogate rung −1".
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
from bisect import bisect_left, insort
from collections import OrderedDict, deque
from operator import mul
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .telemetry import lineage as _lineage
from .telemetry import spans as _tele
from .telemetry.registry import get_registry as _get_registry

__all__ = ["FitnessSurrogate", "SurrogateGate", "encode_genes", "space_key"]

logger = logging.getLogger("gentun_tpu_torch")


def _feature(value: Any) -> List[float]:
    """One gene value → its feature columns, deterministically.

    Bit tuples (the Genetic-CNN stage-DAG encoding) flatten to one 0/1
    column per bit; numeric scalars pass through; anything else (e.g. a
    string choice) contributes a stable hashed column in ``[0, 1)`` so
    the encoding is total over every genome spec.
    """
    if isinstance(value, (list, tuple)):
        out: List[float] = []
        for v in value:
            out.extend(_feature(v))
        return out
    if isinstance(value, bool):
        return [1.0 if value else 0.0]
    if isinstance(value, (int, float)):
        return [float(value)]
    h = hashlib.blake2b(repr(value).encode(), digest_size=4).digest()
    return [int.from_bytes(h, "big") / 2**32]


def encode_genes(genes: Dict[str, Any], rung: int = 0) -> List[float]:
    """Genome → fixed-width feature vector: ``[bias, *bits..., rung]``.

    Gene names are sorted, so the width and column order depend only on
    the genome spec — every genome of one search space encodes to the
    same vector length, which is what lets one ridge model score the
    whole space.  On the score-on-breed hot path (one call per bred
    child, broker_throughput surrogate gate), so the common case — flat
    bit tuples — is inlined instead of recursing per bit.
    """
    x = [1.0]
    for name in sorted(genes):
        v = genes[name]
        if type(v) in (tuple, list):
            try:
                x.extend(map(float, v))
            except (TypeError, ValueError):
                x.extend(_feature(v))
        elif type(v) in (int, float):
            x.append(float(v))
        else:
            x.extend(_feature(v))
    x.append(float(rung))
    return x


def _pending_key(genes: Dict[str, Any]) -> Any:
    """Canonical hashable identity for the pending-decision map.

    Cheaper than :func:`~gentun_tpu_torch.telemetry.lineage.genome_key` (no
    JSON + hash round trip — ``decide`` runs once per bred child) while
    still surviving the checkpoint: tuples serialize as JSON lists and
    load back through ``tuplify``-style re-tuplification.
    """
    try:
        return tuple(
            (name, tuple(v) if type(v) in (tuple, list) else v)
            for name, v in sorted(genes.items()))
    except TypeError:  # unhashable exotic gene value — the slow, safe path
        return _lineage.genome_key(genes)


def _tuplify_key(key: Any) -> Any:
    """JSON round trip of a pending key (lists back to tuples)."""
    if isinstance(key, list):
        return tuple(_tuplify_key(v) for v in key)
    return key


def space_key(genes: Dict[str, Any], namespace: Optional[str] = None) -> str:
    """Per-tenant dataset namespace for a search space.

    Digest of the sorted gene names and their feature widths, prefixed
    by the session namespace — two tenants searching the same space
    still get disjoint dataset keys, and two spaces that merely share
    gene names but differ in width never mix training rows.
    """
    sig = [[name, len(_feature(genes[name]))] for name in sorted(genes)]
    digest = hashlib.blake2b(
        json.dumps(sig, separators=(",", ":")).encode(),
        digest_size=8).hexdigest()
    return f"{namespace or 'default'}:{digest}"


class FitnessSurrogate:
    """Closed-form ridge regressor over encoded genomes.

    Training rows live in an insertion-ordered dict keyed by
    ``(genome_key, rung)`` — re-observing a genome at the same rung
    replaces its row (latest measurement wins), and the oldest rows are
    evicted past ``max_samples``, so the model tracks the recent search
    distribution instead of ossifying on founder-era measurements
    (stale-predictor drift, ROADMAP item 3).

    ``score`` returns ``None`` until ``min_train`` rows have been seen:
    the minimum-training-set gate.  Refits fire every ``refit_every``
    observations past that — cheap (one ``d×d`` solve, d ≈ bits + 2)
    and deterministic, so the model state is a pure function of the
    observation stream.
    """

    def __init__(self, l2: float = 1e-2, min_train: int = 32,
                 refit_every: int = 32, max_samples: int = 4096):
        if min_train < 2:
            raise ValueError(f"min_train must be >= 2 (got {min_train})")
        if refit_every < 1:
            raise ValueError(f"refit_every must be >= 1 (got {refit_every})")
        self.l2 = float(l2)
        self.min_train = int(min_train)
        self.refit_every = int(refit_every)
        self.max_samples = int(max_samples)
        #: (genome_key, rung) -> (feature list, fitness)
        self._samples: "OrderedDict[Tuple[str, int], Tuple[List[float], float]]" = OrderedDict()
        self._weights: Optional[List[float]] = None
        self._since_refit = 0
        self.refits = 0

    # -- training ----------------------------------------------------------

    @property
    def trained(self) -> bool:
        return self._weights is not None

    @property
    def n_samples(self) -> int:
        return len(self._samples)

    def add_row(self, genome_key: str, x: List[float], fitness: float) -> None:
        """Insert one training row WITHOUT advancing the refit counter —
        the bulk-merge path (warm-start / dataset sync).  Re-inserting an
        existing ``(genome, rung)`` row keeps its age (no ``move_to_end``):
        merges must not let remote duplicates evict fresh local rows."""
        rung = int(x[-1]) if x else 0
        key = (str(genome_key), rung)
        if key in self._samples:
            self._samples[key] = (list(map(float, x)), float(fitness))
            return
        self._samples[key] = (list(map(float, x)), float(fitness))
        while len(self._samples) > self.max_samples:
            self._samples.popitem(last=False)

    def observe(self, genes: Dict[str, Any], rung: int, fitness: float) -> bool:
        """Feed one completed measurement; returns True when it fired a
        refit (the gate hangs its dataset sync off that boundary)."""
        x = encode_genes(genes, rung)
        self.add_row(_lineage.genome_key(genes), x, fitness)
        self._since_refit += 1
        if len(self._samples) >= self.min_train and (
                self._weights is None or self._since_refit >= self.refit_every):
            self.fit()
            return True
        return False

    def fit(self) -> None:
        """Closed-form ridge solve over the current sample set."""
        if len(self._samples) < 2:
            return
        rows = list(self._samples.values())
        X = np.asarray([x for x, _ in rows], dtype=np.float64)
        y = np.asarray([f for _, f in rows], dtype=np.float64)
        d = X.shape[1]
        A = X.T @ X + self.l2 * np.eye(d)
        try:
            w = np.linalg.solve(A, X.T @ y)
        except np.linalg.LinAlgError:  # pragma: no cover - l2 > 0 prevents
            w, *_ = np.linalg.lstsq(A, X.T @ y, rcond=None)
        self._weights = [float(v) for v in w]
        self._since_refit = 0
        self.refits += 1
        if _tele.enabled():
            _get_registry().counter("surrogate_refits_total").inc()

    # -- scoring -----------------------------------------------------------

    def score(self, genes: Dict[str, Any], rung: int = 0) -> Optional[float]:
        """Predicted fitness, or ``None`` while untrained (admit-all)."""
        w = self._weights
        if w is None:
            return None
        return self.score_x(encode_genes(genes, rung))

    def score_x(self, x: List[float]) -> Optional[float]:
        """Score an already-encoded feature vector (the gate's hot path
        encodes once and reuses the vector for the pending key)."""
        w = self._weights
        if w is None or len(x) != len(w):  # untrained, or spec changed
            return None
        # map(mul) dot: ~15 columns — cheaper than a generator expression
        # or an ndarray round trip at this width (broker_throughput gate).
        return sum(map(mul, w, x))

    # -- (de)serialization -------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "l2": self.l2,
            "min_train": self.min_train,
            "refit_every": self.refit_every,
            "max_samples": self.max_samples,
            "weights": self._weights,
            "samples": [[gk, rung, x, f]
                        for (gk, rung), (x, f) in self._samples.items()],
            "since_refit": self._since_refit,
            "refits": self.refits,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.l2 = float(state.get("l2", self.l2))
        self.min_train = int(state.get("min_train", self.min_train))
        self.refit_every = int(state.get("refit_every", self.refit_every))
        self.max_samples = int(state.get("max_samples", self.max_samples))
        w = state.get("weights")
        self._weights = None if w is None else [float(v) for v in w]
        self._samples = OrderedDict(
            ((str(gk), int(rung)), ([float(v) for v in x], float(f)))
            for gk, rung, x, f in state.get("samples", []))
        self._since_refit = int(state.get("since_refit", 0))
        self.refits = int(state.get("refits", 0))


class SurrogateGate:
    """Rung −1 admission control in front of rung-0 dispatch.

    ``decide`` scores a freshly bred child and admits it when the score
    lands in the top ``1/eta`` of the last ``window`` scores (quantile
    over a bisect-maintained sorted window — O(log window) per decide,
    no percentile scan).  Until the surrogate trains, until the window
    holds ``min_window`` scores, or while degraded, every child admits —
    the gate can only ever *save* chip-time, never deadlock the breeder:
    a reject streak of ``max_reject_streak`` force-admits regardless.

    Admitted scores park in a pending map keyed by genome; when the
    measurement lands, :meth:`observe_result` resolves the pair into a
    rolling (score, fitness) buffer from which the ``surrogate_precision_at_k``
    gauge is computed — the self-measured answer to "is this model still
    worth trusting".
    """

    PRECISION_K = 8
    #: ``surrogate_score_seconds`` samples 1 decide in (mask+1): the
    #: perf_counter pair plus histogram bucketing cost more than the whole
    #: scoring step, and the broker_throughput 2% budget is per-decide.
    _SAMPLE_MASK = 15

    def __init__(self, surrogate: Optional[FitnessSurrogate] = None,
                 eta: int = 4, window: int = 64, min_window: int = 16,
                 max_reject_streak: int = 32, dataset_client=None,
                 namespace: Optional[str] = None):
        if eta < 2:
            raise ValueError(f"eta must be >= 2 (got {eta}): admitting "
                             "every child is not a gate")
        self.surrogate = surrogate if surrogate is not None else FitnessSurrogate()
        self.eta = int(eta)
        self.window = max(2, int(window))
        self.min_window = max(2, int(min_window))
        self.max_reject_streak = max(1, int(max_reject_streak))
        self.dataset_client = dataset_client
        self.namespace = str(namespace) if namespace else None
        self.maximize = True
        self.admitted = 0
        self.rejected = 0
        self.degraded = False
        self.degraded_total = 0
        self.precision_at_k: Optional[float] = None
        self._space: Optional[str] = None
        self._scores: deque = deque()   # arrival order (window eviction)
        self._sorted: List[float] = []  # same multiset, sorted (quantile)
        self._pending: Dict[str, float] = {}
        self._pairs: deque = deque(maxlen=16 * self.PRECISION_K)
        self._publish_buf: List[List[Any]] = []
        self._reject_streak = 0
        self._prepared = False
        self._metrics = None  # cached (admit, reject, seconds) handles
        self._tick = 0  # latency-histogram sampler (1 in _SAMPLE_MASK+1)

    # -- lifecycle ---------------------------------------------------------

    def prepare(self, example_genes: Dict[str, Any], maximize: bool,
                session: Optional[str] = None) -> None:
        """Bind the gate to a search: objective direction, per-tenant
        dataset space key, and (when a dataset client is attached) the
        warm-start fetch — a fresh master inherits prior runs' training
        rows from the shared fitness service.  Idempotent: a resumed or
        re-entered ``run()`` re-prepares without refetching."""
        if self._prepared:
            return
        self.maximize = bool(maximize)
        self._space = space_key(example_genes, self.namespace or session)
        self._prepared = True
        if self.dataset_client is None:
            return
        rows = self.dataset_client.fetch_dataset(
            self._space, limit=self.surrogate.max_samples)
        if rows is None:
            self._degrade("warm-start dataset fetch failed")
            return
        self._merge_rows(rows)
        if (not self.surrogate.trained
                and self.surrogate.n_samples >= self.surrogate.min_train):
            self.surrogate.fit()
        if rows:
            logger.info(
                "surrogate warm-start: %d dataset row(s) from %s (space %s)",
                len(rows), getattr(self.dataset_client, "url", "?"), self._space)

    # -- the hot path ------------------------------------------------------

    def decide(self, genes: Dict[str, Any], rung: int = 0) -> Tuple[bool, Optional[float]]:
        """Score one bred child and admit or reject it.

        Draws no randomness; the decision is a pure function of the gate
        state, so the gated trajectory stays deterministic and a
        checkpoint (window + pending map) resumes it bit-identically.
        """
        tele = _tele.enabled()
        timed = False
        if tele:
            self._tick = (self._tick + 1) & self._SAMPLE_MASK
            timed = self._tick == 0
            t0 = time.perf_counter() if timed else 0.0
        # Inlined surrogate.score: encode once, dot on the weights — the
        # method-call + double-encode round trip costs as much as scoring.
        w = self.surrogate._weights
        if w is None:
            score = None
        else:
            x = encode_genes(genes, rung)
            score = sum(map(mul, w, x)) if len(x) == len(w) else None
        admit = True
        if score is not None and not self.degraded:
            # Push first, then cut: the threshold includes this score, so
            # the window's best always admits and k = len // eta is exact.
            self._scores.append(score)
            insort(self._sorted, score)
            if len(self._scores) > self.window:
                old = self._scores.popleft()
                del self._sorted[bisect_left(self._sorted, old)]
            if len(self._sorted) >= self.min_window:
                k = max(1, len(self._sorted) // self.eta)
                if self.maximize:
                    admit = score >= self._sorted[-k]
                else:
                    admit = score <= self._sorted[k - 1]
            if not admit and self._reject_streak + 1 >= self.max_reject_streak:
                # A model rejecting everything is miscalibrated, not
                # insightful — force one through so breeding always
                # progresses and fresh measurements re-train it.
                admit = True
        if admit:
            self._reject_streak = 0
            self.admitted += 1
            self._pending[_pending_key(genes)] = (
                score if score is not None else None)
        else:
            self._reject_streak += 1
            self.rejected += 1
        if tele:
            if self._metrics is None:
                # Handles cached once per gate: one registry lock + dict
                # probe per metric per decide would dominate the hot path.
                reg = _get_registry()
                self._metrics = (
                    reg.counter("surrogate_gate_admitted_total"),
                    reg.counter("surrogate_gate_rejected_total"),
                    reg.histogram("surrogate_score_seconds"))
            self._metrics[0 if admit else 1].inc()
            if timed:
                self._metrics[2].observe(time.perf_counter() - t0)
        return admit, score

    def forget(self, genes: Dict[str, Any]) -> None:
        """Drop the pending decision for a permanently failed child —
        there will never be a realized fitness to resolve it against."""
        self._pending.pop(_pending_key(genes), None)

    # -- the feedback path -------------------------------------------------

    def observe_result(self, genes: Dict[str, Any], rung: int, fitness: float) -> None:
        """One measurement landed: train the surrogate, resolve the
        pending gate decision into the precision@k buffer, and — at refit
        boundaries with a dataset client attached — sync training rows
        with the shared fitness service."""
        if self.dataset_client is not None:
            self._publish_buf.append([
                _lineage.genome_key(genes),
                {k: list(v) if isinstance(v, tuple) else v
                 for k, v in genes.items()},
                int(rung), float(fitness)])
        refitted = self.surrogate.observe(genes, rung, fitness)
        score = self._pending.pop(_pending_key(genes), None)
        if score is not None:
            self._pairs.append([float(score), float(fitness)])
            self._update_precision()
        if refitted and self.dataset_client is not None:
            self._sync_dataset()

    def _update_precision(self) -> None:
        k = self.PRECISION_K
        if len(self._pairs) < k:
            return
        pairs = list(self._pairs)
        by_score = sorted(range(len(pairs)), key=lambda i: pairs[i][0],
                          reverse=self.maximize)[:k]
        by_actual = sorted(range(len(pairs)), key=lambda i: pairs[i][1],
                           reverse=self.maximize)[:k]
        self.precision_at_k = len(set(by_score) & set(by_actual)) / k
        if _tele.enabled():
            _get_registry().gauge("surrogate_precision_at_k").set(
                self.precision_at_k)

    # -- dataset plane (shared fitness service) ----------------------------

    def _merge_rows(self, rows: List[Any]) -> None:
        for row in rows:
            if not isinstance(row, dict):
                continue
            genes, fitness = row.get("genes"), row.get("fitness")
            if not isinstance(genes, dict) or fitness is None:
                continue
            try:
                rung = int(row.get("rung", 0))
                x = encode_genes(genes, rung)
                self.surrogate.add_row(
                    str(row.get("genome") or _lineage.genome_key(genes)),
                    x, float(fitness))
            except (TypeError, ValueError):
                continue

    def _sync_dataset(self) -> None:
        """Refit-boundary sync: push the rows measured since the last
        refit, pull the space's merged set.  Off the hot path (refits are
        every ``refit_every`` completions) and fail-open: any failure
        degrades the gate to admit-all until a sync succeeds again."""
        client, space = self.dataset_client, self._space
        if client is None or space is None:
            return
        rows_out = [{"genome": gk, "genes": genes, "rung": rung, "fitness": f}
                    for gk, genes, rung, f in self._publish_buf]
        ok = client.publish_dataset(space, rows_out) is not None
        rows_in = client.fetch_dataset(
            space, limit=self.surrogate.max_samples) if ok else None
        if rows_in is None:
            self._degrade("dataset sync with the fitness service failed")
            return
        self._publish_buf = []
        self._merge_rows(rows_in)
        self._recover()

    def _degrade(self, reason: str) -> None:
        """Admit-all until the dataset plane is consistent again: a gate
        whose training-set sync fails cannot trust its score distribution
        relative to the fleet, and admitting everything costs chip-time,
        never correctness.  Exactly ONE event per up→down transition."""
        if self.degraded:
            return
        self.degraded = True
        self.degraded_total += 1
        logger.warning(
            "surrogate gate degraded to admit-all: %s — the search "
            "continues ungated until a dataset sync succeeds", reason)
        _tele.record_event("surrogate_degraded", {"reason": reason,
                                                  "space": self._space})
        if _tele.enabled():
            _get_registry().counter("surrogate_degraded_total").inc()

    def _recover(self) -> None:
        if self.degraded:
            self.degraded = False
            logger.info("surrogate gate recovered: dataset sync succeeded, "
                        "gating resumes")

    def drop_measurements(self) -> None:
        """Forget every value measured under a fitness protocol — the
        model's samples and weights, the score window, the pending
        decisions, the precision pairs and the unpublished rows — keeping
        the gate's settings, space binding and counters.  For a checkpoint
        stamped with another fitness protocol, whose values this package
        must not mix with its own."""
        old = self.surrogate
        self.surrogate = FitnessSurrogate(
            l2=old.l2, min_train=old.min_train, refit_every=old.refit_every,
            max_samples=old.max_samples)
        self._scores = deque()
        self._sorted = []
        self._pending = {}
        self._pairs.clear()
        self._publish_buf = []
        self._reject_streak = 0
        self.precision_at_k = None

    # -- introspection -----------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The ``/statusz`` engine "surrogate" block (gentun_top panel)."""
        return {
            "trained": self.surrogate.trained,
            "samples": self.surrogate.n_samples,
            "refits": self.surrogate.refits,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "pending": len(self._pending),
            "window": len(self._scores),
            "eta": self.eta,
            "degraded": self.degraded,
            "precision_at_k": self.precision_at_k,
            "space": self._space,
        }

    # -- (de)serialization (checkpoint schema v4) --------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "eta": self.eta,
            "window": self.window,
            "min_window": self.min_window,
            "max_reject_streak": self.max_reject_streak,
            "namespace": self.namespace,
            "maximize": self.maximize,
            "space": self._space,
            "prepared": self._prepared,
            "model": self.surrogate.state_dict(),
            "scores": list(self._scores),
            "pending": [[k, v] for k, v in self._pending.items()],
            "pairs": [list(p) for p in self._pairs],
            "publish_buf": [list(r) for r in self._publish_buf],
            "reject_streak": self._reject_streak,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "degraded": self.degraded,
            "degraded_total": self.degraded_total,
            "precision_at_k": self.precision_at_k,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.eta = int(state.get("eta", self.eta))
        self.window = int(state.get("window", self.window))
        self.min_window = int(state.get("min_window", self.min_window))
        self.max_reject_streak = int(
            state.get("max_reject_streak", self.max_reject_streak))
        ns = state.get("namespace")
        self.namespace = str(ns) if ns else None
        self.maximize = bool(state.get("maximize", True))
        self._space = state.get("space")
        self._prepared = bool(state.get("prepared", False))
        self.surrogate.load_state_dict(state.get("model", {}))
        self._scores = deque(float(s) for s in state.get("scores", []))
        self._sorted = sorted(self._scores)
        self._pending = {
            _tuplify_key(k): (None if v is None else float(v))
            for k, v in state.get("pending", [])}
        self._pairs = deque((list(p) for p in state.get("pairs", [])),
                            maxlen=16 * self.PRECISION_K)
        self._publish_buf = [list(r) for r in state.get("publish_buf", [])]
        self._reject_streak = int(state.get("reject_streak", 0))
        self.admitted = int(state.get("admitted", 0))
        self.rejected = int(state.get("rejected", 0))
        self.degraded = bool(state.get("degraded", False))
        self.degraded_total = int(state.get("degraded_total", 0))
        p = state.get("precision_at_k")
        self.precision_at_k = None if p is None else float(p)

    @classmethod
    def from_state(cls, state: Dict[str, Any],
                   dataset_client=None) -> "SurrogateGate":
        """Reconstruct a gate from checkpoint state alone — the resume
        path when the resuming constructor didn't pass ``surrogate=``
        (the checkpoint wins, like the ladder)."""
        gate = cls(dataset_client=dataset_client)
        gate.load_state_dict(state)
        return gate
