"""Cross-session window packing: broker-side pack state.

The converged tail of a search emits 1–4-individual generations, and each
one pays the full program-switch + dispatch + RPC floor PERF.md measures
at ~1.9 s — a cost a full mesh-bucket window pays once and amortizes over
the whole population.  A multi-tenant broker multiplies that regime: many
concurrent sessions, each emitting tiny batches, each paying the floor
alone.  The fix is to let queued jobs from DIFFERENT sessions share one
device window whenever that is provably safe.

Safety is the purity protocol note (PERF.md, ``TestBatchCompositionPurity``):
under content-hash PRNG keys, fitness is a pure function of
(architecture, config, seed) — invariant to batch composition, slot, and
padding.  Two jobs may therefore share a window iff they would compile to
the same program, which is exactly equality of:

- the serialized ``additional_parameters`` bytes (static config
  fingerprint — the ``jobs2`` envelope-grouping rule),
- the serialized ``fidelity`` bytes (fidelity fingerprint — rung epochs
  feed the compiled step count), and
- the genome size class (``job_size_class`` — small genomes share the
  data-parallel program; big/micro genomes get singleton windows).

:class:`WindowPacker` is pure pack STATE: compile-compatibility groups,
each a FIFO of ``(session, job_id)`` with arrival stamps, plus bounded
fill/linger observations for ``pack_stats()``.  All policy — when to fill
(fair-share ``pop_next``, so DRR deficit charging is preserved job by
job), when to flush (window full at the worker's mesh-aligned capacity,
or the oldest job's ``max_linger_ms`` deadline), and where (placement
class, credit) — lives in ``JobBroker._dispatch_packed``.  Like
``FairShareScheduler``, every method here runs on the broker's event
loop thread only; no locks.

Crash safety needs no packed-window journal record: the journal is
per-job, a packed in-flight window replays as its constituent
per-session jobs, and the packer itself is rebuilt empty on restart
(held jobs were never dispatched, so replay returns them to the
scheduler and they simply re-pack).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

__all__ = ["PackGroup", "WindowPacker"]


class PackGroup:
    """One compile-compatibility class's held jobs, FIFO with arrivals.

    ``key`` is the broker's pack key — ``(pack_envelope(env),
    size_class)`` — opaque here beyond identity.  ``size_class`` and
    ``prefers_preemptible`` are denormalized out of the key's jobs so
    the flush loop can size/place a window without touching payloads;
    both are constant within a group by construction (size class is in
    the key, and placement preference is rung-0 AND small, where the
    rung comes from the fidelity bytes that are also in the key).
    """

    __slots__ = ("key", "size_class", "prefers_preemptible", "jobs", "arrivals")

    def __init__(self, key: tuple, size_class: str,
                 prefers_preemptible: bool) -> None:
        self.key = key
        self.size_class = size_class
        self.prefers_preemptible = prefers_preemptible
        self.jobs: Deque[Tuple[str, str]] = deque()  # (session_id, job_id)
        self.arrivals: Deque[float] = deque()

    def __len__(self) -> int:
        return len(self.jobs)

    @property
    def oldest(self) -> Optional[float]:
        """Monotonic arrival stamp of the head job, or ``None`` if empty."""
        return self.arrivals[0] if self.arrivals else None


def _dist(values: List[float]) -> Optional[Dict[str, float]]:
    """count/mean/p50/p90/max over a sorted sample; None when empty."""
    if not values:
        return None
    n = len(values)
    return {
        "count": n,
        "mean": round(sum(values) / n, 6),
        "p50": round(values[min(n - 1, int(0.50 * n))], 6),
        "p90": round(values[min(n - 1, int(0.90 * n))], 6),
        "max": round(values[-1], 6),
    }


class WindowPacker:
    """Pack state for ``JobBroker(pack_windows=True)``.

    Jobs enter through :meth:`add` (the broker pops them from the
    fair-share scheduler, so fairness was already charged), sit in their
    compatibility group's FIFO, and leave through :meth:`take` (one
    window) or :meth:`remove` (cancel / session close).  ``held``
    counts jobs currently parked here — they are neither queued (the
    scheduler no longer has them) nor in flight (no worker owns them),
    so the broker's ``outstanding()`` reports them as ``packed_held``
    and chaos quiescence asserts the count drains to zero.
    """

    #: Bounded window for fill/linger observations — enough for stable
    #: percentiles, small enough to never matter for memory.
    STATS_WINDOW = 512

    def __init__(self, linger_s: float) -> None:
        self.linger_s = max(0.0, float(linger_s))
        self._groups: Dict[tuple, PackGroup] = {}
        self._job_group: Dict[str, tuple] = {}
        self._held = 0
        self.windows_total = 0
        self.jobs_total = 0
        self.cross_session_windows = 0
        self.fill_ratios: Deque[float] = deque(maxlen=self.STATS_WINDOW)
        self.lingers: Deque[float] = deque(maxlen=self.STATS_WINDOW)

    # -- holding ----------------------------------------------------------

    @property
    def held(self) -> int:
        return self._held

    def held_by_session(self) -> Dict[str, int]:
        """Held-job count per session — the broker folds this into its
        in-flight view so ``max_in_flight`` quotas see parked jobs."""
        counts: Dict[str, int] = {}
        for g in self._groups.values():
            for sid, _ in g.jobs:
                counts[sid] = counts.get(sid, 0) + 1
        return counts

    def add(self, sid: str, job_id: str, key: tuple, size_class: str,
            prefers_preemptible: bool, now: Optional[float] = None) -> None:
        """Park one job in its compatibility group (FIFO tail)."""
        g = self._groups.get(key)
        if g is None:
            g = self._groups[key] = PackGroup(key, size_class,
                                             prefers_preemptible)
        g.jobs.append((sid, job_id))
        g.arrivals.append(time.monotonic() if now is None else now)
        self._job_group[job_id] = key
        self._held += 1

    def groups(self) -> List[PackGroup]:
        return list(self._groups.values())

    def next_deadline(self) -> Optional[float]:
        """Earliest monotonic instant a held window becomes linger-due,
        or ``None`` when nothing is held (nothing to time out)."""
        oldest = [g.arrivals[0] for g in self._groups.values() if g.arrivals]
        if not oldest:
            return None
        return min(oldest) + self.linger_s

    # -- leaving ----------------------------------------------------------

    def take(self, group: PackGroup, n: int, step: int,
             now: Optional[float] = None) -> List[Tuple[str, str]]:
        """Pop up to ``n`` jobs FIFO from ``group`` as ONE window.

        ``step`` is the window's target size (the worker's mesh-aligned
        capacity) — it only feeds the fill-ratio observation.  Records
        one windows_total / fill / linger sample, drops the group when
        emptied, and returns the ``(session, job_id)`` window in pack
        order (which IS dispatch order — the DRR interleave the fill
        phase charged).
        """
        if n <= 0 or not group.jobs:
            return []
        now = time.monotonic() if now is None else now
        linger = now - group.arrivals[0]
        out: List[Tuple[str, str]] = []
        for _ in range(min(n, len(group.jobs))):
            pair = group.jobs.popleft()
            group.arrivals.popleft()
            self._job_group.pop(pair[1], None)
            out.append(pair)
        self._held -= len(out)
        if not group.jobs:
            self._groups.pop(group.key, None)
        self.windows_total += 1
        self.jobs_total += len(out)
        if len({sid for sid, _ in out}) > 1:
            self.cross_session_windows += 1
        self.fill_ratios.append(len(out) / max(1, step))
        self.lingers.append(max(0.0, linger))
        return out

    def remove(self, ids: Iterable[str]) -> int:
        """Purge held jobs by id (cancel, session close, terminal fail).
        Returns how many were actually held here."""
        ids = set(ids)
        affected = set()
        for jid in ids:
            key = self._job_group.pop(jid, None)
            if key is not None:
                affected.add(key)
        removed = 0
        for key in affected:
            g = self._groups.get(key)
            if g is None:
                continue
            kept = [(pair, at) for pair, at in zip(g.jobs, g.arrivals)
                    if pair[1] not in ids]
            removed += len(g.jobs) - len(kept)
            g.jobs = deque(pair for pair, _ in kept)
            g.arrivals = deque(at for _, at in kept)
            if not g.jobs:
                del self._groups[key]
        self._held -= removed
        return removed

    # -- observability -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Pack stats for ``/statusz`` and ``JobBroker.pack_stats()``."""
        return {
            "linger_ms": round(self.linger_s * 1000.0, 3),
            "held": self._held,
            "groups": len(self._groups),
            "windows_total": self.windows_total,
            "jobs_total": self.jobs_total,
            "cross_session_windows": self.cross_session_windows,
            "fill_ratio": _dist(sorted(self.fill_ratios)),
            "linger_s": _dist(sorted(self.lingers)),
        }
