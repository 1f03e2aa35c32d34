"""Process-local metrics registry: counters, gauges, log-scale histograms.

SURVEY.md §5 records that the reference gentun has no metrics of any kind;
the rebuild's observability plane starts here.  Design constraints, each
load-bearing:

- **zero-dependency** — the registry must be importable by the GA outer
  loop, which never imports jax (``algorithms._initialized_chip_count``),
  and by workers on minimal installs.  stdlib only.
- **thread-safe** — the broker loop thread, worker consume threads, and
  the master thread all write concurrently.  One lock per instrument,
  held for a few arithmetic ops; no lock on the registry read path that
  tests care about (``snapshot`` takes the creation lock only to copy
  the instrument table).
- **fixed log-scale histogram buckets** — span durations range from
  microseconds (a cache hit) to minutes (a CIFAR compile); linear buckets
  cannot cover that.  Buckets are FIXED at construction so concurrent
  ``observe`` never reallocates and snapshots are always comparable.

Renderers: :meth:`MetricsRegistry.render_prometheus` (the text exposition
format, scrape-ready) and :meth:`MetricsRegistry.render_jsonl` (one JSON
object per metric line, the same schema ``snapshot`` returns — the
``telemetry.jsonl`` artifact embeds these).
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DeltaSnapshotter",
    "get_registry",
    "DEFAULT_BUCKETS",
]


def _log_buckets(lo: float, hi: float, per_decade: int) -> Tuple[float, ...]:
    """Fixed log-scale bucket upper bounds from ``lo`` to ``hi`` inclusive."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


#: Default histogram bounds: 10 µs .. 10 ks, 4 buckets per decade (~1.78×
#: resolution).  Covers a sub-millisecond OneMax evaluation and a
#: minutes-long CIFAR-scale XLA compile in one fixed 37-bucket layout.
DEFAULT_BUCKETS: Tuple[float, ...] = _log_buckets(1e-5, 1e4, 4)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count.  ``inc`` is thread-safe."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A value that can go up and down (queue depth, connected workers)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Cumulative histogram over fixed log-scale buckets.

    ``observe`` is O(log n_buckets) (bisect) under one lock — safe from
    the broker loop thread at per-frame rates.  ``quantile`` interpolates
    log-linearly inside the bucket; span-record percentiles in the run
    summary are exact (``export.RunTelemetry`` keeps the raw durations),
    the histogram quantile is the cheap always-on estimate.
    """

    __slots__ = ("name", "labels", "bounds", "_lock", "_counts", "_sum", "_count")

    def __init__(self, name: str, labels: Dict[str, str],
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.labels = dict(labels)
        bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # +1 = +Inf overflow bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        import bisect

        v = float(value)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0..1), log-interpolated within the bucket."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank and c:
                if i >= len(self.bounds):
                    return self.bounds[-1]  # overflow bucket: clamp
                hi = self.bounds[i]
                lo = self.bounds[i - 1] if i else hi / 10.0
                frac = (rank - (seen - c)) / c
                return lo * (hi / lo) ** frac
        return self.bounds[-1]  # pragma: no cover - defensive

    def snapshot_buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (upper_bound, count) pairs, Prometheus-style."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        out.append((math.inf, cum + counts[-1]))
        return out


class MetricsRegistry:
    """Thread-safe instrument factory + snapshot/render surface.

    ``counter``/``gauge``/``histogram`` are get-or-create keyed on
    (name, sorted labels): calling them on the hot path is a dict lookup
    under the registry lock, but callers that care (broker, populations)
    hold the instrument object instead of re-looking it up per event.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, str, Tuple], Any] = {}

    def _get(self, cls_tag: str, cls, name: str, labels: Dict[str, Any], **kw):
        key = (cls_tag, name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, {str(k): str(v) for k, v in labels.items()}, **kw)
                self._instruments[key] = inst
            return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, buckets: Optional[Iterable[float]] = None,
                  **labels: Any) -> Histogram:
        return self._get("histogram", Histogram, name, labels, buckets=buckets)

    def reset(self) -> None:
        """Drop every instrument (tests; a fresh run artifact)."""
        with self._lock:
            self._instruments.clear()

    # -- read side ---------------------------------------------------------

    def _items(self) -> List[Tuple[str, Any]]:
        with self._lock:
            return [(tag, inst) for (tag, _, _), inst in sorted(
                self._instruments.items(),
                key=lambda kv: (kv[0][1], kv[0][2], kv[0][0]),
            )]

    def snapshot(self) -> Dict[str, Any]:
        """{"counters": [...], "gauges": [...], "histograms": [...]} — every
        value JSON-native, the shape the JSONL renderer and the run summary
        consume."""
        out: Dict[str, List[Dict[str, Any]]] = {
            "counters": [], "gauges": [], "histograms": [],
        }
        for tag, inst in self._items():
            if tag == "counter":
                out["counters"].append(
                    {"name": inst.name, "labels": inst.labels, "value": inst.value})
            elif tag == "gauge":
                out["gauges"].append(
                    {"name": inst.name, "labels": inst.labels, "value": inst.value})
            else:
                out["histograms"].append({
                    "name": inst.name,
                    "labels": inst.labels,
                    "count": inst.count,
                    "sum": inst.sum,
                    "buckets": [
                        ["+Inf" if math.isinf(b) else b, c]
                        for b, c in inst.snapshot_buckets()
                    ],
                })
        return out

    def render_jsonl(self) -> str:
        """One JSON object per metric, newline-delimited (artifact-ready)."""
        lines = []
        snap = self.snapshot()
        for tag in ("counters", "gauges", "histograms"):
            for rec in snap[tag]:
                lines.append(json.dumps({"metric": tag[:-1], **rec},
                                        separators=(",", ":")))
        return "\n".join(lines) + ("\n" if lines else "")

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (scrape- or textfile-ready).

        Label values are escaped per the exposition format spec
        (backslash, double-quote, newline — in that order, so an
        already-present backslash can't re-arm the later replacements).
        """

        def esc(v: str) -> str:
            return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")

        def fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
            parts = [f'{k}="{esc(v)}"' for k, v in sorted(labels.items())]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines: List[str] = []
        typed: set = set()
        for tag, inst in self._items():
            if (tag, inst.name) not in typed:
                typed.add((tag, inst.name))
                lines.append(f"# TYPE {inst.name} {tag}")
            if tag in ("counter", "gauge"):
                lines.append(f"{inst.name}{fmt_labels(inst.labels)} {inst.value:g}")
            else:
                for b, c in inst.snapshot_buckets():
                    le = "+Inf" if math.isinf(b) else f"{b:g}"
                    le_label = 'le="%s"' % le
                    lines.append(
                        f"{inst.name}_bucket{fmt_labels(inst.labels, le_label)} {c}")
                lines.append(f"{inst.name}_sum{fmt_labels(inst.labels)} {inst.sum:g}")
                lines.append(f"{inst.name}_count{fmt_labels(inst.labels)} {inst.count}")
        return "\n".join(lines) + ("\n" if lines else "")


class DeltaSnapshotter:
    """Incremental :meth:`MetricsRegistry.snapshot`: only changed series.

    The aggregator pusher ships a snapshot every flush interval; most
    series are quiet between flushes (a search touches a handful of
    instruments per job).  ``collect`` memoizes the last-shipped scalar
    per instrument — ``(value)`` for counters/gauges, ``(count, sum)``
    for histograms — and emits only series whose scalar moved, with the
    FULL cumulative value (the aggregator derives deltas itself, which
    is what makes counter-reset detection possible server-side).  Cost
    is O(#instruments) cheap compares per flush, zero per metric write —
    the property the ``broker_throughput`` push-path gate certifies.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry if registry is not None else get_registry()
        self._last: Dict[Tuple[str, str, Tuple], Any] = {}

    def collect(self, full: bool = False) -> Dict[str, Any]:
        """Changed-series snapshot (same shape as ``snapshot``).

        ``full=True`` resends everything (first push after a reconnect,
        so an aggregator that lost state recovers the whole picture).
        """
        out: Dict[str, List[Dict[str, Any]]] = {
            "counters": [], "gauges": [], "histograms": [],
        }
        last = self._last
        for tag, inst in self._registry._items():
            key = (tag, inst.name, _label_key(inst.labels))
            if tag == "histogram":
                cur = (inst.count, inst.sum)
            else:
                cur = inst.value
            if not full and last.get(key) == cur:
                continue
            last[key] = cur
            if tag == "counter":
                out["counters"].append(
                    {"name": inst.name, "labels": inst.labels, "value": cur})
            elif tag == "gauge":
                out["gauges"].append(
                    {"name": inst.name, "labels": inst.labels, "value": cur})
            else:
                out["histograms"].append({
                    "name": inst.name,
                    "labels": inst.labels,
                    "count": cur[0],
                    "sum": cur[1],
                    "buckets": [
                        ["+Inf" if math.isinf(b) else b, c]
                        for b, c in inst.snapshot_buckets()
                    ],
                })
        return out

    def reset(self) -> None:
        """Forget memoized values: the next ``collect`` ships everything."""
        self._last.clear()


#: The process-wide default registry.  Everything in-tree records here;
#: tests that need isolation construct their own MetricsRegistry.
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
