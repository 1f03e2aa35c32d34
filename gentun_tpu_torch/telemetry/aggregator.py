"""Fleet metrics aggregator: push-gateway + time-series rings + SLO plane.

Every gentun process already exports a process-local ``/metrics``, but a
fleet of one master, one broker, and N workers is N+2 scrape
targets with no time dimension and no judgment.  This module closes that
gap with the same three-part shape as the fitness/compile services:

- :class:`MetricsAggregator` — a ``ThreadingHTTPServer`` daemon that
  accepts ``POST /v1/push`` snapshots (``AGG_PROTOCOL`` guarded, HTTP 409
  on skew — all-writers-upgrade-together, like ``FITNESS_PROTOCOL``),
  merges per-process series into one fleet exposition on ``/metrics``,
  keeps a bounded ring of ``(t, value)`` points per series, and drives a
  declarative SLO engine (:mod:`gentun_tpu_torch.telemetry.slo`) whose alerts
  surface on ``/alertz`` and as ``{"type": "alert"}`` telemetry records.

  Merge semantics are the part worth being careful about: pushers send
  *cumulative* values with ``(boot_id, seq)`` identity, so the server —
  not the client — detects counter resets (a restarted worker pushing
  ``5`` after ``100`` contributes ``105`` to the fleet total, never
  ``-95``) and drops late/out-of-order snapshots (stale ``seq`` under an
  unchanged ``boot_id``).

- :class:`TelemetryPusher` — the client side: a daemon flusher that ships
  a memoized snapshot *delta* (:class:`~gentun_tpu_torch.telemetry.registry.
  DeltaSnapshotter`: only series that moved since the last push) every
  ``interval`` seconds.  Every network failure marks the aggregator down
  for a ``cooldown`` window and emits exactly ONE ``aggregator_degraded``
  telemetry event per up→down transition — aggregator downtime can never
  touch a search, the same degradation contract as
  ``FitnessServiceClient``.

- :func:`acquire_pusher`/:func:`release_pusher` — a refcounted per-URL
  process registry, because the master and its in-process broker share
  one metrics registry: two components wiring the same URL must share
  one pusher (their roles merge into the ``role`` label) or the fleet
  rollup would double-count every counter in that process.

Run standalone::

    python -m gentun_tpu_torch.telemetry.aggregator --port 9100
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import threading
import time
import urllib.request
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse
from uuid import uuid4

from . import spans as _tele
from .buildinfo import set_build_info
from .registry import DeltaSnapshotter, MetricsRegistry, get_registry
from .slo import SeriesPoints, SloEngine, default_rules, match_series

__all__ = [
    "AGG_PROTOCOL",
    "MetricsAggregator",
    "TelemetryPusher",
    "acquire_pusher",
    "release_pusher",
    "flush_active_pushers",
    "parse_aggregator_url",
    "main",
]

logger = logging.getLogger("gentun_tpu_torch.telemetry")

#: Wire protocol for ``/v1/push``.  Bump on any change to the payload
#: schema or merge semantics; skewed pushers are refused with HTTP 409.
AGG_PROTOCOL = 1

#: Request-body ceiling — matches the broker frame / fitness service
#: ceiling.  A full snapshot of every instrument in a busy master is
#: ~100 series; even histogram-heavy payloads sit far under this.
_MAX_BODY_BYTES = 4 * 1024 * 1024


def parse_aggregator_url(url: str) -> str:
    """Validate an ``--aggregator-url`` value; returns it normalized.

    Same contract as ``fitness_service.parse_cache_url`` (reimplemented
    here so the telemetry plane never imports the distributed layer):
    loud ``ValueError`` on anything but ``http(s)://host:port`` — a
    typo'd URL must not silently leave a fleet unmonitored.
    """
    parsed = urlparse(url)
    if parsed.scheme not in ("http", "https"):
        raise ValueError(
            f"aggregator url {url!r}: scheme must be http or https "
            f"(got {parsed.scheme or 'none'!r})")
    if not parsed.hostname:
        raise ValueError(f"aggregator url {url!r}: missing host")
    if parsed.port is None:
        raise ValueError(f"aggregator url {url!r}: missing port")
    if parsed.path not in ("", "/") or parsed.query or parsed.fragment:
        raise ValueError(
            f"aggregator url {url!r}: must be scheme://host:port with no "
            "path/query (endpoints are appended by the pusher)")
    return f"{parsed.scheme}://{parsed.hostname}:{parsed.port}"


# -- merged series state -----------------------------------------------------


class _Series:
    """One (instance, instrument) merged series with reset correction.

    ``base`` accumulates everything lost to counter resets: on a push
    whose cumulative value went *down* (process restart — monotone
    counters cannot decrease otherwise), the previous cumulative folds
    into ``base`` and the new value starts fresh, so ``effective = base +
    last`` stays monotone across restarts.  Gauges skip all of that.
    """

    __slots__ = ("tag", "name", "labels", "base", "last", "base_sum",
                 "last_sum", "buckets", "base_buckets", "ring")

    def __init__(self, tag: str, name: str, labels: Dict[str, str],
                 ring_len: int):
        self.tag = tag
        self.name = name
        self.labels = dict(labels)
        self.base = 0.0       # counters: reset carry; histograms: count carry
        self.last = 0.0       # counters: last raw value; histograms: count
        self.base_sum = 0.0   # histograms only
        self.last_sum = 0.0
        self.buckets: List[Tuple[Any, float]] = []   # last raw cum buckets
        self.base_buckets: List[float] = []          # reset carry per bucket
        # counters/gauges: (t, value); histograms: (t, count, sum) —
        # values reset-corrected so window deltas are plain subtraction.
        self.ring: deque = deque(maxlen=ring_len)

    @property
    def effective(self) -> float:
        return self.base + self.last

    @property
    def effective_sum(self) -> float:
        return self.base_sum + self.last_sum

    def effective_buckets(self) -> List[Tuple[Any, float]]:
        out = []
        for i, (b, c) in enumerate(self.buckets):
            carry = self.base_buckets[i] if i < len(self.base_buckets) else 0.0
            out.append((b, c + carry))
        return out

    def update(self, tag: str, t: float, value: float,
               hist_sum: float = 0.0,
               buckets: Optional[List] = None) -> bool:
        """Merge one pushed cumulative value; returns True on a reset."""
        reset = False
        if tag == "gauge":
            self.last = value
            self.ring.append((t, value))
            return False
        if value < self.last - 1e-9:  # monotone violated ⇒ process restart
            reset = True
            self.base += self.last
            if tag == "histogram":
                self.base_sum += self.last_sum
                prev = [c for _, c in self.buckets]
                if len(prev) == len(self.base_buckets):
                    self.base_buckets = [a + b for a, b
                                         in zip(self.base_buckets, prev)]
                else:
                    self.base_buckets = prev
                # The folded counts now live in base; the raw view must
                # restart at zero or effective_buckets double-counts.
                self.buckets = [(b, 0.0) for b, _ in self.buckets]
        self.last = value
        if tag == "histogram":
            self.last_sum = hist_sum
            if buckets is not None:
                cleaned = []
                for pair in buckets:
                    if isinstance(pair, (list, tuple)) and len(pair) == 2:
                        cleaned.append((pair[0], float(pair[1])))
                if len(cleaned) != len(self.base_buckets):
                    # First push, or the bucket layout changed across a
                    # restart: the carry no longer lines up — drop it.
                    self.base_buckets = [0.0] * len(cleaned)
                self.buckets = cleaned
            self.ring.append((t, self.effective, self.effective_sum))
        else:
            self.ring.append((t, self.effective))
        return reset


@dataclass
class _Instance:
    """Everything the aggregator knows about one pushing process."""

    instance: str
    role: str
    boot_id: str = ""
    seq: int = 0
    pushes: int = 0
    last_push: float = 0.0  # time.time() at receipt
    series: Dict[Tuple[str, str, Tuple], _Series] = field(default_factory=dict)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# -- HTTP plumbing -----------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    """Request handler; ``self.server.aggregator`` is the MetricsAggregator."""

    server_version = "gentun-agg/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 - silence stderr chatter
        pass

    def _send_json(self, code: int, obj: Any) -> None:
        body = json.dumps(obj, separators=(",", ":")).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str,
                   ctype: str = "text/plain; version=0.0.4") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> Optional[Any]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            n = -1
        if not 0 < n <= _MAX_BODY_BYTES:
            self._send_json(413, {"error": f"body length {n} out of range"})
            return None
        try:
            return json.loads(self.rfile.read(n).decode())
        except (ValueError, UnicodeDecodeError) as e:
            self._send_json(400, {"error": f"bad json: {e}"})
            return None

    def _check_versions(self, msg: Dict[str, Any]) -> bool:
        """The wire-level all-writers-upgrade-together guard (409 on skew)."""
        proto = msg.get("protocol")
        if proto != AGG_PROTOCOL:
            self._send_json(409, {
                "error": "version skew",
                "protocol": AGG_PROTOCOL,
                "client_protocol": proto,
            })
            return False
        return True

    def do_GET(self):  # noqa: N802 - http.server API
        raw_path = self.path
        path = raw_path.split("?", 1)[0].rstrip("/") or "/"
        agg = self.server.aggregator  # type: ignore[attr-defined]
        if path in ("/", "/healthz"):
            self._send_json(200, {"status": "ok", **agg.stats()})
        elif path == "/statusz":
            self._send_json(200, agg.statusz())
        elif path == "/metrics":
            self._send_text(200, agg.render_prometheus())
        elif path == "/alertz":
            self._send_json(200, agg.alertz())
        elif path == "/ringz":
            qs = parse_qs(urlparse(raw_path).query)
            self._send_json(200, agg.ringz(
                name=qs.get("name", ["*"])[0],
                instance=qs.get("instance", [""])[0] or None))
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def do_POST(self):  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0].rstrip("/")
        agg = self.server.aggregator  # type: ignore[attr-defined]
        msg = self._read_body()
        if msg is None:
            return
        if not isinstance(msg, dict):
            self._send_json(400, {"error": "body must be an object"})
            return
        if not self._check_versions(msg):
            return
        if path == "/v1/push":
            ok, detail = agg.push(msg)
            if ok:
                self._send_json(200, {"ok": True, **detail})
            else:
                self._send_json(400, {"error": detail.get("error", "bad push")})
        else:
            self._send_json(404, {"error": f"no route {path}"})


# -- the aggregator ----------------------------------------------------------


class MetricsAggregator:
    """Push-gateway + rings + SLO judgment behind a ThreadingHTTPServer.

    All state — the instance table, every merged series, every ring —
    lives under one lock, is bounded (``max_instances`` LRU-evicted by
    last push, ``max_series_per_instance`` drop-with-counter,
    ``ring_len`` points per series), and is served on:

    - ``GET /metrics``  — merged fleet exposition, every series labelled
      ``instance=…,role=…``, counters reset-corrected (monotone).
    - ``GET /statusz``  — instance table, fleet counter/gauge rollups,
      the build_info version-skew table, alert summary.
    - ``GET /alertz``   — the SLO engine's full state + history.
    - ``GET /ringz``    — raw ring points for sparklines
      (``?name=pattern&instance=…``).
    - ``POST /v1/push`` — snapshot ingestion (``AGG_PROTOCOL``).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ring_len: int = 128, max_instances: int = 64,
                 max_series_per_instance: int = 2048,
                 instance_ttl: float = 30.0,
                 slo_rules: Optional[List] = None,
                 slo_interval: float = 2.0):
        if ring_len <= 1:
            raise ValueError(f"ring_len must be > 1, got {ring_len}")
        if max_instances <= 0:
            raise ValueError(
                f"max_instances must be positive, got {max_instances}")
        self.ring_len = int(ring_len)
        self.max_instances = int(max_instances)
        self.max_series_per_instance = int(max_series_per_instance)
        self.instance_ttl = float(instance_ttl)
        self.slo_interval = float(slo_interval)
        self._lock = threading.Lock()
        self._instances: "OrderedDict[str, _Instance]" = OrderedDict()
        self._pushes = 0
        self._pushes_dropped = 0        # late/out-of-order
        self._resets = 0                # counter resets folded into base
        self._series_dropped = 0        # per-instance series cap overflow
        self._evicted_instances = 0
        self._started = time.time()
        self._slo = SloEngine(slo_rules if slo_rules is not None
                              else default_rules())
        self._alerts_fired = 0
        self._alerts_cleared = 0
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.aggregator = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._slo_stop = threading.Event()
        self._slo_thread: Optional[threading.Thread] = None

    # -- address -----------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MetricsAggregator":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.25},
            name="metrics-aggregator", daemon=True)
        self._thread.start()
        self._slo_stop.clear()
        self._slo_thread = threading.Thread(
            target=self._slo_loop, name="slo-engine", daemon=True)
        self._slo_thread.start()
        logger.info("metrics aggregator serving on %s (ring %d, "
                    "%d rules)", self.url, self.ring_len,
                    len(self._slo.rules))
        return self

    def stop(self) -> None:
        self._slo_stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._slo_thread is not None:
            self._slo_thread.join(timeout=5.0)
            self._slo_thread = None

    def __enter__(self) -> "MetricsAggregator":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- ingestion ---------------------------------------------------------

    def push(self, msg: Dict[str, Any]) -> Tuple[bool, Dict[str, Any]]:
        """Merge one snapshot; (ok, detail).  Usable in-process, no HTTP."""
        instance = msg.get("instance")
        role = msg.get("role", "")
        boot_id = msg.get("boot_id", "")
        seq = msg.get("seq")
        metrics = msg.get("metrics")
        if not isinstance(instance, str) or not instance:
            return False, {"error": "instance must be a non-empty string"}
        if not isinstance(seq, int):
            return False, {"error": "seq must be an int"}
        if not isinstance(metrics, dict):
            return False, {"error": "metrics must be an object"}
        now = time.time()
        with self._lock:
            inst = self._instances.get(instance)
            if inst is None:
                inst = _Instance(instance=instance, role=str(role))
                self._instances[instance] = inst
                while len(self._instances) > self.max_instances:
                    victim, _ = self._instances.popitem(last=False)
                    self._evicted_instances += 1
                    logger.warning("aggregator: evicted instance %s "
                                   "(max_instances=%d)", victim,
                                   self.max_instances)
            if boot_id and boot_id != inst.boot_id:
                # Restarted pusher: every cumulative series it had rolls
                # into base so the restart reads as continuation, and the
                # sequence restarts with the new life.
                if inst.boot_id:
                    for s in inst.series.values():
                        if s.tag != "gauge" and s.last:
                            s.update(s.tag, now, 0.0, 0.0, None)
                            self._resets += 1
                inst.boot_id = boot_id
                inst.seq = 0
            elif seq <= inst.seq:
                # Late or duplicated snapshot from the same life: the
                # newer state already merged; dropping keeps counters
                # from travelling backwards.
                self._pushes_dropped += 1
                inst.last_push = now
                return True, {"dropped": True, "seq": inst.seq}
            inst.seq = seq
            inst.role = str(role) or inst.role
            inst.pushes += 1
            inst.last_push = now
            self._instances.move_to_end(instance)
            self._pushes += 1
            n = 0
            for tag, key_name in (("counter", "counters"),
                                  ("gauge", "gauges"),
                                  ("histogram", "histograms")):
                for rec in metrics.get(key_name, []) or []:
                    if not isinstance(rec, dict):
                        continue
                    name = rec.get("name")
                    labels = rec.get("labels") or {}
                    if not isinstance(name, str) or not isinstance(labels, dict):
                        continue
                    key = (tag, name, _label_key(labels))
                    s = inst.series.get(key)
                    if s is None:
                        if len(inst.series) >= self.max_series_per_instance:
                            self._series_dropped += 1
                            continue
                        s = inst.series[key] = _Series(
                            tag, name, labels, self.ring_len)
                    try:
                        if tag == "histogram":
                            reset = s.update(
                                tag, now, float(rec.get("count", 0)),
                                float(rec.get("sum", 0.0)),
                                rec.get("buckets"))
                        else:
                            reset = s.update(tag, now,
                                             float(rec.get("value", 0.0)))
                    except (TypeError, ValueError):
                        continue
                    if reset:
                        self._resets += 1
                    n += 1
            return True, {"n": n, "seq": seq}

    # -- read side ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "protocol": AGG_PROTOCOL,
                "uptime_s": round(time.time() - self._started, 3),
                "instances": len(self._instances),
                "series": sum(len(i.series) for i in self._instances.values()),
                "pushes": self._pushes,
                "pushes_dropped": self._pushes_dropped,
                "resets_detected": self._resets,
                "series_dropped": self._series_dropped,
                "evicted_instances": self._evicted_instances,
                "alerts_active": len(self._slo.active()),
                "alerts_fired": self._alerts_fired,
                "alerts_cleared": self._alerts_cleared,
            }

    def _fleet_rollup(self) -> Dict[str, Dict[str, float]]:
        """Reset-corrected fleet sums by metric name (lock held)."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        for inst in self._instances.values():
            for s in inst.series.values():
                if s.tag == "counter":
                    counters[s.name] = counters.get(s.name, 0.0) + s.effective
                elif s.tag == "gauge" and s.name != "build_info":
                    gauges[s.name] = gauges.get(s.name, 0.0) + s.last
        return {"counters": counters, "gauges": gauges}

    def _version_table(self) -> Dict[str, Any]:
        """Group instances by their pushed build_info labels (lock held)."""
        builds: Dict[Tuple, List[str]] = {}
        for inst in self._instances.values():
            sig: Optional[Tuple] = None
            for s in inst.series.values():
                if s.tag == "gauge" and s.name == "build_info":
                    sig = tuple(sorted(s.labels.items()))
                    break
            builds.setdefault(sig or (("version", "unreported"),),
                              []).append(inst.instance)
        return {
            "skew": len(builds) > 1,
            "builds": [{**dict(sig), "instances": sorted(members)}
                       for sig, members in sorted(builds.items())],
        }

    def statusz(self) -> Dict[str, Any]:
        now = time.time()
        with self._lock:
            instances = [{
                "instance": i.instance,
                "role": i.role,
                "boot_id": i.boot_id,
                "seq": i.seq,
                "pushes": i.pushes,
                "age_s": round(now - i.last_push, 3) if i.last_push else None,
                "stale": bool(i.last_push
                              and now - i.last_push > self.instance_ttl),
                "n_series": len(i.series),
            } for i in self._instances.values()]
            fleet = self._fleet_rollup()
            skew = self._version_table()
        return {
            "status": "ok",
            **self.stats(),
            "instance_table": instances,
            "fleet": fleet,
            "version_skew": skew,
            "alerts": {"active": self._slo.active()},
        }

    def alertz(self) -> Dict[str, Any]:
        return self._slo.snapshot()

    def ringz(self, name: str = "*", instance: Optional[str] = None,
              max_series: int = 200) -> Dict[str, Any]:
        """Raw ring points for dashboards (histograms as _sum/_count)."""
        out: List[Dict[str, Any]] = []
        for sp in self._slo_view(name, instance=instance):
            out.append({"name": sp.name, "labels": sp.labels,
                        "points": [[round(t, 3), v] for t, v in sp.points]})
            if len(out) >= max_series:
                break
        return {"series": out, "ring_len": self.ring_len}

    def render_prometheus(self) -> str:
        """Merged fleet exposition (same grammar subset as the registry)."""

        def esc(v: str) -> str:
            return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")

        def fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
            parts = [f'{k}="{esc(v)}"' for k, v in sorted(labels.items())]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines: List[str] = []
        typed: set = set()

        def emit(tag: str, name: str, labels: Dict[str, str],
                 value: float) -> None:
            if (tag, name) not in typed:
                typed.add((tag, name))
                lines.append(f"# TYPE {name} {tag}")
            lines.append(f"{name}{fmt_labels(labels)} {value:g}")

        with self._lock:
            stats = {
                "aggregator_instances": float(len(self._instances)),
                "aggregator_series": float(sum(
                    len(i.series) for i in self._instances.values())),
            }
            rows = []
            for inst in self._instances.values():
                meta = {"instance": inst.instance, "role": inst.role}
                for s in sorted(inst.series.values(),
                                key=lambda s: (s.name, s.tag)):
                    rows.append((s.tag, s.name, {**s.labels, **meta},
                                 s.effective if s.tag == "counter" else s.last,
                                 s.effective_sum,
                                 s.effective_buckets() if s.tag == "histogram"
                                 else None,
                                 s.effective))
            pushes = float(self._pushes)
            dropped = float(self._pushes_dropped)
            resets = float(self._resets)
        for tag, name, labels, value, hsum, buckets, hcount in sorted(
                rows, key=lambda r: (r[1], r[0], sorted(r[2].items()))):
            if tag == "histogram":
                if ("histogram", name) not in typed:
                    typed.add(("histogram", name))
                    lines.append(f"# TYPE {name} histogram")
                for b, c in buckets or []:
                    le = b if isinstance(b, str) else f"{float(b):g}"
                    le_label = 'le="%s"' % le
                    lines.append(
                        f"{name}_bucket{fmt_labels(labels, le_label)} {c:g}")
                lines.append(f"{name}_sum{fmt_labels(labels)} {hsum:g}")
                lines.append(f"{name}_count{fmt_labels(labels)} {hcount:g}")
            else:
                emit(tag, name, labels, value)
        emit("counter", "aggregator_pushes_total", {}, pushes)
        emit("counter", "aggregator_pushes_dropped_total", {}, dropped)
        emit("counter", "aggregator_resets_detected_total", {}, resets)
        for gname, gval in sorted(stats.items()):
            emit("gauge", gname, {}, gval)
        return "\n".join(lines) + ("\n" if lines else "")

    # -- SLO plumbing ------------------------------------------------------

    def _slo_view(self, pattern: str,
                  instance: Optional[str] = None) -> List[SeriesPoints]:
        """Ring adapter for the SLO engine (histograms as _sum/_count)."""
        out: List[SeriesPoints] = []
        with self._lock:
            for inst in self._instances.values():
                if instance is not None and inst.instance != instance:
                    continue
                meta = {"instance": inst.instance, "role": inst.role}
                for s in inst.series.values():
                    labels = {**s.labels, **meta}
                    if s.tag == "histogram":
                        if match_series(pattern, s.name + "_sum"):
                            out.append(SeriesPoints(
                                s.name + "_sum", labels,
                                [(t, hs) for t, _, hs in s.ring]))
                        if match_series(pattern, s.name + "_count"):
                            out.append(SeriesPoints(
                                s.name + "_count", labels,
                                [(t, c) for t, c, _ in s.ring]))
                    elif match_series(pattern, s.name):
                        out.append(SeriesPoints(
                            s.name, labels, [(t, v) for t, v in s.ring]))
        return out

    def evaluate_slos(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One SLO pass; fires/clears alerts, returns the transitions.

        Called from the background loop; exposed for tests and for
        deterministic drives from the study harness.
        """
        transitions = self._slo.evaluate(self._slo_view, now=now)
        for tr in transitions:
            if tr["event"] == "fire":
                self._alerts_fired += 1
                logger.warning(
                    "SLO alert FIRING: %s [%s] subject=%s value=%.4g "
                    "(%s %s %.4g) — %s", tr["rule"], tr["severity"],
                    tr["subject"], tr["value"], tr["rule"], tr["op"],
                    tr["threshold"], tr["description"])
            else:
                self._alerts_cleared += 1
                logger.info("SLO alert cleared: %s subject=%s",
                            tr["rule"], tr["subject"])
            if _tele.enabled():
                _tele.emit_record({
                    "type": "alert",
                    "event": tr["event"],
                    "rule": tr["rule"],
                    "severity": tr["severity"],
                    "subject": tr["subject"],
                    "value": tr["value"],
                    "threshold": tr["threshold"],
                    "transition_seq": tr["transition_seq"],
                    "firing_since": tr["firing_since"],
                    "t": tr["t"],
                })
        return transitions

    def _slo_loop(self) -> None:
        while not self._slo_stop.wait(self.slo_interval):
            try:
                self.evaluate_slos()
            except Exception:  # noqa: BLE001 - judgment must not kill serving
                logger.exception("SLO evaluation pass failed")


# -- the pusher --------------------------------------------------------------


class TelemetryPusher:
    """Background snapshot pusher with the ONE-degraded-event contract.

    A daemon thread ships ``DeltaSnapshotter.collect()`` every
    ``interval`` seconds.  Failures mark the aggregator down for
    ``cooldown`` seconds (no socket is touched during the window), emit
    exactly ONE ``aggregator_degraded`` telemetry event per up→down
    transition, and schedule a *full* snapshot for the next successful
    push — the aggregator may have restarted empty, and deltas alone
    would leave it blind to quiet series.  Nothing here ever raises into
    the caller and nothing here touches the search RNG.
    """

    def __init__(self, url: str, role: str, instance: Optional[str] = None,
                 interval: float = 2.0, timeout: float = 2.0,
                 cooldown: float = 5.0, full_every: int = 15,
                 registry: Optional[MetricsRegistry] = None):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        if full_every < 1:
            raise ValueError(f"full_every must be >= 1, got {full_every}")
        self.url = parse_aggregator_url(url)
        self.instance = instance or f"{socket.gethostname()}:{os.getpid()}"
        self.interval = float(interval)
        self.timeout = float(timeout)
        self.cooldown = float(cooldown)
        self._registry = registry if registry is not None else get_registry()
        self._delta = DeltaSnapshotter(self._registry)
        self._roles = [role]
        self._boot_id = uuid4().hex
        self._seq = 0
        self._full_next = True
        self.full_every = int(full_every)
        self._since_full = 0
        self._down_until = 0.0
        self._degraded = False
        self._degraded_total = 0
        self._pushes_ok = 0
        self._pushes_failed = 0
        self._lock = threading.Lock()
        self._push_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._refs = 1  # managed by acquire_pusher/release_pusher

    # -- roles -------------------------------------------------------------

    @property
    def role(self) -> str:
        with self._lock:
            return "+".join(self._roles)

    def add_role(self, role: str) -> None:
        with self._lock:
            if role not in self._roles:
                self._roles.append(role)

    # -- availability ------------------------------------------------------

    def available(self) -> bool:
        with self._lock:
            return time.monotonic() >= self._down_until

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def _mark_down(self, err: Exception) -> None:
        with self._lock:
            self._down_until = time.monotonic() + self.cooldown
            first = not self._degraded
            self._degraded = True
            self._degraded_total += 1
            self._full_next = True  # it may come back empty: resend all
        if first:
            logger.warning(
                "metrics aggregator %s unreachable (%s); pushing pauses, "
                "retrying every %.1fs — the search is not affected",
                self.url, err, self.cooldown)
            _tele.record_event("aggregator_degraded", {
                "url": self.url, "instance": self.instance,
                "error": str(err)[:200],
            })
            if _tele.enabled():
                self._registry.counter("aggregator_degraded_total").inc()

    def _mark_up(self) -> None:
        with self._lock:
            was = self._degraded
            self._degraded = False
        if was:
            logger.info("metrics aggregator %s reachable again", self.url)

    # -- push --------------------------------------------------------------

    def _build_payload(self) -> Dict[str, Any]:
        """One wire snapshot; memoized deltas unless a full resend is due.

        Every ``full_every``-th push resends the complete snapshot even
        when nothing changed: quiet series keep receiving ring points on
        the aggregator (a firing SLO over a series that simply stopped
        moving must be able to observe the flatline and self-clear), and
        an aggregator that silently lost state re-learns it within one
        heartbeat cycle.
        """
        with self._lock:
            self._since_full += 1
            full = self._full_next or self._since_full >= self.full_every
            if full:
                self._since_full = 0
            self._full_next = False
            self._seq += 1
            seq = self._seq
            role = "+".join(self._roles)
        return {
            "v": 1,
            "protocol": AGG_PROTOCOL,
            "instance": self.instance,
            "role": role,
            "boot_id": self._boot_id,
            "seq": seq,
            "t": time.time(),
            "metrics": self._delta.collect(full=full),
        }

    def push_once(self) -> bool:
        """One push attempt now (degradation-safe); True on success."""
        if not self.available():
            return False
        with self._push_lock:
            payload = self._build_payload()
            req = urllib.request.Request(
                self.url + "/v1/push",
                data=json.dumps(payload, separators=(",", ":")).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    json.loads(resp.read().decode())
            except Exception as e:  # noqa: BLE001 - degradation boundary
                # The delta state already advanced; resend everything on
                # recovery so the lost snapshot cannot leave holes.
                self._mark_down(e)
                with self._lock:
                    self._pushes_failed += 1
                return False
            self._mark_up()
            with self._lock:
                self._pushes_ok += 1
            return True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.push_once()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "TelemetryPusher":
        set_build_info(self._registry)
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="telemetry-pusher", daemon=True)
            self._thread.start()
        return self

    def flush(self, timeout: float = 2.0) -> bool:
        """Synchronous best-effort push (run boundaries, tests)."""
        old = self.timeout
        self.timeout = min(old, timeout) if timeout else old
        try:
            return self.push_once()
        finally:
            self.timeout = old

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if flush:
            self.push_once()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "url": self.url,
                "instance": self.instance,
                "role": "+".join(self._roles),
                "seq": self._seq,
                "degraded": self._degraded,
                "degraded_total": self._degraded_total,
                "pushes_ok": self._pushes_ok,
                "pushes_failed": self._pushes_failed,
            }


# -- per-process pusher registry ---------------------------------------------

_PUSHER_LOCK = threading.Lock()
_ACTIVE_PUSHERS: Dict[str, TelemetryPusher] = {}


def acquire_pusher(url: str, role: str, instance: Optional[str] = None,
                   interval: Optional[float] = None,
                   **kw: Any) -> TelemetryPusher:
    """Get-or-create the process's pusher for ``url`` (refcounted).

    The master and its in-process broker share one metrics registry;
    if each started its own pusher the fleet rollup would double-count
    every counter in the process.  Sharing one pusher per URL (roles
    merging into the ``role`` label) is what keeps instance == process.

    Cadence defaults come from the environment when not passed — the
    wiring call sites (broker/master/worker) never hardcode a rhythm, so
    seconds-long drills and studies can compress the push/heartbeat
    cadence fleet-wide without touching the dispatch plane:

    - ``GENTUN_TPU_AGG_PUSH_INTERVAL`` (seconds, default 2.0)
    - ``GENTUN_TPU_AGG_FULL_EVERY`` (pushes per heartbeat full resend,
      default 15)
    """
    if interval is None:
        interval = float(os.environ.get("GENTUN_TPU_AGG_PUSH_INTERVAL", "2.0"))
    if "full_every" not in kw and "GENTUN_TPU_AGG_FULL_EVERY" in os.environ:
        kw["full_every"] = int(os.environ["GENTUN_TPU_AGG_FULL_EVERY"])
    key = parse_aggregator_url(url)
    with _PUSHER_LOCK:
        p = _ACTIVE_PUSHERS.get(key)
        if p is not None:
            p._refs += 1
            p.add_role(role)
            return p
        p = TelemetryPusher(key, role, instance=instance,
                            interval=interval, **kw)
        _ACTIVE_PUSHERS[key] = p
        p.start()
        return p


def release_pusher(pusher: TelemetryPusher, flush: bool = True) -> None:
    """Drop one reference; the last release stops (and flushes) it."""
    with _PUSHER_LOCK:
        pusher._refs -= 1
        if pusher._refs > 0:
            return
        _ACTIVE_PUSHERS.pop(pusher.url, None)
    pusher.stop(flush=flush)


def flush_active_pushers(timeout: float = 2.0) -> None:
    """Best-effort immediate push from every live pusher (run boundaries)."""
    with _PUSHER_LOCK:
        pushers = list(_ACTIVE_PUSHERS.values())
    for p in pushers:
        p.flush(timeout=timeout)


# -- standalone entrypoint ---------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m gentun_tpu_torch.telemetry.aggregator`` — run a fleet aggregator."""
    ap = argparse.ArgumentParser(
        prog="gentun-aggregator",
        description="Fleet metrics aggregation + SLO/alerting plane")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9100)
    ap.add_argument("--ring-len", type=int, default=128,
                    help="time-series points kept per series")
    ap.add_argument("--max-instances", type=int, default=64)
    ap.add_argument("--instance-ttl", type=float, default=30.0,
                    help="seconds without a push before an instance "
                         "reads as stale on /statusz")
    ap.add_argument("--slo-interval", type=float, default=2.0)
    ap.add_argument("--slo-scale", type=float, default=1.0,
                    help="shrink every SLO window/hold by this factor "
                         "(drills; production keeps 1.0)")
    args = ap.parse_args(argv)
    try:
        rules = default_rules(scale=args.slo_scale)
        agg = MetricsAggregator(
            host=args.host, port=args.port, ring_len=args.ring_len,
            max_instances=args.max_instances,
            instance_ttl=args.instance_ttl,
            slo_rules=rules, slo_interval=args.slo_interval)
    except ValueError as e:
        raise SystemExit(f"aggregator: {e}")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    agg.start()
    print(f"aggregator serving on {agg.url} "
          f"(/metrics /statusz /alertz /ringz)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        agg.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
