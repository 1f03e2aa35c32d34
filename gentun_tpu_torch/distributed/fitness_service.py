"""Networked shared fitness memoization: never train a genome twice,
fleet-wide.

``utils/fitness_store.py`` already carries measurements across runs via a
shared JSON file — but a file only reaches processes that mount it.  This
module promotes the store to a small network service so *concurrent*
searches, elastic worker fleets, and sequential experiments on different
machines share one content-addressed genome→fitness cache (cross-run
dedup is "the cheapest throughput there is"; ASHA — Li et al.
2020 — is likewise built around a shared state service feeding an elastic
worker pool).

Three pieces, all stdlib:

- :class:`FitnessService` — a ``ThreadingHTTPServer`` daemon (the
  ``telemetry/ops_server.py`` pattern) holding a bounded LRU of
  ``digest:fingerprint → fitness``.  Entries are addressed by
  ``fitness_store.key_digest`` (64-bit blake2b of the canonical key JSON,
  the 64-bit hash width) **plus** the fidelity fingerprint
  (``fitness_store._key_fingerprint``), so a rung-0 proxy measurement can
  never answer a full-schedule lookup.  Requests carry ``STORE_VERSION``
  and ``FITNESS_PROTOCOL``; a mismatch is refused with HTTP 409 — the same
  all-writers-upgrade-together guard as the file store, enforced at the
  wire instead of at the file.
- :class:`FitnessServiceClient` — read-through lookups and write-behind
  publishes over plain ``urllib``.  Any network failure marks the service
  degraded for a cooldown window: the caller gets a miss (→ local-only
  operation), a ``fitness_service_degraded`` telemetry event records the
  transition, and the search NEVER sees an exception — cache downtime
  must not fail a search, exactly like a corrupt store file.
- :class:`ServiceBackedCache` — a ``dict`` subclass that layers the
  service over any local fitness cache.  Populations and engines consult
  ``fitness_cache`` via ``in``/``[]``/``.get`` and write via ``[k] = v``;
  overriding exactly those four operations extends the dispatch-side
  dedup through the service: a genome another run already measured
  completes instantly (never dispatched), and every new measurement is
  published for the next run.  In-flight *follower* attachment stays
  within one run — two runs evaluating the same genome at the same moment
  cost at most one duplicate training, after which both publish the same
  pure-function fitness.

Like the ops endpoints, the service is unauthenticated and binds
127.0.0.1 by default; bind a routable address only on a trusted network.
Run it standalone with ``python -m gentun_tpu_torch.distributed.fitness_service
--port 9736``, or in-process via ``FitnessService(...).start()``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from ..telemetry import lineage as _lineage
from ..telemetry import spans as _tele
from ..telemetry.registry import get_registry as _get_registry
from ..utils.fitness_store import (
    FITNESS_PROTOCOL,
    STORE_VERSION,
    _key_fingerprint,
    is_serializable_key,
    key_digest,
)

__all__ = [
    "FitnessService",
    "FitnessServiceClient",
    "ServiceBackedCache",
    "parse_cache_url",
    "wire_key",
]

logger = logging.getLogger("gentun_tpu_torch.distributed")

#: Request-body ceiling, matching the broker's frame ceiling: a publish
#: batch is never larger than one jobs window's worth of results.
_MAX_BODY_BYTES = 4 * 1024 * 1024


def parse_cache_url(url: str) -> str:
    """Validate a ``--cache-url`` value; returns it normalized.

    Raises ``ValueError`` with an operator-readable message on anything
    that is not ``http://host:port[/]`` — the worker CLI converts that to
    a loud ``SystemExit`` (a typo'd URL must not silently degrade a whole
    fleet to local-only caching).
    """
    parsed = urlparse(url)
    if parsed.scheme not in ("http", "https"):
        raise ValueError(
            f"cache url {url!r}: scheme must be http or https "
            f"(got {parsed.scheme or 'none'!r})")
    if not parsed.hostname:
        raise ValueError(f"cache url {url!r}: missing host")
    if parsed.port is None:
        raise ValueError(f"cache url {url!r}: missing port")
    if parsed.path not in ("", "/") or parsed.query or parsed.fragment:
        raise ValueError(
            f"cache url {url!r}: must be scheme://host:port with no "
            "path/query (endpoints are appended by the client)")
    return f"{parsed.scheme}://{parsed.hostname}:{parsed.port}"


def wire_key(key: Any) -> Optional[str]:
    """``digest:fingerprint`` service address for a cache key.

    None for keys that don't survive JSON (same skip rule as the file
    store — a dropped entry only costs a retrain).  The fingerprint rides
    in the address itself, so fidelity isolation needs no server logic:
    proxy and full-schedule measurements of one genome are simply two
    different entries.
    """
    if not is_serializable_key(key):
        return None
    return f"{key_digest(key)}:{_key_fingerprint(key)}"


class _Handler(BaseHTTPRequestHandler):
    """Request handler; ``self.server.service`` is the FitnessService."""

    server_version = "gentun-fitness/1"
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
        version, proto = msg.get("version"), msg.get("protocol")
        if version != STORE_VERSION or proto != FITNESS_PROTOCOL:
            self._send_json(409, {
                "error": "version skew",
                "version": STORE_VERSION,
                "protocol": FITNESS_PROTOCOL,
                "client_version": version,
                "client_protocol": proto,
            })
            return False
        return True

    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        svc = self.server.service  # type: ignore[attr-defined]
        if path in ("/", "/healthz"):
            self._send_json(200, {"status": "ok", **svc.stats()})
        elif path == "/statusz":
            self._send_json(200, svc.stats())
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def do_POST(self):  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0].rstrip("/")
        svc = self.server.service  # type: ignore[attr-defined]
        msg = self._read_body()
        if msg is None:
            return
        if not isinstance(msg, dict) or not self._check_versions(msg):
            if not isinstance(msg, dict):
                self._send_json(400, {"error": "body must be an object"})
            return
        if path == "/v1/lookup":
            keys = msg.get("keys")
            if not isinstance(keys, list):
                self._send_json(400, {"error": "keys must be a list"})
                return
            self._send_json(200, {"hits": svc.lookup(keys)})
        elif path == "/v1/publish":
            entries = msg.get("entries")
            if not isinstance(entries, list):
                self._send_json(400, {"error": "entries must be a list"})
                return
            self._send_json(200, {"stored": svc.publish(entries)})
        elif path == "/v1/dataset/publish":
            space, rows = msg.get("space"), msg.get("rows")
            if not isinstance(space, str) or not isinstance(rows, list):
                self._send_json(400, {"error": "space must be a string and "
                                               "rows a list"})
                return
            self._send_json(200, {"stored": svc.publish_dataset(space, rows)})
        elif path == "/v1/dataset/fetch":
            space = msg.get("space")
            if not isinstance(space, str):
                self._send_json(400, {"error": "space must be a string"})
                return
            self._send_json(200, {
                "rows": svc.fetch_dataset(space, msg.get("limit"))})
        else:
            self._send_json(404, {"error": f"no route {path}"})


class FitnessService:
    """Bounded-LRU genome→fitness cache behind a ThreadingHTTPServer.

    State is a single ``OrderedDict`` under one lock — lookups
    ``move_to_end`` (recently *used* survives, not just recently
    written) and publishes evict from the cold end past ``max_entries``.
    Counters (hits/misses/evictions/puts) are served on ``/statusz`` and,
    when telemetry is enabled in the hosting process, mirrored to the
    metrics registry as ``fitness_service_{hits,misses,evictions}_total``
    so an in-process service surfaces on the master's ``/metrics``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_entries: int = 100_000, max_dataset_rows: int = 50_000):
        if max_entries <= 0:
            raise ValueError(f"max_entries must be positive, got {max_entries}")
        self.max_entries = int(max_entries)
        self.max_dataset_rows = int(max_dataset_rows)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, float]" = OrderedDict()
        # Surrogate training rows, keyed (space, genome, rung) so
        # re-publishes dedup — the side table the rung −1 gate warm-starts
        # from and syncs with at refit boundaries (surrogate.py).  Bounded
        # like the fitness table: oldest rows fall off fleet-wide.
        self._dataset: "OrderedDict[Tuple[str, str, int], Dict[str, Any]]" = OrderedDict()
        self._dataset_puts = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._puts = 0
        self._started = time.time()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.service = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    # -- address -----------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FitnessService":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.25},
            name="fitness-service", daemon=True)
        self._thread.start()
        logger.info("fitness service serving on %s (max %d entries)",
                    self.url, self.max_entries)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- cache ops (also usable in-process, no HTTP) -----------------------

    def lookup(self, keys: List[Any]) -> Dict[str, float]:
        hits: Dict[str, float] = {}
        n_miss = 0
        with self._lock:
            for k in keys:
                if isinstance(k, str) and k in self._entries:
                    self._entries.move_to_end(k)
                    hits[k] = self._entries[k]
                else:
                    n_miss += 1
            self._hits += len(hits)
            self._misses += n_miss
        if _tele.enabled():
            reg = _get_registry()
            if hits:
                reg.counter("fitness_service_hits_total").inc(len(hits))
            if n_miss:
                reg.counter("fitness_service_misses_total").inc(n_miss)
        return hits

    def publish(self, entries: List[Any]) -> int:
        stored = 0
        evicted = 0
        with self._lock:
            for entry in entries:
                if (not isinstance(entry, (list, tuple)) or len(entry) != 2
                        or not isinstance(entry[0], str)):
                    continue
                k, v = entry
                try:
                    self._entries[k] = float(v)
                except (TypeError, ValueError):
                    continue
                self._entries.move_to_end(k)
                stored += 1
            self._puts += stored
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                evicted += 1
            self._evictions += evicted
        if evicted and _tele.enabled():
            _get_registry().counter("fitness_service_evictions_total").inc(evicted)
        return stored

    def publish_dataset(self, space: str, rows: List[Any]) -> int:
        """Store surrogate training rows under a per-tenant space key.

        A row is ``{"genome": key, "genes": {...}, "rung": r,
        "fitness": f}``; the service treats ``genes`` opaquely (each
        master re-encodes with its own feature map), validating only the
        dedup key and the label.  Rows keyed ``(space, genome, rung)``,
        latest measurement wins."""
        stored = 0
        with self._lock:
            for row in rows:
                if not isinstance(row, dict):
                    continue
                genome = row.get("genome")
                if not isinstance(genome, str) or not isinstance(
                        row.get("genes"), dict):
                    continue
                try:
                    rung = int(row.get("rung", 0))
                    fitness = float(row["fitness"])
                except (KeyError, TypeError, ValueError):
                    continue
                key = (str(space), genome, rung)
                self._dataset[key] = {"genome": genome, "genes": row["genes"],
                                      "rung": rung, "fitness": fitness}
                self._dataset.move_to_end(key)
                stored += 1
            self._dataset_puts += stored
            while len(self._dataset) > self.max_dataset_rows:
                self._dataset.popitem(last=False)
        return stored

    def fetch_dataset(self, space: str, limit: Any = None) -> List[Dict[str, Any]]:
        """The space's rows, oldest first (a bounded trainer keeps the
        freshest when it truncates from the front)."""
        try:
            cap = None if limit is None else max(0, int(limit))
        except (TypeError, ValueError):
            cap = None
        with self._lock:
            rows = [row for (sp, _, _), row in self._dataset.items()
                    if sp == space]
        if cap is not None and len(rows) > cap:
            rows = rows[-cap:]
        return rows

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "dataset_rows": len(self._dataset),
                "dataset_puts": self._dataset_puts,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "puts": self._puts,
                "uptime_s": round(time.time() - self._started, 3),
                "version": STORE_VERSION,
                "protocol": FITNESS_PROTOCOL,
            }


class FitnessServiceClient:
    """Read-through lookups + write-behind publishes, degradation-safe.

    Every network failure (refused, timeout, 5xx, version skew) marks the
    service down for ``cooldown`` seconds: during the window lookups
    return misses and publishes queue (bounded) without touching the
    socket, so a dead service costs one timeout per cooldown — not one
    per genome.  The down transition emits ONE ``fitness_service_degraded``
    telemetry event and a warning; recovery logs at info.  Nothing in
    this class ever raises into the caller.
    """

    def __init__(self, url: str, timeout: float = 2.0, cooldown: float = 5.0,
                 max_pending: int = 10_000):
        self.url = parse_cache_url(url)
        self.timeout = float(timeout)
        self.cooldown = float(cooldown)
        self._down_until = 0.0
        self._degraded = False
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._degraded_total = 0
        # Write-behind: measurements queue here and a daemon flusher ships
        # them in batches, so a publish never adds an RTT to the search
        # loop.  Bounded: when the service is down for a whole run the
        # queue drops oldest-first (those entries simply stay local).
        self._pending: deque = deque(maxlen=max_pending)
        self._wake = threading.Event()
        self._closed = False
        self._flusher: Optional[threading.Thread] = None

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
        if first:
            logger.warning(
                "fitness service %s unreachable (%s); degrading to "
                "local-only caching, retrying every %.1fs — the search "
                "continues, new measurements stay local until it returns",
                self.url, err, self.cooldown)
            _tele.record_event("fitness_service_degraded", {
                "url": self.url, "error": str(err)[:200],
            })
            if _tele.enabled():
                _get_registry().counter("fitness_service_degraded_total").inc()

    def _mark_up(self) -> None:
        with self._lock:
            was = self._degraded
            self._degraded = False
        if was:
            logger.info("fitness service %s reachable again", self.url)

    # -- http --------------------------------------------------------------

    def _post(self, endpoint: str, payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        body = dict(payload)
        body["v"] = 1
        body["version"] = STORE_VERSION
        body["protocol"] = FITNESS_PROTOCOL
        req = urllib.request.Request(
            self.url + endpoint,
            data=json.dumps(body, separators=(",", ":")).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read().decode())
            self._mark_up()
            return out
        except Exception as e:  # noqa: BLE001 - degradation boundary by design
            self._mark_down(e)
            return None

    # -- API ---------------------------------------------------------------

    def lookup(self, keys: List[str]) -> Dict[str, float]:
        """``{wire_key: fitness}`` for the hits; {} on miss or degradation."""
        if not keys or not self.available():
            return {}
        out = self._post("/v1/lookup", {"keys": list(keys)})
        if out is None:
            return {}
        hits = out.get("hits")
        if not isinstance(hits, dict):
            return {}
        clean: Dict[str, float] = {}
        for k, v in hits.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        with self._lock:
            self._hits += len(clean)
            self._misses += len(keys) - len(clean)
        return clean

    def publish_dataset(self, space: str, rows: List[Dict[str, Any]]) -> Optional[int]:
        """Ship surrogate training rows; ``None`` on degradation/failure.

        Synchronous by design — the rung −1 gate calls this only at refit
        boundaries (every ``refit_every`` completions), never on the
        score-on-breed hot path, and it needs the verdict to decide
        whether to degrade to admit-all (surrogate.py)."""
        if not self.available():
            return None
        out = self._post("/v1/dataset/publish",
                         {"space": str(space), "rows": list(rows)})
        if out is None:
            return None
        try:
            return int(out.get("stored", 0))
        except (TypeError, ValueError):
            return 0

    def fetch_dataset(self, space: str,
                      limit: Optional[int] = None) -> Optional[List[Dict[str, Any]]]:
        """The space's training rows; ``None`` on degradation/failure
        (distinct from ``[]``, a healthy-but-empty space)."""
        if not self.available():
            return None
        payload: Dict[str, Any] = {"space": str(space)}
        if limit is not None:
            payload["limit"] = int(limit)
        out = self._post("/v1/dataset/fetch", payload)
        if out is None:
            return None
        rows = out.get("rows")
        return rows if isinstance(rows, list) else []

    def publish(self, entries: List[Tuple[str, float]]) -> None:
        """Queue entries for the write-behind flusher (never blocks)."""
        if not entries or self._closed:
            return
        self._pending.extend(entries)
        if self._flusher is None:
            with self._lock:
                if self._flusher is None and not self._closed:
                    self._flusher = threading.Thread(
                        target=self._flush_loop, name="fitness-publish",
                        daemon=True)
                    self._flusher.start()
        self._wake.set()

    def _drain_batch(self, cap: int = 512) -> List[Tuple[str, float]]:
        batch: List[Tuple[str, float]] = []
        while self._pending and len(batch) < cap:
            try:
                batch.append(self._pending.popleft())
            except IndexError:  # pragma: no cover - racing producer
                break
        return batch

    def _flush_loop(self) -> None:
        while True:
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            if self._closed and not self._pending:
                return
            if not self._pending:
                continue
            if not self.available():
                if self._closed:
                    return  # closing while degraded: entries stay local
                time.sleep(min(0.5, self.cooldown))
                continue
            batch = self._drain_batch()
            if batch and self._post(
                    "/v1/publish",
                    {"entries": [[k, float(v)] for k, v in batch]}) is None:
                # Failed mid-flight: requeue so a transient blip doesn't
                # drop measurements (deque maxlen bounds the worst case).
                self._pending.extendleft(reversed(batch))

    def flush(self, timeout: float = 5.0) -> bool:
        """Best-effort wait for the write-behind queue to drain."""
        deadline = time.monotonic() + timeout
        self._wake.set()
        while self._pending and time.monotonic() < deadline:
            if not self.available():
                return False
            time.sleep(0.02)
        return not self._pending

    def close(self, flush_timeout: float = 2.0) -> None:
        """Flush what we can, then stop the flusher thread."""
        self.flush(timeout=flush_timeout)
        self._closed = True
        self._wake.set()
        t = self._flusher
        if t is not None:
            t.join(timeout=1.0)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self._hits + self._misses
            return {
                "url": self.url,
                "hits": self._hits,
                "misses": self._misses,
                "hit_rate": round(self._hits / total, 4) if total else None,
                "degraded": self._degraded,
                "degraded_total": self._degraded_total,
                "pending_publish": len(self._pending),
            }


class ServiceBackedCache(dict):
    """A fitness cache that reads through to, and publishes to, the service.

    Drop-in for any ``Population.fitness_cache`` (it IS a dict, so
    checkpoints iterate it and ``clone_with`` shares it by identity
    unchanged).  Local entries always win — the service is only consulted
    on a local miss, and every hit is adopted locally so the second
    touch of a key never pays an RTT.  Writes go local first, then to the
    write-behind queue.  Only JSON-serializable keys ever reach the wire;
    the rest behave exactly like a plain dict entry.

    Client-side hit/miss counters land in the metrics registry
    (``fitness_service_{hits,misses}_total``) when telemetry is on, so
    the MASTER's ``/metrics`` and ``/statusz`` show its own hit rate even
    when the service runs on another machine.
    """

    def __init__(self, client: FitnessServiceClient,
                 seed: Optional[Dict[Any, float]] = None,
                 namespace: Optional[str] = None):
        super().__init__(seed or {})
        self.client = client
        self.namespace = str(namespace) if namespace else None
        self._wire_keys: Dict[Any, Optional[str]] = {}

    def _wire_key(self, key: Any) -> Optional[str]:
        try:
            wk = self._wire_keys[key]
        except KeyError:
            wk = wire_key(key)
            # An explicit namespace opts a tenant OUT of cross-tenant
            # dedup: its service entries live under a disjoint key prefix.
            # Default (None) keeps content-addressed sharing on.
            if wk is not None and self.namespace is not None:
                wk = f"{self.namespace}/{wk}"
            self._wire_keys[key] = wk
        except TypeError:  # unhashable key: nothing upstream produces one,
            return None    # but a cache must never crash a search
        return wk

    def _service_get(self, key: Any):
        """Service lookup on local miss → fitness or None; adopts hits."""
        wk = self._wire_key(key)
        if wk is None:
            return None
        hits = self.client.lookup([wk])
        if _tele.enabled():
            reg = _get_registry()
            if wk in hits:
                reg.counter("fitness_service_hits_total").inc()
            else:
                reg.counter("fitness_service_misses_total").inc()
        if wk in hits:
            fitness = float(hits[wk])
            super().__setitem__(key, fitness)
            # Lineage: a service hit means some OTHER search already paid
            # for this training — identity here is the wire key (the
            # fitness-cache content address), not genome_key.
            _lineage.record("cache_hit", wk, source="service")
            return fitness
        return None

    # -- the four operations populations/engines actually use --------------

    def __contains__(self, key: Any) -> bool:
        if super().__contains__(key):
            return True
        return self._service_get(key) is not None

    def get(self, key: Any, default: Any = None) -> Any:
        if super().__contains__(key):
            return super().__getitem__(key)
        hit = self._service_get(key)
        return default if hit is None else hit

    def __getitem__(self, key: Any) -> Any:
        if super().__contains__(key):
            return super().__getitem__(key)
        hit = self._service_get(key)
        if hit is None:
            raise KeyError(key)
        return hit

    def __setitem__(self, key: Any, value: Any) -> None:
        super().__setitem__(key, float(value))
        wk = self._wire_key(key)
        if wk is not None:
            self.client.publish([(wk, float(value))])

    def rebase(self, mapping: Dict[Any, float]) -> None:
        """Replace local contents, keep the service backing (checkpoint
        resume rebuilds ``fitness_cache`` from the saved state; without
        this hook the restore would silently discard the service layer)."""
        super().clear()
        super().update(mapping)

    def stats(self) -> Dict[str, Any]:
        return {**self.client.stats(), "local_entries": len(self)}


def main(argv=None) -> int:
    """Standalone service: ``python -m gentun_tpu_torch.distributed.fitness_service``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m gentun_tpu_torch.distributed.fitness_service",
        description="shared genome→fitness memoization service "
                    "(point masters/workers at it with --cache-url)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address (default 127.0.0.1; the endpoints "
                         "are unauthenticated — bind a routable address "
                         "only on a trusted network)")
    ap.add_argument("--port", type=int, default=9736,
                    help="listen port (0 picks an ephemeral port, logged)")
    ap.add_argument("--max-entries", type=int, default=100_000,
                    help="LRU capacity before cold entries evict")
    args = ap.parse_args(argv)
    if not 0 <= args.port <= 65535:
        raise SystemExit(f"--port must be in [0, 65535], got {args.port}")
    if args.max_entries <= 0:
        raise SystemExit(f"--max-entries must be positive, got {args.max_entries}")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    svc = FitnessService(host=args.host, port=args.port,
                         max_entries=args.max_entries).start()
    print(f"fitness service on {svc.url} (ctrl-C to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        svc.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
