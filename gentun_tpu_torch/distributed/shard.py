"""Horizontal broker sharding: consistent-hash session placement.

PERF.md's "control plane headroom" pins the fleet's scaling wall: ONE
broker process moves ~1-3k job round-trips/sec, and every earlier win
(wire fast path, compile cache, autoscaler) still funnels through that
single asyncio loop.  This module multiplies the ceiling horizontally
instead of optimizing the loop further: N independent ``JobBroker``
processes ("shards") share one fleet, and *sessions* — the unit of
tenancy since the multi-tenant PR — are placed on shards by consistent
hashing, so each search talks to exactly one broker and the shards never
coordinate.  Li et al. (ASHA, MLSys 2020) shows search throughput at
scale is gated by the dispatch plane, not the accelerators; Real et al.
(ICML 2017) scaled evolution precisely by removing central coordination
— sharding the broker is this codebase's version of both.

Placement rule (DISTRIBUTED.md "Horizontal broker sharding"):

- :class:`ShardRing` is a consistent-hash ring with virtual nodes.  A
  session's **home shard** is ``ring.home(session_id)`` — deterministic
  across processes (the hash is :func:`hashlib.blake2b`, never Python's
  per-process-salted ``hash``), so a master, a reconnecting master, and
  an operator's ``gentun_top`` all compute the same placement without a
  directory service.
- Adding/removing a shard moves only ~1/N of the sessions (the virtual
  nodes bound the imbalance); :class:`ShardRouter` tracks live
  placements and counts the moves (``shard_rebalances_total``).
- Everything below the session is unchanged: each shard keeps its OWN
  journal, epoch, and admission bucket, so crash safety and back-pressure
  compose with sharding for free.

:class:`ShardedBroker` is the master-side facade: the ``JobBroker`` API
subset ``DistributedPopulation`` uses, implemented over wire
:class:`~.sessions.SessionClient` connections (one per shard, lazily
dialed).  Failover rides the reconnect/journal path — a killed
shard's sessions re-attach after restart and its journal re-adopts every
in-flight job; submits that hit the outage window retry until the
reconnect window closes.  Workers multi-home separately (one
``GentunClient`` holds a connection per shard — ``client.py``).

Single-URL deployments never reach this module's routing: a one-element
``broker_urls`` collapses to the exact host/port code path, wire
byte-identical to today (asserted by ``scripts/shard_study.py``).
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid
from bisect import bisect_right
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..telemetry.registry import get_registry as _get_registry

__all__ = [
    "parse_broker_urls",
    "shard_id",
    "ShardRing",
    "ShardRouter",
    "ShardedBroker",
]


def parse_broker_urls(urls: Iterable[Any]) -> List[Tuple[str, int]]:
    """Normalize a ``broker_urls`` list to ``[(host, port), ...]``.

    Accepts ``"host:port"`` strings (an optional ``tcp://`` scheme is
    tolerated) and ``(host, port)`` pairs.  Order is preserved — it is
    part of the ring identity, so every participant must pass the same
    list — and duplicates or malformed entries raise ``ValueError``
    loudly: a typo'd shard list that silently half-works would place
    sessions on brokers nobody is running.
    """
    addrs: List[Tuple[str, int]] = []
    seen = set()
    for url in urls:
        if isinstance(url, (tuple, list)) and len(url) == 2:
            host, port = str(url[0]), url[1]
        elif isinstance(url, str):
            u = url[6:] if url.startswith("tcp://") else url
            host, _, port = u.rpartition(":")
            if not host:
                raise ValueError(f"broker url {url!r} is not 'host:port'")
        else:
            raise ValueError(f"broker url {url!r} is not 'host:port' or (host, port)")
        try:
            port = int(port)
        except (TypeError, ValueError):
            raise ValueError(f"broker url {url!r} has a non-integer port")
        if not host or not 0 < port < 65536:
            raise ValueError(f"broker url {url!r} is not 'host:port'")
        key = (host, port)
        if key in seen:
            raise ValueError(f"duplicate broker url {host}:{port}")
        seen.add(key)
        addrs.append(key)
    if not addrs:
        raise ValueError("broker_urls is empty")
    return addrs


def shard_id(addr: Tuple[str, int]) -> str:
    """The canonical shard label (``"host:port"``) for an address — the
    ring member id, the ``shard_sessions{shard=...}`` label, and the
    gentun_top panel row key."""
    return f"{addr[0]}:{addr[1]}"


def _point(key: str) -> int:
    """Stable 64-bit ring coordinate.  blake2b, NOT ``hash()``: Python's
    string hash is salted per process, and two processes disagreeing on a
    session's home would split one search across two brokers."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class ShardRing:
    """Consistent-hash ring with virtual nodes.

    Each shard owns ``vnodes`` points on a 64-bit ring; a key's home is
    the first shard point at or clockwise-after the key's own point.
    Virtual nodes smooth the arc lengths so the per-shard session load is
    near-uniform, and membership changes move only the arcs adjacent to
    the changed shard's points (~1/N of all keys).

    Routing (:meth:`home`) is a hash + ``bisect`` over a flat sorted
    array — micro-gated at ≤2% of per-job dispatch cost by
    ``scripts/broker_throughput.py::run_shard_route_gate`` (and routing
    runs per *session placement*, not per job, so the gate is a worst
    case bound).
    """

    def __init__(self, shards: Sequence[str], vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        if not shards:
            raise ValueError("ring needs at least one shard")
        self._vnodes = int(vnodes)
        self._shards: List[str] = []
        self._points: List[int] = []
        self._owners: List[str] = []
        for shard in shards:
            self.add(str(shard))

    # -- membership --------------------------------------------------------

    @property
    def shards(self) -> List[str]:
        return list(self._shards)

    def add(self, shard: str) -> None:
        shard = str(shard)
        if shard in self._shards:
            raise ValueError(f"shard {shard!r} already on the ring")
        self._shards.append(shard)
        self._rebuild()

    def remove(self, shard: str) -> None:
        shard = str(shard)
        if shard not in self._shards:
            raise ValueError(f"shard {shard!r} not on the ring")
        self._shards.remove(shard)
        self._rebuild()

    def _rebuild(self) -> None:
        pairs = sorted(
            (_point(f"{shard}#{i}"), shard)
            for shard in self._shards
            for i in range(self._vnodes)
        )
        self._points = [p for p, _ in pairs]
        self._owners = [s for _, s in pairs]

    # -- routing -----------------------------------------------------------

    def home(self, key: str) -> str:
        """The shard owning ``key`` (deterministic across processes)."""
        if not self._points:
            raise ValueError("ring has no shards")
        i = bisect_right(self._points, _point(str(key)))
        return self._owners[i % len(self._owners)]

    def successors(self, key: str) -> List[str]:
        """Every shard in ring order starting at ``key``'s home — the
        failover *preference* order (informational: failover in this
        codebase re-attaches to the restarted home shard via its journal
        rather than migrating the session)."""
        if not self._points:
            raise ValueError("ring has no shards")
        i = bisect_right(self._points, _point(str(key)))
        out: List[str] = []
        n = len(self._owners)
        for step in range(n):
            owner = self._owners[(i + step) % n]
            if owner not in out:
                out.append(owner)
                if len(out) == len(self._shards):
                    break
        return out

    def census(self, keys: Iterable[str]) -> Dict[str, int]:
        """Keys-per-shard histogram (every shard present, even at 0) —
        the balance column of ``run_shard_curve`` and the tests'
        uniformity assertions."""
        out = {shard: 0 for shard in self._shards}
        for key in keys:
            out[self.home(key)] += 1
        return out


class ShardRouter:
    """Live placement table over a :class:`ShardRing` + its telemetry.

    Tracks which sessions this process placed where, keeps the
    ``shard_sessions{shard}`` gauges current, and counts
    ``shard_rebalances_total`` when a membership change moves a tracked
    session to a new home.  Thread-safe (placements happen from engine
    threads; membership changes from operator paths).
    """

    def __init__(self, ring: ShardRing):
        self.ring = ring
        self._lock = threading.Lock()
        self._homes: Dict[str, str] = {}

    def place(self, session_id: str) -> str:
        sid = str(session_id)
        home = self.ring.home(sid)
        with self._lock:
            self._homes[sid] = home
            self._set_gauges()
        return home

    def forget(self, session_id: str) -> None:
        with self._lock:
            if self._homes.pop(str(session_id), None) is not None:
                self._set_gauges()

    def placements(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._homes)

    def set_shards(self, shards: Sequence[str]) -> int:
        """Replace the ring membership; returns how many tracked sessions
        moved home (each move bumps ``shard_rebalances_total``).  The
        consistent-hash guarantee under test: ~1/N of sessions move when
        one of N shards changes, never a full reshuffle."""
        with self._lock:
            old = dict(self._homes)
            for shard in self.ring.shards:
                if shard not in shards:
                    self.ring.remove(shard)
            for shard in shards:
                if shard not in self.ring.shards:
                    self.ring.add(shard)
            moved = 0
            for sid in self._homes:
                home = self.ring.home(sid)
                if home != old.get(sid):
                    self._homes[sid] = home
                    moved += 1
            if moved:
                _get_registry().counter("shard_rebalances_total").inc(moved)
            self._set_gauges()
            return moved

    def _set_gauges(self) -> None:
        # Caller holds the lock.  One gauge series per shard, including
        # empty shards (a 0 reads differently from a missing row).
        reg = _get_registry()
        counts = {shard: 0 for shard in self.ring.shards}
        for home in self._homes.values():
            counts[home] = counts.get(home, 0) + 1
        for shard, n in counts.items():
            reg.gauge("shard_sessions", shard=shard).set(n)


class ShardedBroker:
    """Master-side facade: the ``JobBroker`` API over N broker shards.

    ``DistributedPopulation(broker_urls=[...])`` installs one of these as
    ``self.broker``; the engines keep calling ``submit`` / ``wait_any`` /
    ``gather`` / ``session_capacity`` exactly as against an embedded
    broker, and the facade routes every call to the owning session's home
    shard over a wire :class:`~.sessions.SessionClient` (one per shard,
    lazily dialed, ``reconnect=True`` so a shard restart re-attaches via
    the journal path).

    Failover semantics (DISTRIBUTED.md): results and session state
    survive a shard SIGKILL — the journal re-adopts open jobs and parks
    undelivered results for re-attach.  A ``submit`` that lands IN the
    outage window retries under ``retry_window`` seconds; if the shard
    stays dead past the window the error surfaces to the engine, whose
    ``evaluate_retries`` policy decides (at-least-once end to end).
    """

    def __init__(self, broker_urls: Sequence[Any], token: Optional[str] = None,
                 timeout: float = 10.0, retry_window: float = 60.0,
                 reconnect_max_delay: float = 5.0, vnodes: int = 64):
        self._addrs = parse_broker_urls(broker_urls)
        self._by_shard = {shard_id(a): a for a in self._addrs}
        self.ring = ShardRing(list(self._by_shard), vnodes=vnodes)
        self.router = ShardRouter(self.ring)
        self._token = token
        self._timeout = float(timeout)
        self._retry_window = float(retry_window)
        self._reconnect_max_delay = float(reconnect_max_delay)
        self._lock = threading.Lock()
        self._clients: Dict[str, Any] = {}
        #: job_id -> shard label, for wait_any/gather/cancel routing.
        self._jobs: Dict[str, str] = {}
        #: sessions this facade opened (sid -> shard), re-opened lazily.
        self._sessions: Dict[str, str] = {}
        self._closed = False

    # -- plumbing ----------------------------------------------------------

    @property
    def address(self) -> tuple:
        """First shard's address — the ``broker_address`` a sharded
        master logs (the full list is :attr:`shards`)."""
        return self._addrs[0]

    @property
    def shards(self) -> List[str]:
        return list(self._by_shard)

    def _client(self, shard: str):
        with self._lock:
            client = self._clients.get(shard)
            if client is None:
                from .sessions import SessionClient

                host, port = self._by_shard[shard]
                client = SessionClient(
                    host, port, token=self._token, timeout=self._timeout,
                    reconnect=True, reconnect_window=self._retry_window,
                    reconnect_max_delay=self._reconnect_max_delay)
                self._clients[shard] = client
            return client

    def _retry(self, shard: str, fn, what: str):
        """At-least-once wrapper for one shard call: a connection error
        (shard down, mid-restart) retries until ``retry_window`` closes.
        The underlying :class:`SessionClient` redials in its reader
        thread; this loop just re-issues the request once the link is
        back.  Non-connection errors (auth, unknown session) are
        deterministic and re-raise immediately."""
        deadline = time.monotonic() + self._retry_window
        while True:
            try:
                return fn(self._client(shard))
            except (ConnectionError, OSError, TimeoutError) as e:
                if time.monotonic() >= deadline or self._closed:
                    raise
                # A client whose reconnect window expired is permanently
                # closed: drop it so the next attempt dials fresh.
                with self._lock:
                    client = self._clients.get(shard)
                    if client is not None and getattr(client, "_closed", False):
                        try:
                            client.close()
                        except OSError:
                            pass
                        self._clients.pop(shard, None)
                time.sleep(0.2)
                if time.monotonic() < deadline:
                    continue
                raise ConnectionError(f"{what} to shard {shard} failed: {e}") from e

    def _home(self, session: Optional[str]) -> str:
        from .sessions import DEFAULT_SESSION

        sid = str(session) if session else DEFAULT_SESSION
        return self._sessions.get(sid) or self.router.place(sid)

    def _ensure_session(self, session: Optional[str]) -> str:
        """Open (idempotently) the session on its home shard; returns the
        effective sid.  The implicit default session must be opened
        explicitly over the wire — the broker only lazily creates it for
        in-process submits."""
        from .sessions import DEFAULT_SESSION

        sid = str(session) if session else DEFAULT_SESSION
        if sid not in self._sessions:
            self.open_session(sid)
        return sid

    # -- JobBroker API subset ----------------------------------------------

    @staticmethod
    def new_job_id() -> str:
        return uuid.uuid4().hex

    def open_session(self, session_id: Optional[str] = None, weight: float = 1.0,
                     max_in_flight: Optional[int] = None) -> str:
        # Mint the id HERE when absent: placement needs the id before the
        # wire does (the broker-side generator would pick the shard after
        # the fact).
        sid = str(session_id) if session_id else f"s-{uuid.uuid4().hex[:12]}"
        shard = self._home(sid)
        self._retry(shard, lambda c: c.open_session(
            sid, weight=weight, max_in_flight=max_in_flight), "session_open")
        self._sessions[sid] = shard
        return sid

    def close_session(self, session_id: str) -> None:
        sid = str(session_id)
        shard = self._sessions.pop(sid, None) or self._home(sid)
        self.router.forget(sid)
        try:
            self._retry(shard, lambda c: c.close_session(sid), "session_close")
        except (ConnectionError, OSError, TimeoutError):
            pass  # teardown path: a dead shard cancels the session itself

    def submit(self, payloads: Dict[str, Dict[str, Any]],
               session: Optional[str] = None) -> None:
        sid = self._ensure_session(session)
        shard = self._sessions[sid]
        self._retry(shard, lambda c: c.submit(sid, payloads), "submit")
        for job_id in payloads:
            self._jobs[job_id] = shard

    def _jobs_by_shard(self, job_ids: Iterable[str]) -> Dict[str, List[str]]:
        groups: Dict[str, List[str]] = {}
        for j in job_ids:
            shard = self._jobs.get(str(j))
            if shard is None:
                # Unknown id (submitted by another facade / pre-restart):
                # ask every shard — at most a wasted table lookup each.
                for s in self._by_shard:
                    groups.setdefault(s, []).append(str(j))
            else:
                groups.setdefault(shard, []).append(str(j))
        return groups

    def wait_any(self, job_ids: List[str], timeout: Optional[float] = None
                 ) -> Tuple[Dict[str, float], Dict[str, str]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        groups = self._jobs_by_shard(job_ids)
        if not groups:
            return {}, {}
        while True:
            for shard, ids in groups.items():
                # One session's jobs live on ONE shard, so the common case
                # is a single group and a full-timeout delegate; the
                # multi-shard case polls in short slices.
                if len(groups) == 1:
                    remaining = (None if deadline is None
                                 else max(0.0, deadline - time.monotonic()))
                    slice_t = remaining
                else:
                    slice_t = 0.05
                r, f = self._retry(
                    shard, lambda c, i=ids, t=slice_t: c.wait_any(i, timeout=t),
                    "wait_any")
                if r or f:
                    for j in list(r) + list(f):
                        self._jobs.pop(j, None)
                    return r, f
            if deadline is not None and time.monotonic() >= deadline:
                return {}, {}

    def gather(self, job_ids: List[str], timeout: Optional[float] = None
               ) -> Dict[str, float]:
        from .broker import GatherTimeout, JobFailed

        deadline = None if timeout is None else time.monotonic() + timeout
        want = set(str(j) for j in job_ids)
        results: Dict[str, float] = {}
        failures: Dict[str, str] = {}
        while want:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                if failures:
                    break  # terminal verdict below, not a timeout
                self.cancel(list(want))
                raise GatherTimeout(
                    f"{len(want)} of {len(job_ids)} job(s) unfinished after "
                    f"{timeout}s", partial=results)
            r, f = self.wait_any(
                sorted(want),
                timeout=min(remaining, 1.0) if remaining is not None else 1.0)
            results.update(r)
            failures.update(f)
            want -= set(r) | set(f)
        if failures:
            job_id = sorted(failures)[0]
            raise JobFailed(
                f"{len(failures)} of {len(job_ids)} job(s) failed permanently "
                f"(first: {job_id}: {failures[job_id]})",
                failures=failures, partial=results)
        return results

    def cancel(self, job_ids) -> None:
        for shard, ids in self._jobs_by_shard(job_ids).items():
            try:
                self._retry(shard, lambda c, i=ids: c.cancel(i), "cancel")
            except (ConnectionError, OSError, TimeoutError):
                pass  # a dead shard's jobs die with it (requeue on restart)
            for j in ids:
                self._jobs.pop(j, None)

    def evaluate(self, payloads: Dict[str, Dict[str, Any]],
                 timeout: Optional[float] = None) -> Dict[str, float]:
        self.submit(payloads)
        return self.gather(list(payloads), timeout=timeout)

    # -- fleet/session sizing (wire ``session_stats``) ---------------------

    def _stats(self, session: Optional[str] = None,
               reset_chips: bool = False) -> Dict[str, Any]:
        sid = self._ensure_session(session)
        shard = self._sessions[sid]
        return self._retry(
            shard, lambda c: c.session_stats(sid, reset_chips=reset_chips),
            "session_stats")

    def session_capacity(self, session_id: Optional[str] = None) -> int:
        try:
            return int(self._stats(session_id).get("capacity", 0))
        except (ConnectionError, OSError, TimeoutError):
            return 0  # sizing is advisory: a dead shard sizes to zero

    def session_prefetch(self, session_id: Optional[str] = None) -> int:
        try:
            return int(self._stats(session_id).get("prefetch", 0))
        except (ConnectionError, OSError, TimeoutError):
            return 0

    def fleet_mesh_pop(self) -> int:
        """Max advertised pop axis across every REACHED shard (shards this
        facade has a session on; fleets multi-home, so any shard sees the
        same workers)."""
        out = 1
        for sid in list(self._sessions):
            try:
                out = max(out, int(self._stats(sid).get("mesh_pop", 1)))
            except (ConnectionError, OSError, TimeoutError):
                continue
        return out

    def reset_chips_seen(self) -> None:
        for sid in list(self._sessions):
            try:
                self._stats(sid, reset_chips=True)
            except (ConnectionError, OSError, TimeoutError):
                continue

    def chips_seen(self) -> int:
        """Max over shards (NOT sum: a multi-homed worker's chips appear
        on every shard it joined)."""
        out = 0
        for sid in list(self._sessions):
            try:
                out = max(out, int(self._stats(sid).get("chips", 0)))
            except (ConnectionError, OSError, TimeoutError):
                continue
        return out

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        """Close every shard connection (the facade owns no broker
        process — operators stop shard brokers directly)."""
        self._closed = True
        with self._lock:
            clients, self._clients = dict(self._clients), {}
        for client in clients.values():
            try:
                client.close()
            except OSError:
                pass
