"""Worker-side client: owns the data, trains genes shipped by the master.

Reference parity: ``GentunClient`` in ``gentun/client.py`` [PUB][BASELINE]
(SURVEY.md §2.0 row 11, §3.3).  Preserved behaviors:

- the worker holds ``(x_train, y_train)``; only genes + hyperparameters
  arrive, only fitness scalars leave;
- ``work()`` is a blocking consume loop: pop job → rebuild individual from
  genes → ``get_fitness()`` (the hot path) → reply → ack.  Here the ack IS
  the ``result`` message (ack-after-work): a worker that dies mid-job never
  acks, and the broker redelivers (at-least-once, SURVEY.md §5);
- evaluation errors are reported (``fail``) rather than crashing the loop,
  and the broker decides between redelivery and giving up.

TPU-first extension: ``capacity > 1`` asks the broker for several jobs at
once; jobs sharing one config are evaluated as a single batched population
program via ``Population.evaluate`` (``models/cnn.py``), which is how one
TPU worker keeps its chip saturated even mid-generation.  Heartbeats run on
a side thread so a minutes-long train step doesn't make a healthy
worker look dead.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Type

from ..individuals import Individual
from ..populations import Population
from ..telemetry import health as _health
from ..telemetry import lineage as _lineage
from ..telemetry import spans as _tele
from ..telemetry.registry import get_registry as _get_registry
from .protocol import (
    MAX_MESSAGE_BYTES,
    WIRE_CAPS,
    AuthError,
    ProtocolError,
    coalesce_results,
    decode,
    encode,
    expand_jobs2,
    parse_caps,
)

__all__ = ["GentunClient"]

logger = logging.getLogger("gentun_tpu_torch.distributed")


class _ReconnectBackoff:
    """Capped exponential backoff with decorrelated jitter.

    A fixed reconnect delay synchronizes a fleet: every worker that lost
    the same master retries in lockstep, stampeding the reborn broker at
    the exact same instants forever.  Decorrelated jitter (the AWS
    formula: ``sleep_{n+1} = min(cap, uniform(base, 3 * sleep_n))``)
    spreads the fleet out while still backing off exponentially toward
    the cap.  The stream is seeded from the worker id — deterministic
    per worker (reproducible chaos runs), decorrelated across a fleet —
    and :meth:`reset` re-arms the base delay after any successful
    connection.
    """

    def __init__(self, base: float, cap: float, seed: str):
        import random

        self._base = max(1e-3, float(base))
        self._cap = max(self._base, float(cap))
        self._rng = random.Random(seed)  # str-seeded: stable across runs
        self._next = self._base

    def reset(self) -> None:
        self._next = self._base

    def next_delay(self) -> float:
        d = self._next
        self._next = min(self._cap, self._rng.uniform(self._base, 3.0 * d))
        return d


class _ShardConn:
    """One worker↔shard connection (multi-homed worker).

    Everything a single-homed ``GentunClient`` keeps as instance state —
    socket, read stream, granted caps, boot epoch — lives HERE per shard,
    plus the pieces that make shard independence real:

    - ``backoff``: this connection's OWN reconnect backoff (the satellite
      fix — one flapping shard inflating its delay toward the cap must
      never slow redials to healthy shards), seeded per (worker, shard)
      so a fleet's reconnects stay decorrelated per shard too.
    - ``gen``: redial generation.  Batches are enqueued tagged with the
      gen that received them; a batch whose gen is stale by evaluation
      time came from a dead connection — the broker already requeued
      those jobs at disconnect, so evaluating them would only duplicate
      work the fleet is already redoing.
    """

    __slots__ = ("host", "port", "shard", "sock", "rfile", "write_lock",
                 "handshaken", "boot_id", "caps", "backoff", "gen", "dead")

    def __init__(self, host: str, port: int, backoff: _ReconnectBackoff):
        self.host, self.port = host, int(port)
        self.shard = f"{host}:{port}"
        self.sock: Optional[socket.socket] = None
        self.rfile = None
        self.write_lock = threading.Lock()
        self.handshaken = False
        self.boot_id: Optional[str] = None
        self.caps: frozenset = frozenset()
        self.backoff = backoff
        self.gen = 0
        #: terminal auth rejection — never redialed again.
        self.dead = False


def _cuda_device_count(multihost: bool = False) -> int:
    """Cards this worker spans, at least 1: a multihost worker's ranks (one
    card each, as the mesh counts them), else the local CUDA devices (the
    fitness path initializes CUDA anyway)."""
    if multihost:
        from ..parallel import multihost as mh

        return mh.process_count()
    import torch

    return max(1, int(torch.cuda.device_count()))


class GentunClient:
    """Connects to the master's broker and evaluates individuals forever.

    Parameters mirror the reference constructor
    (``GentunClient(IndividualCls, x_train, y_train, host, user, password)``
    [PUB]); ``user`` is accepted for signature parity but unused, ``password``
    maps to the broker token.

    - ``species``: the Individual subclass to rebuild from wire genes.
    - ``capacity``: max jobs held at once (1 = reference semantics; >1 lets
      a TPU worker train a whole batch in one compiled program).  The
      string ``"auto"`` switches on **host-mesh mode**: this worker is one
      HOST driving all of its local devices through the ``(pop, data)``
      evaluation mesh, and capacity is DERIVED from that mesh
      (``parallel.mesh.host_worker_capacity``: compile bucket × pop-axis
      size) instead of typed in — so the dispatch window is always a
      shape the compiled evaluator wants, re-advertised via
      :meth:`remesh` when the device set changes.
    - ``mesh_devices``: override the probed device count host-mesh mode
      derives from (default ``torch.cuda.device_count()``).  For tests and
      chaos drills — a process cannot gain or lose a device on demand —
      and for host-only species that want mesh-derived windows anyway.
    - ``mesh_override``: pin the ``(pop, data)`` factoring instead of the
      heuristic — a ``"POPxDATA"`` string (the worker's ``--mesh`` flag)
      or a tuple.  Malformed or non-factoring values raise ``ValueError``
      at the point the device count is known, and :meth:`remesh`
      re-validates against the post-change count.
    - ``prefetch_depth``: jobs queued locally BEYOND ``capacity`` so the
      next window is already decoded when the current one finishes
      (double buffering — a background receive thread feeds a local
      ready-queue while the evaluate loop trains, hiding the
      results→breed→dispatch round trip).  ``None`` (default) means
      ``capacity``; ``0`` restores the exact pre-pipelining serial loop
      (bit-identical frame sequence).  Clamped to ``[0, 4 × capacity]``,
      mirroring the broker's own clamp.  An old broker that ignores the
      hello field simply never grants the extra credit — the worker
      degrades to the serial flow without protocol errors.
    - ``heartbeat_interval``: seconds between pings from the side thread.
    - ``reconnect_delay``: INITIAL delay after a lost connection; subsequent
      attempts back off exponentially with decorrelated jitter up to
      ``reconnect_max_delay`` (and reset to the initial delay on success),
      so a fleet's reconnects never stampede a restarted broker in lockstep.
    - ``fault_injector``: optional ``distributed.faults.FaultInjector`` for
      deterministic chaos testing; ``None`` (default) is zero-cost.
    - ``compile_cache_url``: the fleet-wide compiled-executable cache
      (``distributed/compile_service.py``).  At join and after
      :meth:`remesh` — before capacity is (re-)advertised — the worker
      prefetches the fleet's built kernel libraries for its platform
      fingerprint into the local cache dir, and publishes whatever it
      builds first.  A malformed URL raises ``ValueError`` here (the
      worker CLI converts it to ``SystemExit``); service downtime never
      fails a search, it only costs recompiles.
    - ``multihost``: this worker is ONE logical worker spanning the ranks of
      a ``torch.distributed`` group, one process per card
      (``parallel/multihost.py``; ``initialize`` already called).  Rank 0
      alone owns the broker connection; every rank runs the same
      evaluation, with each window of job payloads broadcast to the ranks.
      Off by default, so a one-card worker (and a host-only species) never
      touches ``torch.distributed``.
    """

    def __init__(
        self,
        species: Type[Individual],
        x_train,
        y_train,
        host: str = "127.0.0.1",
        port: int = 5672,
        user: Optional[str] = None,
        password: Optional[str] = None,
        capacity=1,
        prefetch_depth: Optional[int] = None,
        mesh_devices: Optional[int] = None,
        mesh_override=None,
        heartbeat_interval: float = 3.0,
        reconnect_delay: float = 1.0,
        reconnect_max_delay: float = 30.0,
        worker_id: Optional[str] = None,
        multihost: bool = False,
        n_chips: Optional[int] = None,
        fitness_store: Optional[str] = None,
        cache_url: Optional[str] = None,
        compile_cache_url: Optional[str] = None,
        aggregator_url: Optional[str] = None,
        fault_injector=None,
        wire_caps: Optional[tuple] = None,
        preemptible: bool = False,
        broker_urls: Optional[list] = None,
    ):
        self.species = species
        self.x_train = x_train
        self.y_train = y_train
        self.host = host
        self.port = int(port)
        self.token = password
        # Host-mesh mode (capacity="auto"): the host is the unit of fleet
        # membership.  The mesh shape is remembered so the hello/advertise
        # frames can carry it and the pipelined re-chunker can align
        # windows to the pop-axis multiple (zero padding waste, one
        # compiled batch shape).
        self._mesh_shape: Optional[tuple] = None  # (pop, data) axis sizes
        self._mesh_devices: Optional[int] = None
        # Operator mesh override (worker ``--mesh POPxDATA``): pins the
        # (pop, data) factoring instead of the heuristic.  Accepted as a
        # "POPxDATA" string or a (pop, data) tuple; malformed values raise
        # ValueError here (the worker CLI converts to SystemExit).  The
        # override is installed process-wide (``parallel.mesh
        # .set_mesh_override``) so the evaluator's ``auto_mesh`` honors it
        # without touching the wire config — cache keys and fitness
        # fingerprints stay unchanged — and it is re-validated against the
        # live device count on every capacity derivation (join, remesh).
        self._mesh_override: Optional[tuple] = None
        self.multihost = bool(multihost)
        if mesh_override is not None:
            from ..parallel.mesh import parse_mesh_spec, set_mesh_override

            if isinstance(mesh_override, str):
                mesh_override = parse_mesh_spec(mesh_override)
            self._mesh_override = (int(mesh_override[0]), int(mesh_override[1]))
            set_mesh_override(self._mesh_override)  # validates positivity
        self._mesh_auto = isinstance(capacity, str)
        if self._mesh_auto:
            if str(capacity).strip().lower() != "auto":
                raise ValueError(
                    f"capacity must be a positive integer or 'auto', got {capacity!r}")
            capacity = self._derive_mesh_capacity(mesh_devices)
        self.capacity = max(1, int(capacity))
        #: True when the operator pinned prefetch explicitly — remesh()
        #: then respects it instead of tracking the derived capacity.
        self._prefetch_explicit = prefetch_depth is not None
        if prefetch_depth is None:
            prefetch_depth = self.capacity
        self.prefetch_depth = max(0, min(int(prefetch_depth), 4 * self.capacity))
        self.heartbeat_interval = float(heartbeat_interval)
        self.reconnect_delay = float(reconnect_delay)
        self.reconnect_max_delay = float(reconnect_max_delay)
        self.worker_id = worker_id or f"{socket.gethostname()}-{uuid.uuid4().hex[:8]}"
        # Preemptible capacity (protocol.py "Preemptible-capacity field"):
        # advertised on hello/advertise so the broker's placement routes
        # cheap rung-0 probes here and pins promotions to stable members.
        # False is the wire default — a stable worker never sends the key.
        self.preemptible = bool(preemptible)
        # Drain attribution for the NEXT drain frame ("drain"|"preempt");
        # "drain" is the wire default and is never sent explicitly.
        self._drain_reason = "drain"
        self._injector = fault_injector
        # Wire fast path (protocol.py "Wire fast path"): capabilities this
        # worker ADVERTISES on hello; what the broker GRANTS comes back on
        # welcome and gates which frame types may arrive.  ``wire_caps=()``
        # pins the v1 frame set (ops kill switch, mixed-fleet tests).
        self._wire_caps = tuple(WIRE_CAPS if wire_caps is None else wire_caps)
        self._broker_caps: frozenset = frozenset()
        # Broker boot epoch (OPTIONAL on welcome; only journaled brokers
        # send one).  Echoed back on results/fail frames so a restarted
        # broker can tell a live completion from a stale pre-crash one.
        self._boot_id: Optional[str] = None
        # Memoized wire-telemetry handles + 1-in-N encode sampling state
        # (same memoize-or-die discipline as the broker's).
        self._wire_counters: Dict[str, tuple] = {}
        self._encode_hist = None
        self._encode_samples = 0
        self._n_chips = None if n_chips is None else max(1, int(n_chips))
        # Worker-side cross-run fitness reuse : the store
        # is loaded ONCE, read-only, and seeds every evaluation Population's
        # fitness cache — cache keys embed additional_parameters, so reuse is
        # training-config-exact.  New measurements accumulate in memory (so a
        # repeated genome later in the same session also hits) but are never
        # written back; persistence stays the master's job.
        if fitness_store and multihost:
            # Followers replay the leader's batches; a store file present on
            # one host but not another would diverge the ranks' programs
            # mid-collective.  Refuse loudly instead.
            raise ValueError("fitness_store is not supported for multihost workers")
        if fitness_store:
            from ..utils.fitness_store import load_fitness_cache

            self._store_cache: Optional[dict] = load_fitness_cache(fitness_store)
            # Snapshot of what the FILE held: the live dict also accumulates
            # this session's measurements (deliberately — later repeats hit
            # without retraining), but only file entries count as cross-run
            # reuse in the log.
            self._store_keys = frozenset(self._store_cache)
            logger.info(
                "worker fitness store %s: %d entries loaded (read-only)",
                fitness_store, len(self._store_cache),
            )
        else:
            self._store_cache = None
            self._store_keys = frozenset()
        # Networked shared fitness cache (distributed/fitness_service.py):
        # layers read-through/write-behind service access over whatever the
        # local store loaded, so a genome ANY run already measured is
        # answered without training — and every new measurement is
        # published for the rest of the fleet.  Refused for multihost
        # workers for the same reason as fitness_store: a service hit on
        # one host but not another would diverge the ranks' programs
        # mid-collective.
        self._cache_client = None
        if cache_url:
            if multihost:
                raise ValueError("cache_url is not supported for multihost workers")
            from .fitness_service import FitnessServiceClient, ServiceBackedCache

            self._cache_client = FitnessServiceClient(cache_url)
            self._store_cache = ServiceBackedCache(
                self._cache_client, self._store_cache or {})
        # Fleet-wide compile cache (distributed/compile_service.py):
        # prefetch the fleet's built kernel libraries into the local kernel
        # cache dir at join (and after remesh) so this worker loads instead of
        # building, and publish the library if it builds it first.  Refused
        # for multihost workers: the cache dir is per host, so the leader
        # cannot prefetch for its followers.
        self._compile_client = None
        if compile_cache_url:
            if multihost:
                raise ValueError(
                    "compile_cache_url is not supported for multihost workers")
            from .compile_service import CompileServiceClient

            self._compile_client = CompileServiceClient(
                compile_cache_url,
                probe_devices=getattr(species, "uses_jax", False))
        # Fleet observability (telemetry/aggregator.py): the URL is only
        # validated here (loud ValueError → SystemExit in the CLI); the
        # pusher itself starts with work() and stops when work() returns,
        # under this worker's id as the fleet instance label.
        self._aggregator_url = None
        if aggregator_url:
            from ..telemetry.aggregator import parse_aggregator_url

            self._aggregator_url = parse_aggregator_url(aggregator_url)
        self._pusher = None
        if self.multihost:
            from ..parallel import multihost as mh

            self._mh = mh
            self._is_leader = mh.is_leader()
        else:
            self._mh = None
            self._is_leader = True

        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._write_lock = threading.Lock()
        self._stop = threading.Event()
        self._handshaken = threading.Event()  # gates heartbeats until welcome
        self._jobs_done = 0
        self._last_batch_end: Optional[float] = None  # worker_idle_s anchor
        # Elastic membership: drain() arms this; the consume loops notice
        # at the next batch boundary, announce the drain to the broker
        # (returning queued-but-unstarted jobs), and work() exits cleanly.
        self._drain_req = threading.Event()
        self._work_stop: Optional[threading.Event] = None
        # Multi-homing (horizontal broker sharding): with
        # ``broker_urls=[...]`` of length >1 this worker holds ONE
        # connection per shard — per-connection receive threads, per-shard
        # credit windows and backoff — so a stalled or dead shard can
        # never block dispatch on healthy shards.  A one-element list
        # collapses to the plain host/port path, wire byte-identical.
        self._addrs: Optional[List[tuple]] = None
        self._conns: List[_ShardConn] = []
        if broker_urls:
            from .shard import parse_broker_urls

            addrs = parse_broker_urls(broker_urls)
            self.host, self.port = addrs[0]
            if len(addrs) > 1:
                if self.multihost:
                    # One leader connection is the multihost contract:
                    # followers replay ITS batches; two shards' interleaved
                    # windows would diverge the ranks' programs.
                    raise ValueError(
                        "broker_urls multi-homing is not supported for "
                        "multihost workers")
                if self._injector is not None:
                    # Frame-counted fault schedules assume one connection;
                    # shard chaos drills kill brokers instead (chaos_run.py
                    # shard_kill).
                    raise ValueError(
                        "fault_injector is not supported with multi-shard "
                        "broker_urls")
                self._addrs = addrs

    # -- host-mesh capacity ------------------------------------------------

    def _derive_mesh_capacity(self, n_devices: Optional[int] = None) -> int:
        """Capacity from the local device mesh (host-mesh mode).

        ``parallel.mesh.host_worker_capacity``: factor the devices into
        the ``(pop, data)`` mesh the evaluator will build, then size the
        window to compile bucket × pop-axis — a shape that shards with
        zero padding and is already in the compile cache after the first
        window.  ``n_devices=None`` probes ``torch.cuda.device_count()``
        (the local CUDA devices; 1 when there is none, so a worker without a
        card still joins and then fails its jobs with the device error), or
        a multihost worker's world size (one card per rank), which requires
        a device species; tests and host-only species pass the count
        explicitly.  Records the shape for the hello/advertise
        frames, the re-chunker, and the ``mesh_*`` gauges.
        """
        from ..parallel.mesh import host_worker_capacity

        if n_devices is None:
            if not getattr(self.species, "uses_jax", False):
                raise ValueError(
                    f"capacity='auto' derives from the local device mesh, but "
                    f"species {self.species.__name__} never uses the CUDA "
                    f"device — pass mesh_devices= or an integer capacity")
            n_devices = _cuda_device_count(self.multihost)
        pop_o, data_o = self._mesh_override or (None, None)
        capacity, pop_axis, data_axis = host_worker_capacity(
            n_devices, pop_axis=pop_o, data_axis=data_o)
        self._mesh_devices = int(n_devices)
        self._mesh_shape = (pop_axis, data_axis)
        reg = _get_registry()
        reg.gauge("mesh_pop_axis").set(pop_axis)
        reg.gauge("mesh_data_axis").set(data_axis)
        logger.info(
            "host-mesh worker %s: %d device(s) -> mesh (pop=%d, data=%d), "
            "derived capacity %d", self.worker_id if hasattr(self, "worker_id")
            else "?", n_devices, pop_axis, data_axis, capacity)
        return capacity

    def _mesh_advert(self) -> Optional[Dict[str, int]]:
        """The OPTIONAL ``mesh`` wire field (protocol.py "Host-mesh
        field"), or None for per-chip workers."""
        if self._mesh_shape is None:
            return None
        return {"pop": self._mesh_shape[0], "data": self._mesh_shape[1],
                "devices": self._mesh_devices or 0}

    def remesh(self, n_devices: Optional[int] = None) -> None:
        """Re-derive capacity from the current device mesh and re-advertise.

        The elastic half of host-mesh mode: when the host's device set
        changes (a chip lost to hardware fault, a co-tenant releasing
        devices, a restarted runtime finding fewer cores), the worker's
        window must follow — the broker clamps credit immediately on the
        ``advertise`` frame, in-flight jobs finish unaffected.
        ``n_devices`` overrides the probe (tests / chaos drills).  Only
        meaningful in host-mesh mode (``capacity="auto"``).
        """
        if not self._mesh_auto:
            raise ValueError("remesh() requires host-mesh mode (capacity='auto')")
        capacity = self._derive_mesh_capacity(n_devices)
        if self._prefetch_explicit:
            prefetch = min(self.prefetch_depth, 4 * capacity)
        else:
            prefetch = capacity  # the derived-window double-buffer default
        if self._compile_client is not None:
            # A remesh changes the mesh shape, i.e. the compile shapes the
            # next window needs.  Warm the local kernel cache BEFORE the
            # advertise frame restores credit, so the first post-remesh
            # window loads instead of compiling.
            self._compile_client.prefetch()
        self.advertise(capacity=capacity, prefetch_depth=prefetch)

    # -- connection --------------------------------------------------------

    def _fleet_chips(self) -> int:
        """Accelerator chips this logical worker spans, for the ``hello`` frame.

        The master divides its throughput metric by the connected fleet's
        chip total (``individuals/hour/chip`` — SURVEY.md §5 "Metrics"), so
        the advertisement must be honest: a device species reports
        ``torch.cuda.device_count()`` (at least 1), or a multihost worker's
        world size (one card per rank).  Species that never
        touch the card (``uses_jax`` False: the flag keeps the reference's
        name) report 1 and never initialize CUDA here.  Override with the
        ``n_chips`` constructor kwarg.
        """
        if self._n_chips is None:
            if getattr(self.species, "uses_jax", False):
                self._n_chips = _cuda_device_count(self.multihost)
            else:
                self._n_chips = 1
        return self._n_chips

    def _connect(self) -> None:
        if self._injector is not None:
            self._injector.client_connect(self)  # may delay or refuse
        n_chips = self._fleet_chips()  # before the socket: may initialize CUDA
        sock = socket.create_connection((self.host, self.port), timeout=10.0)
        sock.settimeout(None)
        self._sock = sock
        self._rfile = sock.makefile("rb")
        try:
            backend = self.species.fitness_backend()
        except Exception:  # never let an advisory field block the handshake
            backend = None
        hello = {
            "type": "hello",
            "worker_id": self.worker_id,
            "token": self.token,
            "capacity": self.capacity,
            "prefetch_depth": self.prefetch_depth,
            "n_chips": n_chips,
            "backend": backend,
        }
        mesh = self._mesh_advert()
        if mesh is not None:
            # OPTIONAL advisory field (protocol.py "Host-mesh field"):
            # old brokers ignore unknown hello keys.
            hello["mesh"] = mesh
        if self.preemptible:
            # OPTIONAL placement hint (protocol.py "Preemptible-capacity
            # field"): only ever sent as ``true`` — absent means stable,
            # so a stable worker's hello is byte-identical to before.
            hello["preemptible"] = True
        if self._wire_caps:
            # OPTIONAL capability advertisement (protocol.py "Wire fast
            # path"): old brokers ignore it and keep speaking v1 frames.
            hello["caps"] = list(self._wire_caps)
        self._send(hello)
        reply = self._recv()
        if reply.get("type") != "welcome":
            if reply.get("type") == "error" and reply.get("code") == "auth":
                raise AuthError(f"broker rejected credentials: {reply.get('reason')}")
            raise ConnectionError(f"broker rejected worker: {reply}")
        # What the broker GRANTED (old brokers grant nothing); only frames
        # in this set may arrive, so a v1 broker never surprises us.
        self._broker_caps = parse_caps(reply)
        # Journaled brokers stamp their boot epoch on welcome; we echo it
        # on every result so post-restart the new epoch can vet stale ones.
        self._boot_id = reply.get("boot_id")
        self._handshaken.set()
        # A reconnect gap is downtime, not a dispatch bubble: don't let it
        # pollute the worker_idle_s histogram.
        self._last_batch_end = None
        logger.info("worker %s connected to %s:%d", self.worker_id, self.host, self.port)

    def _close(self) -> None:
        self._handshaken.clear()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None

    def _graceful_close(self) -> None:
        """FIN, then drain, then close — never RST away unread results.

        A plain ``close()`` on a socket whose receive buffer still holds
        unread broker frames emits RST, which destroys our just-sent
        result frames before the broker reads them.  Shut down the write
        side first (FIN queued AFTER the results), then read the
        connection to EOF so nothing is left unread, then close.

        Cost (accepted tradeoff): if the broker holds the
        connection open after our FIN, each ``recv`` may stall up to the
        2 s timeout before we give up and close anyway — a worst-case 2 s
        added to a clean ``work()`` teardown (reconnect-path closes don't
        come through here).  The stock broker responds to FIN by closing,
        so the drain normally completes in one round-trip.
        """
        sock = self._sock
        if sock is None:
            return
        try:
            sock.shutdown(socket.SHUT_WR)
            sock.settimeout(2.0)
            while sock.recv(4096):
                pass
        except OSError:
            pass  # broker already gone: nothing left to protect
        finally:
            self._close()

    def _send(self, msg: Dict[str, Any]) -> None:
        if self._injector is not None and self._injector.client_send(self, msg):
            return
        # Wire telemetry mirrors the broker's: per-type byte/frame counters
        # on every send, encode latency sampled 1-in-64 (coalesced results
        # frames arrive pre-encoded, so the sampled cost is honest about
        # the fast path).
        self._encode_samples += 1
        if (self._encode_samples & 63) == 0:
            t0 = time.perf_counter()
            data = encode(msg)
            if self._encode_hist is None:
                self._encode_hist = _get_registry().histogram(
                    "frame_encode_seconds", side="worker")
            self._encode_hist.observe(time.perf_counter() - t0)
        else:
            data = encode(msg)
        self._raw_send(data)
        mtype = str(msg.get("type"))
        handles = self._wire_counters.get(mtype)
        if handles is None:
            reg = _get_registry()
            handles = (reg.counter("wire_bytes_sent_total", type=mtype),
                       reg.counter("wire_frames_sent_total", type=mtype))
            self._wire_counters[mtype] = handles
        handles[0].inc(len(data))
        handles[1].inc()

    def _raw_send(self, data: bytes) -> None:
        with self._write_lock:
            sock = self._sock
            if sock is None:
                raise OSError("not connected")
            sock.sendall(data)

    def _recv(self, rfile=None) -> Dict[str, Any]:
        # `rfile` pins the read to ONE connection's stream: the pipelined
        # receiver thread captures it at spawn so a thread that outlives a
        # reconnect can never steal frames from the NEW connection.
        rfile = self._rfile if rfile is None else rfile
        line = rfile.readline(MAX_MESSAGE_BYTES + 2)
        if not line:
            raise ConnectionError("broker closed connection")
        msg = decode(line)
        if self._injector is not None:
            msg = self._injector.client_recv(self, msg)  # may delay or raise
        return msg

    # -- multi-home connection plumbing --------------------------

    def _send_conn(self, conn: _ShardConn, msg: Dict[str, Any]) -> None:
        """Send one frame on ONE shard's connection (manager threads,
        heartbeats, credit replenish — anything that must not depend on
        which conn the evaluator currently has bound)."""
        data = encode(msg)
        with conn.write_lock:
            sock = conn.sock
            if sock is None:
                raise OSError("not connected")
            sock.sendall(data)
        mtype = str(msg.get("type"))
        handles = self._wire_counters.get(mtype)
        if handles is None:
            reg = _get_registry()
            handles = (reg.counter("wire_bytes_sent_total", type=mtype),
                       reg.counter("wire_frames_sent_total", type=mtype))
            self._wire_counters[mtype] = handles
        handles[0].inc(len(data))
        handles[1].inc()

    def _bind_conn(self, conn: _ShardConn) -> None:
        """Point the shared send path (``_send``/``_raw_send`` and the
        boot-epoch echo in ``_evaluate_batch``) at ONE shard for the
        duration of a batch.  Safe because the evaluator is the only
        thread that touches ``self._sock`` in multi-home mode — managers
        and heartbeats use conn-scoped sends."""
        self._sock = conn.sock
        self._rfile = conn.rfile
        self._boot_id = conn.boot_id
        self._broker_caps = conn.caps

    def _connect_conn(self, conn: _ShardConn) -> None:
        """Dial + handshake one shard (the multi-home mirror of
        :meth:`_connect`), with the OPTIONAL ``homes`` hello rider so the
        shard's ``/statusz`` reads this worker's capacity correctly."""
        n_chips = self._fleet_chips()  # before the socket: may initialize CUDA
        sock = socket.create_connection((conn.host, conn.port), timeout=10.0)
        sock.settimeout(None)
        rfile = sock.makefile("rb")
        try:
            backend = self.species.fitness_backend()
        except Exception:  # never let an advisory field block the handshake
            backend = None
        hello = {
            "type": "hello",
            "worker_id": self.worker_id,
            "token": self.token,
            "capacity": self.capacity,
            "prefetch_depth": self.prefetch_depth,
            "n_chips": n_chips,
            "backend": backend,
            # OPTIONAL multi-home advertisement (protocol.py "Multi-home
            # field"): only multi-homed workers send it.
            "homes": len(self._addrs or ()) or 1,
        }
        mesh = self._mesh_advert()
        if mesh is not None:
            hello["mesh"] = mesh
        if self.preemptible:
            hello["preemptible"] = True
        if self._wire_caps:
            hello["caps"] = list(self._wire_caps)
        try:
            sock.sendall(encode(hello))
            line = rfile.readline(MAX_MESSAGE_BYTES + 2)
            if not line:
                raise ConnectionError(f"shard {conn.shard} closed during handshake")
            reply = decode(line)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        if reply.get("type") != "welcome":
            try:
                sock.close()
            except OSError:
                pass
            if reply.get("type") == "error" and reply.get("code") == "auth":
                raise AuthError(
                    f"shard {conn.shard} rejected credentials: {reply.get('reason')}")
            raise ConnectionError(f"shard {conn.shard} rejected worker: {reply}")
        conn.caps = parse_caps(reply)
        conn.boot_id = reply.get("boot_id")
        with conn.write_lock:
            conn.sock, conn.rfile = sock, rfile
        conn.gen += 1
        conn.handshaken = True
        self._handshaken.set()
        self._last_batch_end = None  # reconnect gap ≠ dispatch bubble
        logger.info("worker %s connected to shard %s", self.worker_id, conn.shard)

    def _close_conn(self, conn: _ShardConn) -> None:
        conn.handshaken = False
        with conn.write_lock:
            sock, conn.sock, conn.rfile = conn.sock, None, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _graceful_close_conn(self, conn: _ShardConn) -> None:
        """Teardown close for one shard: FIN, drain, close — the same
        RST-avoidance dance as :meth:`_graceful_close`."""
        conn.handshaken = False
        with conn.write_lock:
            sock, conn.sock, conn.rfile = conn.sock, None, None
        if sock is None:
            return
        try:
            sock.shutdown(socket.SHUT_WR)
            sock.settimeout(2.0)
            while sock.recv(4096):
                pass
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _heartbeat_loop(self) -> None:
        """Pings from a side thread keep liveness visible during training.

        Only pings once the hello/welcome handshake is done (a ping as the
        first frame would be a protocol violation), and survives any race
        with ``_close`` nulling the socket mid-send.
        """
        while not self._stop.is_set():
            time.sleep(self.heartbeat_interval)
            if self._conns:
                # Multi-home fan-out: ping every live shard on ITS OWN
                # connection (liveness is per-shard — one stalled shard
                # must not mark this worker stale everywhere).  Beat on
                # any delivered ping: the worker process is alive iff at
                # least one shard can hear it.
                delivered = False
                for conn in list(self._conns):
                    if conn.dead or not conn.handshaken:
                        continue
                    try:
                        self._send_conn(conn, {"type": "ping"})
                    except Exception:
                        continue  # that shard's manager will redial
                    delivered = True
                if delivered:
                    _health.beat("worker_heartbeat")
                continue
            if not self._handshaken.is_set():
                continue
            inj = self._injector
            if inj is not None and inj.heartbeats_suppressed():
                continue  # injected hang: go silent while holding jobs
            try:
                # Pings bypass the send hook: they fire on wall-clock time,
                # so routing them through the injector would make fault
                # schedules (counted in frames) nondeterministic.  The ping
                # fault is `hang` (suppression above), not a frame fault.
                self._raw_send(encode({"type": "ping"}))
            except Exception:
                pass  # main loop will notice and reconnect
            else:
                # Beat only on a DELIVERED ping: an injected hang (above)
                # or dead socket leaves this worker's /healthz stale, the
                # same silence the broker's reaper sees.
                _health.beat("worker_heartbeat")

    # -- the consume loop --------------------------------------------------

    def work(self, max_jobs: Optional[int] = None, stop_event: Optional[threading.Event] = None) -> int:
        """Blocking consume loop (reference ``GentunClient.work()`` [PUB]).

        Returns the number of jobs completed (useful for tests); runs until
        ``stop_event`` is set or ``max_jobs`` results have been sent.

        Multi-host mode: rank 0 runs this loop against the broker and
        broadcasts each received window; the other ranks never touch the
        socket: they loop on the broadcast and run the same evaluation,
        keeping every rank's collectives in lockstep.  A ``None`` broadcast
        is the shutdown sentinel, sent when the leader's loop exits for any
        reason.
        """
        if self.multihost and not self._is_leader:
            return self._work_follower()
        stop = stop_event or threading.Event()
        self._work_stop = stop  # shutdown() handle for signal-driven exits
        self._stop = threading.Event()
        self._jobs_done = 0  # each work() call gets a fresh budget
        # Ops-plane registration (dict writes, inert while the plane is
        # off): the ping thread's beat gates this process's /healthz — it
        # pings even during a long train step, so only a genuinely
        # hung or disconnected worker goes stale.  The consume/evaluate
        # beats are advisory (a long compile legitimately silences them).
        _health.register_source(
            "worker_heartbeat", timeout=max(5.0, 4.0 * self.heartbeat_interval))
        _health.register_status_provider("worker", self._ops_status)
        if self._aggregator_url and self._pusher is None:
            from ..telemetry.aggregator import acquire_pusher

            self._pusher = acquire_pusher(
                self._aggregator_url, role="worker", instance=self.worker_id)
        hb = threading.Thread(target=self._heartbeat_loop, name="gentun-heartbeat", daemon=True)
        hb.start()
        if self._compile_client is not None:
            # Join-time warmup, BEFORE the first connect advertises
            # capacity: fetch the fleet's compiled artifacts so the first
            # dispatched window loads the kernel library instead of
            # compiling.  The hook lets models/_prepare_population_setup
            # trigger publish scans right after potential first compiles.
            from ..utils.kernel_cache import register_publish_hook

            self._compile_client.prefetch()
            register_publish_hook(self._compile_client.publish_hook)
        backoff = _ReconnectBackoff(self.reconnect_delay, self.reconnect_max_delay, self.worker_id)
        try:
            if self._addrs is not None:
                # Multi-homed consume: one manager thread per
                # shard feeds a shared ready-queue; reconnect/backoff state
                # lives per connection inside each _ShardConn.
                self._work_multihome(stop, max_jobs)
            else:
                self._work_single(stop, max_jobs, backoff)
        finally:
            self._stop.set()
            self._graceful_close()
            if self._cache_client is not None:
                self._cache_client.close()
            if self._compile_client is not None:
                # close() unregisters the publish hook, runs a final scan
                # (catching entries the last batch wrote) and flushes.
                self._compile_client.close()
            _health.unregister_status_provider("worker", self._ops_status)
            _health.unregister_source("worker_heartbeat")
            if self._pusher is not None:
                from ..telemetry.aggregator import release_pusher

                release_pusher(self._pusher)
                self._pusher = None
            if self.multihost:
                self._mh.broadcast_payload(None)  # release the followers
        return self._jobs_done

    def _work_single(self, stop: threading.Event, max_jobs: Optional[int],
                     backoff: _ReconnectBackoff) -> None:
        """The single-connection consume/reconnect loop — the historical
        ``work()`` body, bit-identical frame flow."""
        while (not stop.is_set() and not self._drain_req.is_set()
               and (max_jobs is None or self._jobs_done < max_jobs)):
            try:
                self._connect()
                backoff.reset()  # a completed handshake re-arms the base delay
                self._consume(stop, max_jobs)
            except AuthError:
                # Deterministic rejection: reconnecting with the same
                # token can never succeed, so fail loudly instead of
                # spinning in the reconnect loop forever.
                logger.error("worker %s: broker rejected credentials; giving up", self.worker_id)
                raise
            except (ConnectionError, OSError, ProtocolError) as e:
                if (stop.is_set() or self._drain_req.is_set()
                        or (max_jobs is not None and self._jobs_done >= max_jobs)):
                    break
                delay = backoff.next_delay()
                logger.info("worker %s reconnecting in %.2gs after: %s", self.worker_id, delay, e)
                self._close()
                time.sleep(delay)

    def _work_multihome(self, stop: threading.Event,
                        max_jobs: Optional[int]) -> None:
        """Multi-homed consume: one manager thread per shard.

        Each :class:`_ShardConn` gets a daemon manager that owns its
        connect/receive/redial cycle end to end and feeds decoded batches
        into ONE shared ready-queue tagged ``(conn, gen, batch)``; this
        thread evaluates from the queue, acks each batch's credit back to
        the shard that dispatched it, and never blocks on any single
        shard's link — the per-shard independence the sharding design
        requires (a SIGKILLed shard costs only its own in-flight window,
        which its journal requeues).
        """
        import queue as _queue

        ready_q: "_queue.Queue" = _queue.Queue()
        self._conns = [
            _ShardConn(host, port, _ReconnectBackoff(
                self.reconnect_delay, self.reconnect_max_delay,
                f"{self.worker_id}:{host}:{port}"))
            for host, port in (self._addrs or ())
        ]
        _get_registry().gauge(
            "worker_homes", worker=self.worker_id).set(len(self._conns))
        for conn in self._conns:
            threading.Thread(
                target=self._shard_manager, args=(conn, stop, ready_q),
                name=f"gentun-shard-{conn.shard}", daemon=True).start()
        try:
            self._consume_multihome(stop, max_jobs, ready_q)
        finally:
            self._stop.set()  # managers: no more redials
            for conn in self._conns:
                self._graceful_close_conn(conn)
            # The shared send path may still point at a closed shard
            # socket; null it so work()'s _graceful_close is a no-op.
            self._sock = None
            self._rfile = None

    def _shard_manager(self, conn: _ShardConn, stop: threading.Event,
                       ready_q) -> None:
        """Own one shard's connection: dial, handshake, advertise the full
        credit window, then pump decoded batches into the shared queue.
        Redials under the conn's OWN backoff — a flapping shard inflates
        only its own delay (satellite regression: test_shard.py)."""
        while not (stop.is_set() or self._stop.is_set()
                   or self._drain_req.is_set()):
            try:
                self._connect_conn(conn)
                conn.backoff.reset()
                # Per-broker credit: each shard gets this
                # worker's FULL window — the worker picks work first-ready
                # across shards, so per-shard under-use costs nothing,
                # while a partitioned advertisement would idle the worker
                # whenever one shard had no tenants.
                self._send_conn(conn, {
                    "type": "ready",
                    "credit": self.capacity + self.prefetch_depth})
                gen = conn.gen
                rfile = conn.rfile  # pin: never read a future connection
                while True:
                    msg = self._recv(rfile=rfile)
                    if msg["type"] in ("jobs", "jobs2"):
                        jobs = (list(msg["jobs"]) if msg["type"] == "jobs"
                                else expand_jobs2(msg))
                        for chunk in self._chunk_jobs(jobs):
                            ready_q.put((conn, gen, chunk))
                    elif msg["type"] != "welcome":
                        logger.warning("unexpected message %r", msg["type"])
            except AuthError as e:
                # Terminal for THIS shard only: a healthy shard keeps this
                # worker alive; the consume loop raises only when every
                # shard has rejected us.
                conn.dead = True
                logger.error("worker %s: shard %s rejected credentials",
                             self.worker_id, conn.shard)
                ready_q.put((conn, conn.gen, e))
                return
            except (ConnectionError, OSError, ProtocolError) as e:
                if (stop.is_set() or self._stop.is_set()
                        or self._drain_req.is_set()):
                    break
                self._close_conn(conn)
                delay = conn.backoff.next_delay()
                logger.info("worker %s reconnecting to shard %s in %.2gs after: %s",
                            self.worker_id, conn.shard, delay, e)
                if stop.wait(delay):
                    break

    def _consume_multihome(self, stop: threading.Event,
                           max_jobs: Optional[int], ready_q) -> None:
        import queue as _queue

        while not stop.is_set() and (max_jobs is None or self._jobs_done < max_jobs):
            _health.beat("worker_consume")
            if self._drain_req.is_set():
                # Drain fan-out: hand every locally-queued batch back to
                # the shard that dispatched it, and announce the drain on
                # EVERY live connection so no shard redispatches here.
                returned: Dict[str, List[str]] = {}
                while True:
                    try:
                        conn, gen, item = ready_q.get_nowait()
                    except _queue.Empty:
                        break
                    if isinstance(item, list) and gen == conn.gen:
                        returned.setdefault(conn.shard, []).extend(
                            str(j["job_id"]) for j in item if "job_id" in j)
                for conn in self._conns:
                    if conn.dead or not conn.handshaken:
                        continue
                    self._announce_drain(returned.get(conn.shard, []), conn=conn)
                return
            try:
                conn, gen, item = ready_q.get(timeout=0.25)
            except _queue.Empty:
                continue
            if isinstance(item, BaseException):
                if all(c.dead for c in self._conns):
                    raise item  # every shard rejected this worker
                continue
            if gen != conn.gen or conn.sock is None:
                # Stale batch from a dead connection: the broker already
                # requeued these jobs at disconnect — evaluating them here
                # would only duplicate work the fleet is redoing.
                continue
            self._bind_conn(conn)
            try:
                self._evaluate_batch(item)
                # Replenish exactly this batch's credit AT ITS SHARD.
                self._send_conn(conn, {"type": "ready", "credit": len(item)})
            except (ConnectionError, OSError, ProtocolError) as e:
                logger.info("worker %s: shard %s link lost mid-batch: %s",
                            self.worker_id, conn.shard, e)
                if conn.gen == gen:
                    # Gen guard: the manager may have redialed already —
                    # never close a NEWER connection than the one we used.
                    self._close_conn(conn)

    def _ops_status(self) -> Dict[str, Any]:
        """The ``/statusz`` "worker" block when the ops plane runs inside
        a worker process (``--ops-port``)."""
        out = {
            "worker_id": self.worker_id,
            "capacity": self.capacity,
            "prefetch_depth": self.prefetch_depth,
            "jobs_done": self._jobs_done,
            "connected": self._handshaken.is_set(),
            "draining": self._drain_req.is_set(),
            "multihost": self.multihost,
            # Wire fast path: advertised vs broker-granted capabilities
            # (empty grant ⇔ a v1 broker on the other end).
            "wire_caps": sorted(self._wire_caps),
            "wire_caps_granted": sorted(self._broker_caps),
        }
        if self._mesh_shape is not None:
            # Host-mesh mode: the shape capacity was derived from.
            out["mesh"] = {"pop": self._mesh_shape[0],
                           "data": self._mesh_shape[1],
                           "devices": self._mesh_devices,
                           "derived_capacity": self._mesh_auto}
        # Padding-waste split (big-genome regime): slots trained and sliced
        # away on the pop axis vs batch lanes GSPMD pads on the data axis —
        # the two ways a misaligned schedule burns device time.
        _reg = _get_registry()
        out["pad_waste"] = {
            "pop": _reg.counter("eval_pad_waste_total").value,
            "data": _reg.counter("eval_data_pad_waste_total").value,
        }
        if self._cache_client is not None:
            out["fitness_service"] = self._cache_client.stats()
        if self._compile_client is not None:
            out["compile_cache"] = self._compile_client.stats()
        if self._conns:
            # Multi-home panel: one row per shard connection.
            out["homes"] = [{
                "shard": c.shard,
                "connected": c.handshaken,
                "dead": c.dead,
                "boot_id": c.boot_id,
                "wire_caps_granted": sorted(c.caps),
            } for c in self._conns]
        return out

    # -- elastic membership -------------------------------------------------

    @property
    def draining(self) -> bool:
        """True once :meth:`drain` or :meth:`shutdown` has been requested."""
        return self._drain_req.is_set()

    def drain(self, reason: str = "drain") -> None:
        """Request an orderly exit (elastic membership; thread-safe).

        The consume loop notices at its next batch boundary: the window
        currently training FINISHES and its results are delivered, any
        batches still queued locally are returned to the broker by id
        (redelivered to the rest of the fleet immediately), and
        :meth:`work` returns.  A worker blocked waiting for its first jobs
        in the serial (``prefetch_depth=0``) flow only notices when a
        frame arrives — use :meth:`shutdown` for an immediate hard stop.

        ``reason`` attributes the drain on the wire ("drain"|"preempt");
        the broker stamps it on the requeue lineage events so preemption
        churn is separable from operator drains.  Anything else degrades
        to "drain" broker-side.
        """
        if reason == "preempt":
            self._drain_reason = "preempt"
        self._drain_req.set()

    def shutdown(self) -> None:
        """Hard stop: set work()'s stop event (the broker's disconnect
        requeue covers everything in flight).  Thread-safe; the escalation
        path when a drain cannot complete (no more jobs coming)."""
        self._drain_req.set()  # don't reconnect on the way out
        stop = self._work_stop
        if stop is not None:
            stop.set()

    def advertise(self, capacity: Optional[int] = None,
                  prefetch_depth: Optional[int] = None) -> None:
        """Re-advertise capacity/prefetch to the broker (elastic membership).

        Updates the local values (the next evaluation window re-chunks to
        the new capacity) and sends the OPTIONAL ``advertise`` frame; an
        old broker logs-and-ignores it, leaving hello-time values in
        force.  Best-effort — a send failure surfaces on the next frame.
        """
        if capacity is not None:
            self.capacity = max(1, int(capacity))
        if prefetch_depth is not None:
            self.prefetch_depth = max(
                0, min(int(prefetch_depth), 4 * self.capacity))
        frame = {
            "type": "advertise",
            "capacity": self.capacity,
            "prefetch_depth": self.prefetch_depth,
        }
        mesh = self._mesh_advert()
        if mesh is not None:
            frame["mesh"] = mesh  # host-mesh shape rides along (OPTIONAL)
        if self.preemptible:
            frame["preemptible"] = True  # placement hint (OPTIONAL)
        try:
            self._send(frame)
        except OSError:
            pass  # reconnect hello re-advertises everything anyway

    def _announce_drain(self, unstarted_job_ids: List[str],
                        conn: Optional[_ShardConn] = None) -> None:
        """Send the ``drain`` frame; never raises (broker death during a
        drain just means the disconnect requeue does the whole job).
        ``conn`` routes the frame to ONE shard in multi-home mode."""
        frame: Dict[str, Any] = {"type": "drain",
                                 "requeue": list(unstarted_job_ids)}
        if self._drain_reason != "drain":
            # OPTIONAL attribution — the default is never sent, so an
            # operator drain's frame is byte-identical to before.
            frame["reason"] = self._drain_reason
        try:
            if conn is not None:
                self._send_conn(conn, frame)
            else:
                self._send(frame)
        except OSError:
            pass
        logger.info("worker %s draining: returned %d queued job(s)%s",
                    self.worker_id, len(unstarted_job_ids),
                    f" to shard {conn.shard}" if conn is not None else "")

    def _work_follower(self) -> int:
        """Ranks other than 0: evaluate what the leader broadcasts, reply never.

        The return value counts EVALUATIONS PERFORMED on this rank, which
        can exceed the leader's completed-job count when a connection drop
        makes the broker redeliver a window (followers evaluate it twice,
        the leader replies once).  ``max_jobs`` does not apply here: the
        leader decides when the worker is done, with the shutdown sentinel.
        A leader that dies without sending it (SIGKILL, OOM) ends this rank
        with code 17: by the watchdog within ~10 s, or as soon as the
        leader's store port is gone after a collective fails.
        """
        self._jobs_done = 0
        watchdog_stop = self._mh.start_leader_watchdog()
        try:
            while True:
                try:
                    jobs = self._mh.broadcast_payload(None)
                    if jobs is None:
                        return self._jobs_done
                    self._evaluate_batch(jobs)
                except Exception:
                    if self._mh.leader_gone():
                        logger.error("a collective failed and the leader's store port is "
                                     "gone; follower rank %d exiting with code 17",
                                     self._mh.process_index())
                        os._exit(17)
                    raise
        finally:
            watchdog_stop.set()

    def _consume(self, stop: threading.Event, max_jobs: Optional[int]) -> None:
        if self.prefetch_depth == 0:
            self._consume_serial(stop, max_jobs)
        else:
            self._consume_pipelined(stop, max_jobs)

    def _consume_serial(self, stop: threading.Event, max_jobs: Optional[int]) -> None:
        """The pre-pipelining loop, preserved verbatim for ``prefetch_depth=0``.

        One ``ready`` → one blocking read → one evaluation per iteration:
        the worker sits idle for a full results→breed→dispatch round trip
        between windows, but the frame sequence is exactly the historical
        one — the bit-identity anchor for determinism and chaos tests.
        """
        while not stop.is_set() and (max_jobs is None or self._jobs_done < max_jobs):
            _health.beat("worker_consume")
            if self._drain_req.is_set():
                # Serial flow holds nothing locally: announce with an empty
                # requeue list (credit already granted is covered by the
                # disconnect requeue) and exit at this batch boundary.
                self._announce_drain([])
                return
            self._send({"type": "ready", "credit": self.capacity})
            # The broker delivers everything our credit allows as ONE `jobs`
            # frame (credit-based prefetch), so a capacity-N worker receives
            # its whole batch in a single blocking read — no drain window, no
            # read timeouts through the buffered reader, and the batch trains
            # as one batched program whatever the network latency was.
            # (Batches near the protocol size cap arrive split into several
            # frames, trained one frame per loop iteration — see protocol.py.)
            jobs = self._await_jobs()
            if self.multihost:
                # Ship the window to every rank BEFORE evaluating: all ranks
                # must enter the same evaluation, and its collectives, together.
                self._mh.broadcast_payload(jobs)
            self._evaluate_batch(jobs)

    def _consume_pipelined(self, stop: threading.Event, max_jobs: Optional[int]) -> None:
        """Double-buffered consume: receive decodes while evaluate trains.

        A background thread owns THIS connection's read side and feeds a
        local ready-queue of decoded job batches; the evaluate loop drains
        it.  The initial ``ready`` advertises the full window
        (``capacity + prefetch_depth``), so the broker keeps a next window
        queued at the worker while the current one trains — when a batch
        finishes, its successor is already decoded and the next program
        enqueues immediately (asynchronous CUDA launches overlap host-side decode
        and result framing with device compute).  Each completed batch
        replenishes exactly its own credit, holding broker-side credit at
        the window ceiling.

        Fault composition: the receiver thread forwards its terminal
        exception through the queue, so broker death or an injected recv
        fault re-raises in this loop and takes the normal ``work()``
        reconnect path.  Batches still sitting in the local queue at
        disconnect are simply dropped — the broker's requeue-on-disconnect
        covers every dispatched-unacked job, queued-but-unstarted ones
        included (at-least-once, unchanged).
        """
        import queue as _queue

        rfile = self._rfile  # pin: never read a future connection's stream
        ready_q: "_queue.Queue" = _queue.Queue()

        def _receiver() -> None:
            try:
                while True:
                    msg = self._recv(rfile=rfile)
                    if msg["type"] in ("jobs", "jobs2"):
                        # Over-subscribed credit can coalesce up to
                        # capacity + prefetch_depth jobs into one frame;
                        # evaluate in capacity-sized (mesh-aligned)
                        # programs so prefetch changes WHEN work is
                        # decoded, never the compiled batch shape — or a
                        # poison genome's all-or-nothing blast radius
                        # (ack-after-work failure reporting stays per
                        # evaluation group).  A jobs2 frame expands its
                        # shared envelope once (protocol.py "Wire fast
                        # path") before the same chunking.
                        for chunk in self._chunk_frame(msg):
                            ready_q.put(chunk)
                    elif msg["type"] != "welcome":
                        logger.warning("unexpected message %r", msg["type"])
            except BaseException as e:  # forwarded, re-raised by the consumer
                ready_q.put(e)

        rx = threading.Thread(target=_receiver, name="gentun-recv", daemon=True)
        rx.start()
        # The receiver exits via its pinned rfile: when work() closes this
        # socket (reconnect or teardown), the blocked readline raises/EOFs
        # and the thread dies with it — no separate stop signal needed.
        self._send({"type": "ready", "credit": self.capacity + self.prefetch_depth})
        while not stop.is_set() and (max_jobs is None or self._jobs_done < max_jobs):
            _health.beat("worker_consume")
            if self._drain_req.is_set():
                # Batch boundary: the window we were evaluating has already
                # been acked.  Hand every batch still queued locally back to
                # the broker by id — those jobs redeliver to the rest of the
                # fleet NOW instead of waiting out our disconnect.
                unstarted: List[str] = []
                while True:
                    try:
                        item = ready_q.get_nowait()
                    except _queue.Empty:
                        break
                    if isinstance(item, list):
                        unstarted.extend(
                            str(j["job_id"]) for j in item if "job_id" in j)
                self._announce_drain(unstarted)
                return
            try:
                item = ready_q.get(timeout=0.25)
            except _queue.Empty:
                continue  # poll stop/max_jobs while the fleet is idle
            if isinstance(item, BaseException):
                raise item
            jobs = item
            if self.multihost:
                # Ship the window to every rank BEFORE evaluating: all ranks
                # must enter the same evaluation, and its collectives, together.
                self._mh.broadcast_payload(jobs)
            self._evaluate_batch(jobs)
            self._send({"type": "ready", "credit": len(jobs)})

    def _chunk_jobs(self, jobs: List[Dict[str, Any]]) -> List[List[Dict[str, Any]]]:
        """Split a ``jobs`` frame into evaluation-window batches.

        Windows are ``capacity``-sized; in host-mesh mode the window is
        additionally aligned DOWN to the mesh pop-axis multiple.  A
        capacity that is not a pop-multiple would pad EVERY window to the
        next multiple (``eval_pad_waste_total`` climbing forever) and
        alternate the compiled batch shape between full and tail windows;
        aligning down keeps every full window on ONE cached compile shape
        with zero padding.  Only a frame's final partial chunk can land
        off-multiple — it buckets and pads exactly as a small generation
        tail always has.  Per-chip workers (integer capacity, no mesh)
        keep the historical capacity-sized chunking bit-for-bit.

        Big-genome regime: jobs are first partitioned by size class
        (``parallel.mesh.job_size_class`` on the wire config — jax-free,
        micro-gated) so a window never mixes mesh shapes.  Small jobs keep
        the windowed chunking above; big/micro jobs get the per-class
        window ``host_worker_capacity`` derives for them — exactly 1, one
        genome per ``(1, n_devices)`` data-sharded program — and are
        emitted AFTER the small windows so each frame flips the mesh shape
        at most once (``mesh_reshapes_total``).  With no ``device_budget``
        in any job's config every job classifies small and the historical
        chunking is bit-for-bit unchanged.
        """
        from ..parallel.mesh import SIZE_SMALL, job_size_class

        n_dev = self._mesh_devices or 1
        small = []
        narrow = []
        for job in jobs:
            params = job.get("additional_parameters") if isinstance(job, dict) else None
            if job_size_class(params, n_dev) == SIZE_SMALL:
                small.append(job)
            else:
                narrow.append([job])
        step = self.capacity
        pop = self._mesh_shape[0] if self._mesh_shape else 1
        if pop > 1 and step % pop:
            step = max(pop, step - step % pop)
        chunks = [small[i:i + step] for i in range(0, len(small), step)]
        chunks.extend(narrow)
        return chunks

    def _chunk_frame(self, msg: Dict[str, Any]) -> List[List[Dict[str, Any]]]:
        """Expand one ``jobs``/``jobs2`` frame and chunk it for evaluation.

        A frame marked ``packed: true`` was sized broker-side as ONE
        mesh-aligned evaluation window (cross-session window packing,
        DISTRIBUTED.md) — it must come back from ``_chunk_jobs`` as
        exactly one chunk.  If it does not, the broker's capacity mirror
        (``_pack_step``) and this worker's advertisement disagree: log
        loudly, bump ``packed_window_resplit_total``, and evaluate the
        chunks anyway — degraded amortization, never dropped work.
        """
        jobs = (list(msg["jobs"]) if msg["type"] == "jobs"
                else expand_jobs2(msg))
        chunks = self._chunk_jobs(jobs)
        if msg.get("packed") is True and len(chunks) > 1:
            logger.error(
                "packed window of %d job(s) re-split into %d evaluation "
                "chunks on worker %s (capacity %d): broker and worker "
                "disagree on the window size; evaluating anyway",
                len(jobs), len(chunks), self.worker_id, self.capacity)
            _get_registry().counter("packed_window_resplit_total").inc()
        return chunks

    def _await_jobs(self) -> List[Dict[str, Any]]:
        while True:
            msg = self._recv()
            if msg["type"] == "jobs":
                return list(msg["jobs"])
            if msg["type"] == "jobs2":
                return expand_jobs2(msg)
            # Only "welcome" (handshake replay after reconnect) is benign;
            # the broker never replies to pings.
            if msg["type"] != "welcome":
                logger.warning("unexpected message %r", msg["type"])

    # -- evaluation --------------------------------------------------------

    def _evaluate_batch(self, jobs: List[Dict[str, Any]]) -> None:
        """Rebuild individuals from wire genes and train them.

        Jobs sharing identical ``additional_parameters`` go through
        ``Population.evaluate`` so the species' batched path is
        used when available; singletons fall back to ``get_fitness()``.
        """
        # worker_idle_s: the gap between consecutive evaluation batches on
        # this connection — the dispatch bubble the pipelined consume loop
        # exists to hide.  Anchored at the previous batch's END so training
        # time never counts as idleness; reconnect gaps are excluded
        # (anchor reset in _connect).
        _health.beat("worker_evaluate")
        t_start = time.monotonic()
        if _tele.enabled() and self._last_batch_end is not None:
            idle = t_start - self._last_batch_end
            _tele.record_span(
                "worker_idle", self._last_batch_end, idle,
                trace=jobs[0].get("trace") if jobs else None,
                attrs={"worker": self.worker_id},
            )
            _get_registry().histogram("worker_idle_s").observe(idle)
        # Grouping stays client-side (rather than delegating wholly to
        # Population.evaluate) so a raising group fails ONLY its own jobs;
        # the key matches populations._group_by_params: _freeze, collision-
        # free for numpy-array params, with unhashables isolated.
        from ..individuals import _freeze

        groups: Dict[Any, List[Dict[str, Any]]] = {}
        for job in jobs:
            try:
                # no_memo jobs (protocol.py "Canary messages": the canary
                # plane's dedup bypass) must never share a Population — and
                # therefore a fitness cache — with memoizing jobs.
                key = (_freeze(job.get("additional_parameters") or {}),
                       bool(job.get("no_memo")))
                hash(key)
            except TypeError:
                key = ("__unhashable__", id(job))
            groups.setdefault(key, []).append(job)

        logger.info("window of %d job(s) in %d group(s) of %s", len(jobs), len(groups),
                    [len(g) for g in groups.values()])
        for group in groups.values():
            params = group[0].get("additional_parameters") or {}
            # ONE defensive copy per evaluation group, shared by every
            # individual and the Population (wire fast path: a jobs2 window
            # already shares one decoded params object; this keeps the v1
            # path at one copy too instead of N+1).  Evaluators treat
            # additional_parameters as read-only — the grouping above keys
            # on its VALUE, so a mutating evaluator was already broken.
            shared_params = dict(params)
            individuals = []
            ok_jobs = []
            for job in group:
                # OPTIONAL per-job fidelity tag (protocol.py "Multi-fidelity
                # field"): validated BEFORE the individual is built, so an
                # unknown or mislabeled tag answers with a structured fail
                # frame — one lost job the master retries or re-routes — and
                # never a poison-genome crash or, worse, a wrong-schedule
                # fitness silently poisoning a rung.  Tagless jobs (old
                # masters) skip the check entirely.
                reason = self._check_fidelity(job)
                if reason is not None:
                    logger.warning("job %s rejected: %s", job["job_id"], reason)
                    self._try_send_fail(job["job_id"], reason)
                    continue
                try:
                    ind = self.species(
                        x_train=self.x_train,
                        y_train=self.y_train,
                        genes=job["genes"],
                        additional_parameters=shared_params,
                    )
                    individuals.append(ind)
                    ok_jobs.append(job)
                except Exception as e:  # bad genes off the wire
                    logger.exception("job %s: cannot build individual", job["job_id"])
                    self._try_send_fail(job["job_id"], f"build: {e!r}")
            if not individuals:
                continue
            # Canary dedup bypass: a no_memo group neither consults nor
            # publishes to the shared fitness store — every evaluation is
            # real, so a sealed golden genome keeps exercising the full
            # training path instead of memoizing after its first probe.
            no_memo = bool(group[0].get("no_memo"))
            pop = Population(
                self.species,
                x_train=self.x_train,
                y_train=self.y_train,
                individual_list=individuals,
                additional_parameters=shared_params,
                # None ⇒ fresh per-group cache (a no_memo group gets one too)
                fitness_cache=None if no_memo else self._store_cache,
            )
            try:
                inj = self._injector
                if inj is not None:
                    for job in ok_jobs:
                        inj.worker_pre_eval(self, job)
                # Count true store-FILE hits BEFORE evaluating: `trained`
                # alone can't distinguish store answers from in-batch dedup,
                # and same-session accumulated measurements aren't cross-run
                # reuse — this log exists to prove the latter.
                store_hits = 0
                if self._store_cache is not None and not no_memo:
                    store_hits = sum(
                        1 for ind in individuals
                        if pop._safe_cache_key(ind) in self._store_keys
                    )
                captured: Optional[List[Dict[str, Any]]] = None
                if _tele.enabled():
                    # Adopt the master's trace context off the job payload,
                    # collect every span this group produces (the `eval`
                    # wrapper plus Population.evaluate's nested `train` and
                    # any model-level compile/train/eval), and ship them
                    # home in the first result frame of the group.
                    eval_attrs: Dict[str, Any] = {"jobs": len(individuals)}
                    # Tenant attribution (protocol.py "Session messages"):
                    # a session-tagged group labels its worker-side spans.
                    session = ok_jobs[0].get("session")
                    if session:
                        eval_attrs["session"] = str(session)
                    t_eval0 = time.monotonic()
                    with _tele.attach(ok_jobs[0].get("trace")), _tele.capture() as captured:
                        with _tele.span("eval", eval_attrs):
                            pop.evaluate()
                        # Search forensics (telemetry/lineage.py): when the
                        # master stamped the forensics flag into the trace,
                        # split the group's device time into one `device`
                        # span per job — (session, genome, rung, worker)
                        # attribution cells.  Emitted INSIDE the capture so
                        # they ship home and the broker bills them (an
                        # in-process ledger write here would double-count).
                        if _lineage.wants_device_spans(ok_jobs[0].get("trace")):
                            share = (time.monotonic() - t_eval0) / len(ok_jobs)
                            for i, job in enumerate(ok_jobs):
                                _lineage.emit_device(
                                    share,
                                    # jobs2 entries carry the broker's
                                    # already-computed genome key; v1 jobs
                                    # fall back to hashing locally.
                                    job.get("gk") or _lineage.genome_key(job["genes"]),
                                    rung=(job.get("fidelity") or {}).get("rung", 0),
                                    session=str(session) if session else None,
                                    worker=self.worker_id,
                                    job=job["job_id"],
                                    start_monotonic=t_eval0 + i * share)
                    for rec in captured:
                        rec.setdefault("src", self.worker_id)
                else:
                    pop.evaluate()
                if store_hits:
                    logger.info(
                        "fitness store answered %d/%d job(s) without training",
                        store_hits, len(individuals),
                    )
                entries = []
                for job, ind in zip(ok_jobs, individuals):
                    fitness = ind.get_fitness()
                    if inj is not None and inj.take_fitness_corrupt(job["job_id"]):
                        # fitness_corrupt (faults.py): the eval succeeded but
                        # the reported number is wrong — the silent-corruption
                        # class only the canary's bit-equality check catches.
                        fitness = inj.corrupt_fitness(fitness)
                    entry = {"job_id": job["job_id"], "fitness": fitness}
                    if job.get("session"):
                        # Echo the tenant tag (OPTIONAL; the broker keys on
                        # job_id — the echo is for wire-level attribution).
                        entry["session"] = job["session"]
                    entries.append(entry)
                    self._jobs_done += 1
                if self._is_leader and entries:
                    # The whole capacity window acks as ONE `results` frame
                    # (protocol.coalesce_results) instead of a TCP frame per
                    # job — the worker-side half of the batched-dispatch
                    # contract, and the lever on the tail-regime RPC floor.
                    # The group's span report (capped well under the frame
                    # limit; spans are ~200 bytes each) rides the first frame.
                    for msg in coalesce_results(entries, spans=captured[:500] if captured else None):
                        if self._boot_id is not None:
                            # Epoch echo (OPTIONAL): lets a journal-restarted
                            # broker drop results minted under a prior boot.
                            msg["boot"] = self._boot_id
                        self._send(msg)
                    for entry in entries:
                        logger.info("job %s done: fitness %.6g", entry["job_id"], entry["fitness"])
            except Exception as e:
                # Evaluation is all-or-nothing per group: report every job so
                # the broker can redeliver (ack-after-work semantics).
                logger.exception("batch evaluation failed")
                for job in ok_jobs:
                    self._try_send_fail(job["job_id"], f"evaluate: {e!r}")
                if self.multihost:
                    # The ranks may have parted mid-collective: the jobs are
                    # requeued above, and the worker stops on every rank.
                    raise
        self._last_batch_end = time.monotonic()
        if self._compile_client is not None:
            # Publish-after-first-compile for every species (the models-
            # layer hook only covers the CNN path): one dir-mtime stat
            # when nothing changed, a write-behind enqueue when the batch
            # just built the kernel library.
            self._compile_client.scan_publish()

    @staticmethod
    def _check_fidelity(job: Dict[str, Any]) -> Optional[str]:
        """None when the job's fidelity tag is absent or checks out;
        otherwise the structured-``fail`` reason string.

        The tag's fingerprint must match what this worker computes from
        the SHIPPED ``additional_parameters`` — a mismatch means the
        master's rung label and the training schedule in the payload
        disagree (a mixed-version fleet, or a relabeled overlay), and
        training it would file a wrong-fidelity fitness under the rung's
        cache key.  Unknown tag versions are refused the same way rather
        than guessed at.
        """
        tag = job.get("fidelity")
        if tag is None:
            return None  # old master — pre-ladder protocol, evaluate as-is
        if not isinstance(tag, dict) or tag.get("v") != 1:
            return (f"fidelity: unknown tag version {tag!r}; this worker "
                    f"understands v=1 — upgrade the fleet together")
        from ..utils.fitness_store import fidelity_fingerprint

        expected = fidelity_fingerprint(job.get("additional_parameters") or {})
        if tag.get("fingerprint") != expected:
            return (f"fidelity: tag fingerprint {tag.get('fingerprint')!r} does "
                    f"not match the shipped config ({expected}) at rung "
                    f"{tag.get('rung')} — refusing a mislabeled schedule")
        return None

    def _try_send_fail(self, job_id: str, reason: str) -> None:
        if not self._is_leader:
            return  # follower ranks hold no connection; the leader reports
        try:
            msg = {"type": "fail", "job_id": job_id, "reason": reason[:2000]}
            if self._boot_id is not None:
                msg["boot"] = self._boot_id
            self._send(msg)
        except OSError:
            pass  # connection gone; broker requeues via disconnect path
