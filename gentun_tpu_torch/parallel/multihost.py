"""Multi-process execution over ``torch.distributed``: one process (rank) per CUDA card.

The port's counterpart of the JAX package's multi-controller module.  There,
one process drives every local device and ``jax.distributed`` joins the
hosts of a slice into one device mesh.  Here the unit is one process per
card: a worker with several cards on one host and a worker spread over
several hosts are the same code, ``N`` ranks of one process group, rank 0
the leader (it alone owns the broker connection, writes checkpoints and
logs results).

- :func:`initialize` joins (or, on rank 0, founds) the group through a TCP
  store at ``coordinator`` and gives each rank ``cuda:{local_rank %
  device_count}``.  The backend is NCCL when every rank has a card of its
  own; ranks that share a card need ``backend="gloo"`` (NCCL refuses two
  ranks on one GPU), given explicitly: ``initialize`` never switches
  backend by itself.
- :func:`place` / :func:`place_tree` put a host value that every rank holds
  whole (the data pipeline is deterministic per seed) onto this rank's
  device.
- :func:`fetch` all-gathers each rank's share of a small host result so
  every rank gets the whole value and the ranks stay in lockstep.
- :func:`broadcast_payload` ships rank 0's JSON-serialisable object (a
  window of job payloads) to every rank: a length, then a padded byte
  buffer of a bucketed size.
- :func:`start_leader_watchdog` exits a follower with code 17 when the
  leader's store port stops answering.

Host values (:func:`fetch`, :func:`broadcast_payload`) ride a gloo group of
their own as CPU tensors, whatever the device backend: gloo's CUDA support
covers ``all_reduce`` and ``broadcast`` only, and NCCL takes no CPU tensor.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "initialize",
    "shutdown",
    "process_count",
    "process_index",
    "is_leader",
    "local_device",
    "row_group",
    "place",
    "place_tree",
    "fetch",
    "broadcast_payload",
    "coordinator_reachable",
    "leader_gone",
    "start_leader_watchdog",
]

logger = logging.getLogger("gentun_tpu_torch")

#: The follower waits in :func:`broadcast_payload` for the next window for
#: as long as the master has no work; a dead leader is the watchdog's to
#: notice, not a timeout's.
HOST_TIMEOUT = datetime.timedelta(days=7)
#: How long :func:`initialize` waits for every rank to reach the store.
INIT_TIMEOUT = datetime.timedelta(minutes=10)

#: Coordinator address recorded by :func:`initialize`: rank 0's store port
#: doubles as the leader-liveness signal of :func:`start_leader_watchdog`.
_coordinator: Optional[str] = None
_device: Optional[torch.device] = None
_host_group = None
#: ``(pop, data)`` → this rank's data-axis group (None when data is 1).
_row_groups: Dict[Tuple[int, int], Any] = {}


def _dist():
    import torch.distributed as dist

    return dist


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    backend: Optional[str] = None,
) -> None:
    """Join the process group of ``num_processes`` ranks as rank ``process_id``.

    ``coordinator`` is ``host:port`` of rank 0, which serves the TCP store
    there.  Each rank takes ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK``
    from the environment, else the rank).  Every rank publishes which card
    it took; ``backend=None`` means NCCL, and raises ``ValueError`` when two
    ranks share a card or a rank has none: such ranks run over
    ``backend="gloo"``, which the caller names.
    """
    global _coordinator, _device, _host_group
    dist = _dist()
    world, rank = int(num_processes), int(process_id)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"process_id {process_id} is not a rank of {num_processes} processes")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    host, _, port = str(coordinator).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator must be 'host:port', got {coordinator!r}")
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device("cuda", local % n_cards) if n_cards else None
    store = dist.TCPStore(host, int(port), world, is_master=(rank == 0), timeout=INIT_TIMEOUT)
    card = f"{socket.gethostname()}:{device.index}" if device is not None else f"none:{rank}"
    store.set(f"gentun/card/{rank}", card)
    cards = [store.get(f"gentun/card/{r}").decode() for r in range(world)]
    if backend in (None, "nccl"):
        shared = len(set(cards)) < world
        if shared or any(c.startswith("none:") for c in cards):
            raise ValueError(
                f"NCCL needs one CUDA card per rank; these {world} ranks hold "
                f"{sorted(cards)}: ranks that share a card (or have none) must "
                f"ask for backend='gloo' explicitly")
        backend = "nccl"
    if device is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    _host_group = dist.new_group(backend="gloo", timeout=HOST_TIMEOUT)
    _coordinator, _device = f"{host}:{port}", device
    _row_groups.clear()
    logger.info("torch.distributed initialized: rank %d/%d, backend %s, device %s, cards %s",
                rank, world, backend, device, cards)


def shutdown() -> None:
    """Leave the process group (a no-op when none was joined here)."""
    global _coordinator, _device, _host_group
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _coordinator, _device, _host_group = None, None, None
    _row_groups.clear()


def process_count() -> int:
    """Ranks in the group (1 when none was initialized)."""
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_leader() -> bool:
    """True on the rank that owns external I/O (broker connection, logs)."""
    return process_index() == 0


def local_device() -> torch.device:
    """This rank's card; raises when the rank has none (the port never falls
    back to the CPU by itself: a caller asks for it with ``mesh='cpu'``)."""
    if _device is None:
        raise RuntimeError(
            "this rank has no CUDA device; pass mesh='cpu' to run the ranks on the CPU")
    return _device


def row_group(pop_axis: int, data_axis: int):
    """This rank's group along the data axis of a ``(pop, data)`` grid of the
    world's ranks (rank ``r`` at row ``r // data``), or ``None`` for a data
    axis of 1.  Every row's group is built on every rank, in row order, the
    first time a shape is asked for (``new_group`` is collective), and kept."""
    key = (int(pop_axis), int(data_axis))
    if key not in _row_groups:
        mine = None
        if key[1] > 1:
            dist = _dist()
            row = process_index() // key[1]
            for r in range(key[0]):
                g = dist.new_group(ranks=list(range(r * key[1], (r + 1) * key[1])))
                if r == row:
                    mine = g
        _row_groups[key] = mine
    return _row_groups[key]


def place(x: Any, device: torch.device) -> torch.Tensor:
    """A host value every rank holds whole → a tensor on ``device``; a tensor
    already there passes through untouched."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def place_tree(tree: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """:func:`place` over a flat dict of leaves."""
    return {k: place(v, device) for k, v in tree.items()}


def fetch(x: Any, ranks: Optional[Sequence[int]] = None, dim: int = 0) -> np.ndarray:
    """Each rank's share → the whole value as numpy, on every rank.

    All-gathers ``x`` (the same shape on every rank) and concatenates the
    shares of ``ranks`` (default: every rank, in order) along ``dim``.  One
    process: ``x`` as numpy.  The gather rides the host group on the CPU.
    """
    t = torch.as_tensor(x).detach().cpu().contiguous()
    if process_count() == 1:
        return t.numpy()
    dist = _dist()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t, group=_host_group)
    keep = range(len(parts)) if ranks is None else ranks
    return torch.cat([parts[r] for r in keep], dim=dim).numpy()


def _bucket_bytes(n: int) -> int:
    """Buffer sizes in powers of two ≥ 256 bytes."""
    b = 256
    while b < n:
        b *= 2
    return b


def broadcast_payload(obj: Any = None) -> Any:
    """Ship rank 0's JSON-serialisable object to every rank.

    Rank 0 passes the object; the others pass anything (ignored) and receive
    rank 0's.  Two broadcasts on the host group: an int64 length, then a
    uint8 buffer whose bucketed size every rank derives from the length.
    """
    if process_count() == 1:
        return obj
    dist = _dist()
    data = json.dumps(obj).encode("utf-8") if is_leader() else b""
    n = torch.tensor([len(data)], dtype=torch.int64)
    dist.broadcast(n, src=0, group=_host_group)
    size = int(n.item())
    buf = torch.zeros(_bucket_bytes(size), dtype=torch.uint8)
    if is_leader():
        buf[:size] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    dist.broadcast(buf, src=0, group=_host_group)
    return json.loads(bytes(buf[:size].numpy()).decode("utf-8"))


def coordinator_reachable(timeout: float = 1.0) -> bool:
    """One TCP connect to rank 0's store port: is the leader's process alive?"""
    if not _coordinator:
        return True
    host, port = _coordinator.rsplit(":", 1)
    try:
        with socket.create_connection((host, int(port)), timeout=timeout):
            return True
    except OSError:
        return False


def leader_gone(within: float = 10.0, interval: float = 0.2) -> bool:
    """After a failed collective: does rank 0's store port stop answering
    within ``within`` seconds?  A killed leader's sockets close as its
    process is torn down, the store's not always before the one a
    collective saw close."""
    deadline = time.monotonic() + within
    while coordinator_reachable(timeout=interval):
        if time.monotonic() >= deadline:
            return False
        time.sleep(interval)
    return True


def start_leader_watchdog(
    interval: float = 2.0,
    grace: int = 3,
    _exit=os._exit,
) -> threading.Event:
    """Bounded follower exit when the leader process dies.

    A follower waiting in :func:`broadcast_payload` (or in a collective of an
    evaluation) cannot hear from a SIGKILLed leader.  Rank 0 serves the TCP
    store, so its port is the leader's liveness signal: a daemon thread
    connects every ``interval`` seconds and hard-exits the process with code
    17 after ``grace`` misses in a row, about ``grace × (interval + 1 s)`` at
    worst, 9 s at the defaults.  ``os._exit``, because the thread stuck in
    the collective would block a normal shutdown.

    Returns a stop event: set it once the clean shutdown sentinel arrives.
    A no-op on the leader and when :func:`initialize` did not run here.
    """
    stop = threading.Event()
    if is_leader() or not _coordinator:
        return stop
    rank = process_index()

    def _loop() -> None:
        misses = 0
        while not stop.wait(interval):
            if coordinator_reachable(timeout=max(1.0, interval)):
                misses = 0
                continue
            misses += 1
            if misses >= grace and not stop.is_set():
                logger.error(
                    "leader liveness probe failed %d times (coordinator %s unreachable); "
                    "follower rank %d exiting with code 17", misses, _coordinator, rank)
                _exit(17)
                return  # unreachable with the real os._exit; ends fakes

    threading.Thread(target=_loop, name="gentun-leader-watchdog", daemon=True).start()
    return stop
