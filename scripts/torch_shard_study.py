"""Horizontal broker sharding study → ``torch_shard_study.json``.

Four proofs, one artifact (DISTRIBUTED.md "Horizontal broker sharding"):

A. **Bit-identity** — a 2-shard ``DistributedPopulation`` GA run lands
   bit-identical to the single-broker reference: session-affine
   placement means one search sees ONE broker's scheduling semantics
   regardless of fleet shape.
B. **Throughput** — ``broker_throughput.run_shard_curve``'s 1→2-shard
   aggregate scaling is ≥1.8× (serial-isolation methodology; see that
   function's docstring for why wall-clock concurrency is the wrong
   instrument on a near-single-core host).
C. **Crash safety** — ``chaos_run.run_shard_kill``: SIGKILL-equivalent
   ``kill()`` of one of two shards mid-swarm loses ZERO searches; both
   concurrent searches finish bit-identical to no-kill references.
D. **Back-compat** — a one-element ``broker_urls`` list is wire
   BYTE-identical to passing ``host``/``port``, proved by capturing the
   raw frames both variants send at a stub broker (worker hello+ready,
   master hello+session_open+submit).

CPU-only, under a minute: ``python scripts/torch_shard_study.py``.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import GeneticAlgorithm  # noqa: E402
from gentun_tpu_torch.distributed import (  # noqa: E402
    DistributedPopulation,
    GentunClient,
    JobBroker,
)
from gentun_tpu_torch.distributed.sessions import SessionClient  # noqa: E402

from torch_chaos_run import DATA, OneMax, run_shard_kill  # noqa: E402
from torch_broker_throughput import run_shard_curve  # noqa: E402

POP_SIZE, POP_SEED, GA_SEED, GENERATIONS = 8, 42, 7, 3


# -- arm A: 2-shard bit-identity -----------------------------------------


def _spawn_worker(urls_or_port, worker_id):
    stop = threading.Event()
    kwargs = dict(capacity=2, worker_id=worker_id,
                  heartbeat_interval=0.2, reconnect_delay=0.05)
    if isinstance(urls_or_port, list):
        client = GentunClient(OneMax, *DATA, broker_urls=urls_or_port, **kwargs)
    else:
        client = GentunClient(OneMax, *DATA, host="127.0.0.1",
                              port=urls_or_port, **kwargs)
    t = threading.Thread(target=lambda: client.work(stop_event=stop),
                         daemon=True)
    t.start()
    return client, stop


def _ga_fingerprint(pop):
    return {
        "per_individual_fitness": [i.get_fitness() for i in pop.individuals],
        "best_fitness": pop.get_fittest().get_fitness(),
    }


def run_bit_identity() -> dict:
    """A 2-shard run vs the single-broker reference, same seeds."""
    b1 = JobBroker(host="127.0.0.1", port=0).start()
    b2 = JobBroker(host="127.0.0.1", port=0).start()
    urls = [f"127.0.0.1:{b.address[1]}" for b in (b1, b2)]
    worker = stop = pop = None
    try:
        worker, stop = _spawn_worker(urls, "study-sh-w0")
        pop = DistributedPopulation(OneMax, size=POP_SIZE, seed=POP_SEED,
                                    maximize=True, broker_urls=urls,
                                    session="study-session")
        GeneticAlgorithm(pop, seed=GA_SEED).run(GENERATIONS)
        sharded = _ga_fingerprint(pop)
    finally:
        if pop is not None:
            pop.close()
        if stop is not None:
            stop.set()
        if worker is not None:
            worker.shutdown()
        b1.stop()
        b2.stop()

    ref_worker = ref_stop = ref = None
    try:
        ref = DistributedPopulation(OneMax, size=POP_SIZE, seed=POP_SEED,
                                    maximize=True, port=0)
        ref_worker, ref_stop = _spawn_worker(ref.broker_address[1],
                                             "study-ref-w0")
        GeneticAlgorithm(ref, seed=GA_SEED).run(GENERATIONS)
        reference = _ga_fingerprint(ref)
    finally:
        if ref is not None:
            ref.close()
        if ref_stop is not None:
            ref_stop.set()
        if ref_worker is not None:
            ref_worker.shutdown()

    identical = sharded == reference
    assert identical, (
        f"2-shard run diverged from single-broker reference:\n"
        f"  sharded:   {sharded}\n  reference: {reference}")
    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "seeds": {"population": POP_SEED, "ga": GA_SEED},
        "shards": 2,
        "sharded": sharded,
        "single_broker_reference": reference,
        "bit_identical": identical,
    }


# -- arm D: single-URL wire byte-identity --------------------------------


class _FrameTap:
    """Stub broker for the byte-identity proof: accepts ONE connection,
    answers handshake frames with canned replies, and records every raw
    line the client sends — the wire bytes themselves, not a decoded
    approximation."""

    def __init__(self, replies):
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self.lines: list = []
        self._replies = replies
        self._lock = threading.Lock()
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        try:
            conn, _ = self._srv.accept()
        except OSError:
            return
        rfile = conn.makefile("rb")
        while True:
            try:
                line = rfile.readline()
            except OSError:
                break
            if not line:
                break
            with self._lock:
                self.lines.append(line)
            reply = self._replies.get(json.loads(line).get("type"))
            if reply is not None:
                try:
                    conn.sendall((json.dumps(reply) + "\n").encode())
                except OSError:
                    break
        try:
            conn.close()
        except OSError:
            pass

    def wait_lines(self, n, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if len(self.lines) >= n:
                    return [bytes(x) for x in self.lines[:n]]
            time.sleep(0.01)
        raise AssertionError(
            f"stub broker saw only {len(self.lines)}/{n} frames")

    def close(self):
        try:
            self._srv.close()
        except OSError:
            pass


def _capture_worker_frames(use_urls: bool) -> list:
    """The first two frames (hello, ready) a worker sends at connect."""
    tap = _FrameTap({"hello": {"type": "welcome", "boot_id": "tap"}})
    stop = threading.Event()
    kwargs = dict(capacity=2, worker_id="bytes-w0",
                  heartbeat_interval=60.0, reconnect_delay=0.05)
    url = f"127.0.0.1:{tap.port}"
    if use_urls:
        client = GentunClient(OneMax, *DATA, broker_urls=[url], **kwargs)
    else:
        client = GentunClient(OneMax, *DATA, host="127.0.0.1",
                              port=tap.port, **kwargs)
    t = threading.Thread(target=lambda: client.work(stop_event=stop),
                         daemon=True)
    t.start()
    try:
        return tap.wait_lines(2)
    finally:
        stop.set()
        tap.close()
        t.join(timeout=10.0)
        client.shutdown()


def _capture_master_frames(use_urls: bool) -> list:
    """The first three frames (hello, session_open, submit) a tenant
    client sends."""
    tap = _FrameTap({
        "hello": {"type": "welcome", "boot_id": "tap"},
        "session_open": {"type": "session_ok", "session": "bytes-sess"},
    })
    url = f"127.0.0.1:{tap.port}"
    if use_urls:
        sc = SessionClient(broker_urls=[url])
    else:
        sc = SessionClient("127.0.0.1", tap.port)
    try:
        sc.open_session("bytes-sess")
        sc.submit("bytes-sess", {"bytes-job": {
            "genes": {"S_1": [0, 1, 0, 1, 0, 1], "S_2": [1, 0, 1, 0, 1, 0]},
            "additional_parameters": {"nodes": (4, 4)},
        }})
        return tap.wait_lines(3)
    finally:
        sc.close()
        tap.close()


def run_byte_identity() -> dict:
    """``broker_urls=[one]`` must put the SAME BYTES on the wire as
    ``host``/``port`` — worker side and master side."""
    worker_classic = _capture_worker_frames(use_urls=False)
    worker_urls = _capture_worker_frames(use_urls=True)
    assert worker_classic == worker_urls, (
        f"worker single-URL frames diverged:\n"
        f"  host/port:   {worker_classic}\n  broker_urls: {worker_urls}")

    master_classic = _capture_master_frames(use_urls=False)
    master_urls = _capture_master_frames(use_urls=True)
    assert master_classic == master_urls, (
        f"master single-URL frames diverged:\n"
        f"  host/port:   {master_classic}\n  broker_urls: {master_urls}")

    return {
        "worker_frames_compared": len(worker_classic),
        "worker_bytes_compared": sum(len(x) for x in worker_classic),
        "worker_byte_identical": True,
        "master_frames_compared": len(master_classic),
        "master_bytes_compared": sum(len(x) for x in master_classic),
        "master_byte_identical": True,
        "worker_frame_types": [json.loads(x)["type"] for x in worker_classic],
        "master_frame_types": [json.loads(x)["type"] for x in master_classic],
    }


def main() -> dict:
    t0 = time.monotonic()
    out = {
        "bit_identity": run_bit_identity(),
        "single_url_byte_identity": run_byte_identity(),
        "throughput": run_shard_curve(),
        "shard_kill": run_shard_kill(),
    }
    assert out["throughput"]["within_gate"], (
        f"1->2 shard scaling {out['throughput']['scale_1_to_2']}x "
        f"below the 1.8x gate")
    out["proofs"] = {
        "two_shard_bit_identical": out["bit_identity"]["bit_identical"],
        "scale_1_to_2": out["throughput"]["scale_1_to_2"],
        "shard_kill_searches_lost": out["shard_kill"]["searches_lost"],
        "single_url_wire_byte_identical": (
            out["single_url_byte_identity"]["worker_byte_identical"]
            and out["single_url_byte_identity"]["master_byte_identical"]),
    }
    out["wall_s"] = round(time.monotonic() - t0, 3)
    return out


if __name__ == "__main__":
    result = main()
    print(json.dumps(result, indent=2))
    path = out_path("torch_shard_study.json")
    stamp(result)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(f"wrote {path}", file=sys.stderr)
