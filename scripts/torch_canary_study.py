"""Measured canary-plane study: does the black-box sentinel earn its keep?

Five arms, one committed artifact (``scripts/torch_canary_study.json``):

- **detection matrix** — for each fault class the canary exists to catch
  (``fitness_corrupt`` silent wrong-answer, worker hang, shard kill),
  measure the number of probe cycles until the canary flags it, then
  project worst-case detection latency across probe cadences
  (``latency ≤ cycles × cadence + probe_timeout``).  The golden is
  sealed by a clean fleet first, so the corruption arm tests the
  *verify* path, not first-seal.
- **clean arm** — ≥100 consecutive probe cycles against a healthy fleet:
  every probe ``ok``, zero drift, zero errors.  The false-positive
  floor: a canary that cries wolf is worse than no canary.
- **overhead arm** — a tenant search (jobs that sleep ``train_s`` per
  evaluation, the realistic cost asymmetry: probes are rung-0 trivia,
  tenant jobs train) beside a live canary, with the search-forensics
  cost ledger ON.  Canary device-seconds, attributed to ``canary-*``
  sessions by the same broker-side billing path tenants use, must be
  ≤1% of fleet total.
- **wire identity** — canary OFF must cost zero bytes: the frames a
  tag-less ``SessionClient`` sends are byte-equal to hand-built
  pre-canary encodings (no ``tag`` key), and a real broker's
  ``session_ok``/pre-dispatch ``session_stats`` replies are byte-equal
  to the legacy layout (no ``ttfd_s`` before first dispatch).
- **tenant isolation** — a deterministic OneMax search beside a live
  probing canary is bit-identical to the single-process reference:
  probes never steer a search.

CPU-only, a few seconds: ``python scripts/torch_canary_study.py`` writes
``scripts/torch_canary_study.json``.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import GeneticAlgorithm, Individual, Population, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import (  # noqa: E402
    FaultInjector,
    FaultPlan,
    FaultSpec,
    GentunClient,
    JobBroker,
    SessionClient,
)
from gentun_tpu_torch.distributed.protocol import decode, encode  # noqa: E402
from gentun_tpu_torch.telemetry import RunTelemetry, lineage  # noqa: E402
from gentun_tpu_torch.telemetry import spans as spans_mod  # noqa: E402
from gentun_tpu_torch.telemetry.canary import CanaryDaemon  # noqa: E402
from gentun_tpu_torch.telemetry.registry import get_registry  # noqa: E402

GENERATIONS = 5
POP_SIZE = 8
POP_SEED, GA_SEED = 42, 7
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))

#: study-wide probe timeout — also the per-cycle latency bound in the
#: detection matrix (a probe that will fail takes at most this long).
PROBE_TIMEOUT = 1.5
#: probe cadences (seconds) the matrix projects detection latency over —
#: from aggressive (canary fleet) to lazy (cron-ish).
CADENCES = (0.25, 1.0, 5.0, 30.0)


class OneMax(Individual):
    """Deterministic bit-count fitness — local and distributed runs are
    comparable bit-for-bit (same species as scripts/torch_chaos_run.py)."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


class SleepTrain(Individual):
    """OneMax with a paid training bill: evaluation sleeps ``train_s``
    from ``additional_parameters``.  Tenant jobs ship a real budget;
    canary probes ship none and fall back to ~rung-0 cost — the
    asymmetry the ≤1% overhead gate is a statement about."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        time.sleep(float(self.additional_parameters.get("train_s", 0.002)))
        return float(sum(sum(g) for g in self.genes.values()))


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _worker(port, injector=None, worker_id=None, species=None):
    stop = threading.Event()
    client = GentunClient(
        species or OneMax, *DATA, host="127.0.0.1", port=port,
        worker_id=worker_id,
        heartbeat_interval=0.2, reconnect_delay=0.05, reconnect_max_delay=0.5,
        fault_injector=injector,
    )
    t = threading.Thread(target=lambda: client.work(stop_event=stop), daemon=True)
    t.start()
    return stop


def _wait_members(broker, n, timeout=10.0):
    # Worker swaps must settle broker-side before probing, or a draining
    # predecessor absorbs the probe and the cycle count measures the
    # handoff instead of the canary (same guard as torch_chaos_run.py).
    deadline = time.time() + timeout
    while broker.fleet_members() != n and time.time() < deadline:
        time.sleep(0.05)
    assert broker.fleet_members() == n, f"fleet never settled at {n}"


def _probes(species=OneMax):
    return [{"genes": Population(species, *DATA, size=1,
                                 seed=POP_SEED)[0].get_genes()}]


def _daemon(port, probes, timeout=PROBE_TIMEOUT):
    return CanaryDaemon([f"127.0.0.1:{port}"], probes, space_key="study",
                        probe_interval=999, probe_timeout=timeout,
                        serve_http=False)


def _snapshot(ga):
    return {
        "best_fitness_history": [r["best_fitness"] for r in ga.history],
        "final_population": [
            {"genes": {k: list(v) for k, v in ind.get_genes().items()},
             "fitness": ind.get_fitness()}
            for ind in ga.population
        ],
        "n_architectures_evaluated": len(ga.population.fitness_cache),
    }


# ---------------------------------------------------------------------------
# arm 1: detection-latency matrix
# ---------------------------------------------------------------------------


def _measure_fault(kind):
    """Cycles-to-detect for one fault class on a fresh fleet.

    The golden is sealed by a clean worker FIRST (seal-then-fault), so
    every class exercises the steady-state verify path."""
    get_registry().reset()
    broker = JobBroker(port=0).start()
    port = broker.address[1]
    stop = _worker(port, worker_id=f"dm-{kind}-w0")
    cn = _daemon(port, _probes())
    try:
        sealed = cn.probe_once()
        assert sealed["result"] == "ok" and sealed["newly_sealed"], sealed

        if kind == "shard_kill":
            stop.set()
            broker.stop()
            r = cn.probe_once()
            assert r["result"] == "error" and r["stage"] == "open", r
            return {"cycles_to_detect": 1, "signal": "error", "stage": "open"}

        stop.set()
        _wait_members(broker, 0)
        if kind == "fitness_corrupt":
            inj = FaultInjector(FaultPlan([FaultSpec(
                hook="worker_pre_eval", kind="fitness_corrupt", at=0)]))
        else:  # worker_hang
            inj = FaultInjector(FaultPlan([FaultSpec(
                hook="worker_pre_eval", kind="hang", at=0,
                duration=PROBE_TIMEOUT * 2)]))
        stop = _worker(port, injector=inj, worker_id=f"dm-{kind}-w1")
        _wait_members(broker, 1)
        cycles = 0
        for _ in range(4):
            cycles += 1
            r = cn.probe_once()
            if r["result"] != "ok":
                break
        if kind == "fitness_corrupt":
            assert r["result"] == "drift", r
            assert [s["kind"] for s in inj.fired] == ["fitness_corrupt"]
            return {"cycles_to_detect": cycles, "signal": "drift",
                    "stage": "verify"}
        assert r["result"] == "error" and r["stage"] == "result", r
        return {"cycles_to_detect": cycles, "signal": "error",
                "stage": "result"}
    finally:
        cn.stop()
        stop.set()
        broker.stop()


def run_detection_matrix() -> dict:
    classes = {k: _measure_fault(k)
               for k in ("fitness_corrupt", "worker_hang", "shard_kill")}
    # Worst-case wall-clock latency at each cadence: the fault lands just
    # after a probe, waits out `cycles` inter-probe gaps, and the flagging
    # probe itself takes at most the timeout.
    latency = {
        k: {str(c): round(v["cycles_to_detect"] * c + PROBE_TIMEOUT, 3)
            for c in CADENCES}
        for k, v in classes.items()
    }
    assert all(v["cycles_to_detect"] == 1 for v in classes.values()), classes
    return {
        "probe_timeout_s": PROBE_TIMEOUT,
        "cadences_s": list(CADENCES),
        "fault_classes": classes,
        "worst_case_latency_s": latency,
        "latency_model": "cycles_to_detect * cadence + probe_timeout",
    }


# ---------------------------------------------------------------------------
# arm 2: clean fleet, zero false alarms
# ---------------------------------------------------------------------------


def run_clean_arm(cycles: int = 120) -> dict:
    get_registry().reset()
    broker = JobBroker(port=0).start()
    port = broker.address[1]
    stop = _worker(port, worker_id="clean-w0")
    cn = _daemon(port, _probes(), timeout=10.0)
    t0 = time.monotonic()
    try:
        results = [cn.probe_once()["result"] for _ in range(cycles)]
        wall = time.monotonic() - t0
        stats = cn.stats()
    finally:
        cn.stop()
        stop.set()
        broker.stop()
    bad = [r for r in results if r != "ok"]
    assert not bad, f"clean fleet raised {len(bad)} false alarm(s): {bad[:5]}"
    assert stats["drift_total"] == 0 and stats["error_total"] == 0, stats
    return {
        "cycles": cycles,
        "ok": results.count("ok"),
        "false_alarms": len(bad),
        "drift_total": stats["drift_total"],
        "error_total": stats["error_total"],
        "wall_s": round(wall, 3),
        "probe_p50_ms_approx": round(1000.0 * wall / cycles, 3),
    }


# ---------------------------------------------------------------------------
# arm 3: chip-second overhead under the cost ledger
# ---------------------------------------------------------------------------


def run_overhead_arm() -> dict:
    """Tenant search beside a live canary, forensics plane ON: the cost
    ledger (the SAME broker-side billing path that meters tenants)
    attributes canary probe device time to its ``canary-*`` sessions —
    the ≤1% gate is measured, not asserted from cadence math."""
    script_dir = os.path.dirname(os.path.abspath(__file__))
    tele_path = os.path.join(script_dir, ".torch_canary_study_telemetry.jsonl")
    run_tele = RunTelemetry(tele_path, label="canary-study").install()
    get_registry().reset()
    lineage.reset_ledger()
    lineage.enable()
    broker = JobBroker(port=0).start()
    port = broker.address[1]
    stops = [_worker(port, worker_id="oh-w0", species=SleepTrain),
             _worker(port, worker_id="oh-w1", species=SleepTrain)]
    cn = _daemon(port, _probes(SleepTrain), timeout=10.0)
    train_s = 0.08
    try:
        _wait_members(broker, 2)
        sid = broker.open_session("tenant-a")
        # Distinct genomes so neither worker fitness caches nor broker
        # memoization swallows the tenant's training bill.
        pool = Population(SleepTrain, *DATA, size=48, seed=11)
        seen, genomes = set(), []
        for ind in pool:
            gk = lineage.genome_key(ind.get_genes())
            if gk not in seen:
                seen.add(gk)
                genomes.append(ind.get_genes())
        probe_records = []
        n_rounds = 4
        per_round = len(genomes) // n_rounds
        job_i = 0
        for rnd in range(n_rounds):
            batch = genomes[rnd * per_round:(rnd + 1) * per_round]
            with spans_mod.span("tenant_round", {"round": rnd}):
                ctx = lineage.forensic_context(spans_mod.current_context())
                payloads = {}
                for g in batch:
                    payloads[f"oh-{job_i}"] = {
                        "genes": g,
                        "additional_parameters": {"train_s": train_s},
                        "trace": ctx,
                    }
                    job_i += 1
                broker.submit(payloads, session=sid)
            probe_records.append(cn.probe_once())
            pending = set(payloads)
            deadline = time.monotonic() + 60
            while pending and time.monotonic() < deadline:
                res, fails = broker.wait_any(sorted(pending), timeout=60)
                assert not fails, f"tenant jobs failed: {fails}"
                pending -= set(res)
            assert not pending, f"tenant jobs stuck: {sorted(pending)[:5]}"
        probe_records.append(cn.probe_once())
        by_session = lineage.get_ledger().by_session()
    finally:
        cn.stop()
        for s in stops:
            s.set()
        broker.stop()
        lineage.disable()
        lineage.reset_ledger()
        run_tele.close()
        if os.path.exists(tele_path):
            os.unlink(tele_path)
        get_registry().reset()

    assert all(r["result"] == "ok" for r in probe_records), probe_records
    canary_s = sum(v for k, v in by_session.items() if k.startswith("canary-"))
    tenant_s = by_session.get("tenant-a", 0.0)
    total_s = sum(by_session.values())
    # Both sides must actually be billed — a zero canary bill would make
    # the gate pass vacuously with the attribution path broken.
    assert canary_s > 0, f"canary probes never billed: {by_session}"
    assert tenant_s >= job_i * train_s * 0.9, (tenant_s, job_i)
    overhead_pct = 100.0 * canary_s / total_s
    assert overhead_pct <= 1.0, (
        f"canary overhead {overhead_pct:.3f}% exceeds the 1% gate "
        f"({by_session})")
    return {
        "tenant_jobs": job_i,
        "tenant_train_s_per_job": train_s,
        "tenant_device_s": round(tenant_s, 6),
        "canary_probes": len(probe_records),
        "canary_sessions_billed": sum(
            1 for k in by_session if k.startswith("canary-")),
        "canary_device_s": round(canary_s, 6),
        "fleet_device_s": round(total_s, 6),
        "overhead_pct": round(overhead_pct, 4),
        "gate_pct": 1.0,
        "within_gate": True,
    }


# ---------------------------------------------------------------------------
# arm 4: canary-off wire byte-identity
# ---------------------------------------------------------------------------


def _capture_client_frames() -> list:
    """Raw frames a tag-less SessionClient sends, recorded by a stub
    broker that speaks just enough protocol to keep the client moving."""
    frames = []
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def serve():
        conn, _ = srv.accept()
        rf = conn.makefile("rb")
        conn.sendall(encode({"type": "welcome"}))
        while True:
            line = rf.readline()
            if not line:
                break
            frames.append(line)
            msg = decode(line)
            t = msg.get("type")
            if t in ("session_open", "session_close", "session_detach"):
                conn.sendall(encode({"type": "session_ok",
                                     "session": msg.get("session") or "s-x"}))
            elif t == "session_stats":
                conn.sendall(encode({
                    "type": "session_stats",
                    "session": msg.get("session") or "default",
                    "capacity": 1, "prefetch": 1, "mesh_pop": 0,
                    "chips": []}))
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    client = SessionClient("127.0.0.1", port, reconnect=False)
    try:
        client.open_session("wire-s0", weight=2.0)
        client.open_session("wire-s1", weight=1.0, max_in_flight=4)
        client.session_stats("wire-s0")
        client.close_session("wire-s0")
    finally:
        client.close()
        srv.close()
    t.join(timeout=5.0)
    return frames


def run_wire_identity() -> dict:
    """Canary off ⇒ zero wire delta, both directions, checked in bytes.

    Client→broker: a SessionClient that never passes ``tag`` emits
    frames byte-equal to hand-built pre-canary encodings.  Broker→client:
    a real broker's ``welcome``/``session_ok``/pre-dispatch
    ``session_stats`` replies are byte-equal to the legacy layout —
    ``ttfd_s`` is absent until a session's first dispatch."""
    frames = _capture_client_frames()
    expected = [
        {"type": "hello", "role": "client", "token": None},
        {"type": "session_open", "weight": 2.0, "session": "wire-s0"},
        {"type": "session_open", "weight": 1.0, "session": "wire-s1",
         "max_in_flight": 4},
        {"type": "session_stats", "session": "wire-s0"},
        {"type": "session_close", "session": "wire-s0"},
    ]
    assert len(frames) == len(expected), [decode(f) for f in frames]
    for raw, legacy in zip(frames, expected):
        assert raw == encode(legacy), (raw, encode(legacy))
        assert b'"tag"' not in raw

    # Broker replies, against a live broker over a raw socket.
    broker = JobBroker(port=0).start()
    try:
        port = broker.address[1]
        s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        rf = s.makefile("rb")
        s.sendall(encode({"type": "hello", "role": "client", "token": None}))
        welcome_raw = rf.readline()
        assert welcome_raw == encode({"type": "welcome"}), welcome_raw
        s.sendall(encode({"type": "session_open", "weight": 1.0,
                          "session": "wire-t0"}))
        open_raw = rf.readline()
        assert open_raw == encode({"type": "session_ok",
                                   "session": "wire-t0"}), open_raw
        s.sendall(encode({"type": "session_stats", "session": "wire-t0"}))
        stats_raw = rf.readline()
        reply = decode(stats_raw)
        assert set(reply) == {"type", "session", "capacity", "prefetch",
                              "mesh_pop", "chips"}, reply
        legacy_stats = {"type": "session_stats", "session": "wire-t0",
                        "capacity": reply["capacity"],
                        "prefetch": reply["prefetch"],
                        "mesh_pop": reply["mesh_pop"],
                        "chips": reply["chips"]}
        assert stats_raw == encode(legacy_stats), stats_raw
        s.close()
    finally:
        broker.stop()
    return {
        "client_frames_checked": [e["type"] for e in expected],
        "broker_replies_checked": ["welcome", "session_ok",
                                   "session_stats(pre-dispatch)"],
        "ttfd_absent_pre_dispatch": True,
        "tag_absent_when_unset": True,
        "identical": True,
    }


# ---------------------------------------------------------------------------
# arm 5: tenant search beside a live canary is bit-identical
# ---------------------------------------------------------------------------


#: Searches arm 5 may run beside the canary to land three probes.
MAX_BESIDE_SEARCHES = 10


def run_bit_identity() -> dict:
    # More generations than the other arms: the OneMax search is cheap,
    # and the canary needs enough wall-clock to land several probes
    # DURING the search for the contention claim to mean anything.
    generations = 12
    get_registry().reset()
    clean = GeneticAlgorithm(
        Population(OneMax, *DATA, size=POP_SIZE, seed=POP_SEED), seed=GA_SEED)
    clean.run(generations)
    ref = _snapshot(clean)

    from gentun_tpu_torch.distributed import DistributedPopulation
    port = _free_port()
    stops = [_worker(port, worker_id="bi-w0"), _worker(port, worker_id="bi-w1")]
    cn = None
    try:
        pop = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1", port=port,
            job_timeout=120, heartbeat_timeout=1.0)
        try:
            # Free-running canary against the tenant's own broker — real
            # scheduler contention, not a staged one.
            cn = CanaryDaemon([f"127.0.0.1:{port}"], _probes(),
                              space_key="study-bi", probe_interval=0.02,
                              probe_timeout=10.0, serve_http=False).start()
            # A fast host can finish the search before the canary probed
            # three times: the same search (same seeds, a fresh population
            # on the same broker) then runs again beside the same live
            # canary, every run held to the reference, until three probes
            # landed or MAX_BESIDE_SEARCHES ran.
            beside = []
            while True:
                tenant = pop if not beside else DistributedPopulation(
                    OneMax, size=POP_SIZE, seed=POP_SEED, broker=pop.broker,
                    job_timeout=120, heartbeat_timeout=1.0)
                ga = GeneticAlgorithm(tenant, seed=GA_SEED)
                ga.run(generations)
                beside.append(_snapshot(ga))
                if (cn.stats()["ok_total"] >= 3
                        or len(beside) >= MAX_BESIDE_SEARCHES):
                    break
            cn.stop()
            stats = cn.stats()
        finally:
            pop.close()
    finally:
        if cn is not None:
            cn.stop()
        for s in stops:
            s.set()
    print(f"[tenant isolation] {len(beside)} search(es) of {generations} "
          f"generations beside the canary: {stats}", flush=True)
    assert stats["ok_total"] >= 3, (
        f"canary barely probed during the search: {stats}")
    assert stats["drift_total"] == 0, stats
    assert all(b == ref for b in beside), (
        "search beside live canary diverged from reference")
    return {
        "generations": generations,
        "population": POP_SIZE,
        "canary_probes_during_search": stats["cycles"],
        "canary_ok": stats["ok_total"],
        "canary_drift": stats["drift_total"],
        "best_fitness_history": ref["best_fitness_history"],
        "bit_identical": True,
    }


def run() -> dict:
    t0 = time.monotonic()
    out = {
        "detection_matrix": run_detection_matrix(),
        "clean_arm": run_clean_arm(),
        "overhead": run_overhead_arm(),
        "wire_identity": run_wire_identity(),
        "tenant_isolation": run_bit_identity(),
    }
    out["wall_s"] = round(time.monotonic() - t0, 3)
    return out


if __name__ == "__main__":
    out = run()
    print(json.dumps(out, indent=2))
    path = out_path("torch_canary_study.json")
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
