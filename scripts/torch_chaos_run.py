"""Measured chaos artifact: a full distributed search under a composed
fault plan, compared bit-for-bit against the clean run.

DISTRIBUTED.md records the happy path (0 retries, 0 requeues); this
script records the UNHAPPY path the same way — a seeded 2-worker search
surviving a worker kill mid-batch, a corrupt frame, an injected eval
failure, a hung worker (reaped + redelivered), a duplicated result
(dropped), and a master kill/resume at a generation boundary — and
asserts the headline invariant: identical best-fitness history,
evaluated-architecture set, and final population versus the fault-free
run, with zero leaked broker state.

The chaos search runs under the telemetry plane (``RunTelemetry``): every
injected fault must surface as a ``fault_injected`` event in the
telemetry artifact (asserted: the event kinds equal the kinds fired), and
bit-identity against the telemetry-free clean run doubles as proof that
telemetry never perturbs a search trajectory.

A third act (``run_stall_ops``) replays the worker-stall fault under the
live ops plane (``start_ops_server``, see docs/OBSERVABILITY.md "Live
ops plane"): an injected ``hang`` must be flagged by the stall watchdog
and surface BOTH as a ``straggler_detected`` event in the telemetry
artifact AND as a 503 on ``/healthz`` with a straggler reason — then
self-heal to 200 when the stalled result lands.  It runs separately from
the composed plan above because the composed schedule is count-based and
timing-sensitive: observation load must not decide which faults fire.

A forensics act (``run_forensics_act``) replays the poison-genome story
under the search-forensics plane (lineage ledger ON): the injected
evaluation failures must surface as ``requeued`` and ``quarantined``
lineage events in the run artifact, keyed to the poison genome — chaos
is not just survived, it is narrated.

An observability act (``run_obs_agg``) kills the fleet metrics
aggregator (``telemetry/aggregator.py``) mid-search: the shared
telemetry pusher must fail OPEN — exactly ONE ``aggregator_degraded``
event per up→down transition — and the finished search must be
bit-identical to an aggregator-free run (observability can drop data,
never steer a search).

CPU-only, a few seconds: `python scripts/torch_chaos_run.py` writes
``scripts/torch_chaos_run.json``.  The plan is serialized into the artifact, so
a recorded run can be replayed exactly.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import AsyncEvolution, GeneticAlgorithm, Individual, Population, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import (  # noqa: E402
    DistributedPopulation,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    GentunClient,
    JobBroker,
    MasterKilled,
)
from gentun_tpu_torch.telemetry import RunTelemetry, lineage  # noqa: E402
from gentun_tpu_torch.telemetry.ops_server import start_ops_server, stop_ops_server  # noqa: E402
from gentun_tpu_torch.utils import Checkpointer  # noqa: E402

GENERATIONS = 5
POP_SIZE = 8
POP_SEED, GA_SEED = 42, 7
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))


class OneMax(Individual):
    """Pure deterministic fitness — count of set bits — so local and
    distributed runs are comparable bit-for-bit."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _worker(port, injector=None, worker_id=None, species=None,
            aggregator_url=None, wire_caps=None):
    stop = threading.Event()
    client = GentunClient(
        species or OneMax, *DATA, host="127.0.0.1", port=port,
        worker_id=worker_id,
        heartbeat_interval=0.2, reconnect_delay=0.05, reconnect_max_delay=0.5,
        fault_injector=injector, aggregator_url=aggregator_url,
        wire_caps=wire_caps,
    )
    t = threading.Thread(target=lambda: client.work(stop_event=stop), daemon=True)
    t.start()
    return stop


def _healthz(url):
    """(status_code, reasons) — non-2xx handled, not raised."""
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=5.0) as resp:
            return resp.status, json.loads(resp.read()).get("reasons", [])
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()).get("reasons", [])


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


def run() -> dict:
    # -- clean reference (single-process; OneMax purity makes it comparable)
    clean = GeneticAlgorithm(
        Population(OneMax, *DATA, size=POP_SIZE, seed=POP_SEED), seed=GA_SEED)
    clean.run(GENERATIONS)

    # -- the composed plan: every fault kind, against a live search --------
    # The `at` schedule is tuned to the pipelined dispatch plane's
    # observed per-worker event counts (chaos-w0 sees ~7 pre-evals and
    # ~6 result sends over the 5 generations — double buffering spreads
    # jobs differently than the serial loop the original schedule was
    # tuned against).  The hang is last so the reap it provokes cannot
    # starve the later client_send specs of their events.
    worker_plan = FaultPlan([
        FaultSpec(hook="client_send", kind="drop_connection", match_type="results", at=0),
        FaultSpec(hook="client_send", kind="duplicate_result", match_type="results", at=2),
        FaultSpec(hook="client_send", kind="corrupt", match_type="results", at=3),
        FaultSpec(hook="client_recv", kind="delay", at=2, delay=0.05),
        FaultSpec(hook="worker_pre_eval", kind="fail_eval", at=1),
        FaultSpec(hook="worker_pre_eval", kind="hang", at=5, duration=2.5),
    ], seed=2026)
    master_plan = FaultPlan([
        FaultSpec(hook="master_boundary", kind="kill_master", generation=2),
    ], seed=2026)

    w0_inj = FaultInjector(worker_plan)
    kill_inj = FaultInjector(master_plan)

    port = _free_port()
    script_dir = os.path.dirname(os.path.abspath(__file__))
    ckpt_path = os.path.join(script_dir, ".torch_chaos_ckpt.json")
    if os.path.exists(ckpt_path):
        os.unlink(ckpt_path)
    # Telemetry wraps the WHOLE chaos story (both acts, both workers —
    # in-process threads share the run sink); the clean reference above
    # ran telemetry-free, so bit-identity below also proves the plane
    # is trajectory-neutral.
    tele_path = os.path.join(script_dir, ".torch_chaos_telemetry.jsonl")
    run_tele = RunTelemetry(tele_path, label="chaos").install()
    stops = [_worker(port, injector=w0_inj, worker_id="chaos-w0"),
             _worker(port, worker_id="clean-w1")]

    t0 = time.monotonic()
    master_killed_at = None
    try:
        # Act 1: chaos until the injected master death.
        pop_a = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1", port=port,
            job_timeout=120, heartbeat_timeout=1.0)
        try:
            ga_a = GeneticAlgorithm(pop_a, seed=GA_SEED)
            ga_a.set_fault_injector(kill_inj)
            try:
                ga_a.run(GENERATIONS, checkpointer=Checkpointer(ckpt_path))
                raise AssertionError("kill_master never fired")
            except MasterKilled as e:
                master_killed_at = e.generation
        finally:
            pop_a.close()

        # Act 2: reborn master, same port, auto-resume, run to completion.
        pop_b = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=0, host="127.0.0.1", port=port,
            job_timeout=120, heartbeat_timeout=1.0)
        try:
            ga_b = GeneticAlgorithm(pop_b, seed=0)
            ga_b.run(GENERATIONS, checkpointer=Checkpointer(ckpt_path))
            wall = time.monotonic() - t0
            chaos_snap = _snapshot(ga_b)
            leaked = ga_b.population.broker.outstanding()
        finally:
            ga_b.population.close()
            pop_b.close()
    finally:
        for s in stops:
            s.set()
        tele_summary = run_tele.close()
        if os.path.exists(ckpt_path):
            os.unlink(ckpt_path)

    clean_snap = _snapshot(clean)
    fired = list(w0_inj.fired) + list(kill_inj.fired)
    identical = clean_snap == chaos_snap
    assert identical, "chaos run diverged from the clean run"
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"
    kinds_fired = sorted({f["kind"] for f in fired})

    # -- every injected fault must surface in the telemetry artifact ------
    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    fault_events = [r for r in tele_lines
                    if r.get("type") == "event" and r.get("name") == "fault_injected"]
    assert fault_events, "telemetry artifact recorded no fault events"
    tele_event_kinds = sorted({e["data"]["kind"] for e in fault_events})
    assert tele_event_kinds == kinds_fired, (
        f"telemetry fault events {tele_event_kinds} != faults fired {kinds_fired}")
    fault_counters = [c for c in tele_summary["counters"]
                      if c["name"] == "faults_injected_total"]
    assert sum(c["value"] for c in fault_counters) == len(fired)

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "seeds": {"population": POP_SEED, "ga": GA_SEED},
        "workers": 2,
        "fault_plan": {"worker0": worker_plan.to_dict(), "master": master_plan.to_dict()},
        "faults_fired": fired,
        "fault_kinds_fired": kinds_fired,
        "master_killed_at_generation": master_killed_at,
        "bit_identical_to_clean_run": identical,
        "broker_state_after_final_gather": leaked,
        "best_fitness_history": chaos_snap["best_fitness_history"],
        "n_architectures_evaluated": chaos_snap["n_architectures_evaluated"],
        "chaos_wall_s": round(wall, 3),
        "telemetry": {
            "fault_events": len(fault_events),
            "fault_event_kinds": tele_event_kinds,
            "n_spans": tele_summary["n_spans"],
            "span_kinds": sorted(tele_summary["spans"].keys()),
        },
    }


def run_stall_ops() -> dict:
    """Worker-stall act under the live ops plane: one injected ``hang``
    (2.5 s, far past the 0.5 s watchdog floor) on a 2-worker fleet with
    the heartbeat reaper pinned out (``heartbeat_timeout=30``), so the
    stall watchdog is the only component that can act.  Asserts the stall
    surfaces BOTH as a ``straggler_detected`` event in the telemetry
    artifact AND as a straggler-attributed 503 on ``/healthz``, which
    self-heals to 200 when the hung worker's result finally lands."""
    floor_s, hang_s = 0.5, 2.5
    plan = FaultPlan([
        FaultSpec(hook="worker_pre_eval", kind="hang", at=1, duration=hang_s),
    ], seed=2026)
    inj = FaultInjector(plan)

    script_dir = os.path.dirname(os.path.abspath(__file__))
    tele_path = os.path.join(script_dir, ".torch_chaos_stall_telemetry.jsonl")
    flight_path = os.path.join(script_dir, ".torch_chaos_stall_flight.jsonl")
    run_tele = RunTelemetry(tele_path, label="chaos-stall").install()
    ops_srv = start_ops_server(port=0, flight_path=flight_path)
    healthz_samples = []  # (t_rel_s, status, straggler_attributed)
    stop_poll = threading.Event()
    t0 = time.monotonic()

    def _poll_healthz():
        while not stop_poll.is_set():
            code, reasons = _healthz(ops_srv.url)
            healthz_samples.append((round(time.monotonic() - t0, 3), code,
                                    any("straggler" in r for r in reasons)))
            time.sleep(0.1)

    poller = threading.Thread(target=_poll_healthz, daemon=True)
    port = _free_port()
    stops = [_worker(port, injector=inj, worker_id="stall-w0"),
             _worker(port, worker_id="stall-w1")]
    poller.start()
    try:
        pop = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1", port=port,
            job_timeout=120, heartbeat_timeout=30.0, straggler_floor_s=floor_s)
        try:
            ga = GeneticAlgorithm(pop, seed=GA_SEED)
            ga.run(2)
            wall = time.monotonic() - t0
            leaked = pop.broker.outstanding()
            # Final verdict sampled while the fleet is quiescent but
            # still alive — polling through pop.close() would race the
            # broker's own shutdown (sources unregistering) and could
            # record a shutdown transient as the last word.
            stop_poll.set()
            poller.join(timeout=5.0)
            final_code, final_reasons = _healthz(ops_srv.url)
            healthz_samples.append(
                (round(time.monotonic() - t0, 3), final_code,
                 any("straggler" in r for r in final_reasons)))
        finally:
            pop.close()
    finally:
        stop_poll.set()
        poller.join(timeout=5.0)
        for s in stops:
            s.set()
        tele_summary = run_tele.close()
        stop_ops_server()
        if os.path.exists(flight_path):
            os.unlink(flight_path)

    assert inj.fired, "the hang never fired"
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"

    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    # (1) the stall surfaced as straggler telemetry naming the hung worker
    straggler_events = [r for r in tele_lines
                        if r.get("type") == "event"
                        and r.get("name") == "straggler_detected"]
    assert straggler_events, "worker hang never surfaced as a straggler event"
    assert any(e["data"]["worker_id"] == "stall-w0" for e in straggler_events), (
        f"straggler events name the wrong worker: "
        f"{[e['data'] for e in straggler_events]}")
    # (2) and flipped /healthz to a straggler-attributed 503, then healed
    assert any(code == 503 and strag for _, code, strag in healthz_samples), (
        f"healthz never flipped 503 for the stall: {healthz_samples}")
    assert final_code == 200, (
        f"healthz did not recover: final={final_code} samples={healthz_samples}")
    transitions = []
    for t, code, _ in healthz_samples:
        if not transitions or transitions[-1]["status"] != code:
            transitions.append({"t_s": t, "status": code})
    detected = sum(c["value"] for c in tele_summary["counters"]
                   if c["name"] == "stragglers_detected_total")
    assert detected >= 1

    return {
        "workers": 2,
        "population_size": POP_SIZE,
        "fault_plan": plan.to_dict(),
        "straggler_floor_s": floor_s,
        "hang_s": hang_s,
        "heartbeat_timeout_s": 30.0,
        "straggler_events": len(straggler_events),
        "straggler_worker": "stall-w0",
        "stragglers_detected_total": detected,
        "healthz_transitions": transitions,
        "healthz_samples": len(healthz_samples),
        "healthz_recovered": True,
        "wall_s": round(wall, 3),
    }


def run_async_smoke() -> dict:
    """Async-mode chaos smoke: the steady-state engine under injected
    faults (a dropped ``results`` frame mid-send and an evaluation
    failure), with telemetry on.  Asserts what generational bit-identity
    cannot (2-worker async completion order is timing-dependent): the run
    completes its full budget anyway, every injected fault surfaces as a
    ``fault_injected`` telemetry event, and the broker ends quiescent."""
    budget = 24
    plan = FaultPlan([
        # fail_eval on the FIRST pre-eval: after the dropped connection
        # the clean worker can drain the whole budget before this one
        # rejoins, so only the first batch is guaranteed to reach it.
        FaultSpec(hook="worker_pre_eval", kind="fail_eval", at=0),
        FaultSpec(hook="client_send", kind="drop_connection", match_type="results", at=0),
    ], seed=2026)
    inj = FaultInjector(plan)

    script_dir = os.path.dirname(os.path.abspath(__file__))
    tele_path = os.path.join(script_dir, ".torch_chaos_async_telemetry.jsonl")
    run_tele = RunTelemetry(tele_path, label="chaos-async").install()
    port = _free_port()
    stops = [_worker(port, injector=inj, worker_id="async-chaos-w0"),
             _worker(port, worker_id="async-clean-w1")]
    t0 = time.monotonic()
    try:
        pop = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1", port=port,
            job_timeout=120, heartbeat_timeout=1.0)
        try:
            eng = AsyncEvolution(pop, tournament_size=3, seed=GA_SEED, job_timeout=120)
            best = eng.run(max_evaluations=budget)
            wall = time.monotonic() - t0
            leaked = pop.broker.outstanding()
        finally:
            pop.close()
    finally:
        for s in stops:
            s.set()
        tele_summary = run_tele.close()

    assert eng.completed == budget, f"budget not met: {eng.completed}/{budget}"
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"
    fired = list(inj.fired)
    kinds_fired = sorted({f["kind"] for f in fired})
    assert fired, "async fault plan never fired"
    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    fault_events = [r for r in tele_lines
                    if r.get("type") == "event" and r.get("name") == "fault_injected"]
    assert fault_events, "async telemetry artifact recorded no fault events"
    tele_event_kinds = sorted({e["data"]["kind"] for e in fault_events})
    assert tele_event_kinds == kinds_fired, (
        f"telemetry fault events {tele_event_kinds} != faults fired {kinds_fired}")

    return {
        "mode": "async",
        "budget": budget,
        "population_size": POP_SIZE,
        "workers": 2,
        "fault_plan": plan.to_dict(),
        "faults_fired": fired,
        "fault_kinds_fired": kinds_fired,
        "completed": eng.completed,
        "best_fitness": best.get_fitness(),
        "broker_state_after_run": leaked,
        "wall_s": round(wall, 3),
        "telemetry": {
            "fault_events": len(fault_events),
            "fault_event_kinds": tele_event_kinds,
            "n_spans": tele_summary["n_spans"],
        },
    }


def run_ladder_act() -> dict:
    """Multi-fidelity chaos act: the ASHA ladder under injected faults
    while promotions are in flight.  A dropped ``results`` frame and an
    evaluation failure land on a fleet running a 2-rung ladder; asserts
    the budget completes, every fault surfaces as a ``fault_injected``
    telemetry event, promotions actually happened and stayed within the
    eta quota, no member is left marked promotion-pending, and the
    broker ends quiescent (a leaked cancelled probe would show up as
    outstanding state)."""
    budget = 24
    ladder = [{"kfold": 2, "epochs": (1,)}, {"kfold": 5, "epochs": (4,)}]
    plan = FaultPlan([
        FaultSpec(hook="worker_pre_eval", kind="fail_eval", at=1),
        FaultSpec(hook="client_send", kind="drop_connection", match_type="results", at=0),
    ], seed=2026)
    inj = FaultInjector(plan)

    script_dir = os.path.dirname(os.path.abspath(__file__))
    tele_path = os.path.join(script_dir, ".torch_chaos_ladder_telemetry.jsonl")
    run_tele = RunTelemetry(tele_path, label="chaos-ladder").install()
    port = _free_port()
    stops = [_worker(port, injector=inj, worker_id="ladder-chaos-w0"),
             _worker(port, worker_id="ladder-clean-w1")]
    t0 = time.monotonic()
    try:
        pop = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1", port=port,
            job_timeout=120, heartbeat_timeout=1.0)
        try:
            eng = AsyncEvolution(pop, tournament_size=3, seed=GA_SEED,
                                 fidelity_ladder=ladder, eta=3, job_timeout=120)
            eng.run(max_evaluations=budget)
            wall = time.monotonic() - t0
            leaked = pop.broker.outstanding()
        finally:
            pop.close()
    finally:
        for s in stops:
            s.set()
        tele_summary = run_tele.close()

    assert eng.completed == budget, f"budget not met: {eng.completed}/{budget}"
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"
    assert not any(getattr(m, "_promo_pending", False) for m in pop), \
        "a ring member was left promotion-pending"
    promotions = sum(1 for h in eng.history if h.get("promotion"))
    r0, r1 = (len(v) for v in eng._rung_completions)
    assert promotions > 0, "the ladder never promoted under chaos"
    assert r1 <= r0 // eng.eta, f"over-promoted: rungs [{r0}, {r1}], eta {eng.eta}"
    fired = list(inj.fired)
    kinds_fired = sorted({f["kind"] for f in fired})
    assert fired, "ladder fault plan never fired"
    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    fault_events = [r for r in tele_lines
                    if r.get("type") == "event" and r.get("name") == "fault_injected"]
    assert fault_events, "ladder telemetry artifact recorded no fault events"
    tele_event_kinds = sorted({e["data"]["kind"] for e in fault_events})
    assert tele_event_kinds == kinds_fired, (
        f"telemetry fault events {tele_event_kinds} != faults fired {kinds_fired}")

    return {
        "mode": "async-ladder",
        "budget": budget,
        "ladder": [{**r, "epochs": list(r["epochs"])} for r in ladder],
        "eta": 3,
        "population_size": POP_SIZE,
        "workers": 2,
        "fault_plan": plan.to_dict(),
        "faults_fired": fired,
        "fault_kinds_fired": kinds_fired,
        "completed": eng.completed,
        "promotions": promotions,
        "rung_completions": [r0, r1],
        "best_fitness": eng.best.get_fitness(),
        "best_rung": getattr(eng.best, "_rung", None),
        "broker_state_after_run": leaked,
        "wall_s": round(wall, 3),
        "telemetry": {
            "fault_events": len(fault_events),
            "fault_event_kinds": tele_event_kinds,
            "n_spans": tele_summary["n_spans"],
        },
    }


class SlowishOneMax(OneMax):
    """OneMax with enough training delay that a mid-search service kill
    reliably lands while generations are still running."""

    def evaluate(self):
        time.sleep(0.05)
        return super().evaluate()


def run_cache_chaos() -> dict:
    """Shared-fitness-service kill act: the networked memoization cache
    (``distributed/fitness_service.py``) dies mid-search.  Cache downtime
    must never fail a search — the master degrades to its local fitness
    cache, the transition surfaces as ONE ``fitness_service_degraded``
    telemetry event, and the finished search is bit-identical to a
    service-off run (a cache can only skip retraining, never steer)."""
    from gentun_tpu_torch.distributed.fitness_service import FitnessService

    # Service-off reference: single-process, telemetry-free, same seeds.
    ref = GeneticAlgorithm(
        Population(SlowishOneMax, *DATA, size=POP_SIZE, seed=POP_SEED),
        seed=GA_SEED)
    ref.run(GENERATIONS)

    svc = FitnessService(port=0).start()
    script_dir = os.path.dirname(os.path.abspath(__file__))
    tele_path = os.path.join(script_dir, ".torch_chaos_cache_telemetry.jsonl")
    run_tele = RunTelemetry(tele_path, label="chaos-cache").install()
    port = _free_port()
    stops = [_worker(port, worker_id="cache-w0", species=SlowishOneMax),
             _worker(port, worker_id="cache-w1", species=SlowishOneMax)]
    killed_after_gen = []
    t0 = time.monotonic()
    try:
        pop = DistributedPopulation(
            SlowishOneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1",
            port=port, job_timeout=120, cache_url=svc.url)
        try:
            ga = GeneticAlgorithm(pop, seed=GA_SEED)

            def _kill_service():
                # Pull the plug once generation 1 has landed — squarely
                # mid-search, with generations still to run.
                while not ga.history:
                    time.sleep(0.005)
                killed_after_gen.append(len(ga.history))
                svc.stop()

            killer = threading.Thread(target=_kill_service, daemon=True)
            killer.start()
            ga.run(GENERATIONS)
            killer.join(timeout=10)
            wall = time.monotonic() - t0
            chaos_snap = _snapshot(ga)
            leaked = pop.broker.outstanding()
            client_stats = pop._cache_client.stats()
        finally:
            pop.close()
    finally:
        for s in stops:
            s.set()
        run_tele.close()
        try:
            svc.stop()
        except Exception:
            pass

    ref_snap = _snapshot(ref)
    identical = chaos_snap == ref_snap
    assert identical, "cache-kill run diverged from the service-off run"
    assert len(ga.history) == GENERATIONS, "search did not complete"
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"
    assert client_stats["degraded_total"] >= 1, (
        f"service kill never degraded the client: {client_stats}")

    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    degraded_events = [r for r in tele_lines
                       if r.get("type") == "event"
                       and r.get("name") == "fitness_service_degraded"]
    assert len(degraded_events) == 1, (
        f"expected ONE degraded event per transition, got {len(degraded_events)}")

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "seeds": {"population": POP_SEED, "ga": GA_SEED},
        "workers": 2,
        "service_killed_after_generation": killed_after_gen[0],
        "search_completed": True,
        "bit_identical_to_service_off_run": identical,
        "degraded_events": len(degraded_events),
        "client": client_stats,
        "broker_state_after_final_gather": leaked,
        "wall_s": round(wall, 3),
    }


def run_surrogate_act() -> dict:
    """Surrogate rung −1 under fitness-service downtime: a gated search
    whose dataset plane (warm-start + refit-boundary sync against the
    shared fitness service) loses its service mid-run.  The gate must
    fail OPEN — degrade to admit-all with exactly ONE
    ``surrogate_degraded`` telemetry event — and the search must still
    complete its full budget: dataset downtime costs chip-time, never
    correctness.  The kill is held until the surrogate has refit (and
    synced) at least twice, so the act proves the degradation path from
    a *working* gate, not a never-trained one."""
    from gentun_tpu_torch.distributed.fitness_service import (
        FitnessService,
        FitnessServiceClient,
    )
    from gentun_tpu_torch.surrogate import FitnessSurrogate, SurrogateGate

    budget = 60
    svc = FitnessService(port=0).start()
    script_dir = os.path.dirname(os.path.abspath(__file__))
    tele_path = os.path.join(script_dir, ".torch_chaos_surrogate_telemetry.jsonl")
    run_tele = RunTelemetry(tele_path, label="chaos-surrogate").install()
    client = FitnessServiceClient(svc.url, timeout=1.0, cooldown=1.0)
    gate = SurrogateGate(FitnessSurrogate(min_train=8, refit_every=8),
                         eta=4, window=32, min_window=8,
                         dataset_client=client)
    killed_after = {}
    t0 = time.monotonic()
    try:
        pop = Population(SlowishOneMax, *DATA, size=POP_SIZE, seed=POP_SEED)
        eng = AsyncEvolution(pop, tournament_size=3, seed=GA_SEED,
                             surrogate=gate)

        def _kill_service():
            # Pull the plug only after the gate has trained, refit and
            # synced against the live service — squarely mid-search.
            while gate.surrogate.refits < 2:
                time.sleep(0.005)
            rows = client.fetch_dataset(gate._space, limit=1000) or []
            killed_after["refits"] = gate.surrogate.refits
            killed_after["dataset_rows"] = len(rows)
            svc.stop()

        killer = threading.Thread(target=_kill_service, daemon=True)
        killer.start()
        eng.run(max_evaluations=budget)
        killer.join(timeout=10)
        wall = time.monotonic() - t0
    finally:
        run_tele.close()
        try:
            client.close()
        except Exception:
            pass
        try:
            svc.stop()
        except Exception:
            pass

    assert eng.completed == budget, f"budget not met: {eng.completed}/{budget}"
    assert killed_after.get("refits", 0) >= 2, (
        f"service killed before the gate ever synced: {killed_after}")
    assert killed_after.get("dataset_rows", 0) >= gate.surrogate.min_train, (
        f"refit-boundary syncs never landed rows on the service: {killed_after}")
    assert gate.degraded, "service kill never degraded the gate"
    assert gate.degraded_total == 1, (
        f"expected ONE up->down transition, got {gate.degraded_total}")
    assert gate.surrogate.refits > killed_after["refits"], (
        "local refits must continue while degraded — degradation disables "
        "gating, not training")

    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    degraded_events = [r for r in tele_lines
                       if r.get("type") == "event"
                       and r.get("name") == "surrogate_degraded"]
    assert len(degraded_events) == 1, (
        f"expected ONE surrogate_degraded event, got {len(degraded_events)}")

    return {
        "budget": budget,
        "population_size": POP_SIZE,
        "seeds": {"population": POP_SEED, "engine": GA_SEED},
        "service_killed_after_refits": killed_after["refits"],
        "dataset_rows_on_service_at_kill": killed_after["dataset_rows"],
        "search_completed": True,
        "gate": gate.status(),
        "degraded_events": len(degraded_events),
        "degraded_transitions": gate.degraded_total,
        "refits_after_kill": gate.surrogate.refits - killed_after["refits"],
        "wall_s": round(wall, 3),
    }


def run_forensics_act() -> dict:
    """Chaos under the search-forensics plane: with the lineage ledger ON,
    the fault paths must narrate themselves in the run artifact.  A
    single-worker broker with ``max_attempts=2, quarantine_after=1`` gets
    one poison job: the first injected evaluation failure requeues it (a
    ``requeued`` lineage event, reason ``worker_fail``), the second fails
    it terminally and quarantines its genome in the session (a
    ``quarantined`` lineage event).  Asserts both surface in the lineage
    ledger keyed to the poison genome, that the quarantined genome's
    resubmission is rejected without dispatch, and that a clean genome
    still evaluates on the same worker afterwards."""
    plan = FaultPlan([
        FaultSpec(hook="worker_pre_eval", kind="fail_eval", at=0, times=2),
    ], seed=2026)
    inj = FaultInjector(plan)

    script_dir = os.path.dirname(os.path.abspath(__file__))
    tele_path = os.path.join(script_dir, ".torch_chaos_forensics_telemetry.jsonl")
    run_tele = RunTelemetry(tele_path, label="chaos-forensics").install()
    lineage.reset_ledger()
    lineage.enable()
    broker = JobBroker(port=0, max_attempts=2, quarantine_after=1,
                       heartbeat_timeout=30.0).start()
    t0 = time.monotonic()
    stops = []
    try:
        _, port = broker.address
        stops.append(_worker(port, injector=inj, worker_id="fz-chaos-w0"))
        sid = broker.open_session("fz-chaos")
        pool = Population(OneMax, *DATA, size=2, seed=13)
        poison, clean = (ind.get_genes() for ind in pool)
        gk = lineage.genome_key(poison)

        broker.submit({"fz-poison": {"genes": poison}}, session=sid)
        _, fails = broker.wait_any(["fz-poison"], timeout=30)
        assert "fz-poison" in fails, "poison job unexpectedly succeeded"
        # The quarantined genome bounces at the gate — never dispatched.
        broker.submit({"fz-again": {"genes": poison}}, session=sid)
        _, fails2 = broker.wait_any(["fz-again"], timeout=15)
        assert "quarantined" in fails2["fz-again"]
        # The worker is fine (the genome was "poison", not the process):
        # a clean genome still evaluates normally.
        broker.submit({"fz-clean": {"genes": clean}}, session=sid)
        results, fails3 = broker.wait_any(["fz-clean"], timeout=30)
        assert fails3 == {}, f"clean job failed: {fails3}"
        assert results["fz-clean"] == float(
            sum(sum(g) for g in clean.values()))
        wall = time.monotonic() - t0
        stats = broker.session_stats()[sid]
    finally:
        for s in stops:
            s.set()
        tele_summary = run_tele.close()
        lineage.disable()
        broker.stop()

    assert list(inj.fired), "the eval-failure faults never fired"
    assert stats["quarantined"] == 1 and stats["rejected"] == 1

    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    lin = [r for r in tele_lines if r.get("type") == "lineage"]
    by_event = {}
    for e in lin:
        by_event.setdefault(e["event"], []).append(e)
    requeued = [e for e in by_event.get("requeued", [])
                if e.get("genome") == gk and e.get("reason") == "worker_fail"]
    assert requeued, (
        f"injected eval failure never surfaced as a requeued lineage "
        f"event: {by_event.get('requeued')}")
    quarantined = [e for e in by_event.get("quarantined", [])
                   if e.get("genome") == gk and e.get("session") == sid]
    assert quarantined, (
        f"quarantine never surfaced as a lineage event: "
        f"{by_event.get('quarantined')}")
    assert by_event.get("dispatched"), "no dispatched lineage events"

    return {
        "workers": 1,
        "fault_plan": plan.to_dict(),
        "faults_fired": list(inj.fired),
        "session": sid,
        "poison_genome": gk,
        "session_stats": {k: stats[k] for k in
                          ("submitted", "failed", "quarantined", "rejected")},
        "lineage_events": {k: len(v) for k, v in sorted(by_event.items())},
        "requeued_events": [{k: e.get(k) for k in
                             ("genome", "job", "worker", "reason", "session")}
                            for e in requeued],
        "quarantined_events": [{k: e.get(k) for k in
                                ("genome", "session", "terminal_failures")}
                               for e in quarantined],
        "n_spans": tele_summary["n_spans"],
        "wall_s": round(wall, 3),
    }


def run_obs_agg() -> dict:
    """Metrics-aggregator kill act: the fleet observability plane
    (``telemetry/aggregator.py``) dies mid-search.  Observability downtime
    must never fail or steer a search — every wired role keeps running,
    the process's (refcounted, shared) pusher fails OPEN with exactly ONE
    ``aggregator_degraded`` telemetry event per up→down transition, and
    the finished search is bit-identical to an aggregator-free run.

    ``SlowishOneMax`` plus a high per-bit mutation rate keep every
    generation training novel genomes, so the kill (held until generation
    1 has landed) strikes while dispatch is still live and the 0.25 s
    push cadence gets several failed flush attempts before the search
    ends — the degradation is observed DURING the run, not at teardown."""
    from gentun_tpu_torch.telemetry.aggregator import MetricsAggregator
    from gentun_tpu_torch.telemetry.registry import get_registry

    mutation_rate = 0.5

    # Aggregator-free reference: single-process, telemetry-free, same seeds.
    ref = GeneticAlgorithm(
        Population(SlowishOneMax, *DATA, size=POP_SIZE, seed=POP_SEED,
                   mutation_rate=mutation_rate), seed=GA_SEED)
    ref.run(GENERATIONS)

    script_dir = os.path.dirname(os.path.abspath(__file__))
    tele_path = os.path.join(script_dir, ".torch_chaos_obsagg_telemetry.jsonl")
    run_tele = RunTelemetry(tele_path, label="chaos-obsagg").install()
    agg = MetricsAggregator("127.0.0.1", 0)
    agg.start()
    old_interval = os.environ.get("GENTUN_TPU_AGG_PUSH_INTERVAL")
    os.environ["GENTUN_TPU_AGG_PUSH_INTERVAL"] = "0.25"
    port = _free_port()
    killed_after_gen = []
    pushes_before_kill = []
    t0 = time.monotonic()
    stops = []
    try:
        pop = DistributedPopulation(
            SlowishOneMax, size=POP_SIZE, seed=POP_SEED,
            mutation_rate=mutation_rate, host="127.0.0.1", port=port,
            job_timeout=120, aggregator_url=agg.url)
        try:
            stops = [_worker(port, worker_id="obs-w0", species=SlowishOneMax,
                             aggregator_url=agg.url),
                     _worker(port, worker_id="obs-w1", species=SlowishOneMax,
                             aggregator_url=agg.url)]
            ga = GeneticAlgorithm(pop, seed=GA_SEED)

            def _kill_aggregator():
                # Pull the plug once generation 1 has landed AND at least
                # one snapshot has been pushed — squarely mid-search, with
                # dispatch still running and the aggregator demonstrably
                # receiving before it dies.
                while not ga.history or agg.stats()["pushes"] < 1:
                    time.sleep(0.005)
                killed_after_gen.append(len(ga.history))
                pushes_before_kill.append(agg.stats()["pushes"])
                agg.stop()

            killer = threading.Thread(target=_kill_aggregator, daemon=True)
            killer.start()
            ga.run(GENERATIONS)
            killer.join(timeout=10)
            # The shared pusher is still alive until pop.close(): give it
            # until its next flush to observe the dead aggregator in case
            # the search outran the 0.25 s cadence.
            deadline = time.monotonic() + 5.0
            reg = get_registry()
            while time.monotonic() < deadline:
                degraded = sum(
                    c["value"] for c in reg.snapshot()["counters"]
                    if c["name"] == "aggregator_degraded_total")
                if degraded >= 1:
                    break
                time.sleep(0.05)
            wall = time.monotonic() - t0
            chaos_snap = _snapshot(ga)
            leaked = pop.broker.outstanding()
        finally:
            pop.close()
    finally:
        for s in stops:
            s.set()
        run_tele.close()
        if old_interval is None:
            os.environ.pop("GENTUN_TPU_AGG_PUSH_INTERVAL", None)
        else:
            os.environ["GENTUN_TPU_AGG_PUSH_INTERVAL"] = old_interval
        try:
            agg.stop()
        except Exception:
            pass

    ref_snap = _snapshot(ref)
    identical = chaos_snap == ref_snap
    assert identical, "aggregator-kill run diverged from the aggregator-free run"
    assert len(ga.history) == GENERATIONS, "search did not complete"
    assert killed_after_gen[0] < GENERATIONS, (
        f"aggregator outlived the search: killed after generation "
        f"{killed_after_gen[0]}")
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"
    assert degraded >= 1, "aggregator kill never degraded the pusher"

    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    degraded_events = [r for r in tele_lines
                       if r.get("type") == "event"
                       and r.get("name") == "aggregator_degraded"]
    # master + broker + both in-thread workers share ONE refcounted
    # pusher (acquire_pusher dedups by URL within a process), so the
    # whole fleet degrades with exactly one event.
    assert len(degraded_events) == 1, (
        f"expected ONE degraded event per pusher, got {len(degraded_events)}")

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "seeds": {"population": POP_SEED, "ga": GA_SEED},
        "mutation_rate": mutation_rate,
        "workers": 2,
        "aggregator_killed_after_generation": killed_after_gen[0],
        "pushes_before_kill": pushes_before_kill[0],
        "search_completed": True,
        "bit_identical_to_aggregator_free_run": identical,
        "degraded_events": len(degraded_events),
        "degraded_transitions": int(degraded),
        "broker_state_after_final_gather": leaked,
        "wall_s": round(wall, 3),
    }


def run_wire_act() -> dict:
    """Wire fast-path chaos act (DISTRIBUTED.md "Wire fast path"): the
    encode-once dispatch plane under the two requeue paths that re-send a
    job from its cached frame bytes — a worker disconnect mid-window and a
    straggler speculative requeue — plus both interop postures of the caps
    negotiation.  Three distributed searches against one clean reference,
    all on the same seeds:

    - **fast** (both workers jobs2-capable, the default): the fault plan
      drops a ``results`` connection (the broker requeues the dead
      worker's in-flight window) and hangs an evaluation 2.5 s past the
      0.5 s straggler floor with ``straggler_requeue=True`` (the watchdog
      speculatively requeues the stalled job); every re-dispatch re-joins
      the entry bytes built once at submit.
    - **v1** (both workers advertise no caps): the same plan through the
      legacy ``jobs`` frames the negotiation falls back to.
    - **mixed** (one v1 + one jobs2 worker): fault-free interop — the
      negotiated fleet must finish with zero outstanding broker state.

    Asserts every distributed trajectory is bit-identical to the clean
    run (cached-byte re-dispatch and frame format steer nothing), both
    fault kinds fired and the speculative requeue actually happened in
    the fast and v1 runs, ``jobs2`` frames moved ONLY in runs with a
    jobs2-capable worker, and no run leaked job-wire records."""
    from gentun_tpu_torch.telemetry.registry import get_registry

    ref = GeneticAlgorithm(
        Population(OneMax, *DATA, size=POP_SIZE, seed=POP_SEED), seed=GA_SEED)
    ref.run(GENERATIONS)
    ref_snap = _snapshot(ref)

    def _wire_plan():
        # Count-based like run()'s composed plan, but this fleet shifts
        # work to the clean worker after the drop (the speculative watchdog
        # compounds it), so wire-w0 sees only a handful of pre-evals —
        # at=0 lands the drop on the first window, at=2 lands the hang
        # early enough to be guaranteed an event to ride.
        return FaultInjector(FaultPlan([
            FaultSpec(hook="client_send", kind="drop_connection",
                      match_type="results", at=0),
            FaultSpec(hook="worker_pre_eval", kind="hang", at=2, duration=2.5),
        ], seed=2026))

    def _frames_by_type(snap):
        out = {}
        for c in snap["counters"]:
            if c["name"] == "wire_frames_sent_total":
                t = c["labels"].get("type", "")
                out[t] = out.get(t, 0) + c["value"]
        return out

    def _stragglers_requeued(snap):
        return sum(c["value"] for c in snap["counters"]
                   if c["name"] == "stragglers_requeued_total")

    script_dir = os.path.dirname(os.path.abspath(__file__))

    def _search(name, caps0, caps1, inject):
        # The stall watchdog only tracks dispatches while the ops plane is
        # live (run_stall_ops's setup), and the heartbeat reaper is pinned
        # out so the watchdog's speculative requeue is the ONLY path that
        # can recover the dropped window and the hang; ``straggler_k=1``
        # keeps the threshold at the floor even after the drop's requeued
        # round trips inflate the rolling p95.
        inj = _wire_plan() if inject else None
        port = _free_port()
        flight_path = os.path.join(script_dir, f".torch_chaos_wire_{name}_flight.jsonl")
        start_ops_server(port=0, flight_path=flight_path)
        before = get_registry().snapshot()
        frames0, requeued0 = _frames_by_type(before), _stragglers_requeued(before)
        stops = [_worker(port, injector=inj, worker_id=f"wire-w0-{name}",
                         wire_caps=caps0),
                 _worker(port, worker_id=f"wire-w1-{name}", wire_caps=caps1)]
        t0 = time.monotonic()
        try:
            pop = DistributedPopulation(
                OneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1",
                port=port, job_timeout=120, heartbeat_timeout=30.0,
                straggler_floor_s=0.5, straggler_k=1.0,
                straggler_requeue=True)
            try:
                ga = GeneticAlgorithm(pop, seed=GA_SEED)
                ga.run(GENERATIONS)
                wall = time.monotonic() - t0
                snap = _snapshot(ga)
                leaked = pop.broker.outstanding()
                frag = pop.broker._frag_cache
                frag_stats = {"entries": len(frag), "hits": frag.hits,
                              "misses": frag.misses}
            finally:
                pop.close()
        finally:
            for s in stops:
                s.set()
            stop_ops_server()
            if os.path.exists(flight_path):
                os.unlink(flight_path)
        after = get_registry().snapshot()
        frames1 = _frames_by_type(after)
        frames = {t: frames1.get(t, 0) - frames0.get(t, 0)
                  for t in frames1 if frames1.get(t, 0) > frames0.get(t, 0)}
        assert snap == ref_snap, f"{name} run diverged from the clean run"
        assert all(v == 0 for v in leaked.values()), (
            f"{name} run leaked broker state: {leaked}")
        if inject:
            kinds = sorted({f["kind"] for f in inj.fired})
            assert kinds == ["drop_connection", "hang"], (
                f"{name} plan misfired: {kinds}")
            assert _stragglers_requeued(after) - requeued0 >= 1, (
                f"{name} hang was never speculatively requeued")
        return {
            "bit_identical_to_clean_run": True,
            "faults_fired": list(inj.fired) if inj else [],
            "stragglers_requeued": _stragglers_requeued(after) - requeued0,
            "frames_sent": frames,
            "fragment_cache": frag_stats,
            "broker_state_after_final_gather": leaked,
            "wall_s": round(wall, 3),
        }

    fast = _search("fast", None, None, inject=True)
    v1 = _search("v1", (), (), inject=True)
    mixed = _search("mixed", (), None, inject=False)

    assert fast["frames_sent"].get("jobs2", 0) > 0, (
        f"fast fleet never negotiated jobs2: {fast['frames_sent']}")
    assert v1["frames_sent"].get("jobs2", 0) == 0, (
        f"caps-less fleet was sent jobs2 frames: {v1['frames_sent']}")
    assert mixed["frames_sent"].get("jobs2", 0) > 0 and \
        mixed["frames_sent"].get("jobs", 0) > 0, (
        f"mixed fleet should move both formats: {mixed['frames_sent']}")

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "seeds": {"population": POP_SEED, "ga": GA_SEED},
        "workers": 2,
        "straggler_floor_s": 0.5,
        "fast": fast,
        "v1": v1,
        "mixed": mixed,
    }


def run_recompile_storm() -> dict:
    """Mass-remesh compile storm with the executable cache up: fleet-wide
    compiles must collapse to ~1 per ``(pop_bucket, static-key)`` shape.

    Simulates the worst elastic moment — every host remeshing and needing
    every program shape at once — against a REAL ``CompileService`` and
    real clients, with the compile itself stubbed (a deterministic
    artifact blob per shape; the ``nvcc`` version of this act lives in
    ``scripts/torch_compile_cache_study.py``).  Each simulated host owns a
    private kernel cache dir, prefetches at (re)join exactly like
    ``GentunClient.remesh()``, "compiles" only the shapes still missing
    locally, and publishes what it compiled.  Asserts: total compiles ==
    number of shapes (the first host pays them all, every later host
    fetches), and a concurrent same-shape race stays idempotent."""
    import base64
    import shutil
    import tempfile

    from gentun_tpu_torch.distributed.compile_service import (
        CompileService,
        CompileServiceClient,
    )

    n_hosts, shapes = 4, [
        ("pop16", "sk-a"), ("pop16", "sk-b"), ("pop32", "sk-a"),
        ("pop32", "sk-c"), ("pop64", "sk-d"),
    ]

    def entry_name(shape):
        # Stand-in for a cache entry's key hash: deterministic per shape.
        return "xla_" + base64.b16encode(
            f"{shape[0]}/{shape[1]}".encode()).decode().lower()

    svc = CompileService(port=0).start()
    root = tempfile.mkdtemp(prefix="recompile-storm-")
    compiles_per_shape: dict = {s: 0 for s in shapes}
    fetches = 0
    t0 = time.monotonic()
    try:
        for h in range(n_hosts):
            cache_dir = os.path.join(root, f"host{h}")
            client = CompileServiceClient(svc.url, cache_dir=cache_dir,
                                          fingerprint="storm-fp")
            fetches += client.prefetch()  # the remesh()-before-advertise step
            local = set(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else set()
            for shape in shapes:
                name = entry_name(shape)
                if name in local:
                    continue  # prefetched: this host skips the compile
                os.makedirs(cache_dir, exist_ok=True)
                with open(os.path.join(cache_dir, name), "wb") as fh:
                    fh.write(f"artifact:{shape}".encode() * 64)
                compiles_per_shape[shape] += 1
            client.scan_publish()
            assert client.flush(10.0), "publish queue failed to drain"
            client.close()

        # Concurrent same-shape race: two late hosts compile the SAME new
        # shape simultaneously (prefetch raced the publish) — duplicate
        # publishes must stay idempotent, one stored blob.
        race_shape = ("pop128", "sk-race")
        race_clients = []
        for h in range(2):
            cache_dir = os.path.join(root, f"race{h}")
            os.makedirs(cache_dir)
            with open(os.path.join(cache_dir, entry_name(race_shape)), "wb") as fh:
                fh.write(b"race-artifact" * 64)
            race_clients.append(CompileServiceClient(
                svc.url, cache_dir=cache_dir, fingerprint="storm-fp"))
        ts = [threading.Thread(target=c.scan_publish) for c in race_clients]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        for c in race_clients:
            assert c.flush(10.0)
            c.close()
        svc_stats = svc.stats()
        wall = time.monotonic() - t0
    finally:
        svc.stop()
        shutil.rmtree(root, ignore_errors=True)

    total_compiles = sum(compiles_per_shape.values())
    max_per_shape = max(compiles_per_shape.values())
    assert max_per_shape <= 1, (
        f"a shape compiled more than once fleet-wide: {compiles_per_shape}")
    assert total_compiles == len(shapes), (
        f"expected exactly one compile per shape, got {compiles_per_shape}")
    assert fetches == (n_hosts - 1) * len(shapes), (
        f"late hosts should have fetched every shape: {fetches}")
    assert svc_stats["entries"] == len(shapes) + 1  # + the race shape, once

    return {
        "hosts": n_hosts,
        "shapes": [list(s) for s in shapes],
        "compiles_per_shape": {f"{p}/{k}": v for (p, k), v
                               in compiles_per_shape.items()},
        "total_compiles": total_compiles,
        "max_compiles_per_shape_fleet_wide": max_per_shape,
        "artifacts_fetched_instead_of_compiled": fetches,
        "concurrent_same_shape_publishes_idempotent": True,
        "service": {k: svc_stats[k] for k in
                    ("entries", "bytes", "puts", "evictions", "conflicts")},
        "wall_s": round(wall, 3),
    }


def run_broker_kill() -> dict:
    """Broker crash act: the broker itself dies mid-swarm —
    SIGKILL-equivalent ``kill()`` (the journal buffer is abandoned, not
    flushed) — and restarts on the same port from its dispatch journal.
    Workers re-adopt through the normal reconnect path; the in-process
    master's pending gather barrier survives (results memory is the
    master's, not the dispatch plane's).  Asserts the generational search
    finishes bit-identical to the no-kill reference with zero lost and
    zero double-counted completions, then replays the kill under the
    async engine (incremental ``wait_any``), where the only tolerated
    residue is orphan results from at-least-once resurrection of
    completions whose journal record died in the un-fsynced buffer."""
    # -- no-kill reference (single-process, journal-free) -----------------
    clean = GeneticAlgorithm(
        Population(OneMax, *DATA, size=POP_SIZE, seed=POP_SEED), seed=GA_SEED)
    clean.run(GENERATIONS)
    clean_snap = _snapshot(clean)

    script_dir = os.path.dirname(os.path.abspath(__file__))

    def _journaled_broker(tag):
        path = os.path.join(script_dir, f".torch_chaos_broker_{tag}.journal")
        for p in (path, path + ".snap"):
            if os.path.exists(p):
                os.unlink(p)
        port = _free_port()  # fixed port: restart must rebind the same one
        broker = JobBroker(port=port, journal_path=path,
                           journal_fsync_interval=0.01).start()
        return broker, port, path

    def _kill_at(broker, completes, info):
        """Kill + journal-restart the broker once `completes` jobs have a
        durable completion record; returns the killer thread."""
        def _n():
            jrn = broker._journal
            return (jrn.status()["records_total"].get("c", 0)
                    if jrn is not None else -1)

        def _go():
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and _n() < completes:
                time.sleep(0.005)
            info["completes_at_kill"] = _n()
            t_kill = time.monotonic()
            broker.kill()
            broker.start()
            info["restart_wall_s"] = round(time.monotonic() - t_kill, 3)
        t = threading.Thread(target=_go, daemon=True)
        t.start()
        return t

    def _cleanup(path):
        for p in (path, path + ".snap"):
            if os.path.exists(p):
                os.unlink(p)

    # -- generational arm: all-at-once gather barrier across the kill -----
    broker, port, jpath = _journaled_broker("gen")
    stops = [_worker(port, species=SlowishOneMax, worker_id="hakill-w0"),
             _worker(port, species=SlowishOneMax, worker_id="hakill-w1")]
    gen_kill: dict = {}
    t0 = time.monotonic()
    try:
        pop = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1", port=port,
            broker=broker, job_timeout=120)
        try:
            killer = _kill_at(broker, completes=10, info=gen_kill)
            ga = GeneticAlgorithm(pop, seed=GA_SEED)
            ga.run(GENERATIONS)
            killer.join(timeout=60)
            gen_wall = time.monotonic() - t0
            chaos_snap = _snapshot(ga)
            leaked = broker.outstanding()
            ops = broker._ops_status()
        finally:
            pop.close()
    finally:
        for s in stops:
            s.set()
        broker.stop()
        _cleanup(jpath)

    assert "restart_wall_s" in gen_kill, "broker kill never fired"
    assert ops["epoch"] == 2 and ops["restarts"] == 1, ops
    identical = clean_snap == chaos_snap
    assert identical, "broker-kill run diverged from the no-kill reference"
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"

    # -- async arm: incremental wait_any across the kill ------------------
    budget = 24
    broker2, port2, jpath2 = _journaled_broker("async")
    stops2 = [_worker(port2, species=SlowishOneMax, worker_id="hakill-aw0"),
              _worker(port2, species=SlowishOneMax, worker_id="hakill-aw1")]
    async_kill: dict = {}
    t0 = time.monotonic()
    try:
        pop2 = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1", port=port2,
            broker=broker2, job_timeout=120)
        try:
            killer2 = _kill_at(broker2, completes=8, info=async_kill)
            eng = AsyncEvolution(pop2, tournament_size=3, seed=GA_SEED,
                                 job_timeout=120)
            best = eng.run(max_evaluations=budget)
            killer2.join(timeout=60)
            async_wall = time.monotonic() - t0
            leaked2 = broker2.outstanding()
            ops2 = broker2._ops_status()
        finally:
            pop2.close()
    finally:
        for s in stops2:
            s.set()
        broker2.stop()
        _cleanup(jpath2)

    assert "restart_wall_s" in async_kill, "async broker kill never fired"
    assert ops2["epoch"] == 2 and ops2["restarts"] == 1, ops2
    assert eng.completed == budget, f"budget not met: {eng.completed}/{budget}"
    # wait_any consumes incrementally, so a completion the engine already
    # counted can be resurrected by replay if its `c` record was still in
    # the abandoned buffer at kill time — an orphan result is the documented
    # at-least-once residue.  Everything else must be quiescent.
    non_result_leaks = {k: v for k, v in leaked2.items() if k != "results"}
    assert all(v == 0 for v in non_result_leaks.values()), (
        f"leaked broker state: {leaked2}")

    return {
        "generational": {
            "generations": GENERATIONS,
            "population_size": POP_SIZE,
            "seeds": {"population": POP_SEED, "ga": GA_SEED},
            "workers": 2,
            "kill": gen_kill,
            "epoch_after_restart": ops["epoch"],
            "restarts": ops["restarts"],
            "journal": ops["journal"],
            "bit_identical_to_no_kill_reference": identical,
            "best_fitness_history": chaos_snap["best_fitness_history"],
            "n_architectures_evaluated": chaos_snap["n_architectures_evaluated"],
            "broker_state_after_final_gather": leaked,
            "wall_s": round(gen_wall, 3),
        },
        "async": {
            "budget": budget,
            "completed": eng.completed,
            "best_fitness": best.get_fitness(),
            "kill": async_kill,
            "epoch_after_restart": ops2["epoch"],
            "restarts": ops2["restarts"],
            "orphan_results_tolerated": leaked2["results"],
            "broker_state_after_run": leaked2,
            "wall_s": round(async_wall, 3),
        },
    }


def run_shard_kill() -> dict:
    """Shard-kill act (DISTRIBUTED.md "Horizontal broker
    sharding"): two journaled broker shards, two concurrent generational
    searches whose sessions the ring homes on DIFFERENT shards, two
    multi-homed workers serving both — then the shard homing the first
    search is SIGKILLed (``kill()``: journal buffer abandoned, not
    flushed) mid-swarm and restarted on its port from its journal.
    Proofs: the kill fired while work was in flight, the victim came
    back at epoch 2, BOTH searches finish bit-identical to their no-kill
    single-process references (zero lost searches — the healthy shard's
    search must not even hiccup), and neither shard leaks state."""
    from gentun_tpu_torch.distributed.shard import (
        ShardRing,
        parse_broker_urls,
        shard_id,
    )

    # -- no-kill references: one single-process run per concurrent search
    pop_seeds = (POP_SEED, POP_SEED + 1)
    clean_snaps = []
    for seed in pop_seeds:
        clean = GeneticAlgorithm(
            Population(OneMax, *DATA, size=POP_SIZE, seed=seed), seed=GA_SEED)
        clean.run(GENERATIONS)
        clean_snaps.append(_snapshot(clean))

    script_dir = os.path.dirname(os.path.abspath(__file__))
    brokers, jpaths = [], []
    for tag in ("shard0", "shard1"):
        path = os.path.join(script_dir, f".torch_chaos_shard_{tag}.journal")
        for p in (path, path + ".snap"):
            if os.path.exists(p):
                os.unlink(p)
        port = _free_port()  # fixed port: the restart must rebind it
        brokers.append(JobBroker(port=port, journal_path=path,
                                 journal_fsync_interval=0.01).start())
        jpaths.append(path)
    urls = [f"127.0.0.1:{b.address[1]}" for b in brokers]
    by_shard = {shard_id(a): b
                for a, b in zip(parse_broker_urls(urls), brokers)}

    # Sessions the ring homes on DIFFERENT shards; the first search's
    # home is the kill victim.
    ring = ShardRing(list(by_shard))
    homes = {}
    for i in range(10_000):
        sid = f"chaos-sess-{i:05d}"
        homes.setdefault(ring.home(sid), sid)
        if len(homes) == 2:
            break
    assert len(homes) == 2, "ring never split 10k keys across 2 shards"
    sessions = [homes[s] for s in sorted(homes)]
    victim = by_shard[ring.home(sessions[0])]
    victim_url = ring.home(sessions[0])

    def _mh_worker(worker_id):
        stop = threading.Event()
        client = GentunClient(
            SlowishOneMax, *DATA, broker_urls=urls, worker_id=worker_id,
            heartbeat_interval=0.2, reconnect_delay=0.05,
            reconnect_max_delay=0.5,
        )
        t = threading.Thread(target=lambda: client.work(stop_event=stop),
                             daemon=True)
        t.start()
        return stop

    kill_info: dict = {}

    def _kill_victim():
        def _n():
            jrn = victim._journal
            return (jrn.status()["records_total"].get("c", 0)
                    if jrn is not None else -1)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and _n() < 6:
            time.sleep(0.005)
        kill_info["completes_at_kill"] = _n()
        t_kill = time.monotonic()
        victim.kill()
        victim.start()
        kill_info["restart_wall_s"] = round(time.monotonic() - t_kill, 3)

    stops = [_mh_worker("shkill-w0"), _mh_worker("shkill-w1")]
    search_errs: list = []
    chaos_snaps: list = [None, None]
    t0 = time.monotonic()
    try:
        pops = [
            DistributedPopulation(
                OneMax, size=POP_SIZE, seed=seed, broker_urls=urls,
                session=sid, job_timeout=120)
            for seed, sid in zip(pop_seeds, sessions)
        ]
        try:
            killer = threading.Thread(target=_kill_victim, daemon=True)
            killer.start()

            def _search(idx):
                try:
                    ga = GeneticAlgorithm(pops[idx], seed=GA_SEED)
                    ga.run(GENERATIONS)
                    chaos_snaps[idx] = _snapshot(ga)
                except BaseException as e:
                    search_errs.append(f"search {idx}: {e!r}")

            searchers = [threading.Thread(target=_search, args=(i,))
                         for i in range(len(pops))]
            for t in searchers:
                t.start()
            for t in searchers:
                t.join(timeout=300)
            killer.join(timeout=60)
            wall = time.monotonic() - t0
            assert not any(t.is_alive() for t in searchers), "search hung"
            leaked = {u: b.outstanding() for u, b in zip(urls, brokers)}
            victim_ops = victim._ops_status()
        finally:
            for pop in pops:
                pop.close()
    finally:
        for s in stops:
            s.set()
        for b in brokers:
            b.stop()
        for path in jpaths:
            for p in (path, path + ".snap"):
                if os.path.exists(p):
                    os.unlink(p)

    assert search_errs == [], f"lost searches: {search_errs}"
    assert "restart_wall_s" in kill_info, "shard kill never fired"
    assert victim_ops["epoch"] == 2 and victim_ops["restarts"] == 1, victim_ops
    identical = [c == s for c, s in zip(clean_snaps, chaos_snaps)]
    assert all(identical), (
        f"shard-kill run diverged from no-kill references: {identical}")
    for url, out in leaked.items():
        assert all(v == 0 for v in out.values()), \
            f"leaked state on shard {url}: {out}"

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "seeds": {"populations": list(pop_seeds), "ga": GA_SEED},
        "shards": urls,
        "sessions": sessions,
        "victim_shard": victim_url,
        "workers_multihomed": 2,
        "kill": kill_info,
        "victim_epoch_after_restart": victim_ops["epoch"],
        "victim_restarts": victim_ops["restarts"],
        "searches": len(sessions),
        "searches_lost": 0,
        "bit_identical_to_no_kill_references": identical,
        "broker_state_after_final_gather": leaked,
        "wall_s": round(wall, 3),
    }


def run_preemption_act() -> dict:
    """Preemption chaos act (DISTRIBUTED.md "Autoscaling & preemptible
    capacity"): a mostly-preemptible fleet under the full storm — two
    SIGUSR1-style self-drains mid-flight (the ``--preempt`` deadline
    path, each followed by a replacement member joining), a broker
    SIGKILL + journal restart, and a dropped ``results`` connection —
    must finish bit-identical to the stable single-process reference.
    Asserts the requeue storm completes (zero lost: every
    preemption-requeued job re-dispatches and the broker ends
    quiescent), that the churn is attributed in the lineage ledger
    (``requeued`` events with reason ``preempt``, distinct from the
    disconnect/drain reasons the other faults produce), and that the
    idle stable member proves mixed-fleet placement holds under chaos
    (rung-0 work stays on preemptible capacity throughout)."""
    mutation_rate = 0.5  # novel genomes every generation: dispatch stays live

    # Stable-fleet reference: single-process, telemetry-free, same seeds
    # (SlowishOneMax == OneMax fitness values; the sleep only shapes
    # timing in the distributed arm).
    ref = GeneticAlgorithm(
        Population(SlowishOneMax, *DATA, size=POP_SIZE, seed=POP_SEED,
                   mutation_rate=mutation_rate), seed=GA_SEED)
    ref.run(GENERATIONS)
    ref_snap = _snapshot(ref)

    script_dir = os.path.dirname(os.path.abspath(__file__))
    tele_path = os.path.join(script_dir, ".torch_chaos_preempt_telemetry.jsonl")
    jpath = os.path.join(script_dir, ".torch_chaos_preempt.journal")
    for p in (jpath, jpath + ".snap"):
        if os.path.exists(p):
            os.unlink(p)
    run_tele = RunTelemetry(tele_path, label="chaos-preempt").install()
    lineage.reset_ledger()
    lineage.enable()

    drop_inj = FaultInjector(FaultPlan([
        FaultSpec(hook="client_send", kind="drop_connection",
                  match_type="results", at=0),
    ], seed=2026))

    port = _free_port()
    broker = JobBroker(port=port, journal_path=jpath,
                       journal_fsync_interval=0.01).start()
    fleet: dict = {}

    def _spawn_preemptible(wid, injector=None):
        stop = threading.Event()
        client = GentunClient(
            SlowishOneMax, *DATA, host="127.0.0.1", port=port,
            worker_id=wid, capacity=1, prefetch_depth=3,
            heartbeat_interval=0.2, reconnect_delay=0.05,
            reconnect_max_delay=0.5, fault_injector=injector,
            preemptible=True)
        threading.Thread(target=lambda: client.work(stop_event=stop),
                         daemon=True).start()
        fleet[wid] = (client, stop)

    _spawn_preemptible("preempt-w0", injector=drop_inj)
    _spawn_preemptible("preempt-w1")
    stable_stop = _worker(port, worker_id="preempt-stable",
                          species=SlowishOneMax)

    done = threading.Event()
    kill_info: dict = {}
    preemptions: list = []
    t0 = time.monotonic()
    try:
        pop = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED,
            mutation_rate=mutation_rate, host="127.0.0.1", port=port,
            broker=broker, job_timeout=120)
        try:
            ga = GeneticAlgorithm(pop, seed=GA_SEED)

            def _completes():
                jrn = broker._journal
                return (jrn.status()["records_total"].get("c", 0)
                        if jrn is not None else -1)

            def _worker_loaded(wid, n, deadline_s=60.0):
                # True once `wid` is CONNECTED (present, not draining —
                # so the drain announce has a live socket to ride, not
                # the injected drop's reconnect window) and holds >= n
                # jobs (capacity 1: at least n-1 prefetched-unstarted,
                # guaranteeing the drain has something to hand back).
                deadline = time.monotonic() + deadline_s
                while time.monotonic() < deadline and not done.is_set():
                    ws = {x["worker_id"]: x
                          for x in broker._ops_status()["workers"]}
                    w = ws.get(wid)
                    if (w is not None and not w["draining"]
                            and w["jobs_in_flight"] >= n):
                        return True
                    time.sleep(0.005)
                return False

            def _storm():
                # Two preemption waves first (each drains a member whose
                # prefetch window is demonstrably loaded, then joins a
                # replacement), then the broker SIGKILL + restart.
                for wid in ("preempt-w0", "preempt-w1"):
                    if not _worker_loaded(wid, 2):
                        return
                    client, stop = fleet.pop(wid)
                    client.drain(reason="preempt")  # the SIGUSR1 path
                    preemptions.append(
                        {"worker": wid, "at_generation": len(ga.history)})
                    time.sleep(0.5)  # in-flight job finishes, drain lands
                    stop.set()
                    _spawn_preemptible(wid + "-r")
                deadline = time.monotonic() + 60
                while (time.monotonic() < deadline and not done.is_set()
                       and _completes() < 20):
                    time.sleep(0.005)
                kill_info["completes_at_kill"] = _completes()
                t_kill = time.monotonic()
                broker.kill()
                broker.start()
                kill_info["restart_wall_s"] = round(
                    time.monotonic() - t_kill, 3)

            storm = threading.Thread(target=_storm, daemon=True)
            storm.start()
            ga.run(GENERATIONS)
            done.set()
            storm.join(timeout=90)
            wall = time.monotonic() - t0
            chaos_snap = _snapshot(ga)
            leaked = broker.outstanding()
            ops = broker._ops_status()
            # Bound the lineage record to the live search: teardown
            # below churns the orphan resurrection job through whatever
            # members are still exiting, which is shutdown noise, not
            # placement evidence.
            lineage.disable()
        finally:
            pop.close()
    finally:
        done.set()
        for _, stop in fleet.values():
            stop.set()
        stable_stop.set()
        run_tele.close()
        lineage.disable()
        lineage.reset_ledger()
        broker.stop()
        for p in (jpath, jpath + ".snap"):
            if os.path.exists(p):
                os.unlink(p)

    assert len(preemptions) == 2, f"preemption waves misfired: {preemptions}"
    assert "restart_wall_s" in kill_info, "broker kill never fired"
    assert ops["epoch"] == 2 and ops["restarts"] == 1, ops
    assert drop_inj.fired, "the drop_connection fault never fired"
    identical = chaos_snap == ref_snap
    assert identical, "preemption run diverged from the stable reference"
    # The broker-kill composition adds run_broker_kill's documented
    # at-least-once residue: a completion whose journal record died in
    # the un-fsynced buffer resurrects at restart, re-runs, and its
    # duplicate result has no gather left to claim it.  Orphan results
    # are the ONLY tolerated leak; everything else must be quiescent.
    non_result_leaks = {k: v for k, v in leaked.items() if k != "results"}
    assert all(v == 0 for v in non_result_leaks.values()), (
        f"leaked broker state: {leaked}")

    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    lin = [r for r in tele_lines if r.get("type") == "lineage"]
    requeued_by_reason: dict = {}
    for r in lin:
        if r.get("event") == "requeued":
            requeued_by_reason.setdefault(r.get("reason"), []).append(r)
    preempt_requeued = requeued_by_reason.get("preempt", [])
    assert preempt_requeued, (
        f"preemption churn never attributed in lineage: "
        f"{ {k: len(v) for k, v in requeued_by_reason.items()} }")
    assert all(r["worker"] in ("preempt-w0", "preempt-w1")
               for r in preempt_requeued), preempt_requeued
    # Zero lost: every preemption-requeued job re-dispatched afterwards.
    dispatches: dict = {}
    for r in lin:
        if r.get("event") == "dispatched":
            dispatches[r["job"]] = dispatches.get(r["job"], 0) + 1
    assert all(dispatches.get(r["job"], 0) >= 2 for r in preempt_requeued), (
        "a preemption-requeued job never re-dispatched")
    # Placement held under chaos: rung-0 work stays >=90% on preemptible
    # capacity.  Not 100% — after the broker kill, whichever member
    # reconnects first owns a briefly homogeneous fleet, and if that is
    # the stable one, fallback (by design) hands it work rather than
    # stalling the search until a preemptible member re-adopts.
    all_dispatches = [r for r in lin if r.get("event") == "dispatched"]
    stable_n = sum(1 for r in all_dispatches
                   if r.get("worker") == "preempt-stable")
    assert all_dispatches and stable_n * 10 <= len(all_dispatches), (
        f"placement collapsed under chaos: {stable_n}/{len(all_dispatches)} "
        f"rung-0 dispatches landed on the stable member")

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "seeds": {"population": POP_SEED, "ga": GA_SEED},
        "mutation_rate": mutation_rate,
        "workers": {"preemptible": 2, "stable": 1, "replacements": 2},
        "preemptions": preemptions,
        "broker_kill": kill_info,
        "epoch_after_restart": ops["epoch"],
        "restarts": ops["restarts"],
        "fault_plan": drop_inj.plan.to_dict(),
        "faults_fired": list(drop_inj.fired),
        "requeued_by_reason": {str(k): len(v)
                               for k, v in sorted(requeued_by_reason.items())},
        "preempt_requeued_jobs": sorted({r["job"] for r in preempt_requeued}),
        "bit_identical_to_stable_reference": identical,
        "dispatches": {"total": len(all_dispatches),
                       "stable_member": stable_n,
                       "preemptible_share_pct": round(
                           (1 - stable_n / len(all_dispatches)) * 100, 1)},
        "orphan_results_tolerated": leaked["results"],
        "broker_state_after_final_gather": leaked,
        "wall_s": round(wall, 3),
    }


def run_packing_act() -> dict:
    """Packing chaos act (DISTRIBUTED.md "Cross-session window
    packing"): two tenant searches share a ``pack_windows=True`` broker,
    so their per-generation batches coalesce into cross-session windows —
    and the worker's connection is dropped on a received packed ``jobs2``
    frame, i.e. mid-packed-window, before any job in it evaluates.  The
    whole window (jobs from BOTH sessions) must requeue through the
    per-job disconnect path, re-pack, and land exactly once per session:
    each tenant finishes bit-identical to its single-process solo
    reference, per-session books show completed == submitted with zero
    failures/quarantines, and the broker ends quiescent including the
    pack plane (``packed_held`` drains to zero)."""
    mutation_rate = 0.5  # novel genomes every generation: windows stay live

    # Per-tenant solo references: single-process, different population
    # seeds so the tenants' genomes (and windows) genuinely differ.
    tenants = (("pack-a", POP_SEED), ("pack-b", POP_SEED + 1))
    refs = {}
    for tag, pseed in tenants:
        ref = GeneticAlgorithm(
            Population(SlowishOneMax, *DATA, size=POP_SIZE, seed=pseed,
                       mutation_rate=mutation_rate), seed=GA_SEED)
        ref.run(GENERATIONS)
        refs[tag] = _snapshot(ref)

    # With packing on, every job frame the broker ships is a packed
    # window, so any received ``jobs2`` is one.  ``at=1`` lets the first
    # window land cleanly, then severs the second mid-delivery.
    drop_inj = FaultInjector(FaultPlan([
        FaultSpec(hook="client_recv", kind="drop_connection",
                  match_type="jobs2", at=1),
    ], seed=2028))

    port = _free_port()
    broker = JobBroker(port=port, pack_windows=True,
                       pack_linger_ms=50.0).start()

    # One worker whose capacity spans both tenants' generations, so a
    # full cross-session window fits in a single frame.
    stop = threading.Event()
    client = GentunClient(
        SlowishOneMax, *DATA, host="127.0.0.1", port=port,
        worker_id="pack-chaos-w0", capacity=2 * POP_SIZE,
        heartbeat_interval=0.2, reconnect_delay=0.05,
        reconnect_max_delay=0.5, fault_injector=drop_inj)
    threading.Thread(target=lambda: client.work(stop_event=stop),
                     daemon=True).start()

    snaps: dict = {}
    errs: dict = {}
    t0 = time.monotonic()
    try:
        def _tenant(tag, pseed):
            try:
                pop = DistributedPopulation(
                    OneMax, size=POP_SIZE, seed=pseed,
                    mutation_rate=mutation_rate, host="127.0.0.1",
                    port=port, broker=broker, session=tag, job_timeout=120)
                try:
                    ga = GeneticAlgorithm(pop, seed=GA_SEED)
                    ga.run(GENERATIONS)
                    snaps[tag] = _snapshot(ga)
                finally:
                    pop.close()
            except Exception as e:  # noqa: BLE001 — surfaced in asserts
                errs[tag] = repr(e)

        threads = [threading.Thread(target=_tenant, args=t, daemon=True)
                   for t in tenants]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        wall = time.monotonic() - t0
        leaked = broker.outstanding()
        pack = broker.pack_stats()
        books = broker.session_stats()
    finally:
        stop.set()
        broker.stop()

    assert not errs, f"tenant search(es) died: {errs}"
    assert set(snaps) == {t for t, _ in tenants}, f"missing snaps: {snaps}"
    assert drop_inj.fired, "the mid-packed-window drop never fired"
    identical = {tag: snaps[tag] == refs[tag] for tag, _ in tenants}
    assert all(identical.values()), (
        f"packed run diverged from solo references: {identical}")
    assert pack is not None and pack["windows_total"] >= 1, pack
    assert pack["cross_session_windows"] >= 1, (
        f"tenants never shared a window: {pack}")
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"
    requeued_total = 0
    for tag, _ in tenants:
        book = books[tag]
        assert book["completed"] == book["submitted"], (
            f"{tag}: {book['completed']}/{book['submitted']} landed")
        assert book["failed"] == 0 and book["quarantined"] == 0, book
        requeued_total += book["requeued"]
    assert requeued_total >= 1, (
        "the dropped window never requeued through the per-job path")

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "seeds": {"ga": GA_SEED,
                  "population": {tag: pseed for tag, pseed in tenants}},
        "mutation_rate": mutation_rate,
        "pack_linger_ms": 50.0,
        "fault_plan": drop_inj.plan.to_dict(),
        "faults_fired": list(drop_inj.fired),
        "bit_identical_to_solo_references": identical,
        "packing": pack,
        "session_books": {tag: books[tag] for tag, _ in tenants},
        "requeued_total": requeued_total,
        "broker_state_after_final_gather": leaked,
        "wall_s": round(wall, 3),
    }


def run_canary_act() -> dict:
    """Canary-plane act (docs/OBSERVABILITY.md "Canary plane"): the
    black-box golden-genome sentinel must DETECT each fault class within
    a bounded number of probe cycles — and raise zero false alarms on a
    clean fleet.

    Four arms, one daemon driven deterministically via ``probe_once``:

    - **clean** — healthy broker + worker, 8 cycles: every probe ``ok``,
      zero drift, zero errors (the false-positive floor);
    - **corruption** — a ``fitness_corrupt`` injection (evaluation
      succeeds, reported fitness perturbed — invisible to every
      transport check): the corrupted cycle itself must report
      ``drift`` (detection latency 1 cycle);
    - **hang** — the worker hangs holding the probe job: the probe
      times out at stage ``result`` within 1 cycle of the hang;
    - **broker kill** — the probe's home shard dies: stage ``open``
      error within 1 cycle, and after a restarted shard + fresh worker
      the canary self-recovers to ``ok`` (probe sessions are transient
      by design — nothing to re-adopt).
    """
    from gentun_tpu_torch.telemetry.canary import CanaryDaemon
    from gentun_tpu_torch.telemetry.registry import get_registry

    get_registry().reset()
    probes = [{"genes": Population(OneMax, *DATA, size=1,
                                   seed=POP_SEED)[0].get_genes()}]

    def _daemon(port, timeout=10.0):
        return CanaryDaemon([f"127.0.0.1:{port}"], probes,
                            space_key="chaos", probe_interval=999,
                            probe_timeout=timeout, serve_http=False)

    def _wait_members(broker, n, timeout=10.0):
        # Worker swaps must be visible broker-side before probing, or a
        # draining predecessor absorbs the probe and the detection-
        # latency count measures the handoff, not the canary.
        deadline = time.time() + timeout
        while broker.fleet_members() != n and time.time() < deadline:
            time.sleep(0.05)
        assert broker.fleet_members() == n, (
            f"fleet never settled at {n} member(s)")

    # -- clean arm: 8 cycles, zero false alarms ---------------------------
    broker = JobBroker(port=0).start()
    port = broker.address[1]
    stop = _worker(port, worker_id="cn-w0")
    cn = _daemon(port)
    clean_results = [cn.probe_once()["result"] for _ in range(8)]
    assert clean_results == ["ok"] * 8, (
        f"clean fleet raised a canary alarm: {clean_results}")

    # -- corruption arm: drift detected ON the corrupted cycle ------------
    stop.set()
    _wait_members(broker, 0)
    inj = FaultInjector(FaultPlan([FaultSpec(
        hook="worker_pre_eval", kind="fitness_corrupt", at=0)]))
    stop = _worker(port, injector=inj, worker_id="cn-w1")
    _wait_members(broker, 1)
    corrupt_cycles = 0
    corruption_detected_in = None
    for i in range(4):
        corrupt_cycles += 1
        if cn.probe_once()["result"] == "drift":
            corruption_detected_in = corrupt_cycles
            break
    assert corruption_detected_in == 1, (
        f"fitness corruption not flagged on its own cycle "
        f"(detected in {corruption_detected_in})")
    assert [s["kind"] for s in inj.fired] == ["fitness_corrupt"]
    post = cn.probe_once()
    assert post["result"] == "ok", "canary did not recover after corruption"

    # -- hang arm: result-stage timeout within 1 cycle --------------------
    stop.set()
    _wait_members(broker, 0)
    hang_inj = FaultInjector(FaultPlan([FaultSpec(
        hook="worker_pre_eval", kind="hang", at=0, duration=3.0)]))
    stop = _worker(port, injector=hang_inj, worker_id="cn-w2")
    _wait_members(broker, 1)
    cn.probe_timeout = 1.0
    hung = cn.probe_once()
    assert hung["result"] == "error" and hung["stage"] == "result", hung
    cn.probe_timeout = 10.0
    time.sleep(3.2)  # let the hang release so the arm below starts clean

    # -- broker-kill arm: open-stage error, then recovery -----------------
    stop.set()
    broker.stop()
    dead = cn.probe_once()
    assert dead["result"] == "error" and dead["stage"] == "open", dead
    broker2 = JobBroker(port=port).start()  # shard restarted on its port
    stop = _worker(port, worker_id="cn-w3")
    recovered = None
    recovery_cycles = 0
    for _ in range(5):
        recovery_cycles += 1
        r = cn.probe_once()
        if r["result"] == "ok":
            recovered = r
            break
        time.sleep(0.3)  # worker still reconnecting
    assert recovered is not None, "canary never recovered after restart"
    assert not recovered["newly_sealed"], (
        "golden was re-sealed after restart — seal must persist in-daemon")

    stats = cn.stats()
    cn.stop()
    stop.set()
    broker2.stop()
    get_registry().reset()
    return {
        "clean_cycles": len(clean_results),
        "clean_false_alarms": 0,
        "corruption_detected_in_cycles": corruption_detected_in,
        "hang_detected_in_cycles": 1,
        "hang_stage": hung["stage"],
        "broker_kill_detected_in_cycles": 1,
        "broker_kill_stage": dead["stage"],
        "recovery_cycles_after_restart": recovery_cycles,
        "drift_total": stats["drift_total"],
        "goldens_sealed": stats["goldens_sealed"],
    }


if __name__ == "__main__":
    out = run()
    out["stall_ops"] = run_stall_ops()
    out["async_smoke"] = run_async_smoke()
    out["ladder"] = run_ladder_act()
    out["cache_service"] = run_cache_chaos()
    out["surrogate"] = run_surrogate_act()
    out["forensics"] = run_forensics_act()
    out["recompile_storm"] = run_recompile_storm()
    out["wire"] = run_wire_act()
    out["obs_agg"] = run_obs_agg()
    out["broker_kill"] = run_broker_kill()
    out["shard_kill"] = run_shard_kill()
    out["preemption"] = run_preemption_act()
    out["packing"] = run_packing_act()
    out["canary"] = run_canary_act()
    print(json.dumps(out, indent=2))
    path = out_path("torch_chaos_run.json")
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
