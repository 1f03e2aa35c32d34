"""Measured autoscaling artifact: preemption churn + SLO-driven scale-up.

Two arms, both against real brokers and real ``GentunClient`` workers
(DISTRIBUTED.md "Autoscaling & preemptible capacity"):

1. **Preemption churn** — the same seeded generational search runs on a
   stable 4-worker fleet and on an all-preemptible fleet where 50% of
   capacity is preempted every ``PREEMPT_EVERY_S`` seconds (each victim
   takes the ``--preempt`` SIGUSR1 path: ``drain(reason="preempt")``
   hands back its prefetched-unstarted jobs, and a replacement member
   joins concurrently — the provider reclaiming spot capacity while new
   capacity provisions).  Asserts the churned search is bit-identical to
   the stable one (preemption steers nothing), loses zero jobs (every
   preemption-requeued job re-dispatches; broker quiescent), attributes
   every wave in the lineage ledger (``requeued`` reason ``preempt``),
   and pays <=10% best-fitness-vs-wall: same fitness trajectory, wall
   clock within 1.10x of the stable fleet.

2. **SLO-driven scale-up** — the full closed loop, over HTTP end to end:
   a broker pushing to a real ``MetricsAggregator`` (the stock
   ``queue_depth_growth`` rule at ``scale=0.05``), an
   ``AutoscalerDaemon`` polling ``/alertz``, and a ``ThreadBackend``
   (defined here) spawning in-process workers.  A submission rate that
   outruns one worker trips the SLO; the daemon steps the backend
   1 -> ``MAX_FLEET`` (exactly ``MAX_FLEET - 1`` decisions — one per
   step transition, no flapping); when submission stops the backlog
   drains, the alert self-clears, and no further decisions fire.  Every
   decision is then RECONSTRUCTED from ``telemetry.jsonl`` alone — the
   ``{"type": "scale"}`` records replay the daemon's decision ring
   exactly, and the triggering fire/clear edges are present as
   ``{"type": "alert"}`` records.

CPU-only, tens of seconds: `python scripts/torch_autoscale_study.py` writes
``scripts/torch_autoscale_study.json``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

_SCRIPT_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPT_DIR))

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import GeneticAlgorithm, Individual, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient, JobBroker  # noqa: E402
from gentun_tpu_torch.distributed.autoscaler import AutoscalerDaemon  # noqa: E402
from gentun_tpu_torch.telemetry import RunTelemetry, lineage  # noqa: E402
from gentun_tpu_torch.telemetry.aggregator import MetricsAggregator  # noqa: E402
from gentun_tpu_torch.telemetry.registry import get_registry  # noqa: E402
from gentun_tpu_torch.telemetry.slo import default_rules  # noqa: E402

GENERATIONS = 8
POP_SIZE = 12
POP_SEED, GA_SEED = 42, 7
#: High per-bit mutation so every generation breeds novel genomes — the
#: dispatch plane stays loaded for the churn to bite (same rate both
#: arms, so bit-identity is unaffected).
MUTATION_RATE = 0.5
EVAL_S = 0.08              # per-evaluation training time (sleep)
FLEET = 4
PREEMPT_EVERY_S = 0.8      # a wave preempts 50% of capacity this often
WAVE_SIZE = FLEET // 2     # = 50% of capacity per wave
WALL_BUDGET = 1.10         # churned wall must stay within 10% of stable

SLO_SCALE = 0.05           # 60s rule windows -> 3s: compressed timeline
PUSH_INTERVAL_S = 0.1
MAX_FLEET = 4
SCALE_JOBS = 120
SUBMIT_EVERY_S = 0.02      # 50 jobs/s: outruns even the full fleet
SCALE_EVAL_S = 0.1
COOLDOWN_S = 0.4

DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))


class OneMax(Individual):
    """Deterministic fitness (count of set bits): arms compare bit-for-bit."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


class SlowOneMax(OneMax):
    def evaluate(self):
        time.sleep(EVAL_S)
        return super().evaluate()


class ScaleOneMax(OneMax):
    def evaluate(self):
        time.sleep(SCALE_EVAL_S)
        return super().evaluate()


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


def _spawn_worker(species, port, wid, preemptible=False):
    stop = threading.Event()
    client = GentunClient(
        species, *DATA, host="127.0.0.1", port=port, worker_id=wid,
        capacity=1, prefetch_depth=1, heartbeat_interval=0.2,
        reconnect_delay=0.05, reconnect_max_delay=0.5,
        preemptible=preemptible)
    t = threading.Thread(target=lambda: client.work(stop_event=stop),
                         daemon=True)
    t.start()
    return client, stop, t


# ---------------------------------------------------------------------------
# Arm 1: preemption churn vs stable fleet
# ---------------------------------------------------------------------------


def _churn_search(churn: bool, tele_path: str | None) -> dict:
    """One seeded search on a FLEET-worker fleet; with ``churn``, 50% of
    capacity is preempted every PREEMPT_EVERY_S with concurrent
    replacement (all members preemptible — a spot pool)."""
    get_registry().reset()
    run_tele = None
    if tele_path:
        run_tele = RunTelemetry(tele_path, label="autoscale-churn").install()
        lineage.reset_ledger()
        lineage.enable()
    broker = JobBroker(port=0).start()
    _, port = broker.address
    fleet: dict = {}
    seq = [0]

    def _spawn():
        seq[0] += 1
        wid = f"{'churn' if churn else 'stable'}-w{seq[0]}"
        fleet[wid] = _spawn_worker(SlowOneMax, port, wid, preemptible=churn)
        return wid

    for _ in range(FLEET):
        _spawn()

    done = threading.Event()
    waves: list = []
    curve: list = []
    t0 = time.monotonic()
    try:
        pop = DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED,
            mutation_rate=MUTATION_RATE, host="127.0.0.1", port=port,
            broker=broker, job_timeout=120)
        try:
            ga = GeneticAlgorithm(pop, seed=GA_SEED)

            def _sample_curve():
                # best-fitness-vs-wall: one point per landed generation
                seen = 0
                while not done.is_set():
                    if len(ga.history) > seen:
                        seen = len(ga.history)
                        curve.append(
                            [round(time.monotonic() - t0, 3),
                             ga.history[seen - 1]["best_fitness"]])
                    time.sleep(0.005)

            def _churn_loop():
                while not done.wait(PREEMPT_EVERY_S):
                    live = [(wid, m) for wid, m in list(fleet.items())
                            if not m[1].is_set()]
                    victims = live[:WAVE_SIZE]  # oldest half of the fleet
                    if not victims:
                        continue
                    # Replacement capacity provisions concurrently with
                    # the reclaim — the preemption-tolerant posture.
                    replacements = [_spawn() for _ in victims]
                    for wid, (client, _, _) in victims:
                        client.drain(reason="preempt")  # the SIGUSR1 path
                    waves.append({
                        "t_s": round(time.monotonic() - t0, 3),
                        "preempted": [wid for wid, _ in victims],
                        "replacements": replacements,
                    })
                    for wid, (_, stop, _) in victims:
                        fleet.pop(wid, None)
                        # The drained member finishes its in-flight job,
                        # hands back the rest, and exits.
                        threading.Timer(1.0, stop.set).start()

            threads = [threading.Thread(target=_sample_curve, daemon=True)]
            if churn:
                threads.append(
                    threading.Thread(target=_churn_loop, daemon=True))
            for t in threads:
                t.start()
            ga.run(GENERATIONS)
            done.set()
            for t in threads:
                t.join(timeout=10)
            wall = time.monotonic() - t0
            snap = _snapshot(ga)
            leaked = broker.outstanding()
        finally:
            pop.close()
    finally:
        done.set()
        for _, stop, _ in fleet.values():
            stop.set()
        if run_tele is not None:
            run_tele.close()
            lineage.disable()
            lineage.reset_ledger()
        broker.stop()
    return {"wall_s": round(wall, 3), "curve": curve, "snapshot": snap,
            "leaked": leaked, "waves": waves}


def run_churn_arm() -> dict:
    tele_path = os.path.join(_SCRIPT_DIR, ".torch_autoscale_churn_telemetry.jsonl")
    stable = _churn_search(churn=False, tele_path=None)
    churned = _churn_search(churn=True, tele_path=tele_path)

    assert churned["waves"], "the churn loop never preempted anyone"
    preempted_total = sum(len(w["preempted"]) for w in churned["waves"])
    identical = churned["snapshot"] == stable["snapshot"]
    assert identical, "churned search diverged from the stable fleet"
    for arm in (stable, churned):
        assert all(v == 0 for v in arm["leaked"].values()), (
            f"leaked broker state: {arm['leaked']}")

    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    lin = [r for r in tele_lines if r.get("type") == "lineage"]
    preempt_requeued = [r for r in lin if r.get("event") == "requeued"
                        and r.get("reason") == "preempt"]
    assert preempt_requeued, "preemption churn never attributed in lineage"
    victims = {wid for w in churned["waves"] for wid in w["preempted"]}
    assert all(r["worker"] in victims for r in preempt_requeued), (
        f"preempt requeues name non-victims: {preempt_requeued}")
    # Zero lost: every preemption-requeued job re-dispatched afterwards
    # (and the search finished bit-identical with a quiescent broker).
    dispatches: dict = {}
    for r in lin:
        if r.get("event") == "dispatched":
            dispatches[r["job"]] = dispatches.get(r["job"], 0) + 1
    assert all(dispatches.get(r["job"], 0) >= 2 for r in preempt_requeued), (
        "a preemption-requeued job never re-dispatched")

    ratio = churned["wall_s"] / stable["wall_s"]
    assert ratio <= WALL_BUDGET, (
        f"preemption churn cost {round((ratio - 1) * 100, 1)}% wall "
        f"(budget {round((WALL_BUDGET - 1) * 100)}%): "
        f"{churned['wall_s']}s vs {stable['wall_s']}s stable")

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "seeds": {"population": POP_SEED, "ga": GA_SEED},
        "mutation_rate": MUTATION_RATE,
        "fleet": FLEET,
        "eval_s": EVAL_S,
        "preempt_every_s": PREEMPT_EVERY_S,
        "capacity_preempted_per_wave_pct": round(
            WAVE_SIZE / FLEET * 100.0, 1),
        "waves": churned["waves"],
        "workers_preempted_total": preempted_total,
        "preempt_requeued_jobs": sorted({r["job"] for r in preempt_requeued}),
        "bit_identical_to_stable_fleet": identical,
        "zero_lost_jobs": True,
        "stable_wall_s": stable["wall_s"],
        "churned_wall_s": churned["wall_s"],
        "wall_overhead_pct": round((ratio - 1) * 100.0, 1),
        "wall_budget_pct": round((WALL_BUDGET - 1) * 100.0, 1),
        "stable_best_fitness_vs_wall": stable["curve"],
        "churned_best_fitness_vs_wall": churned["curve"],
        "broker_state_after_final_gather": churned["leaked"],
    }


# ---------------------------------------------------------------------------
# Arm 2: queue-depth SLO drives the backend 1 -> MAX_FLEET, then self-clears
# ---------------------------------------------------------------------------


class ThreadBackend:
    """``FleetBackend`` over in-process ``GentunClient`` threads — the
    study's stand-in for a VM pool, with the exact drain semantics
    ``LocalProcessBackend`` gets from SIGTERM."""

    def __init__(self, species, port: int):
        self.species = species
        self.port = port
        self._members: list = []  # (wid, client, stop, thread)
        self._spawned = 0

    def size(self) -> int:
        return sum(1 for _, _, stop, _ in self._members if not stop.is_set())

    def spawn(self, n: int) -> int:
        for _ in range(n):
            self._spawned += 1
            wid = f"scale-w{self._spawned}"
            client, stop, t = _spawn_worker(self.species, self.port, wid,
                                            preemptible=True)
            self._members.append((wid, client, stop, t))
        return n

    def drain(self, n: int) -> int:
        live = [m for m in self._members if not m[2].is_set()]
        victims = live[len(live) - min(n, len(live)):]  # newest first
        for _, client, stop, _ in victims:
            client.drain()
            threading.Timer(1.0, stop.set).start()
        return len(victims)

    def reap(self) -> int:
        before = len(self._members)
        self._members = [m for m in self._members
                         if m[3].is_alive() and not m[2].is_set()]
        return before - len(self._members)

    def stop_all(self) -> None:
        for _, _, stop, _ in self._members:
            stop.set()

    def describe(self) -> dict:
        return {"kind": "thread-pool", "spawned_total": self._spawned,
                "size": self.size()}


def run_scale_up_arm() -> dict:
    get_registry().reset()
    tele_path = os.path.join(_SCRIPT_DIR, ".torch_autoscale_scaleup_telemetry.jsonl")
    old_interval = os.environ.get("GENTUN_TPU_AGG_PUSH_INTERVAL")
    os.environ["GENTUN_TPU_AGG_PUSH_INTERVAL"] = str(PUSH_INTERVAL_S)
    # Only the saturation rule: the arm measures one closed loop, and the
    # compressed idle rule would inject down-decisions mid-story.
    rules = [r for r in default_rules(scale=SLO_SCALE)
             if r.name == "queue_depth_growth"]
    agg = MetricsAggregator("127.0.0.1", 0, slo_rules=rules,
                            slo_interval=0.1)
    agg.start()
    run_tele = RunTelemetry(tele_path, label="autoscale-scaleup").install()
    broker = JobBroker(port=0, aggregator_url=agg.url).start()
    _, port = broker.address
    sid = broker.open_session("autoscale-study")
    backend = ThreadBackend(ScaleOneMax, port)
    backend.spawn(1)
    daemon = AutoscalerDaemon(
        backend, aggregator_url=agg.url, port=0, min_fleet=1,
        max_fleet=MAX_FLEET, step=1, cooldown_s=COOLDOWN_S,
        poll_interval=0.1)
    daemon.start()

    rng = np.random.default_rng(0)
    job_ids = []
    t0 = time.monotonic()
    try:
        # Submission outruns even the full fleet (50/s vs ~36/s at
        # MAX_FLEET), so the backlog grows monotonically until submission
        # stops: the gauge stays at its window peak, the alert holds
        # firing through the whole ramp, and the decision count is the
        # clean staircase 1 -> MAX_FLEET.
        for i in range(SCALE_JOBS):
            jid = f"scale-j{i:04d}"
            job_ids.append(jid)
            broker.submit({jid: {"genes": {
                "S_1": [int(b) for b in rng.integers(0, 2, 6)],
                "S_2": [int(b) for b in rng.integers(0, 2, 6)],
            }}}, session=sid)
            time.sleep(SUBMIT_EVERY_S)
        submit_wall = time.monotonic() - t0
        results = broker.gather(job_ids, timeout=120)
        drain_wall = time.monotonic() - t0
        assert len(results) == SCALE_JOBS, "jobs lost in the scale-up ramp"
        leaked = broker.outstanding()

        # Self-clear: backlog gone, the alert must walk back to inactive
        # with no operator action — and no further decisions.
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and agg.alertz()["active"]:
            time.sleep(0.05)
        active_after = agg.alertz()["active"]
        decisions_at_clear = daemon.decisionz()["total"]
        time.sleep(3 * COOLDOWN_S)  # would-be flap window
        decisions_final = daemon.decisionz()["decisions"]
        status = daemon.statusz()
        wall = time.monotonic() - t0
    finally:
        daemon.stop()
        backend.stop_all()
        broker.stop()
        run_tele.close()
        agg.stop()
        if old_interval is None:
            os.environ.pop("GENTUN_TPU_AGG_PUSH_INTERVAL", None)
        else:
            os.environ["GENTUN_TPU_AGG_PUSH_INTERVAL"] = old_interval

    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"
    assert not active_after, f"alert never self-cleared: {active_after}"
    expected = MAX_FLEET - 1  # one decision per staircase transition
    assert len(decisions_final) == expected, (
        f"expected {expected} scale decisions (1 -> {MAX_FLEET}), got "
        f"{len(decisions_final)}: {decisions_final}")
    assert len(decisions_final) == decisions_at_clear, (
        "decisions fired after the alert cleared — flapping")
    assert [d["from"] for d in decisions_final] == list(range(1, MAX_FLEET))
    assert all(d["action"] == "up" and d["rule"] == "queue_depth_growth"
               and d["evidence"] for d in decisions_final)
    assert status["backend"]["size"] == MAX_FLEET

    # -- decisions reconstructible from telemetry.jsonl alone -------------
    with open(tele_path, encoding="utf-8") as fh:
        tele_lines = [json.loads(line) for line in fh]
    os.unlink(tele_path)
    keys = ("action", "rule", "subject", "transition_seq", "from", "to",
            "outcome")
    replayed = [{k: r[k] for k in keys} for r in tele_lines
                if r.get("type") == "scale"]
    ring = [{k: d[k] for k in keys} for d in decisions_final]
    assert replayed == ring, (
        f"telemetry scale records do not replay the decision ring:\n"
        f"  telemetry: {replayed}\n  ring:      {ring}")
    alert_events = [r for r in tele_lines if r.get("type") == "alert"
                    and r.get("rule") == "queue_depth_growth"]
    fired = [r for r in alert_events if r.get("event") == "fire"]
    cleared = [r for r in alert_events if r.get("event") == "clear"]
    assert fired and cleared, (
        f"triggering edges missing from telemetry: {alert_events}")

    return {
        "rule": "queue_depth_growth",
        "slo_scale": SLO_SCALE,
        "jobs": SCALE_JOBS,
        "submit_rate_per_s": round(1.0 / SUBMIT_EVERY_S, 1),
        "eval_s": SCALE_EVAL_S,
        "min_fleet": 1,
        "max_fleet": MAX_FLEET,
        "cooldown_s": COOLDOWN_S,
        "submit_wall_s": round(submit_wall, 3),
        "drain_wall_s": round(drain_wall, 3),
        "wall_s": round(wall, 3),
        "decisions": decisions_final,
        "expected_transitions": expected,
        "decision_count_matches_transitions": True,
        "alert_self_cleared": True,
        "alert_edges_in_telemetry": {"fire": len(fired),
                                     "clear": len(cleared)},
        "decisions_reconstructed_from_telemetry": True,
        "backend": status["backend"],
        "autoscaler": {k: status[k] for k in ("config", "last_decision")},
        "broker_state_after_final_gather": leaked,
        "zero_lost_jobs": True,
    }


def main() -> dict:
    return {
        "preemption_churn": run_churn_arm(),
        "slo_scale_up": run_scale_up_arm(),
    }


if __name__ == "__main__":
    out = main()
    print(json.dumps(out, indent=2))
    path = out_path("torch_autoscale_study.json")
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
