"""Measured fleet-observability artifact: aggregation + SLO story, recorded.

``torch_ops_smoke.json`` records one process's ops plane; this study records
the FLEET one (docs/OBSERVABILITY.md "Fleet aggregation & SLOs"): a
seeded search run by a master (with its in-process broker) and two
spawn-based worker *processes* — each with its own metrics registry —
all pushing periodic snapshot deltas to one in-process
``MetricsAggregator``.  The artifact asserts the acceptance sequence:

1. **merge correctness** — the merged fleet ``/metrics`` page validates
   against the Prometheus exposition grammar, its per-instance counter
   samples sum exactly to the ``/statusz`` fleet rollup, and the
   aggregator's view of the master's ``jobs_dispatched_total`` matches
   the master registry's own value (ground truth);
2. **SLO fire + self-clear** — a 5 s dispatch stall injected between GA
   phases starves both workers; the ``worker_idle_ratio`` burn-rate rule
   trips (alert on ``/alertz`` AND as a ``{"type": "alert"}`` record in
   ``telemetry.jsonl``) and self-clears after dispatch resumes, with no
   operator action;
3. **zero search perturbation** — an aggregator-free run of the same
   seeded search is bit-identical (full population + fitness history) to
   the aggregator-wired run;
4. **push-path cost** — the snapshot-delta scan a pushing process pays
   per flush is micro-timed against measured per-job dispatch cost and
   gated at <= 2% (``broker_throughput.run_aggregator_gate``).

CPU-only: `python scripts/torch_obsagg_study.py` writes
``scripts/torch_obsagg_study.json``.  Wall time is dominated by the two
spawned workers importing the port and the deliberately-injected stall plus
the SLO clear hold (~1 min total).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

_SCRIPT_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPT_DIR))
sys.path.insert(0, _SCRIPT_DIR)

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import GeneticAlgorithm, Individual, Population, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient  # noqa: E402
from gentun_tpu_torch.telemetry import RunTelemetry  # noqa: E402
from gentun_tpu_torch.telemetry.aggregator import MetricsAggregator  # noqa: E402
from gentun_tpu_torch.telemetry.registry import get_registry  # noqa: E402
from gentun_tpu_torch.telemetry.slo import default_rules  # noqa: E402

GENERATIONS_A = 2          # phase A: healthy dispatch
GENERATIONS_B = 1          # phase B: the batch whose arrival exposes the stall
POP_SIZE = 8
POP_SEED, GA_SEED = 42, 7
STALL_S = 5.0              # injected dispatch pause between the phases
#: High per-bit mutation so EVERY generation breeds novel genomes.  At the
#: default 0.015/bit on this 12-bit OneMax genome, phase B's offspring are
#: nearly all fitness-cache hits: zero jobs dispatch after the stall, no
#: batch reaches a worker, and the idle gap is never observed.  Both arms
#: use the same rate, so bit-identity is unaffected.
MUTATION_RATE = 0.5
SLO_SCALE = 0.1            # 60s windows -> 6s: same rules, compressed timeline
PUSH_INTERVAL_S = 0.5
FULL_EVERY = 4             # heartbeat full resend every 2s per instance
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))

# The exposition grammar check, same subset as scripts/torch_ops_smoke.py.
_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [0-9eE+.\-]+(?: [0-9]+)?$')

#: The aggregator's self-metrics: on the /metrics page but (correctly)
#: not part of the per-instance fleet rollup the sum check replays.
_SELF_METRICS = {
    "aggregator_pushes_total", "aggregator_pushes_dropped_total",
    "aggregator_resets_detected_total", "aggregator_instances",
    "aggregator_series",
}


class OneMax(Individual):
    """Pure deterministic fitness — count of set bits."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


def _worker_proc(port: int, agg_url: str, worker_id: str) -> None:
    """Spawn target: one worker PROCESS with its own registry + pusher."""
    os.environ["GENTUN_TPU_AGG_PUSH_INTERVAL"] = str(PUSH_INTERVAL_S)
    os.environ["GENTUN_TPU_AGG_FULL_EVERY"] = str(FULL_EVERY)
    from gentun_tpu_torch.telemetry import spans as spans_mod
    spans_mod.enable()  # the worker_idle_s observation is telemetry-gated
    GentunClient(
        OneMax, *DATA, host="127.0.0.1", port=port, worker_id=worker_id,
        heartbeat_interval=0.2, reconnect_delay=0.1,
        aggregator_url=agg_url,
    ).work()


def _worker_thread(port: int, worker_id: str) -> threading.Event:
    """In-thread worker for the aggregator-free reference run."""
    stop = threading.Event()
    client = GentunClient(
        OneMax, *DATA, host="127.0.0.1", port=port, worker_id=worker_id,
        heartbeat_interval=0.2, reconnect_delay=0.1,
    )
    threading.Thread(target=lambda: client.work(stop_event=stop),
                     daemon=True).start()
    return stop


def _snapshot(ga) -> dict:
    return {
        "best_fitness_history": [r["best_fitness"] for r in ga.history],
        "final_population": [
            {"genes": {k: list(v) for k, v in ind.get_genes().items()},
             "fitness": ind.get_fitness()}
            for ind in ga.population
        ],
    }


def _phased_run(ga, stall_s: float = 0.0):
    """The study's fixed GA call pattern, identical on every arm."""
    ga.run(GENERATIONS_A)
    if stall_s:
        time.sleep(stall_s)
    ga.run(GENERATIONS_B)


def _get_json(url: str, timeout: float = 5.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _validate_prometheus(text: str) -> dict:
    families, samples = set(), 0
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line.startswith("#"):
            continue
        else:
            assert _SAMPLE_RE.match(line), f"invalid exposition line: {line!r}"
            samples += 1
    return {"valid": True, "n_families": len(families), "n_samples": samples}


def _counter_sums_from_text(text: str) -> dict:
    """name -> summed value over every per-instance sample on the page."""
    counters = set()
    for line in text.splitlines():
        if line.startswith("# TYPE ") and line.split()[3] == "counter":
            counters.add(line.split()[2])
    sums: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_part, value = line.rsplit(" ", 1)
        name = name_part.split("{", 1)[0]
        if name in counters:
            sums[name] = sums.get(name, 0.0) + float(value)
    return sums


def _wait_for(predicate, timeout_s: float, poll_s: float = 0.25):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        got = predicate()
        if got:
            return got
        time.sleep(poll_s)
    return None


def run() -> dict:
    os.environ["GENTUN_TPU_AGG_PUSH_INTERVAL"] = str(PUSH_INTERVAL_S)
    os.environ["GENTUN_TPU_AGG_FULL_EVERY"] = str(FULL_EVERY)
    tele_path = os.path.join(_SCRIPT_DIR, ".torch_obsagg_telemetry.jsonl")
    if os.path.exists(tele_path):
        os.unlink(tele_path)

    # -- arm 1: aggregator-free reference (in-thread workers) -------------
    get_registry().reset()
    with DistributedPopulation(OneMax, size=POP_SIZE, seed=POP_SEED,
                               mutation_rate=MUTATION_RATE, port=0) as pop_ref:
        _, port = pop_ref.broker_address
        stops = [_worker_thread(port, "ref-w0"), _worker_thread(port, "ref-w1")]
        ga_ref = GeneticAlgorithm(pop_ref, seed=GA_SEED)
        _phased_run(ga_ref)  # no stall: the stall only exercises the SLO
        for s in stops:
            s.set()
    ref_snap = _snapshot(ga_ref)

    # -- arm 2: the same seeded search, fully wired to an aggregator ------
    get_registry().reset()
    run_tele = RunTelemetry(tele_path, label="obsagg").install()
    agg = MetricsAggregator(
        "127.0.0.1", 0, slo_rules=default_rules(scale=SLO_SCALE),
        slo_interval=0.25, instance_ttl=10.0)
    agg.start()
    t0 = time.monotonic()
    procs = []
    try:
        ctx = multiprocessing.get_context("spawn")
        with DistributedPopulation(OneMax, size=POP_SIZE, seed=POP_SEED,
                                   mutation_rate=MUTATION_RATE, port=0,
                                   aggregator_url=agg.url) as pop:
            _, port = pop.broker_address
            for wid in ("w0", "w1"):
                p = ctx.Process(target=_worker_proc,
                                args=(port, agg.url, wid), daemon=True)
                p.start()
                procs.append(p)
            ga = GeneticAlgorithm(pop, seed=GA_SEED)
            t_stall_start = None

            ga.run(GENERATIONS_A)
            t_stall_start = time.monotonic()
            time.sleep(STALL_S)  # the injected dispatch stall
            ga.run(GENERATIONS_B)
            t_resume = time.monotonic()

            # -- the worker-idle SLO must fire ... --------------------
            fired = _wait_for(
                lambda: [a for a in _get_json(agg.url + "/alertz")["active"]
                         if a["rule"] == "worker_idle_ratio"],
                timeout_s=15.0)
            assert fired, "worker_idle_ratio never fired after the stall"
            t_fired = time.monotonic()

            # -- ... and self-clear once the window slides past -------
            cleared = _wait_for(
                lambda: not [a for a in _get_json(agg.url + "/alertz")["active"]
                             if a["rule"] == "worker_idle_ratio"] or None,
                timeout_s=30.0)
            assert cleared, "worker_idle_ratio never self-cleared"
            t_cleared = time.monotonic()

            # -- merge correctness, with every pusher still alive -----
            # One more heartbeat cycle so final counts are all pushed.
            time.sleep(FULL_EVERY * PUSH_INTERVAL_S + 1.0)
            statusz = _get_json(agg.url + "/statusz")
            with urllib.request.urlopen(agg.url + "/metrics",
                                        timeout=5.0) as resp:
                metrics_text = resp.read().decode("utf-8")
            prom = _validate_prometheus(metrics_text)

            instances = statusz["instance_table"]
            assert len(instances) == 3, instances  # master+broker, w0, w1
            roles = {i["instance"]: i["role"] for i in instances}
            assert {"w0", "w1"} <= set(roles), roles
            master_inst = next(i for i in roles
                               if i not in ("w0", "w1"))
            assert set(roles[master_inst].split("+")) == {"master", "broker"}, \
                roles

            # per-instance samples on the page sum to the fleet rollup
            page_sums = _counter_sums_from_text(metrics_text)
            rollup = statusz["fleet"]["counters"]
            mismatches = {
                name: (page_sums.get(name), rollup.get(name))
                for name in set(page_sums) | set(rollup)
                if name not in _SELF_METRICS
                and abs(page_sums.get(name, 0.0)
                        - rollup.get(name, 0.0)) > 1e-6
            }
            assert not mismatches, f"page vs rollup mismatch: {mismatches}"

            # ground truth: the aggregator's view of the master's
            # dispatch counter equals the master registry's own value
            local_dispatched = sum(
                c["value"] for c in get_registry().snapshot()["counters"]
                if c["name"] == "jobs_dispatched_total")
            agg_dispatched = rollup.get("jobs_dispatched_total", 0.0)
            assert abs(local_dispatched - agg_dispatched) <= 1e-6, (
                local_dispatched, agg_dispatched)
            assert local_dispatched > 0

            skew = statusz["version_skew"]
            assert not skew["skew"], f"single-build fleet read as skewed: {skew}"
            agg_stats = agg.stats()
        best = ga.population.get_fittest()
        wall = time.monotonic() - t0
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=10.0)
        agg.stop()
        run_tele.close()

    on_snap = _snapshot(ga)

    # -- zero perturbation: aggregator-wired == aggregator-free -----------
    assert on_snap == ref_snap, "aggregator wiring perturbed the search"

    # -- the alert also landed in telemetry.jsonl --------------------------
    with open(tele_path) as fh:
        records = [json.loads(line) for line in fh if line.strip()]
    alert_recs = [r for r in records if r.get("type") == "alert"
                  and r.get("rule") == "worker_idle_ratio"]
    fires = [r for r in alert_recs if r.get("event") == "fire"]
    clears = [r for r in alert_recs if r.get("event") == "clear"]
    assert fires, "no worker_idle_ratio fire record in telemetry.jsonl"
    assert clears, "no worker_idle_ratio clear record in telemetry.jsonl"
    degraded = [r for r in records if r.get("name") == "aggregator_degraded"]
    assert not degraded, f"healthy aggregator was marked degraded: {degraded}"
    os.unlink(tele_path)

    # -- push-path cost gate (broker_throughput instrument) ----------------
    import broker_throughput
    bt = broker_throughput.run(n_jobs=2000, n_workers=4)
    per_job_dispatch_us = round(1e6 * bt["wall_s"] / bt["n_jobs"], 1)
    gate = broker_throughput.run_aggregator_gate(per_job_dispatch_us)
    assert gate["within_gate"], f"push-path gate failed: {gate}"

    return {
        "fleet": {
            "instances": sorted(roles),
            "roles": roles,
            "pushes": agg_stats["pushes"],
            "pushes_dropped": agg_stats["pushes_dropped"],
            "resets_detected": agg_stats["resets_detected"],
        },
        "seeds": {"population": POP_SEED, "ga": GA_SEED},
        "generations": {"phase_a": GENERATIONS_A, "phase_b": GENERATIONS_B},
        "merge": {
            "metrics_page": prom,
            "counters_checked": len(
                set(page_sums) | set(rollup)) - len(_SELF_METRICS
                                                    & set(page_sums)),
            "page_equals_rollup": True,
            "master_jobs_dispatched": local_dispatched,
            "aggregator_jobs_dispatched": agg_dispatched,
            "version_skew": False,
        },
        "slo": {
            "rule": "worker_idle_ratio",
            "scale": SLO_SCALE,
            "stall_s": STALL_S,
            "stall_at_s": round(t_stall_start - t0, 3),
            "resumed_at_s": round(t_resume - t0, 3),
            "fired_at_s": round(t_fired - t0, 3),
            "self_cleared_at_s": round(t_cleared - t0, 3),
            "fired_subjects": sorted({a["subject"] for a in fired}),
            "telemetry_fire_records": len(fires),
            "telemetry_clear_records": len(clears),
        },
        "bit_identical_to_aggregator_free_run": True,
        "best_fitness": best.get_fitness(),
        "push_gate": gate,
        "wall_s": round(wall, 3),
    }


if __name__ == "__main__":
    out = run()
    print(json.dumps(out, indent=2))
    path = out_path("torch_obsagg_study.json")
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
