"""Measured artifact for multi-tenant search sessions: N concurrent
searches on ONE shared fleet, each bit-identical to its solo run, plus a
fair-share study.

Part A — isolation (the correctness claim).  Three seeded generational
searches run CONCURRENTLY against one broker + one 2-worker fleet, each
in its own session (``DistributedPopulation(session=...)``), engines
unmodified.  Each must finish with the SAME best genome and fitness as
its solo reference run (local evaluation, same seeds): fitness is a pure
function of genes, so fair-share interleaving and shared-fleet timing
must not be able to steer any tenant's trajectory.

Part B — fairness (the scheduling claim).  Two wire-level job streams
stay backlogged on the same 2-worker fleet under a 2:1 priority
(``gold`` weight 2, ``bronze`` weight 1).  Per-session completed-job
counts are sampled mid-backlog; the weighted deficit-round-robin
scheduler must hold the completed-share ratio within 10% of 2:1, and
Jain's fairness index over the weight-NORMALIZED throughputs
``x_i = completed_i / weight_i`` must be ~1.0 (1.0 = perfectly
weight-proportional service).

CPU-only, <1 minute: ``python scripts/torch_multitenant_study.py`` writes
``scripts/torch_multitenant_study.json``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import GeneticAlgorithm, Individual, Population, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient, JobBroker  # noqa: E402

TENANTS = 3
WORKERS = 2
POP_SIZE = 6
GENERATIONS = 3
POP_SEEDS = [42, 43, 44]
ENGINE_SEEDS = [7, 8, 9]
#: Part B: jobs per stream (large enough that both stay backlogged past
#: the sampling point) and the completed-total at which shares are read.
STREAM_JOBS = 150
SAMPLE_AT = 80
EVAL_S = 0.01
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))


class OneMax(Individual):
    """Pure function of genes: solo and shared-fleet runs must agree
    bit-for-bit."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


class PacedOneMax(OneMax):
    """Fixed per-job service time so Part B's completed counts track the
    dispatch schedule, not evaluation noise."""

    def evaluate(self):
        time.sleep(EVAL_S)
        return super().evaluate()


def _spawn_worker(species, port, worker_id, prefetch_depth=None):
    stop = threading.Event()
    client = GentunClient(
        species, *DATA, host="127.0.0.1", port=port, capacity=1,
        prefetch_depth=prefetch_depth, worker_id=worker_id,
        heartbeat_interval=0.2, reconnect_delay=0.05,
    )
    t = threading.Thread(target=lambda: client.work(stop_event=stop), daemon=True)
    t.start()
    return client, stop, t


def solo_references():
    """The per-tenant gold standard: same seeds, local evaluation."""
    refs = []
    for i in range(TENANTS):
        pop = Population(OneMax, DATA, size=POP_SIZE, seed=POP_SEEDS[i],
                         maximize=True)
        best = GeneticAlgorithm(pop, seed=ENGINE_SEEDS[i]).run(GENERATIONS)
        refs.append({"best_fitness": best.get_fitness(),
                     "best_genes": best.get_genes()})
    return refs


def concurrent_tenants():
    """TENANTS unmodified GeneticAlgorithm runs, one session each, one
    shared broker + fleet."""
    owner = DistributedPopulation(
        OneMax, size=POP_SIZE, seed=POP_SEEDS[0], port=0, maximize=True,
        job_timeout=120, session="tenant0")
    pops = [owner]
    workers = []
    try:
        _, port = owner.broker_address
        for i in range(1, TENANTS):
            pops.append(DistributedPopulation(
                OneMax, size=POP_SIZE, seed=POP_SEEDS[i], maximize=True,
                job_timeout=120, broker=owner.broker, session=f"tenant{i}"))
        for i in range(WORKERS):
            workers.append(_spawn_worker(OneMax, port, f"mt-w{i}"))
        deadline = time.monotonic() + 10
        while owner.broker.fleet_members() < WORKERS:
            if time.monotonic() > deadline:
                raise RuntimeError("workers never joined")
            time.sleep(0.01)

        results = [None] * TENANTS
        errors = []

        def _run(i, pop):
            try:
                best = GeneticAlgorithm(pop, seed=ENGINE_SEEDS[i]).run(GENERATIONS)
                results[i] = {"best_fitness": best.get_fitness(),
                              "best_genes": best.get_genes()}
            except Exception as e:  # pragma: no cover - surfaced below
                errors.append(f"tenant{i}: {e!r}")

        t0 = time.monotonic()
        threads = [threading.Thread(target=_run, args=(i, p), daemon=True)
                   for i, p in enumerate(pops)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.monotonic() - t0
        if errors:
            raise RuntimeError("; ".join(errors))
        stats = {sid: {k: s[k] for k in ("weight", "submitted", "completed",
                                         "failed", "requeued")}
                 for sid, s in owner.broker.session_stats().items()}
        for _, stop, _t in workers:
            stop.set()
        return results, stats, wall
    finally:
        for p in pops[1:]:
            p.close()
        owner.close()


def fairness_study():
    """Two backlogged wire streams, weights 2:1, shares sampled
    mid-backlog; Jain index over weight-normalized throughput."""
    weights = {"gold": 2.0, "bronze": 1.0}
    genome = Population(OneMax, DATA, size=1, seed=5, maximize=True)[0].get_genes()
    broker = JobBroker(port=0).start()
    workers = []
    try:
        _, port = broker.address
        for sid, w in weights.items():
            broker.open_session(sid, weight=w)
        for i in range(WORKERS):
            workers.append(_spawn_worker(PacedOneMax, port, f"fair-w{i}",
                                         prefetch_depth=1))
        deadline = time.monotonic() + 10
        while broker.fleet_members() < WORKERS:
            if time.monotonic() > deadline:
                raise RuntimeError("workers never joined")
            time.sleep(0.01)
        jobs = {}
        for sid in weights:
            ids = {f"{sid}-{i}": {"genes": genome} for i in range(STREAM_JOBS)}
            broker.submit(ids, session=sid)
            jobs[sid] = list(ids)

        def _completed():
            stats = broker.session_stats()
            return {sid: stats[sid]["completed"] for sid in weights}

        deadline = time.monotonic() + 120
        while sum(_completed().values()) < SAMPLE_AT:
            if time.monotonic() > deadline:
                raise RuntimeError("fairness streams stalled")
            time.sleep(0.01)
        done = _completed()
        stats = broker.session_stats()
        # Both streams must still be backlogged at the sampling point —
        # shares measured after one drains would just be work conservation.
        backlogged = all(stats[sid]["submitted"] - done[sid] > WORKERS * 2
                         for sid in weights)
        broker.cancel([j for ids in jobs.values() for j in ids])
        for _, stop, _t in workers:
            stop.set()

        total = sum(done.values())
        shares = {sid: done[sid] / total for sid in weights}
        ratio = done["gold"] / max(1, done["bronze"])
        norm = [done[sid] / weights[sid] for sid in weights]
        jain = (sum(norm) ** 2) / (len(norm) * sum(x * x for x in norm))
        return {
            "weights": weights,
            "jobs_per_stream": STREAM_JOBS,
            "sampled_at_completed": total,
            "both_streams_backlogged_at_sample": backlogged,
            "completed": done,
            "completed_shares": {s: round(v, 4) for s, v in shares.items()},
            "gold_to_bronze_ratio": round(ratio, 4),
            "target_ratio": 2.0,
            "ratio_within_10pct": bool(1.8 <= ratio <= 2.2),
            "jain_index_weight_normalized": round(jain, 4),
        }
    finally:
        broker.stop()


def main(argv=None) -> int:
    refs = solo_references()
    shared, session_stats, wall = concurrent_tenants()
    tenants = []
    for i in range(TENANTS):
        identical = (shared[i] is not None
                     and shared[i]["best_fitness"] == refs[i]["best_fitness"]
                     and shared[i]["best_genes"] == refs[i]["best_genes"])
        tenants.append({
            "session": f"tenant{i}",
            "pop_seed": POP_SEEDS[i],
            "engine_seed": ENGINE_SEEDS[i],
            "solo_best_fitness": refs[i]["best_fitness"],
            "shared_best_fitness": shared[i]["best_fitness"],
            "best_genes": shared[i]["best_genes"],
            "bit_identical_to_solo": bool(identical),
        })
    fairness = fairness_study()

    out = {
        "workload": {
            "tenants": TENANTS,
            "workers": WORKERS,
            "population_size": POP_SIZE,
            "generations": GENERATIONS,
        },
        "concurrent_searches": {
            "wall_s": round(wall, 3),
            "tenants": tenants,
            "all_bit_identical": all(t["bit_identical_to_solo"] for t in tenants),
            "broker_session_stats": session_stats,
        },
        "fairness": fairness,
    }
    path = out_path("torch_multitenant_study.json", argv)
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    ok = (out["concurrent_searches"]["all_bit_identical"]
          and fairness["ratio_within_10pct"])
    print(f"\nwrote {path}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
