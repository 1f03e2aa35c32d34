"""Measured artifact: the networked shared fitness-memoization service.

Two claims, demonstrated on a seeded 2-worker distributed search whose
species burns a fixed simulated chip-time per training:

1. **Warm-cache reuse** — the SAME seeded search replayed against the
   service a first (cold) run populated answers ≥90% of its lookups from
   the service and spends ≥5× less evaluation chip-time than the cold
   run (genomes memoized fleet-wide complete at dispatch, never trained).
2. **Concurrent sharing is trajectory-neutral** — two differently-seeded
   2-worker searches running AT THE SAME TIME against one service finish
   bit-identical to their solo (service-free, single-process) reference
   runs: fitness is a pure function of genes, so a cache hit — even one
   published by the *other* search moments earlier — can never steer a
   seeded trajectory.

CPU-only, a few seconds: ``python scripts/torch_cache_study.py`` writes
``scripts/torch_cache_study.json``.
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
from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient  # noqa: E402
from gentun_tpu_torch.distributed.fitness_service import FitnessService  # noqa: E402

GENERATIONS = 3
POP_SIZE = 8
CHIP_SLEEP_S = 0.02  # simulated training cost per genome evaluation
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))

_chip_lock = threading.Lock()
_chip_time = [0.0]  # simulated chip-seconds burned by evaluations


class OneMaxChip(Individual):
    """Count of set bits, with a fixed simulated chip-time per training.

    Purity (fitness is a function of genes alone) is what makes cache
    reuse safe; the sleep is what makes reuse *measurable* — every skipped
    training shows up as chip-seconds not burned.
    """

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        time.sleep(CHIP_SLEEP_S)
        with _chip_lock:
            _chip_time[0] += CHIP_SLEEP_S
        return float(sum(sum(g) for g in self.genes.values()))


def _reset_chip_time() -> None:
    with _chip_lock:
        _chip_time[0] = 0.0


def _chip_time_s() -> float:
    with _chip_lock:
        return round(_chip_time[0], 6)


def _workers(port: int, n: int, tag: str):
    stops = []
    for i in range(n):
        stop = threading.Event()
        client = GentunClient(
            OneMaxChip, *DATA, host="127.0.0.1", port=port,
            worker_id=f"{tag}-w{i}", heartbeat_interval=0.2,
            reconnect_delay=0.05,
        )
        threading.Thread(target=lambda c=client, s=stop: c.work(stop_event=s),
                         daemon=True).start()
        stops.append(stop)
    return stops


def _snapshot(ga: GeneticAlgorithm) -> dict:
    return {
        "best_fitness_history": [r["best_fitness"] for r in ga.history],
        "final_population": [
            {"genes": {k: list(v) for k, v in ind.get_genes().items()},
             "fitness": ind.get_fitness()}
            for ind in ga.population
        ],
    }


def _search(cache_url: str | None, pop_seed: int, ga_seed: int, tag: str) -> dict:
    """One seeded 2-worker distributed search; returns snapshot + stats."""
    pop = DistributedPopulation(
        OneMaxChip, size=POP_SIZE, seed=pop_seed, host="127.0.0.1", port=0,
        job_timeout=120, cache_url=cache_url)
    stops = _workers(pop.broker_address[1], 2, tag)
    try:
        ga = GeneticAlgorithm(pop, seed=ga_seed)
        ga.run(GENERATIONS)
        out = _snapshot(ga)
        out["service"] = (pop.fitness_cache.stats() if cache_url else None)
        out["unique_architectures"] = len(pop.fitness_cache)
        return out
    finally:
        for s in stops:
            s.set()
        pop.close()


def _solo_reference(pop_seed: int, ga_seed: int) -> dict:
    """Service-free single-process reference with the same seeds."""
    ga = GeneticAlgorithm(
        Population(OneMaxChip, *DATA, size=POP_SIZE, seed=pop_seed),
        seed=ga_seed)
    ga.run(GENERATIONS)
    return _snapshot(ga)


def run() -> dict:
    svc = FitnessService(port=0).start()
    try:
        # -- Act 1: cold vs warm — the memoization payoff ------------------
        _reset_chip_time()
        cold = _search(svc.url, pop_seed=42, ga_seed=7, tag="cold")
        cold_chip = _chip_time_s()

        _reset_chip_time()
        warm = _search(svc.url, pop_seed=42, ga_seed=7, tag="warm")
        warm_chip = _chip_time_s()

        assert warm["best_fitness_history"] == cold["best_fitness_history"], \
            "warm replay diverged from the cold run"
        hit_rate = warm["service"]["hit_rate"]
        assert hit_rate is not None and hit_rate >= 0.90, (
            f"warm run hit rate {hit_rate} < 0.90 "
            f"({warm['service']})")
        assert warm_chip * 5.0 <= cold_chip, (
            f"warm chip-time {warm_chip}s not ≥5× below cold {cold_chip}s")

        # -- Act 2: two concurrent searches sharing the service ------------
        ref_a = _solo_reference(pop_seed=11, ga_seed=3)
        ref_b = _solo_reference(pop_seed=23, ga_seed=9)
        results: dict = {}
        errors: list = []

        def _concurrent(name, pop_seed, ga_seed):
            try:
                results[name] = _search(svc.url, pop_seed, ga_seed,
                                        tag=f"conc-{name}")
            except Exception as e:  # surfaced below — threads must not die silently
                errors.append((name, repr(e)))

        ta = threading.Thread(target=_concurrent, args=("a", 11, 3))
        tb = threading.Thread(target=_concurrent, args=("b", 23, 9))
        t0 = time.monotonic()
        ta.start(), tb.start()
        ta.join(timeout=300), tb.join(timeout=300)
        concurrent_wall = round(time.monotonic() - t0, 3)
        assert not errors, f"concurrent search failed: {errors}"

        a_identical = (
            results["a"]["best_fitness_history"] == ref_a["best_fitness_history"]
            and results["a"]["final_population"] == ref_a["final_population"])
        b_identical = (
            results["b"]["best_fitness_history"] == ref_b["best_fitness_history"]
            and results["b"]["final_population"] == ref_b["final_population"])
        assert a_identical and b_identical, (
            "a concurrent shared-cache search diverged from its solo "
            f"reference (a={a_identical}, b={b_identical})")

        svc_stats = svc.stats()
    finally:
        svc.stop()

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "workers_per_search": 2,
        "chip_sleep_s": CHIP_SLEEP_S,
        "cold": {
            "seeds": {"population": 42, "ga": 7},
            "chip_time_s": cold_chip,
            "unique_architectures": cold["unique_architectures"],
            "client": cold["service"],
        },
        "warm": {
            "seeds": {"population": 42, "ga": 7},
            "chip_time_s": warm_chip,
            "hit_rate": hit_rate,
            "client": warm["service"],
        },
        "warm_hit_rate_ok": hit_rate >= 0.90,
        "chip_time_reduction_x": (
            round(cold_chip / warm_chip, 2) if warm_chip > 0 else None),
        "chip_time_reduction_at_least_5x": warm_chip * 5.0 <= cold_chip,
        "warm_bit_identical_to_cold": True,
        "concurrent": {
            "searches": [
                {"name": "a", "seeds": {"population": 11, "ga": 3},
                 "bit_identical_to_solo": a_identical,
                 "client": results["a"]["service"]},
                {"name": "b", "seeds": {"population": 23, "ga": 9},
                 "bit_identical_to_solo": b_identical,
                 "client": results["b"]["service"]},
            ],
            "wall_s": concurrent_wall,
        },
        "service": svc_stats,
    }


if __name__ == "__main__":
    out = run()
    print(json.dumps(out, indent=2))
    path = out_path("torch_cache_study.json")
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
