"""Measured artifact for the asynchronous steady-state engine: the
generation barrier's cost, and its removal.

Workload: a 2-worker fleet evaluating a deterministic OneMax whose
training time is heterogeneous — most genomes train fast, an unlucky
subset are ~12× stragglers (real CNN search has exactly this shape: deep
chains and wide blocks train slower than the population median).  The
generational engine pays the barrier every generation: the fleet idles
while the straggler finishes, and converged late generations dispatch
1-4 fresh individuals against capacity 2.  The steady-state engine
(``AsyncEvolution``) breeds+dispatches a replacement the instant any
evaluation returns, so the fleet stays saturated through the tail.

Both modes run the SAME total completion budget (generational: pop ×
generations fitness lookups; async: the same number as its
``max_evaluations``) on the same 2-worker in-process fleet, with
telemetry on.  Utilization is the mean of the ``jobs_in_flight`` gauge
(sampled at 5 ms) over the run, divided by fleet capacity.  Two regimes:

- ``saturated_fresh`` (mutation 0.15): every generation breeds mostly
  novel genomes, the fleet has plenty of work, and the barrier costs only
  the end-of-generation straggler tail — the async win is modest.
- ``converged_tail`` (default mutation 0.015): the search converges and
  late generations dispatch only 1-4 fresh individuals (the rest answer
  from the fitness cache), so the generational mode pays a full
  barrier + dispatch round-trip for a trickle of real work — the
  tail-generation regime PERF.md measures, where the steady-state engine
  shines.

CPU-only, <1 minute: ``python scripts/torch_async_study.py`` writes
``scripts/torch_async_study.json``.
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
from gentun_tpu_torch import AsyncEvolution, GeneticAlgorithm, Individual, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient  # noqa: E402
from gentun_tpu_torch.telemetry import spans as spans_mod  # noqa: E402
from gentun_tpu_torch.telemetry.registry import get_registry  # noqa: E402

POP_SIZE = 8
GENERATIONS = 6
WORKERS = 2
POP_SEED, GA_SEED = 42, 7
BASE_S, STRAGGLER_S = 0.04, 0.5
#: High enough that converged parents still mostly breed FRESH genomes —
#: the study measures evaluation throughput, not fitness-cache behavior
#: (identical in both modes).  Applied to both engines equally.
MUTATION_RATE = 0.15
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))

_real_evals = [0]
_eval_lock = threading.Lock()


class HeteroOneMax(Individual):
    """Bit-count fitness with a genes-deterministic training delay:
    every 4th genome (by bit sum) is a straggler."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        bits = int(sum(sum(g) for g in self.genes.values()))
        time.sleep(STRAGGLER_S if bits % 4 == 0 else BASE_S)
        with _eval_lock:
            _real_evals[0] += 1
        return float(bits)


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _start_fleet(port):
    stops = []
    for i in range(WORKERS):
        stop = threading.Event()
        client = GentunClient(
            HeteroOneMax, *DATA, host="127.0.0.1", port=port,
            capacity=1, worker_id=f"study-w{i}",
            heartbeat_interval=0.2, reconnect_delay=0.05,
        )
        threading.Thread(
            target=lambda c=client, s=stop: c.work(stop_event=s), daemon=True,
        ).start()
        stops.append(stop)
    return stops


def _await_fleet(pop, timeout=10.0):
    """Block until every worker is connected, so both engines start against
    the same fully-formed fleet (no capacity-resolution race)."""
    deadline = time.monotonic() + timeout
    while pop.fleet_capacity() < WORKERS:
        if time.monotonic() > deadline:
            raise TimeoutError(f"fleet never reached capacity {WORKERS}")
        time.sleep(0.02)


def _measure(run_fn):
    """Run one engine under a jobs_in_flight sampler; return its stats."""
    get_registry().reset()
    samples, done = [], threading.Event()
    gauge = get_registry().gauge("jobs_in_flight")

    def _sample():
        while not done.is_set():
            samples.append(gauge.value)
            time.sleep(0.005)

    sampler = threading.Thread(target=_sample, daemon=True)
    with _eval_lock:
        _real_evals[0] = 0
    sampler.start()
    t0 = time.monotonic()
    try:
        result = run_fn()
    finally:
        done.set()
        sampler.join(timeout=1)
    wall = time.monotonic() - t0
    mean_in_flight = float(np.mean(samples)) if samples else 0.0
    return {
        "wall_s": round(wall, 3),
        "real_evaluations": _real_evals[0],
        "mean_jobs_in_flight": round(mean_in_flight, 3),
        "peak_jobs_in_flight": int(max(samples)) if samples else 0,
        "utilization": round(mean_in_flight / WORKERS, 3),
        "result": result,
    }


def _run_pair(mutation_rate: float) -> dict:
    """One generational-vs-async comparison at a given breeding freshness."""
    budget = POP_SIZE * GENERATIONS  # same completion count for both modes

    # -- generational: barrier per generation --------------------------
    port = _free_port()
    stops = _start_fleet(port)
    try:
        pop = DistributedPopulation(
            HeteroOneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1",
            port=port, job_timeout=120, maximize=True, mutation_rate=mutation_rate)
        try:
            _await_fleet(pop)
            ga = GeneticAlgorithm(pop, seed=GA_SEED)
            gen = _measure(lambda: ga.run(GENERATIONS))
            gen["best_fitness"] = ga.population.get_fittest().get_fitness()
            gen["completions"] = budget
        finally:
            pop.close()
    finally:
        for s in stops:
            s.set()

    # -- asynchronous steady-state: no barrier -------------------------
    port = _free_port()
    stops = _start_fleet(port)
    try:
        pop = DistributedPopulation(
            HeteroOneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1",
            port=port, job_timeout=120, maximize=True, mutation_rate=mutation_rate)
        try:
            _await_fleet(pop)
            eng = AsyncEvolution(pop, tournament_size=3, seed=GA_SEED,
                                 max_in_flight=WORKERS, job_timeout=120)
            as_ = _measure(lambda: eng.run(max_evaluations=budget))
            as_["best_fitness"] = as_.pop("result").get_fitness()
            as_["completions"] = eng.completed
            as_["cached_completions"] = sum(1 for h in eng.history if h.get("cached"))
        finally:
            pop.close()
    finally:
        for s in stops:
            s.set()
    gen.pop("result", None)

    speedup = gen["wall_s"] / as_["wall_s"] if as_["wall_s"] else float("inf")
    return {
        "mutation_rate": mutation_rate,
        "completion_budget": budget,
        "generational": gen,
        "async": as_,
        "wall_speedup_async_over_generational": round(speedup, 3),
        "utilization_gain": round(as_["utilization"] - gen["utilization"], 3),
    }


def run() -> dict:
    spans_mod.enable()
    try:
        saturated = _run_pair(MUTATION_RATE)
        converged = _run_pair(0.015)  # the Population default: converging search
    finally:
        spans_mod.disable()
    return {
        "workload": {
            "population_size": POP_SIZE,
            "generations": GENERATIONS,
            "workers": WORKERS,
            "eval_base_s": BASE_S,
            "eval_straggler_s": STRAGGLER_S,
            "seeds": {"population": POP_SEED, "engine": GA_SEED},
        },
        "saturated_fresh": saturated,
        "converged_tail": converged,
    }


if __name__ == "__main__":
    out = run()
    print(json.dumps(out, indent=2))
    path = out_path("torch_async_study.json")
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
