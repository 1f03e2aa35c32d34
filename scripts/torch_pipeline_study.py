"""Measured artifact for the pipelined dispatch plane: what double
buffering on the worker + over-subscription on the broker buy.

Workload: the torch_async_study.py fleet — 2 workers (capacity 1 each)
evaluating a deterministic OneMax with genes-deterministic heterogeneous
training time — driven by the steady-state engine (``AsyncEvolution``)
for a FIXED completion budget.  Two configurations, identical except for
the prefetch knob:

- ``no_prefetch`` (``prefetch_depth=0``): the pre-pipelining serial loop.
  After every evaluation the worker sends ``ready`` and then IDLES for a
  full control-plane round trip (result upload + broker dispatch + frame
  decode) before the next genome starts training.
- ``pipelined`` (default ``prefetch_depth=capacity``): the broker keeps
  each worker's next window queued on the worker while the current one
  trains, so the round trip overlaps evaluation and the device-side gap
  between batches collapses to a queue pop.

Utilization is sampled from the ``jobs_in_flight`` gauge at 5 ms.  Under
over-subscription the raw gauge counts dispatched-unacked jobs and so
EXCEEDS fleet capacity (that is the point) — for an honest "fraction of
the fleet busy" number each sample is clamped at fleet capacity before
averaging (``min(sample, fleet_cap) / fleet_cap``); the raw mean is also
reported.  The headline ``utilization`` is measured over the SATURATED
window — samples up to the last instant the fleet was full — because the
final drain (the engine stops breeding once the completion budget is in
flight, so in-flight necessarily falls 4→0) measures the budget's edge,
not the dispatch plane; ``utilization_full_run`` keeps the uncut number.
Worker-side idle gaps come from the ``worker_idle_s`` histogram
percentiles (docs/OBSERVABILITY.md).

CPU-only, <1 minute: ``python scripts/torch_pipeline_study.py`` writes
``scripts/torch_pipeline_study.json``.
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
from gentun_tpu_torch import AsyncEvolution, Individual, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient  # noqa: E402
from gentun_tpu_torch.telemetry import spans as spans_mod  # noqa: E402
from gentun_tpu_torch.telemetry.registry import get_registry  # noqa: E402

POP_SIZE = 8
WORKERS = 2
POP_SEED, ENGINE_SEED = 42, 7
BASE_S, STRAGGLER_S = 0.04, 0.5
#: Same completion budget as torch_async_study.py's engine comparison, so the
#: ``pipelined`` utilization here reads directly against that study's
#: async 0.83 baseline.
BUDGET = 48
MUTATION_RATE = 0.15
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))


class HeteroOneMax(Individual):
    """Bit-count fitness with a genes-deterministic training delay:
    every 4th genome (by bit sum) is a straggler."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        bits = int(sum(sum(g) for g in self.genes.values()))
        time.sleep(STRAGGLER_S if bits % 4 == 0 else BASE_S)
        return float(bits)


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _start_fleet(port, prefetch_depth):
    stops = []
    for i in range(WORKERS):
        stop = threading.Event()
        client = GentunClient(
            HeteroOneMax, *DATA, host="127.0.0.1", port=port,
            capacity=1, prefetch_depth=prefetch_depth,
            worker_id=f"pipe-study-w{i}",
            heartbeat_interval=0.2, reconnect_delay=0.05,
        )
        threading.Thread(
            target=lambda c=client, s=stop: c.work(stop_event=s), daemon=True,
        ).start()
        stops.append(stop)
    return stops


def _await_fleet(pop, timeout=10.0):
    deadline = time.monotonic() + timeout
    while pop.fleet_capacity() < WORKERS:
        if time.monotonic() > deadline:
            raise TimeoutError(f"fleet never reached capacity {WORKERS}")
        time.sleep(0.02)


def _run_config(prefetch_depth) -> dict:
    """One async-engine run at a fixed budget; returns measured stats.

    ``prefetch_depth=None`` is the library default (= capacity);
    ``0`` pins the serial pre-pipelining loop.
    """
    port = _free_port()
    stops = _start_fleet(port, prefetch_depth)
    try:
        pop = DistributedPopulation(
            HeteroOneMax, size=POP_SIZE, seed=POP_SEED, host="127.0.0.1",
            port=port, job_timeout=120, maximize=True,
            mutation_rate=MUTATION_RATE)
        try:
            _await_fleet(pop)
            fleet_cap = pop.fleet_capacity()
            get_registry().reset()
            samples, done = [], threading.Event()
            gauge = get_registry().gauge("jobs_in_flight")

            def _sample():
                while not done.is_set():
                    samples.append(gauge.value)
                    time.sleep(0.005)

            sampler = threading.Thread(target=_sample, daemon=True)
            sampler.start()
            # max_in_flight defaults to fleet_capacity + fleet_prefetch:
            # the engine breeds ahead into the over-subscription window.
            eng = AsyncEvolution(pop, tournament_size=3, seed=ENGINE_SEED,
                                 job_timeout=120)
            t0 = time.monotonic()
            try:
                best = eng.run(max_evaluations=BUDGET)
            finally:
                done.set()
                sampler.join(timeout=1)
            wall = time.monotonic() - t0
            idle = get_registry().histogram("worker_idle_s")
            raw_mean = float(np.mean(samples)) if samples else 0.0
            clamped = [min(s, fleet_cap) / fleet_cap for s in samples]
            # Saturated window: first full-fleet sample → last full-fleet
            # sample.  Before it the engine is still resolving the fleet
            # (default_capacity watches the cap stabilize for 0.75 s before
            # the first dispatch); after it the run is purely draining the
            # final budgeted jobs.  Both edges measure the engine's startup
            # and the budget, not the dispatch plane.
            full = [i for i, s in enumerate(samples) if s >= fleet_cap]
            saturated = clamped[full[0]: full[-1] + 1] if full else clamped
            return {
                "prefetch_depth": "default (= capacity)" if prefetch_depth is None
                                  else prefetch_depth,
                "fleet_capacity": fleet_cap,
                "engine_max_in_flight": eng._cap,
                "wall_s": round(wall, 3),
                "completions": eng.completed,
                "best_fitness": best.get_fitness(),
                "mean_jobs_in_flight_raw": round(raw_mean, 3),
                "peak_jobs_in_flight": int(max(samples)) if samples else 0,
                # fraction of fleet busy; samples clamped at capacity so
                # over-subscription can't report >1.0
                "utilization": round(float(np.mean(saturated)) if saturated else 0.0, 3),
                "utilization_full_run": round(float(np.mean(clamped)) if clamped else 0.0, 3),
                "worker_idle_s": {
                    "count": idle.count,
                    "p50": round(idle.quantile(0.50), 6),
                    "p90": round(idle.quantile(0.90), 6),
                    "p99": round(idle.quantile(0.99), 6),
                },
            }
        finally:
            pop.close()
    finally:
        for s in stops:
            s.set()


def run() -> dict:
    spans_mod.enable()
    try:
        baseline = _run_config(0)
        pipelined = _run_config(None)
    finally:
        spans_mod.disable()
    return {
        "workload": {
            "population_size": POP_SIZE,
            "completion_budget": BUDGET,
            "workers": WORKERS,
            "worker_capacity": 1,
            "eval_base_s": BASE_S,
            "eval_straggler_s": STRAGGLER_S,
            "mutation_rate": MUTATION_RATE,
            "seeds": {"population": POP_SEED, "engine": ENGINE_SEED},
        },
        "no_prefetch": baseline,
        "pipelined": pipelined,
        "utilization_gain": round(
            pipelined["utilization"] - baseline["utilization"], 3),
        "idle_p50_reduction_s": round(
            baseline["worker_idle_s"]["p50"] - pipelined["worker_idle_s"]["p50"], 6),
    }


if __name__ == "__main__":
    out = run()
    print(json.dumps(out, indent=2))
    path = out_path("torch_pipeline_study.json")
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
