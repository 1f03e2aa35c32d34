"""Cross-session window packing study: the headline artifact
for DISTRIBUTED.md "Cross-session window packing" and the PERF.md
addendum.

The converged tail of a search emits 1-4-individual generations, and
each one pays the full program-switch + dispatch + RPC floor PERF.md
measures at ~1.9 s per window on real hardware.  A multi-tenant broker
multiplies that regime: K concurrent sessions, each emitting tiny
batches, each paying the floor ALONE.  ``JobBroker(pack_windows=True)``
coalesces compile-compatible jobs from different sessions into one
full mesh-bucket window, so the fleet pays the floor once per window
instead of once per tenant.

This study runs K=3 concurrent converged-tail searches (small
populations, high cache-hit rate in later generations) against ONE
single-worker fleet, twice — ``pack_windows=False`` vs ``True`` — under
a fixed per-window cost model: the species' batched trainer sleeps
``WINDOW_S`` per ``cross_validate_population`` call regardless of batch
size, which is exactly the program-switch floor scaled down so the
study runs in seconds on CPU.  Fitness itself is the deterministic
bit-sum, so every arm is bit-comparable.

Asserted, then recorded in ``scripts/torch_packing_study.json``:

- **speedup**: aggregate wall (all K searches done) is >= 1.5x faster
  packed than unpacked — the unpacked fleet pays ~K windows per
  generation round, the packed fleet ~1;
- **bit-identity**: each tenant's search (both arms) is bit-identical
  to its single-process solo reference — packing changes WHEN jobs
  ride, never what they compute (the purity protocol,
  ``TestBatchCompositionPurity``);
- **wire identity off**: with ``pack_windows=False`` the frame builders
  emit byte-identical legacy frames — no ``"packed"`` marker anywhere
  (the default path is indistinguishable from the pre-packing broker);
- **hot-path gate**: the packer's per-job cost on a live-measured
  dispatch denominator stays within the 2% gate
  (``broker_throughput.run_pack_gate``).

CPU-only, under a minute: ``python scripts/torch_packing_study.py`` writes
``scripts/torch_packing_study.json``.
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
from gentun_tpu_torch.distributed.protocol import (  # noqa: E402
    GenomeFragmentCache,
    build_job_wire,
    encode,
    jobs2_frame,
    jobs_frame,
)

K = 3                      # concurrent tenant searches (at least 3)
GENERATIONS = 10
POP_SIZE = 4               # converged-tail regime: tiny generations
GA_SEED = 7
POP_SEEDS = tuple(21 + i for i in range(K))  # distinct genomes per tenant
MUTATION_RATE = 0.3
WINDOW_S = 0.15            # fixed per-window cost (the scaled-down floor)
LINGER_MS = 25.0
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))
SPEEDUP_FLOOR = 1.5


class WindowCostModel:
    """Fixed per-window cost: every batched evaluation call sleeps
    ``WINDOW_S`` no matter how many genomes ride in it — the
    program-switch + dispatch floor a real mesh window pays once.  The
    call counter makes the amortization directly visible: unpacked, K
    tenants pay ~K windows per generation round; packed, ~1."""

    windows = 0
    _lock = threading.Lock()

    @staticmethod
    def cross_validate_population(x_train, y_train, genomes, **params):
        with WindowCostModel._lock:
            WindowCostModel.windows += 1
        time.sleep(WINDOW_S)
        return [float(sum(sum(g) for g in genome.values()))
                for genome in genomes]


class TailOneMax(Individual):
    """Bit-sum fitness under the window-cost model — deterministic, so
    solo / unpacked / packed runs are comparable bit-for-bit."""

    model_cls = WindowCostModel

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


def _snapshot(ga) -> dict:
    return {
        "best_fitness_history": [r["best_fitness"] for r in ga.history],
        "final_population": [
            {"genes": {k: list(v) for k, v in ind.get_genes().items()},
             "fitness": ind.get_fitness()}
            for ind in ga.population
        ],
        "n_architectures_evaluated": len(ga.population.fitness_cache),
    }


def run_solo_references() -> dict:
    """Single-process reference per tenant seed: the bit-identity
    ground truth both fleet arms must reproduce exactly."""
    out = {}
    for i, seed in enumerate(POP_SEEDS):
        t0 = time.monotonic()
        ga = GeneticAlgorithm(
            Population(TailOneMax, *DATA, size=POP_SIZE, seed=seed,
                       mutation_rate=MUTATION_RATE), seed=GA_SEED)
        ga.run(GENERATIONS)
        out[f"tenant{i}"] = {"snapshot": _snapshot(ga),
                             "wall_s": round(time.monotonic() - t0, 3)}
    return out


def run_fleet_arm(pack: bool) -> dict:
    """K concurrent tenant searches against one single-worker fleet.

    One worker whose capacity spans all K tenants' generations, so a
    packed window can carry every tenant's batch in one frame; the
    unpacked broker ships each tenant's submit the moment it arrives —
    one window per tenant per round, the floor paid K times."""
    broker = JobBroker(port=0, pack_windows=pack,
                       pack_linger_ms=LINGER_MS).start()
    port = broker.address[1]
    stop = threading.Event()
    worker = GentunClient(
        TailOneMax, *DATA, host="127.0.0.1", port=port,
        worker_id=f"study-{'pack' if pack else 'plain'}-w0",
        capacity=K * POP_SIZE,
        heartbeat_interval=0.5, reconnect_delay=0.1)
    wt = threading.Thread(target=lambda: worker.work(stop_event=stop),
                          daemon=True)
    wt.start()

    snaps: dict = {}
    errs: dict = {}

    def _tenant(tag: str, seed: int) -> None:
        try:
            pop = DistributedPopulation(
                TailOneMax, size=POP_SIZE, seed=seed,
                mutation_rate=MUTATION_RATE, host="127.0.0.1", port=port,
                broker=broker, session=tag, job_timeout=120)
            try:
                ga = GeneticAlgorithm(pop, seed=GA_SEED)
                ga.run(GENERATIONS)
                snaps[tag] = _snapshot(ga)
            finally:
                pop.close()
        except Exception as e:  # noqa: BLE001 — surfaced in the assert
            errs[tag] = repr(e)

    windows_before = WindowCostModel.windows
    t0 = time.monotonic()
    try:
        threads = [
            threading.Thread(target=_tenant, args=(f"tenant{i}", seed),
                             daemon=True)
            for i, seed in enumerate(POP_SEEDS)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.monotonic() - t0
        windows = WindowCostModel.windows - windows_before
        pack_snapshot = broker.pack_stats()
        leaked = broker.outstanding()
        books = broker.session_stats()
    finally:
        stop.set()
        broker.stop()
        wt.join(timeout=10.0)

    assert not errs, f"tenant search(es) died ({'packed' if pack else 'unpacked'}): {errs}"
    assert len(snaps) == K, f"missing tenant snapshots: {sorted(snaps)}"
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"
    for tag in snaps:
        book = books[tag]
        assert book["completed"] == book["submitted"] and book["failed"] == 0, book

    out = {
        "pack_windows": pack,
        "aggregate_wall_s": round(wall, 3),
        "device_windows": windows,
        "snapshots": snaps,
        "jobs_completed": {tag: books[tag]["completed"] for tag in sorted(snaps)},
        "broker_state_after_final_gather": leaked,
    }
    if pack:
        assert pack_snapshot is not None
        assert pack_snapshot["cross_session_windows"] >= 1, (
            f"tenants never shared a window: {pack_snapshot}")
        out["packing"] = pack_snapshot
    else:
        assert pack_snapshot is None, "pack plane active with packing off"
    return out


def check_wire_identity_off() -> dict:
    """With ``pack_windows=False`` the broker's frame builders must emit
    byte-identical legacy frames — the packed marker exists ONLY when
    packing is on.  Checked at the protocol layer: the same entries
    through ``jobs_frame``/``jobs2_frame`` with ``packed=False`` must
    equal the plain-``encode`` layout and carry no ``"packed"`` key."""
    cache = GenomeFragmentCache()
    payloads = {
        f"wire-{i}": {
            "genes": {"S_1": [i % 2] * 6, "S_2": [(i + 1) % 2] * 6},
            "additional_parameters": {"nodes": (4, 4)},
        }
        for i in range(4)
    }
    wires = [build_job_wire(j, p, f"gk{i}", cache)
             for i, (j, p) in enumerate(payloads.items())]

    v1 = jobs_frame([jw.v1 for jw in wires])
    legacy = encode({"type": "jobs", "jobs": [
        {"job_id": j, **p} for j, p in payloads.items()]})
    v1_identical = v1 == legacy and b'"packed"' not in v1

    v2 = jobs2_frame(wires[0].env, [jw.entry2 for jw in wires])
    v2_clean = b'"packed"' not in v2

    assert v1_identical, "v1 frames diverged from the legacy byte layout"
    assert v2_clean, "jobs2 frames carry a packed marker with packing off"
    return {
        "v1_frame_byte_identical": v1_identical,
        "jobs2_frame_has_no_packed_marker": v2_clean,
        "v1_frame_bytes": len(v1),
    }


def run_gate() -> dict:
    """The satellite gate, embedded: packer cost per job against a
    live-measured dispatch denominator (same instrument as
    ``torch_broker_throughput.py`` main)."""
    from scripts.broker_throughput import _measure_broker_rate, run_pack_gate

    broker = JobBroker(port=0).start()
    try:
        rate = _measure_broker_rate(broker, n_jobs=1500, n_workers=2,
                                    capacity=16)
    finally:
        broker.stop()
    gate = run_pack_gate(round(1e6 / rate, 1))
    assert gate["within_gate"], (
        f"window-packer overhead {gate['overhead_pct']}% exceeds the "
        f"{gate['gate_max_pct']}% gate")
    return gate


def main() -> dict:
    solo = run_solo_references()
    unpacked = run_fleet_arm(pack=False)
    packed = run_fleet_arm(pack=True)

    speedup = round(
        unpacked["aggregate_wall_s"] / packed["aggregate_wall_s"], 3)
    assert speedup >= SPEEDUP_FLOOR, (
        f"packed speedup {speedup}x under the {SPEEDUP_FLOOR}x floor "
        f"({unpacked['aggregate_wall_s']}s unpacked vs "
        f"{packed['aggregate_wall_s']}s packed)")

    identity = {}
    for tag in sorted(solo):
        ref = solo[tag]["snapshot"]
        identity[tag] = {
            "unpacked_vs_solo": unpacked["snapshots"][tag] == ref,
            "packed_vs_solo": packed["snapshots"][tag] == ref,
        }
    assert all(v for t in identity.values() for v in t.values()), (
        f"a fleet arm diverged from its solo reference: {identity}")

    wire = check_wire_identity_off()
    gate = run_gate()

    out = {
        "config": {
            "tenants": K,
            "generations": GENERATIONS,
            "population_size": POP_SIZE,
            "seeds": {"ga": GA_SEED, "population": list(POP_SEEDS)},
            "mutation_rate": MUTATION_RATE,
            "window_cost_s": WINDOW_S,
            "pack_linger_ms": LINGER_MS,
            "worker_capacity": K * POP_SIZE,
        },
        "headline": {
            "unpacked_aggregate_wall_s": unpacked["aggregate_wall_s"],
            "packed_aggregate_wall_s": packed["aggregate_wall_s"],
            "speedup": speedup,
            "speedup_floor": SPEEDUP_FLOOR,
            "unpacked_device_windows": unpacked["device_windows"],
            "packed_device_windows": packed["device_windows"],
            "cross_session_windows": packed["packing"]["cross_session_windows"],
            "pack_fill_ratio": packed["packing"]["fill_ratio"],
            "pack_linger_s": packed["packing"]["linger_s"],
        },
        "bit_identity": identity,
        "solo_references": {
            tag: {"wall_s": solo[tag]["wall_s"],
                  "best_fitness_history":
                      solo[tag]["snapshot"]["best_fitness_history"]}
            for tag in sorted(solo)
        },
        "unpacked": {k: v for k, v in unpacked.items() if k != "snapshots"},
        "packed": {k: v for k, v in packed.items() if k != "snapshots"},
        "wire_identity_off": wire,
        "pack_gate": gate,
    }
    return out


if __name__ == "__main__":
    result = main()
    print(json.dumps(result, indent=2))
    path = out_path("torch_packing_study.json")
    stamp(result)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
