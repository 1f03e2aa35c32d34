"""Measured artifact for the search-forensics plane: a 2-worker
fidelity-ladder search run with the lineage ledger and chip-hour cost
accounting ON, post-processed into a Perfetto trace and a winner-ancestry
report — plus the two gates that make forensics safe to leave in the
tree.

Part A — the forensic run.  A seeded ``AsyncEvolution`` ladder search
(2 rungs, eta=3) runs against a broker + two in-process workers under a
named session, with ``RunTelemetry`` + ``lineage.enable()``.  From the
one ``telemetry.jsonl`` it writes, the study checks:

- **trace export**: the Chrome ``trace_event`` conversion
  (``telemetry/traceviz.py``) contains process tracks for the master,
  the broker, and BOTH workers, and cross-process flow arrows stitching
  dispatch→evaluate→result;
- **lineage ledger**: ``born``/``dispatched``/``completed`` (and ladder
  ``promoted``) events land in the artifact, and
  ``scripts/torch_gentun_trace.py``'s report reconstructs the winner's
  ancestry from them;
- **cost attribution**: ≥99% of the span-measured evaluation seconds are
  attributed to ``(session, genome, rung, worker)`` cells — per-worker
  and per-rung chip-second tables come from measurement, not estimates.

Part B — the safety gates:

- **bit-identity**: the same seeded ladder search, run locally with
  forensics ON and OFF, produces identical best genes/fitness/history —
  the plane observes the search, it never steers it;
- **wire hygiene**: with forensics off the propagated trace context is
  returned unchanged (no ``fz`` stamp — byte-identical frames).

CPU-only, <1 minute: ``python scripts/torch_forensics_study.py`` writes
``scripts/torch_forensics_study.json``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import AsyncEvolution, Individual, Population, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient  # noqa: E402
from gentun_tpu_torch.telemetry import RunTelemetry, lineage, traceviz  # noqa: E402
from gentun_tpu_torch.telemetry import spans as spans_mod  # noqa: E402
from gentun_tpu_torch.telemetry.registry import get_registry  # noqa: E402

import torch_gentun_trace as gentun_trace  # noqa: E402  (sibling script: the forensics CLI)

NODES = (3, 3)
POP_SIZE = 5
WORKERS = 2
BUDGET = 30
SESSION = "forensics"
LADDER = [{"kfold": 2, "epochs": (1,)}, {"kfold": 3, "epochs": (2,)}]
EVAL_S = 0.002  # fixed per-evaluation service time → measurable device spans
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))


class OneMax(Individual):
    """Deterministic fitness with a fixed service time, so chip-second
    attribution has real walls to split and bit-identity is checkable."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", NODES)))

    def evaluate(self):
        time.sleep(EVAL_S)
        return float(sum(sum(g) for g in self.genes.values()))


def forensic_fleet_run(path: str) -> dict:
    """Part A: the instrumented 2-worker ladder search."""
    lineage.reset_ledger()
    get_registry().reset()
    lineage.enable()
    stops = []
    try:
        with RunTelemetry(path, label="forensics-study"):
            with DistributedPopulation(
                    OneMax, size=POP_SIZE, seed=3, port=0, maximize=True,
                    job_timeout=60, session=SESSION) as pop:
                _, port = pop.broker_address
                for i in range(WORKERS):
                    stop = threading.Event()
                    client = GentunClient(
                        OneMax, *DATA, host="127.0.0.1", port=port,
                        capacity=1, worker_id=f"fz-w{i}",
                        heartbeat_interval=0.2, reconnect_delay=0.05)
                    threading.Thread(
                        target=lambda c=client, s=stop: c.work(stop_event=s),
                        daemon=True).start()
                    stops.append(stop)
                deadline = time.monotonic() + 10
                while pop.broker.fleet_members() < WORKERS:
                    if time.monotonic() > deadline:
                        raise RuntimeError("workers never joined")
                    time.sleep(0.01)
                eng = AsyncEvolution(pop, tournament_size=3, seed=5,
                                     fidelity_ladder=LADDER, eta=3,
                                     job_timeout=60)
                best = eng.run(max_evaluations=BUDGET)
        ledger = lineage.get_ledger().snapshot()
    finally:
        for s in stops:
            s.set()
        lineage.disable()
    return {"best_fitness": best.get_fitness(), "ledger": ledger,
            "completed": eng.completed}


def analyze(path: str, run: dict) -> dict:
    records = traceviz.load_jsonl(path)
    trace = traceviz.to_trace_events(records)
    processes = sorted(
        e["args"]["name"] for e in trace["traceEvents"]
        if e["ph"] == "M" and e["name"] == "process_name")
    flows = [e for e in trace["traceEvents"] if e["ph"] in ("s", "t", "f")]
    report = gentun_trace.build_report(records)
    events = report["events_by_type"]
    att = report["cost"]["attribution"]
    return {
        "n_records": len(records),
        "lineage_events": events,
        "trace": {
            "n_events": len(trace["traceEvents"]),
            "processes": processes,
            "n_flow_events": len(flows),
        },
        "winner": report["winner"],
        "ancestry_root_origin": report["ancestry"]["origin"],
        "critical_path": report["critical_path"],
        "attribution": att,
        "cost_by_rung": report["cost"]["by_rung"],
        "cost_by_worker": report["cost"]["by_worker"],
        "cost_by_session": report["cost"]["by_session"],
    }


def local_ladder(forensics: bool) -> dict:
    """Part B: one seeded local ladder search, forensics on or off."""
    lineage.reset_ledger()
    if forensics:
        spans_mod.enable()
        lineage.enable()
    try:
        pop = Population(OneMax, DATA, size=4, seed=11, maximize=True)
        eng = AsyncEvolution(pop, tournament_size=3, max_in_flight=1, seed=7,
                             fidelity_ladder=LADDER, eta=3)
        best = eng.run(max_evaluations=20)
        return {"best_genes": best.get_genes(),
                "best_fitness": best.get_fitness(),
                "history": eng.history}
    finally:
        if forensics:
            lineage.disable()
            spans_mod.disable()


def main(argv=None) -> int:
    out_dir = tempfile.mkdtemp(prefix="forensics_study_")
    jsonl = os.path.join(out_dir, "telemetry.jsonl")

    run = forensic_fleet_run(jsonl)
    analysis = analyze(jsonl, run)
    trace_path = os.path.join(out_dir, "trace.json")
    traceviz.convert(jsonl, trace_path)

    on = local_ladder(forensics=True)
    off = local_ladder(forensics=False)
    bit_identical = (on["best_genes"] == off["best_genes"]
                     and on["best_fitness"] == off["best_fitness"]
                     and on["history"] == off["history"])

    ctx = {"trace_id": "t", "span_id": "s"}
    wire_clean_when_off = lineage.forensic_context(ctx) is ctx

    expected = {"master", "broker"} | {f"fz-w{i}" for i in range(WORKERS)}
    gates = {
        "trace_has_master_broker_both_workers":
            expected <= set(analysis["trace"]["processes"]),
        "trace_has_cross_process_flows": analysis["trace"]["n_flow_events"] > 0,
        "ledger_has_core_taxonomy": all(
            analysis["lineage_events"].get(e, 0) > 0
            for e in ("born", "dispatched", "completed", "promoted")),
        "winner_ancestry_reconstructed": analysis["winner"] is not None,
        "attribution_ge_99pct": (analysis["attribution"]["ratio"] or 0) >= 0.99,
        "every_worker_attributed": set(analysis["cost_by_worker"]) ==
            {f"fz-w{i}" for i in range(WORKERS)},
        "session_attributed": set(analysis["cost_by_session"]) == {SESSION},
        "forensics_off_bit_identical": bit_identical,
        "wire_clean_when_off": wire_clean_when_off,
    }

    artifact = {
        "config": {"nodes": NODES, "pop_size": POP_SIZE, "workers": WORKERS,
                   "budget": BUDGET, "session": SESSION, "ladder": LADDER,
                   "eta": 3, "eval_s": EVAL_S},
        "run": {"best_fitness": run["best_fitness"],
                "completed": run["completed"],
                "ledger": run["ledger"]},
        "analysis": analysis,
        "bit_identity": {"on_fitness": on["best_fitness"],
                         "off_fitness": off["best_fitness"],
                         "identical": bit_identical},
        "gates": gates,
        "all_gates_pass": all(gates.values()),
    }
    out = out_path("torch_forensics_study.json", argv)
    stamp(artifact)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(artifact, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    print(json.dumps({"gates": gates, "all_gates_pass": artifact["all_gates_pass"],
                      "attribution": analysis["attribution"],
                      "processes": analysis["trace"]["processes"]}, indent=2))
    print(f"wrote {out}")
    return 0 if artifact["all_gates_pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
