"""Measured artifact for the surrogate rung −1: best fitness per
chip-hour, ledger-trained gate vs the bare ASHA ladder.

Accounting and machinery are ``torch_fidelity_study.py``'s, imported rather
than copied: curves are built from the lineage ledger's ``completed``
events with analytic ``kfold × Σepochs`` rung costs — chip-time is
cost-ledger accounted, never wall-clock.

The HEADLINE comparison runs a harder space than the fidelity study's
12-bit demo: 42 genome bits (``nodes=(7, 7)``), population 16, and a
flatter ladder (2/4/8 chip-seconds per rung).  Both choices are load-
bearing, measured not asserted: in a 12-bit space the population
saturates the cache so rung-0 dispatches are nearly free and there is
nothing for an admission gate to save, and under a 2/6/40 ladder the
fixed cost of the top rung dominates every curve — both arms pay the
same promotion toll regardless of how well rung 0 is chosen.  On the
harder space the bare ladder spends most of its chip-time evaluating
doomed children at rung 0; the gate's ridge model (trained online from
the same ``completed`` stream the ledger records) rejects them on the
host for microseconds each, so the gated arm reaches the baseline's
best fitness in a fraction of the chip-time — ≥2× is the acceptance
gate, on top of the ladder's own ≥5× over full-fidelity evolution.

Four more gates ride along: the surrogate-OFF run must reproduce the
committed ``torch_fidelity_study.json`` ladder curve byte-for-byte
(the one-bool-read contract, checked across PRs), precision@k must land
in the telemetry artifact, same-seed gated runs must be bit-identical,
and a master kill at a boundary whose schema-v4 checkpoint provably
carries PENDING gate decisions must resume bit-identically.

CPU-only, a few minutes: ``python scripts/torch_surrogate_study.py`` writes
``scripts/torch_surrogate_study.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_fidelity_study as fs  # noqa: E402  (the fidelity baseline, reused)

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import AsyncEvolution, Population  # noqa: E402
from gentun_tpu_torch.distributed import FaultInjector, FaultPlan, FaultSpec  # noqa: E402
from gentun_tpu_torch.distributed.faults import MasterKilled  # noqa: E402
from gentun_tpu_torch.surrogate import FitnessSurrogate, SurrogateGate  # noqa: E402
from gentun_tpu_torch.telemetry import RunTelemetry, lineage, traceviz  # noqa: E402
from gentun_tpu_torch.utils import Checkpointer  # noqa: E402

#: Headline workload: 42 bits, big enough that the search is breeding-
#: bound rather than cache-bound, with a flat ladder whose top rung is
#: only 4× rung 0 so the promotion toll doesn't drown the rung-0 spend
#: the gate exists to save.
NODES = (7, 7)
POP_SIZE = 16
BUDGET = 1000
LADDER = [
    {"kfold": 1, "epochs": (2,)},
    {"kfold": 2, "epochs": (2,)},
    {"kfold": 2, "epochs": (4,)},
]
TOP = LADDER[-1]
TOP_COST = fs._cost(TOP)

#: Gate hyperparameters.  A SHORT window (12) is deliberate: on an
#: improving score stream a long window's quantile trails the
#: population, admitting nearly everything; a short one keeps the cut
#: competitive with the current breeding front.
GATE_KW = dict(min_train=8, refit_every=8)
GATE_ETA, WINDOW, MIN_WINDOW = 8, 12, 8


class HeadlineOneMax(fs.FidelityOneMax):
    """FidelityOneMax re-referenced to THIS study's ladder top, so the
    full-fidelity rung measures exactly (proxy noise shrinks to zero at
    ``TOP``, not at the fidelity study's 40-chip-second schedule)."""

    def evaluate(self):
        true = float(sum(sum(g) for g in self.genes.values()))
        knobs = {"kfold": self.additional_parameters.get("kfold", TOP["kfold"]),
                 "epochs": tuple(self.additional_parameters.get(
                     "epochs", TOP["epochs"]))}
        gap = 1.0 - fs._cost(knobs) / TOP_COST
        if gap <= 0:
            return true
        h = hashlib.blake2b(
            repr((sorted((k, tuple(v)) for k, v in self.genes.items()),
                  knobs)).encode(),
            digest_size=4).digest()
        noise = (int.from_bytes(h, "little") / 0xFFFFFFFF - 0.5) \
            * 2 * fs.NOISE_SCALE * gap
        return true + noise


def _gate() -> SurrogateGate:
    return SurrogateGate(FitnessSurrogate(**GATE_KW), eta=GATE_ETA,
                         window=WINDOW, min_window=MIN_WINDOW)


def _run(surrogate=None, checkpointer=None, injector=None, budget=BUDGET):
    pop = Population(HeadlineOneMax, fs.DATA, size=POP_SIZE, seed=fs.POP_SEED,
                     maximize=True, additional_parameters={"nodes": NODES})
    eng = AsyncEvolution(pop, tournament_size=3, max_in_flight=1,
                         seed=fs.ENGINE_SEED, checkpoint_every=2,
                         fidelity_ladder=LADDER, eta=fs.ETA,
                         surrogate=surrogate)
    if injector is not None:
        eng.set_fault_injector(injector)
    best = eng.run(max_evaluations=budget, checkpointer=checkpointer)
    return eng, best


def _forensic(surrogate=None):
    """One curve run under the forensics plane (fidelity_study pattern):
    lineage ``completed`` events feed the chip-second curve, and the run
    summary carries the metrics snapshot the precision@k gate reads."""
    import tempfile

    lineage.reset_ledger()
    lineage.enable()
    try:
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "telemetry.jsonl")
            with RunTelemetry(path, label="surrogate-study") as run:
                eng, best = _run(surrogate=surrogate)
            summary = run.summary()
            completed = [r for r in traceviz.load_jsonl(path)
                         if r.get("type") == "lineage"
                         and r.get("event") == "completed"]
    finally:
        lineage.disable()
    return eng, best, completed, summary


def _gauge(summary, name):
    for g in summary.get("gauges", []):
        if g["name"] == name:
            return g["value"]
    return None


def _off_run_identity() -> bool:
    """The off-path contract: the fidelity study's exact ladder run with
    ``surrogate=None`` must reproduce the ladder curve committed in
    ``torch_fidelity_study.json`` byte-for-byte."""
    import tempfile

    lineage.reset_ledger()
    lineage.enable()
    try:
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "telemetry.jsonl")
            with RunTelemetry(path, label="surrogate-off"):
                fs._run(ladder=fs.LADDER)
            completed = [r for r in traceviz.load_jsonl(path)
                         if r.get("type") == "lineage"
                         and r.get("event") == "completed"]
    finally:
        lineage.disable()
    curve = fs._lineage_curve(completed, fs.LADDER)
    ref_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "torch_fidelity_study.json")
    with open(ref_path, encoding="utf-8") as fh:
        ref_curve = json.load(fh)["ladder"]["curve"]
    return curve == [list(p) for p in ref_curve]


def main(argv=None) -> int:
    # -- off-path bit-identity vs the committed fidelity artifact -------
    off_identical = _off_run_identity()

    # -- baseline: the fidelity ladder, surrogate off -------------------
    base_eng, base_best, base_done, base_summary = _forensic(surrogate=None)
    base_curve = fs._lineage_curve(base_done, LADDER)

    # -- gated: the same ladder behind surrogate rung −1 ----------------
    gate = _gate()
    gated_eng, gated_best, gated_done, gated_summary = _forensic(surrogate=gate)
    gated_curve = fs._lineage_curve(gated_done, LADDER)

    target = max(b for _, b in base_curve if b is not None)
    t_base = fs._time_to(base_curve, target)
    t_gated = fs._time_to(gated_curve, target)
    improvement = (t_base / t_gated) if t_gated else None

    precision_gauge = _gauge(gated_summary, "surrogate_precision_at_k")

    # -- seeded determinism of the gated trajectory ---------------------
    gate2 = _gate()
    gated_eng2, _ = _run(surrogate=gate2)
    deterministic = (
        fs._history_sig(gated_eng) == fs._history_sig(gated_eng2)
        and (gate.admitted, gate.rejected, gate.surrogate.refits)
        == (gate2.admitted, gate2.rejected, gate2.surrogate.refits)
        and gated_best.get_genes() == gated_eng2.best.get_genes()
    )

    # -- bit-identical kill/resume with PENDING gate decisions (v4) -----
    import tempfile

    resume_identical = pending_at_kill = False
    kill_at = None
    with tempfile.TemporaryDirectory() as td:
        for at in range(2, 24):
            path = os.path.join(td, f"ck-{at}.json")
            inj = FaultInjector(FaultPlan([
                FaultSpec(hook="master_boundary", kind="kill_master", at=at)]))
            try:
                _run(surrogate=_gate(), checkpointer=Checkpointer(path),
                     injector=inj)
            except MasterKilled:
                pass
            state = json.load(open(path))
            sur = state.get("surrogate") or {}
            if sur.get("pending"):
                pending_at_kill, kill_at = True, at
                assert state["schema_version"] == 4, state["schema_version"]
                resumed, _ = _run(surrogate=_gate(),
                                  checkpointer=Checkpointer(path))
                resume_identical = (
                    fs._history_sig(resumed) == fs._history_sig(gated_eng))
                break

    out = {
        "config": {
            "nodes": list(NODES), "pop_size": POP_SIZE, "budget": BUDGET,
            "eta": fs.ETA, "noise_scale": fs.NOISE_SCALE,
            "ladder": [{**r, "epochs": list(r["epochs"]),
                        "chip_seconds": fs._cost(r)} for r in LADDER],
            "gate": {**GATE_KW, "eta": GATE_ETA, "window": WINDOW,
                     "min_window": MIN_WINDOW,
                     "precision_k": SurrogateGate.PRECISION_K},
        },
        "baseline": {
            "best_fitness": target,
            "chip_seconds_total": base_curve[-1][0],
            "chip_seconds_to_best": t_base,
            "measured_device_s_by_rung":
                base_summary.get("cost", {}).get("cost_s_by_rung"),
            "curve": base_curve,
        },
        "gated": {
            "best_fitness": max((b for _, b in gated_curve if b is not None),
                                default=None),
            "chip_seconds_total": gated_curve[-1][0],
            "chip_seconds_to_baseline_best": t_gated,
            "admitted": gate.admitted,
            "rejected": gate.rejected,
            "refits": gate.surrogate.refits,
            "precision_at_k": gate.precision_at_k,
            "precision_at_k_telemetry_gauge": precision_gauge,
            "measured_device_s_by_rung":
                gated_summary.get("cost", {}).get("cost_s_by_rung"),
            "curve": gated_curve,
        },
        "gates": {
            "off_run_bit_identical_to_pr11_artifact": bool(off_identical),
            "reached_baseline_best": t_gated is not None,
            "chip_time_improvement": improvement,
            "improvement_at_least_2x": bool(improvement and improvement >= 2.0),
            "precision_at_k_in_telemetry": precision_gauge is not None,
            "seeded_determinism": bool(deterministic),
            "pending_decisions_in_checkpoint_at_kill": bool(pending_at_kill),
            "kill_boundary": kill_at,
            "kill_resume_bit_identical": bool(resume_identical),
        },
    }
    path = out_path("torch_surrogate_study.json", argv)
    stamp(out)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
        fh.write("\n")
    g = out["gates"]
    print(f"baseline: best {target} in {t_base} chip-s "
          f"(total {out['baseline']['chip_seconds_total']})")
    print(f"gated:    best {out['gated']['best_fitness']} — baseline best in "
          f"{t_gated} chip-s (total {out['gated']['chip_seconds_total']}, "
          f"admitted {gate.admitted}, rejected {gate.rejected}, "
          f"refits {gate.surrogate.refits}, "
          f"precision@{SurrogateGate.PRECISION_K} {gate.precision_at_k})")
    imp = g["chip_time_improvement"]
    print(f"gates:    improvement {imp if imp is None else f'{imp:.2f}x'} "
          f"(>=2: {g['improvement_at_least_2x']}), off-run identical "
          f"{g['off_run_bit_identical_to_pr11_artifact']}, deterministic "
          f"{g['seeded_determinism']}, pending-at-kill "
          f"{g['pending_decisions_in_checkpoint_at_kill']} (boundary "
          f"{g['kill_boundary']}), resume identical "
          f"{g['kill_resume_bit_identical']}")
    print(f"wrote {path}")
    ok = all([g["off_run_bit_identical_to_pr11_artifact"],
              g["reached_baseline_best"], g["improvement_at_least_2x"],
              g["precision_at_k_in_telemetry"], g["seeded_determinism"],
              g["pending_decisions_in_checkpoint_at_kill"],
              g["kill_resume_bit_identical"]])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
