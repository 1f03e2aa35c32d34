"""Measured artifact for the multi-fidelity ladder: best fitness per
chip-hour, ASHA promotion ladder vs pure full-schedule evolution.

Workload: a deterministic OneMax over the Genetic-CNN genome space whose
evaluation COST follows the real fidelity knobs — ``kfold × Σepochs``
chip-seconds per measurement — and whose proxy-rung measurements are
deterministically biased (a content-hashed perturbation that shrinks as
fidelity rises), the shape real proxy schedules have: cheap, correlated
with the full schedule, not equal to it.  Rung costs are the actual knob
products, so the chip-second axis is exactly what a fleet would bill.

Both modes run the same completion budget through ``AsyncEvolution``:

- ``full``: every child evaluated at the full schedule (the pre-ladder
  engine), paying ``FULL_COST`` chip-seconds per uncached completion.
- ``ladder``: children dispatch at rung 0 (~1/20 the cost); the engine's
  asynchronous ASHA rule promotes the top-1/eta of each rung toward the
  full schedule, so chip-seconds concentrate on genomes whose cheap
  measurements earned it.

The artifact records both best-fitness-vs-chip-seconds curves (best is
only credited at the FULL schedule — proxy fitnesses never count), the
chip-seconds each mode needed to first reach the full run's final best
fitness, and the acceptance gates: ladder reaches that fitness in ≤1/5
the chip-seconds, same-seed ladder runs are bit-identical, and a
kill/resume through a schema-v3 checkpoint carrying an IN-FLIGHT
promotion replays bit-identically.

CPU-only, <1 minute: ``python scripts/torch_fidelity_study.py`` writes
``scripts/torch_fidelity_study.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import AsyncEvolution, Individual, Population, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import FaultInjector, FaultPlan, FaultSpec  # noqa: E402
from gentun_tpu_torch.distributed.faults import MasterKilled  # noqa: E402
from gentun_tpu_torch.telemetry import RunTelemetry, lineage, traceviz  # noqa: E402
from gentun_tpu_torch.utils import Checkpointer  # noqa: E402

NODES = (4, 4)  # 12 genome bits → fitness in [0, 12]
POP_SIZE = 8
#: Completion budgets, NOT chip-second budgets — the ladder gets more
#: completions because its completions are ~10-20× cheaper (that asymmetry
#: IS the method); the comparison below is on the chip-second axis, where
#: both modes end up spending the same order of magnitude.
FULL_BUDGET = 150
LADDER_BUDGET = 800
POP_SEED, ENGINE_SEED = 42, 5
ETA = 4

#: The promotion ladder: proxy → intermediate → full schedule.  Costs are
#: kfold × Σepochs chip-seconds — rung 0 is 20× cheaper than the full
#: schedule, the proxy ratio the paper's CIFAR studies use.
LADDER = [
    {"kfold": 2, "epochs": (1,)},
    {"kfold": 3, "epochs": (2,)},
    {"kfold": 5, "epochs": (8,)},
]
FULL = LADDER[-1]


def _cost(knobs) -> float:
    return float(knobs["kfold"] * sum(knobs["epochs"]))


FULL_COST = _cost(FULL)
#: Proxy measurement bias at rung 0, in fitness units; shrinks linearly
#: to 0 at the full schedule.  Sized so proxy ranking is correlated-but-
#: imperfect (ASHA's working assumption): ±0.7 on a 12-point scale can
#: swap neighbors but not bury the optimum under lucky mediocrity.
NOISE_SCALE = 0.75

DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))


class FidelityOneMax(Individual):
    """OneMax whose measurement quality follows the fidelity knobs.

    Full schedule → exact bit count.  Cheaper schedules → bit count plus a
    deterministic content-hashed perturbation scaled by the fidelity gap,
    so proxy rungs rank MOSTLY like the full schedule but can misorder
    close genomes — exactly the failure mode the ladder's top-1/eta
    promotion rule has to be robust to.
    """

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", NODES)))

    def evaluate(self):
        true = float(sum(sum(g) for g in self.genes.values()))
        knobs = {"kfold": self.additional_parameters.get("kfold", FULL["kfold"]),
                 "epochs": tuple(self.additional_parameters.get("epochs", FULL["epochs"]))}
        gap = 1.0 - _cost(knobs) / FULL_COST
        if gap <= 0:
            return true
        h = hashlib.blake2b(
            repr((sorted((k, tuple(v)) for k, v in self.genes.items()), knobs)).encode(),
            digest_size=4,
        ).digest()
        noise = (int.from_bytes(h, "little") / 0xFFFFFFFF - 0.5) * 2 * NOISE_SCALE * gap
        return true + noise


def _pop(**kw):
    return Population(FidelityOneMax, DATA, size=POP_SIZE, seed=POP_SEED,
                      maximize=True, additional_parameters={"nodes": NODES}, **kw)


def _lineage_curve(completed_events, ladder):
    """(cum chip-seconds, best full-fidelity fitness so far) per completion,
    sourced from the forensics plane's ``completed`` lineage events
    (telemetry/lineage.py) — the same event-sourced ledger every search
    artifact carries, instead of a study-private replay of engine history.

    Cached completions bill zero chip-seconds (the fleet never retrained;
    the ledger marks them ``cached``); proxy-rung fitnesses never advance
    the best — only measurements at the full schedule count, so both modes
    are scored on the same scale.
    """
    top = len(ladder) - 1 if ladder else None
    spent, best, points = 0.0, None, []
    for e in completed_events:
        rung = e.get("rung", 0)
        knobs = ladder[rung] if ladder else FULL
        if not e.get("cached"):
            spent += _cost(knobs)
        if top is None or rung == top:
            f = e.get("fitness")
            if f is not None and (best is None or f > best):
                best = f
        points.append([spent, best])
    return points


def _time_to(points, target):
    for spent, best in points:
        if best is not None and best >= target:
            return spent
    return None


def _run(ladder=None, checkpointer=None, injector=None, budget=None):
    if budget is None:
        budget = LADDER_BUDGET if ladder else FULL_BUDGET
    pop = _pop()
    kw = {"fidelity_ladder": ladder, "eta": ETA} if ladder else {}
    eng = AsyncEvolution(pop, tournament_size=3, max_in_flight=1,
                         seed=ENGINE_SEED, checkpoint_every=2, **kw)
    if injector is not None:
        eng.set_fault_injector(injector)
    best = eng.run(max_evaluations=budget, checkpointer=checkpointer)
    return eng, best


def _run_forensic(ladder=None):
    """One curve run under the forensics plane: the lineage ledger supplies
    the ``completed`` event stream the chip-second curve is built from, and
    ``RunTelemetry.summary()['cost']`` supplies the MEASURED per-rung
    device-second table (the analytic knob costs' measured twin)."""
    import tempfile

    lineage.reset_ledger()
    lineage.enable()
    try:
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "telemetry.jsonl")
            with RunTelemetry(path, label="fidelity-study") as run:
                eng, best = _run(ladder=ladder)
            summary = run.summary()
            completed = [r for r in traceviz.load_jsonl(path)
                         if r.get("type") == "lineage"
                         and r.get("event") == "completed"]
    finally:
        lineage.disable()
    return eng, best, completed, summary.get("cost", {})


def _history_sig(eng):
    return [(h["fitness"], h.get("rung")) for h in eng.history]


def main(argv=None) -> int:
    # -- the two chip-hour curves (lineage-ledger accounting) -----------
    full_eng, full_best, full_done, full_cost = _run_forensic(ladder=None)
    ladder_eng, ladder_best, ladder_done, ladder_cost = _run_forensic(ladder=LADDER)
    full_curve = _lineage_curve(full_done, None)
    ladder_curve = _lineage_curve(ladder_done, LADDER)

    # The ledger must be a faithful account of what the engine did: one
    # `completed` event per successful history entry, same fitness stream.
    lineage_faithful = (
        [e["fitness"] for e in ladder_done]
        == [h["fitness"] for h in ladder_eng.history if not h.get("failed")]
        and len(full_done) == len(full_eng.history)
    )

    target = max(b for _, b in full_curve if b is not None)
    t_full = _time_to(full_curve, target)
    t_ladder = _time_to(ladder_curve, target)
    speedup = (t_full / t_ladder) if t_ladder else None

    # -- seeded rung-0 determinism --------------------------------------
    ladder_eng2, _ = _run(ladder=LADDER)
    deterministic = (
        _history_sig(ladder_eng) == _history_sig(ladder_eng2)
        and ladder_best.get_genes() == ladder_eng2.best.get_genes()
    )

    # -- bit-identical kill/resume of an IN-FLIGHT promotion (schema v3) --
    import tempfile

    resume_identical = promotion_in_flight = False
    kill_at = None
    with tempfile.TemporaryDirectory() as td:
        for at in range(2, 16):
            path = os.path.join(td, f"ck-{at}.json")
            inj = FaultInjector(FaultPlan([
                FaultSpec(hook="master_boundary", kind="kill_master", at=at)]))
            try:
                _run(ladder=LADDER, checkpointer=Checkpointer(path), injector=inj)
            except MasterKilled:
                pass
            state = json.load(open(path))
            kinds = [e.get("kind") for e in state.get("in_flight", [])
                     if isinstance(e, dict)]
            if "promotion" in kinds:
                promotion_in_flight, kill_at = True, at
                assert state["schema_version"] == 4, state["schema_version"]
                resumed, _ = _run(ladder=LADDER, checkpointer=Checkpointer(path))
                resume_identical = (
                    _history_sig(resumed) == _history_sig(ladder_eng))
                break

    out = {
        "config": {
            "nodes": list(NODES), "pop_size": POP_SIZE,
            "full_budget": FULL_BUDGET, "ladder_budget": LADDER_BUDGET,
            "eta": ETA, "noise_scale": NOISE_SCALE,
            "ladder": [{**r, "epochs": list(r["epochs"]),
                        "chip_seconds": _cost(r)} for r in LADDER],
        },
        "full": {
            "best_fitness": target,
            "chip_seconds_total": full_curve[-1][0],
            "chip_seconds_to_best": t_full,
            "measured_device_s_by_rung": full_cost.get("cost_s_by_rung"),
            "curve": full_curve,
        },
        "ladder": {
            "best_fitness": max((b for _, b in ladder_curve if b is not None),
                                default=None),
            "chip_seconds_total": ladder_curve[-1][0],
            "chip_seconds_to_full_best": t_ladder,
            "promotions": sum(1 for h in ladder_eng.history if h.get("promotion")),
            "rung_completions": [len(v) for v in ladder_eng._rung_completions],
            "measured_device_s_by_rung": ladder_cost.get("cost_s_by_rung"),
            "curve": ladder_curve,
        },
        "gates": {
            "lineage_accounting_faithful": bool(lineage_faithful),
            "reached_full_best": t_ladder is not None,
            "chip_hour_speedup": speedup,
            "speedup_at_least_5x": bool(speedup and speedup >= 5.0),
            "seeded_determinism": bool(deterministic),
            "promotion_was_in_flight_at_kill": bool(promotion_in_flight),
            "kill_boundary": kill_at,
            "kill_resume_bit_identical": bool(resume_identical),
        },
    }
    path = out_path("torch_fidelity_study.json", argv)
    stamp(out)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    g = out["gates"]
    print(f"full:   best {target} in {t_full} chip-s "
          f"(total {out['full']['chip_seconds_total']})")
    print(f"ladder: best {out['ladder']['best_fitness']} — reached full best "
          f"in {t_ladder} chip-s (total {out['ladder']['chip_seconds_total']}, "
          f"{out['ladder']['promotions']} promotions, "
          f"rungs {out['ladder']['rung_completions']})")
    sp = g["chip_hour_speedup"]
    print(f"gates:  speedup {sp if sp is None else f'{sp:.1f}x'} (>=5: "
          f"{g['speedup_at_least_5x']}), deterministic {g['seeded_determinism']}, "
          f"promotion in flight at kill {g['promotion_was_in_flight_at_kill']} "
          f"(boundary {g['kill_boundary']}), resume identical "
          f"{g['kill_resume_bit_identical']}")
    print(f"wrote {path}")
    ok = all([g["lineage_accounting_faithful"], g["reached_full_best"],
              g["speedup_at_least_5x"], g["seeded_determinism"],
              g["promotion_was_in_flight_at_kill"],
              g["kill_resume_bit_identical"]])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
