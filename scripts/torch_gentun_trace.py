"""gentun-trace: offline search forensics over a run's telemetry JSONL.

Post-mortem companion to the live dashboard (``torch_gentun_top.py``): give it
the ``telemetry.jsonl`` a ``RunTelemetry`` + ``lineage.enable()`` run
wrote, and it answers the questions an operator asks after a search —
where did the chip-hours go, how did the winner get here, and what was
the fleet doing while the master thought?

    python scripts/torch_gentun_trace.py report  run/telemetry.jsonl
    python scripts/torch_gentun_trace.py report  run/telemetry.jsonl --json
    python scripts/torch_gentun_trace.py convert run/telemetry.jsonl trace.json
    python scripts/torch_gentun_trace.py dataset run/telemetry.jsonl rows.jsonl

``dataset`` extracts surrogate training tuples — ``(genome bitstring,
rung, fitness, device_seconds)`` — by joining each ``completed`` lineage
event against the genome recorded on its ``born`` event and the
per-genome ``device`` spans, so the rung −1 training set
(``gentun_tpu_torch/surrogate.py``) is reconstructable offline from any
forensics run's ledger.

``convert`` writes Chrome ``trace_event`` JSON — load it at
https://ui.perfetto.dev (or ``chrome://tracing``) for the interactive
timeline: one track per process (master / broker / each worker), device
spans on per-rung tracks, flow arrows stitching dispatch→evaluate→result
across processes (``gentun_tpu_torch/telemetry/traceviz.py``).

``report`` prints, without leaving the terminal:

- the **winner's ancestry tree** — reconstructed from ``born`` lineage
  events (each records the child's and both parents' genome keys);
- the **chip-hour cost table** — device-seconds per rung, session,
  worker, and the top genomes, summed from per-genome ``device`` spans,
  plus the attribution ratio against span-measured evaluation time;
- the **critical path** — born→completed wall time along the winner's
  ancestry chain versus the device-seconds actually spent on it;
- the **idle-gap report** — per-worker idle time from ``worker_idle``
  spans (dispatch bubbles the pipelined consume loop did not hide).

Stdlib only; see docs/OBSERVABILITY.md "Search forensics".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gentun_tpu_torch.telemetry import traceviz  # noqa: E402

_ANCESTRY_DEPTH = 12  # tree print depth cap (lineages can reach founders)


# -- analysis ---------------------------------------------------------------


def _lineage_events(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [r for r in records if r.get("type") == "lineage"]


def _device_spans(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [r for r in records
            if r.get("type") == "span" and r.get("kind") == "device"]


def pick_winner(events: List[Dict[str, Any]],
                maximize: bool = True) -> Optional[Dict[str, Any]]:
    """The genome the search would return: best fitness among ``completed``
    events at the highest rung that completed anything (proxy-rung
    fitnesses never beat a full-schedule measurement)."""
    completed = [e for e in events
                 if e.get("event") == "completed" and e.get("fitness") is not None]
    if not completed:
        return None
    top = max(int(e.get("rung", 0) or 0) for e in completed)
    at_top = [e for e in completed if int(e.get("rung", 0) or 0) == top]
    key = lambda e: float(e["fitness"])  # noqa: E731
    return max(at_top, key=key) if maximize else min(at_top, key=key)


def ancestry(events: List[Dict[str, Any]], genome: str,
             depth: int = _ANCESTRY_DEPTH) -> Dict[str, Any]:
    """Winner-rooted ancestry tree from ``born`` events (child → parents).

    A genome without a ``born`` entry is a **founder** (random init) or
    predates the ledger.  Repro-loop genomes can recur; visited nodes are
    marked ``(seen above)`` instead of recursing forever.
    """
    parents: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e.get("event") == "born" and e.get("genome"):
            parents[str(e["genome"])] = e

    def _node(g: str, d: int, seen: frozenset) -> Dict[str, Any]:
        born = parents.get(g)
        node: Dict[str, Any] = {"genome": g}
        if born is None:
            node["origin"] = "founder"
            return node
        node["origin"] = born.get("op", "reproduce")
        if g in seen:
            node["cycle"] = True
            return node
        if d <= 0:
            node["truncated"] = True
            return node
        ps = born.get("parents") or []
        if ps:
            node["parents"] = [_node(str(p), d - 1, seen | {g}) for p in ps]
        return node

    return _node(str(genome), depth, frozenset())


def cost_tables(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chip-hour accounting straight from the per-genome device spans."""
    by_rung: Dict[int, float] = {}
    by_session: Dict[str, float] = {}
    by_worker: Dict[str, float] = {}
    by_genome: Dict[str, float] = {}
    total = 0.0
    for rec in _device_spans(records):
        a = rec.get("attrs") or {}
        dur = float(rec.get("dur_s", 0.0))
        total += dur
        rung = int(a.get("rung", 0) or 0)
        by_rung[rung] = by_rung.get(rung, 0.0) + dur
        sess = str(a.get("session") or "default")
        by_session[sess] = by_session.get(sess, 0.0) + dur
        worker = str(a.get("worker") or "local")
        by_worker[worker] = by_worker.get(worker, 0.0) + dur
        g = str(a.get("genome") or "?")
        by_genome[g] = by_genome.get(g, 0.0) + dur
    # Attribution gate: the per-genome device spans should account for
    # (≥99% of) the evaluation time the ordinary spans measured.  Worker
    # fleets measure `eval` (the per-group worker span); local runs only
    # have `train`.  The device spans split exactly those walls, so the
    # ratio is ~1.0 when attribution is complete.
    eval_s = sum(float(r.get("dur_s", 0.0)) for r in records
                 if r.get("type") == "span" and r.get("kind") == "eval")
    basis = "eval"
    if eval_s <= 0.0:
        eval_s = sum(float(r.get("dur_s", 0.0)) for r in records
                     if r.get("type") == "span" and r.get("kind") == "train")
        basis = "train"
    top = sorted(by_genome.items(), key=lambda kv: -kv[1])[:10]
    return {
        "device_s_total": total,
        "by_rung": {str(k): v for k, v in sorted(by_rung.items())},
        "by_session": dict(sorted(by_session.items())),
        "by_worker": dict(sorted(by_worker.items())),
        "top_genomes": [{"genome": g, "device_s": s} for g, s in top],
        "attribution": {
            "basis": basis,
            "measured_s": eval_s,
            "attributed_s": total,
            "ratio": (total / eval_s) if eval_s > 0 else None,
        },
    }


def critical_path(events: List[Dict[str, Any]], records: List[Dict[str, Any]],
                  winner: str) -> Dict[str, Any]:
    """Born→completed wall time along the winner's first-parent chain,
    against the device-seconds actually spent on those genomes — the gap
    between the two is scheduling latency (queue waits, dispatch bubbles,
    promotion waits), the thing forensics exists to find."""
    born_t: Dict[str, float] = {}
    done_t: Dict[str, float] = {}
    parents: Dict[str, List[str]] = {}
    for e in events:
        g = str(e.get("genome"))
        ev, t = e.get("event"), e.get("t_wall")
        if not isinstance(t, (int, float)):
            continue
        if ev == "born":
            born_t.setdefault(g, float(t))
            parents[g] = [str(p) for p in (e.get("parents") or [])]
        elif ev == "completed":
            done_t[g] = max(done_t.get(g, float(t)), float(t))
    chain: List[str] = []
    g: Optional[str] = winner
    seen: set = set()
    while g is not None and g not in seen and len(chain) < 64:
        chain.append(g)
        seen.add(g)
        ps = parents.get(g) or []
        g = ps[0] if ps else None  # first parent (the tournament mother)
    dev: Dict[str, float] = {}
    for rec in _device_spans(records):
        a = rec.get("attrs") or {}
        gg = str(a.get("genome") or "?")
        dev[gg] = dev.get(gg, 0.0) + float(rec.get("dur_s", 0.0))
    stamps = [t for g2 in chain for t in
              (born_t.get(g2), done_t.get(g2)) if t is not None]
    wall = (max(stamps) - min(stamps)) if len(stamps) >= 2 else 0.0
    return {
        "chain": chain,
        "wall_s": wall,
        "device_s": sum(dev.get(g2, 0.0) for g2 in chain),
        "scheduling_overhead_s": max(
            0.0, wall - sum(dev.get(g2, 0.0) for g2 in chain)),
    }


def idle_report(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-worker idle totals from ``worker_idle`` spans (the gaps between
    consecutive evaluation batches on a worker connection)."""
    per: Dict[str, Dict[str, float]] = {}
    for rec in records:
        if rec.get("type") != "span" or rec.get("kind") != "worker_idle":
            continue
        w = str((rec.get("attrs") or {}).get("worker")
                or rec.get("src") or "?")
        dur = float(rec.get("dur_s", 0.0))
        slot = per.setdefault(w, {"idle_s": 0.0, "gaps": 0, "max_gap_s": 0.0})
        slot["idle_s"] += dur
        slot["gaps"] += 1
        slot["max_gap_s"] = max(slot["max_gap_s"], dur)
    return dict(sorted(per.items()))


def build_report(records: List[Dict[str, Any]],
                 maximize: bool = True,
                 genome: Optional[str] = None) -> Dict[str, Any]:
    events = _lineage_events(records)
    winner_ev = None
    if genome is None:
        winner_ev = pick_winner(events, maximize=maximize)
        genome = str(winner_ev["genome"]) if winner_ev else None
    out: Dict[str, Any] = {
        "n_records": len(records),
        "n_lineage_events": len(events),
        "events_by_type": _count_by(events, "event"),
        "cost": cost_tables(records),
        "idle": idle_report(records),
    }
    if genome is not None:
        out["winner"] = {
            "genome": genome,
            "fitness": winner_ev.get("fitness") if winner_ev else None,
            "rung": winner_ev.get("rung") if winner_ev else None,
        }
        out["ancestry"] = ancestry(events, genome)
        out["critical_path"] = critical_path(events, records, genome)
    return out


def extract_dataset(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Surrogate training tuples from a ledger: one row per ``completed``
    event, carrying the genome (from its ``born`` event — ledgers written
    before ``born`` recorded ``genes`` are skipped, counted), the rung,
    the realized fitness, and the device-seconds actually billed to that
    ``(genome, rung)`` cell (0.0 for cache hits — a free measurement)."""
    events = _lineage_events(records)
    genes_by_genome: Dict[str, Any] = {}
    for e in events:
        if e.get("event") == "born" and isinstance(e.get("genes"), dict):
            genes_by_genome.setdefault(str(e.get("genome")), e["genes"])
    device: Dict[Any, float] = {}
    for rec in _device_spans(records):
        a = rec.get("attrs") or {}
        cell = (str(a.get("genome") or "?"), int(a.get("rung", 0) or 0))
        device[cell] = device.get(cell, 0.0) + float(rec.get("dur_s", 0.0))
    rows: List[Dict[str, Any]] = []
    skipped = 0
    for e in events:
        if e.get("event") != "completed" or e.get("fitness") is None:
            continue
        g = str(e.get("genome"))
        genes = genes_by_genome.get(g)
        if genes is None:
            skipped += 1  # founder predating genes-on-born, or old ledger
            continue
        rung = int(e.get("rung", 0) or 0)
        rows.append({
            "genome": g,
            "genes": genes,
            "rung": rung,
            "fitness": float(e["fitness"]),
            "device_seconds": round(device.get((g, rung), 0.0), 9),
        })
    return {"rows": rows, "skipped_no_genes": skipped,
            "genomes": len(genes_by_genome)}


def slo_timeline(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Reconstruct the alert/scale/canary timeline from telemetry alone.

    Pairs each SLO ``fire`` with its ``clear`` per (rule, subject) — one
    *episode* each, carrying both ``transition_seq`` edges, the duration,
    and everything that happened inside the window: autoscaler ``scale``
    decisions (with their evidence ring tails) and canary drift events.
    An episode with no ``clear`` in the ledger is reported ``open`` —
    exactly the ones an operator is being paged about.
    """
    alerts = [r for r in records if r.get("type") == "alert"]
    scales = [r for r in records if r.get("type") == "scale"]
    drifts = [r for r in records
              if r.get("type") == "event" and r.get("name") == "canary_drift"]
    probes = [r for r in records if r.get("type") == "canary_probe"]
    alerts.sort(key=lambda r: (r.get("t", 0.0), r.get("transition_seq", 0)))

    episodes: List[Dict[str, Any]] = []
    open_by_key: Dict[tuple, Dict[str, Any]] = {}
    for a in alerts:
        key = (a.get("rule"), a.get("subject"))
        if a.get("event") == "fire":
            ep = {
                "rule": a.get("rule"),
                "subject": a.get("subject"),
                "severity": a.get("severity"),
                "fired_t": a.get("t"),
                "fire_seq": a.get("transition_seq"),
                "value": a.get("value"),
                "threshold": a.get("threshold"),
                "cleared_t": None,
                "clear_seq": None,
                "duration_s": None,
                "open": True,
            }
            episodes.append(ep)
            open_by_key[key] = ep
        elif a.get("event") == "clear" and key in open_by_key:
            ep = open_by_key.pop(key)
            ep["cleared_t"] = a.get("t")
            ep["clear_seq"] = a.get("transition_seq")
            ep["open"] = False
            if ep["fired_t"] is not None and ep["cleared_t"] is not None:
                ep["duration_s"] = round(ep["cleared_t"] - ep["fired_t"], 3)

    # Attach what happened inside each episode's window.
    for ep in episodes:
        t0 = ep["fired_t"] or 0.0
        t1 = ep["cleared_t"] if ep["cleared_t"] is not None else float("inf")
        acts = [s for s in scales
                if s.get("rule") == ep["rule"] and t0 <= s.get("t", 0.0) <= t1]
        ep["actions"] = [{
            "action": s.get("action"),
            "from": s.get("from"),
            "to": s.get("to"),
            "outcome": s.get("outcome"),
            "t": s.get("t"),
            "evidence_tail": (s.get("evidence") or [])[-3:],
        } for s in acts]
        ep["drifts"] = [d for d in drifts
                        if t0 <= d.get("t_wall", 0.0) <= t1]

    results = _count_by(probes, "result")
    return {
        "episodes": episodes,
        "summary": {
            "fires": sum(1 for a in alerts if a.get("event") == "fire"),
            "clears": sum(1 for a in alerts if a.get("event") == "clear"),
            "open": sum(1 for e in episodes if e["open"]),
            "by_severity": _count_by(
                [e for e in episodes], "severity"),
            "scale_actions": len(scales),
            "canary_probes": results,
            "canary_drift_events": len(drifts),
        },
    }


def render_slo(timeline: Dict[str, Any]) -> str:
    L: List[str] = []
    s = timeline["summary"]
    L.append("== SLO timeline ==")
    L.append(f"fires {s['fires']}  clears {s['clears']}  "
             f"still-open {s['open']}  scale-actions {s['scale_actions']}")
    if s["canary_probes"]:
        probes = "  ".join(f"{k}={v}" for k, v in s["canary_probes"].items())
        L.append(f"canary probes: {probes}  "
                 f"drift-events {s['canary_drift_events']}")
    for ep in timeline["episodes"]:
        dur = ("open" if ep["open"]
               else f"{ep['duration_s']}s")
        L.append(f"  [{ep['severity']}] {ep['rule']} subject={ep['subject']} "
                 f"seq {ep['fire_seq']}->"
                 f"{ep['clear_seq'] if ep['clear_seq'] is not None else '…'} "
                 f"({dur})  value={ep['value']} threshold={ep['threshold']}")
        for a in ep["actions"]:
            L.append(f"      scale {a['action']}: {a['from']} -> {a['to']} "
                     f"({a['outcome']})")
            for pt in a["evidence_tail"]:
                L.append(f"        evidence {pt}")
        for d in ep["drifts"]:
            L.append(f"      drift: {d.get('data')}")
    if not timeline["episodes"]:
        L.append("  (no alert transitions in the ledger)")
    return "\n".join(L)


def _count_by(events: List[Dict[str, Any]], field: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for e in events:
        k = str(e.get(field))
        out[k] = out.get(k, 0) + 1
    return dict(sorted(out.items()))


# -- rendering --------------------------------------------------------------


def _fmt_tree(node: Dict[str, Any], indent: str = "") -> List[str]:
    label = node["genome"]
    tag = node.get("origin", "?")
    if node.get("cycle"):
        tag += ", seen above"
    if node.get("truncated"):
        tag += ", …"
    lines = [f"{indent}{label}  ({tag})"]
    for p in node.get("parents", []):
        lines.extend(_fmt_tree(p, indent + "    "))
    return lines


def render(report: Dict[str, Any]) -> str:
    L: List[str] = []
    L.append(f"records: {report['n_records']}   "
             f"lineage events: {report['n_lineage_events']}")
    L.append("events: " + "  ".join(
        f"{k}={v}" for k, v in report["events_by_type"].items()))
    w = report.get("winner")
    if w:
        L.append("")
        L.append(f"winner: {w['genome']}  fitness={w.get('fitness')}  "
                 f"rung={w.get('rung')}")
        L.append("ancestry:")
        L.extend(_fmt_tree(report["ancestry"], "  "))
        cp = report.get("critical_path") or {}
        L.append("")
        L.append(f"critical path ({len(cp.get('chain', []))} genomes): "
                 f"wall {cp.get('wall_s', 0):.3f}s, "
                 f"device {cp.get('device_s', 0):.3f}s, "
                 f"scheduling overhead {cp.get('scheduling_overhead_s', 0):.3f}s")
    c = report["cost"]
    L.append("")
    L.append(f"device seconds total: {c['device_s_total']:.3f}")
    if c["by_rung"]:
        L.append("  by rung:    " + "  ".join(
            f"r{k}={v:.3f}s" for k, v in c["by_rung"].items()))
    if c["by_session"]:
        L.append("  by session: " + "  ".join(
            f"{k}={v:.3f}s" for k, v in c["by_session"].items()))
    if c["by_worker"]:
        L.append("  by worker:  " + "  ".join(
            f"{k}={v:.3f}s" for k, v in c["by_worker"].items()))
    att = c["attribution"]
    if att["ratio"] is not None:
        L.append(f"  attribution: {att['attributed_s']:.3f}s of "
                 f"{att['measured_s']:.3f}s {att['basis']}-span seconds "
                 f"({100.0 * att['ratio']:.1f}%)")
    if c["top_genomes"]:
        L.append("  top genomes:")
        for row in c["top_genomes"][:5]:
            L.append(f"    {row['genome']}  {row['device_s']:.3f}s")
    if report["idle"]:
        L.append("")
        L.append("idle gaps:")
        for wkr, slot in report["idle"].items():
            L.append(f"  {wkr}: {slot['idle_s']:.3f}s idle over "
                     f"{slot['gaps']} gap(s), max {slot['max_gap_s']:.3f}s")
    return "\n".join(L)


# -- CLI --------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_gentun_trace.py",
        description="offline search forensics over a run's telemetry JSONL")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_conv = sub.add_parser("convert",
                            help="JSONL → Chrome trace_event JSON (Perfetto)")
    p_conv.add_argument("jsonl")
    p_conv.add_argument("out")
    p_rep = sub.add_parser("report", help="ancestry/cost/critical-path report")
    p_rep.add_argument("jsonl")
    p_rep.add_argument("--json", action="store_true",
                       help="machine-readable JSON instead of text")
    p_rep.add_argument("--minimize", action="store_true",
                       help="lower fitness is better (default: higher)")
    p_rep.add_argument("--genome", default=None,
                       help="root the ancestry at this genome key "
                            "instead of the inferred winner")
    p_ds = sub.add_parser(
        "dataset",
        help="extract (genome, rung, fitness, device_seconds) surrogate "
             "training rows from the lineage ledger")
    p_ds.add_argument("jsonl")
    p_ds.add_argument("out", nargs="?", default=None,
                      help="output JSONL path (default: stdout)")
    p_slo = sub.add_parser(
        "slo",
        help="reconstruct the alert/scale/canary timeline (fire->clear "
             "episodes with transition_seq, durations, evidence tails)")
    p_slo.add_argument("jsonl")
    p_slo.add_argument("--json", action="store_true",
                       help="machine-readable JSON instead of text")
    args = ap.parse_args(argv)

    if args.cmd == "slo":
        timeline = slo_timeline(traceviz.load_jsonl(args.jsonl))
        if args.json:
            json.dump(timeline, sys.stdout, indent=2, sort_keys=True)
            print()
        else:
            print(render_slo(timeline))
        return 0

    if args.cmd == "convert":
        trace = traceviz.convert(args.jsonl, args.out)
        n = len(trace["traceEvents"])
        print(f"wrote {args.out}: {n} trace events "
              f"(load at https://ui.perfetto.dev)")
        return 0

    if args.cmd == "dataset":
        ds = extract_dataset(traceviz.load_jsonl(args.jsonl))
        lines = [json.dumps(r, separators=(",", ":")) for r in ds["rows"]]
        if args.out:
            with open(args.out, "w", encoding="utf-8") as fh:
                fh.write("\n".join(lines) + ("\n" if lines else ""))
        else:
            for line in lines:
                print(line)
        msg = (f"{len(ds['rows'])} training row(s) from "
               f"{ds['genomes']} genome(s)")
        if ds["skipped_no_genes"]:
            msg += (f"; skipped {ds['skipped_no_genes']} completed event(s) "
                    "without a genes-bearing born event (pre-v12 ledger?)")
        print(msg, file=sys.stderr)
        return 0

    records = traceviz.load_jsonl(args.jsonl)
    report = build_report(records, maximize=not args.minimize,
                          genome=args.genome)
    if args.json:
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
