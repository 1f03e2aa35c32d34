"""Tail-generation throughput on the card: speculative bucket filling off and on.

The port's counterpart of ``scripts/tailgen_study.py``.  Late generations of
a GA evaluate 1-4 individuals and amortise a program's fixed cost poorly;
``speculative_fill`` fills the pop bucket's padding slots with mutants of
the elite (cache warm-up).  This study runs the same proxy search of
``scripts/torch_distributed_run.py`` (a master process and one worker
process, ``--capacity 20``) once per variant, back to back, and compares
per-generation throughput and the search's wall.

Speculation changes which architectures are pre-measured, not the search:
both runs use the same seeds, a fitness is a pure function of (raw genome,
config, seed) whatever program it trained in, and a speculative cache entry
answers only the raw genome it trained (``populations.py``), so the GA's
trajectory (each generation's best fitness and genes, the population sizes)
must be the same in every variant.  The study asserts it: a variant whose trajectory
differs fails the run.

    python3 scripts/torch_tailgen_study.py --out scripts/torch_tailgen_study.json
    python3 scripts/torch_tailgen_study.py --tiny ...   # CPU rehearsal

Each variant's master record goes to ``<workdir>/torch_tailgen_<name>.json``
and the processes' logs to ``<workdir>/logs/`` (``scripts/`` by default).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The fields of a generation's record that make up the GA's trajectory.
TRAJECTORY = ("generation", "best_fitness", "best_genes", "population_size")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_variant(name: str, spec_flag: str, args, port: int) -> dict:
    out = os.path.join(args.workdir, f"torch_tailgen_{name}.json")
    master_cmd = [
        sys.executable, os.path.join(REPO, "scripts", "torch_distributed_run.py"),
        "master", "--port", str(port), "--generations", str(args.generations),
        "--out", out, "--skip-full",
    ]
    if spec_flag:
        master_cmd += ["--speculative-fill", spec_flag]
    if args.tiny:
        master_cmd += ["--tiny"]
    worker_cmd = [
        sys.executable, "-m", "gentun_tpu_torch.distributed.worker",
        "--port", str(port), "--species", "genetic-cnn",
        "--dataset", "cifar10", "--n", str(96 if args.tiny else 10_000),
        "--capacity", "20",
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if args.tiny:
        env["OMP_NUM_THREADS"] = "1"  # master and worker share the host's cores
    logs = os.path.join(args.workdir, "logs")
    master_log = open(os.path.join(logs, f"torch_tailgen_{name}_master.log"), "w")
    worker_log = open(os.path.join(logs, f"torch_tailgen_{name}_worker.log"), "w")
    t0 = time.monotonic()
    master = subprocess.Popen(master_cmd, cwd=REPO, env=env,
                              stdout=master_log, stderr=subprocess.STDOUT)
    worker = None
    try:
        time.sleep(1.0)
        worker = subprocess.Popen(worker_cmd, cwd=REPO, env=env,
                                  stdout=worker_log, stderr=subprocess.STDOUT)
        rc = master.wait(timeout=args.timeout)
    finally:
        # A hung variant must not leak its pair: they hold the card and
        # would slow every later run.
        for proc in (master, worker):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
        master_log.close()
        worker_log.close()
    if rc != 0:
        raise RuntimeError(f"variant {name}: master rc={rc} "
                           f"(see {logs}/torch_tailgen_{name}_master.log)")
    with open(out) as f:
        rec = json.load(f)
    rec["orchestrator_wall_s"] = round(time.monotonic() - t0, 2)
    return rec


def steady_state_stats(history: list) -> dict:
    """Per-generation throughput for generations that trained something,
    split by batch size (the tail = small batches)."""
    small = [h for h in history if 0 < h["evaluated"] <= 4]
    large = [h for h in history if h["evaluated"] > 4]
    zero = [h for h in history if h["evaluated"] == 0]
    agg = lambda hs: {
        "generations": len(hs),
        "trained_total": sum(h["evaluated"] for h in hs),
        "wall_total_s": round(sum(h["eval_wall_s"] for h in hs), 3),
        "individuals_per_hour_per_chip": round(
            sum(h["evaluated"] for h in hs)
            / max(sum(h["eval_wall_s"] for h in hs), 1e-9) * 3600.0, 1),
    }
    return {
        "small_batches_1_to_4": agg(small),
        "large_batches_gt4": agg(large),
        "zero_train_generations": {"generations": len(zero),
                                   "wall_total_s": round(sum(h["eval_wall_s"] for h in zero), 3)},
    }


def trajectory(history: list) -> list:
    return [{k: h.get(k) for k in TRAJECTORY} for h in history]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=50)
    ap.add_argument("--variants", nargs="+", default=["off", "16"],
                    help="speculative-fill settings to compare (''/'off', 'bucket', or an int)")
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--tiny", action="store_true", help="CPU rehearsal")
    ap.add_argument("--workdir", default=os.path.join(REPO, "scripts"),
                    help="where each variant's master record and the logs go")
    ap.add_argument("--out", default=os.path.join(REPO, "scripts", "torch_tailgen_study.json"))
    args = ap.parse_args(argv)

    os.makedirs(os.path.join(args.workdir, "logs"), exist_ok=True)
    sys.path.insert(0, REPO)
    import bench_torch

    record = {"workload": f"distributed proxy search (pop=20), "
                          f"generations={args.generations}, tiny={args.tiny}",
              "card": bench_torch.card_line(args.tiny),
              "variants": {}}
    trajectories = {}
    for i, v in enumerate(args.variants):
        name = "off" if v in ("", "off") else f"spec{v}"
        if name in record["variants"]:
            name = f"{name}_{i}"  # e.g. off,16,off: rerun 'off' on a warm card
        flag = "" if v in ("", "off") else v
        rec = run_variant(name, flag, args, _free_port())
        hist = rec["proxy"]["history"]
        trajectories[name] = trajectory(hist)
        record["variants"][name] = {
            "speculative_fill": rec.get("speculative_fill", "off"),
            "proxy_total_wall_s": rec["proxy"]["wall_s"],
            "evaluated_total": rec["proxy"]["evaluated_total"],
            "best_fitness": rec["proxy"]["best_fitness"],
            "search_level_individuals_per_hour_per_chip":
                rec["proxy"]["individuals_per_hour_per_chip"],
            "steady_state": steady_state_stats(hist),
            "orchestrator_wall_s": rec["orchestrator_wall_s"],
        }
        with open(args.out, "w") as f:  # incremental: a variant is minutes of the card
            json.dump(record, f, indent=1)
        print(f"[{name}] wall={rec['proxy']['wall_s']}s "
              f"evaluated={rec['proxy']['evaluated_total']} "
              f"best={rec['proxy']['best_fitness']:.4f} small-batch rate="
              f"{record['variants'][name]['steady_state']['small_batches_1_to_4']['individuals_per_hour_per_chip']}",
              flush=True)

    names = list(record["variants"])
    first = trajectories[names[0]]
    record["trajectories_identical"] = all(trajectories[n] == first for n in names)
    record["best_fitness_identical"] = len({record["variants"][n]["best_fitness"]
                                            for n in names}) == 1
    if len(names) >= 2:
        # Compare each speculative variant against the LAST plain-off run
        # (the warmest baseline when 'off' appears twice).
        offs = [n for n in names if n.startswith("off")]
        specs = [n for n in names if not n.startswith("off")]
        if offs and specs:
            a = record["variants"][offs[-1]]
            record["comparison"] = {"baseline": offs[-1]}
            for n in specs:
                b = record["variants"][n]
                record["comparison"][n] = {
                    "wall_ratio": round(b["proxy_total_wall_s"] / a["proxy_total_wall_s"], 4),
                    "small_batch_rate_ratio": round(
                        b["steady_state"]["small_batches_1_to_4"]["individuals_per_hour_per_chip"]
                        / max(a["steady_state"]["small_batches_1_to_4"]
                              ["individuals_per_hour_per_chip"], 1e-9), 4),
                }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.out}; trajectories identical: {record['trajectories_identical']}")
    if not (record["trajectories_identical"] and record["best_fitness_identical"]):
        print("torch_tailgen_study: the variants' GA trajectories differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
