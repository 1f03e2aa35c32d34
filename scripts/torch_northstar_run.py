"""The north-star workload on the card: the 20x50 Genetic-CNN search at the
reference-default schedule, distributed, served by a port worker.

The port's counterpart of ``scripts/northstar_run.py``, with the same
subcommands and record keys: CIFAR-10-shaped data, S=(3,4,5), pop=20,
``--generations`` (50 by default), fitness = 5-fold CV at epochs=(20,4,1),
lr=(1e-2,1e-3,1e-4), a master that never touches the card and
``python -m gentun_tpu_torch.distributed.worker`` on it.  ``--generations 0``
evaluates the initial population only: one full-schedule generation.

Usage (two processes, master first; the worker is the stock CLI):

    python3 scripts/torch_northstar_run.py master --port 56730 \
        --out scripts/torch_northstar_run.json
    python3 -m gentun_tpu_torch.distributed.worker --port 56730 \
        --species genetic-cnn --dataset cifar10 --n 10000 --capacity 20

    # afterwards (the worker has exited), the holdout score of the search
    # winners on a disjoint fresh-noise draw of the same synthetic task:
    python3 scripts/torch_northstar_run.py holdout --artifact scripts/torch_northstar_run.json

CPU rehearsal of the whole flow: add ``--tiny`` to both master and holdout
(tiny shapes, the jobs name the CPU; run the worker with ``--n 96``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s %(name)s %(levelname)s %(message)s")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402

POP = 20
GENERATIONS = 50
N_DATA = 10_000
N_HOLDOUT = 2_000
NODES = (3, 4, 5)

#: bench.py's FULL schedule — the reference-default training recipe
#: (SURVEY.md §3.4: per-individual kfold=5 CV, epochs=(20,4,1) with lr steps
#: (1e-2,1e-3,1e-4)); shapes are BASELINE config #2/#4 (CIFAR-10-sized).
FULL = dict(
    nodes=NODES,
    kernels_per_layer=(32, 64, 128),
    batch_size=256,
    dense_units=256,
    compute_dtype="bfloat16",
    seed=0,
    kfold=5,
    epochs=(20, 4, 1),
    learning_rate=(1e-2, 1e-3, 1e-4),
)


def _config(args):
    """(full_cfg, n_data, n_holdout, generations): the tiny variant rehearses
    on the CPU, and its jobs name it."""
    generations = getattr(args, "generations", None)
    if getattr(args, "tiny", False):
        tiny = dict(
            FULL,
            kernels_per_layer=(4, 4, 4),
            batch_size=32,
            dense_units=16,
            kfold=2,
            epochs=(2, 1),
            learning_rate=(1e-2, 1e-3),
            mesh="cpu",
        )
        return tiny, 96, 64, 3 if generations is None else generations
    return dict(FULL), N_DATA, N_HOLDOUT, GENERATIONS if generations is None else generations


def run_master(args) -> None:
    # The master never touches the card: the worker owns it, and the
    # reference's master is pure bookkeeping (SURVEY.md §3.2).
    from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual
    from gentun_tpu_torch.distributed import DistributedPopulation
    from gentun_tpu_torch.ops.dag import canonical_key
    from gentun_tpu_torch.utils.device_state import backend_used

    assert not backend_used(), "the master must not use the CUDA device"
    full_cfg, n_data, n_holdout, generations = _config(args)

    class NorthStarGA(GeneticAlgorithm):
        """Stock GA + a record of every evaluated architecture (canonical
        DAG key, so isomorphic genomes collapse) for the distinct-arch count
        and the top-K holdout step."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seen: dict = {}

        def _capture(self, pop):
            for ind in pop:
                if ind._fitness is not None:
                    key = canonical_key(ind.get_genes(), tuple(full_cfg["nodes"]))
                    self.seen.setdefault(key, (ind.get_genes(), float(ind.get_fitness())))

        def evolve_population(self):
            pop = self.population
            super().evolve_population()
            self._capture(pop)  # the JUST-evaluated generation (super() replaced it)
            # Flush progress every generation: a crash at generation 49 of a
            # wall-hours run must not lose the 48 before it.
            with open(args.out + ".partial", "w") as f:
                json.dump({"generations_done": self.generation,
                           "distinct_architectures": len(self.seen),
                           "history": self.history}, f, indent=1)

    record = {
        "workload": f"north-star 20x{generations} full-schedule distributed genetic-cnn "
                    "search on the PyTorch port (SURVEY.md §6; BASELINE config #2 shape)",
        "pop": POP,
        "generations": generations,
        "schedule": {
            "kfold": full_cfg["kfold"],
            "epochs": list(full_cfg["epochs"]),
            "learning_rate": list(full_cfg["learning_rate"]),
            "kernels_per_layer": list(full_cfg["kernels_per_layer"]),
            "batch_size": full_cfg["batch_size"],
            "dense_units": full_cfg["dense_units"],
            "nodes": list(full_cfg["nodes"]),
        },
        "n_data": n_data,
        "n_holdout": n_holdout,
        "proxy_anywhere": False,
        "card": bench_torch.card_line(args.tiny),
    }
    t_start = time.monotonic()
    with DistributedPopulation(
        GeneticCnnIndividual,
        size=POP,
        seed=0,
        additional_parameters=dict(full_cfg),
        host="127.0.0.1",
        port=args.port,
        job_timeout=args.job_timeout,
        evaluate_retries=3,
        # A straggler that still fails after 4 passes gets the generation's
        # worst fitness instead of killing the whole wall-hours search.
        failed_policy="penalize",
        fitness_store=args.fitness_store or None,
    ) as pop:
        print(f"broker listening on {pop.broker_address}; waiting for a worker", flush=True)
        from gentun_tpu_torch.utils.checkpoint import Checkpointer

        ga = NorthStarGA(pop, seed=0)
        ga.set_checkpointer(Checkpointer(args.out + ".ckpt"))  # resume point
        t0 = time.monotonic()
        # ga.run(generations) inlined so the final post-loop evaluation's
        # training count is recorded too (run() doesn't log it to history).
        for _ in range(generations):
            ga.evolve_population()
        final_trained = ga.population.evaluate() or 0
        best = ga.population.get_fittest()
        wall = time.monotonic() - t0
        ga._capture(ga.population)  # final population evaluated just above

        trained = sum(h["evaluated"] for h in ga.history) + final_trained
        n_chips = max((h.get("n_chips", 1) for h in ga.history),
                      default=int(pop.eval_stats.get("n_chips") or 1))
        ranked = sorted(ga.seen.values(), key=lambda gf: gf[1], reverse=True)
        record["search"] = {
            "wall_s": round(wall, 2),
            "individuals_trained": trained,
            "final_eval_trained": final_trained,
            "distinct_architectures": len(ga.seen),
            "n_chips": n_chips,
            "individuals_per_hour_per_chip": round(trained / (wall / 3600.0) / n_chips, 2),
            "best_fitness_cv5": best.get_fitness(),
            "best_genes": best.get_genes(),
            "retries_total": sum(h.get("evaluate_retries", 0) for h in ga.history),
            "penalized_total": sum(h.get("penalized", 0) for h in ga.history),
            "history": ga.history,
        }
        record["top3"] = [
            {"genes": {k: list(v) for k, v in g.items()}, "fitness_cv5": f}
            for g, f in ranked[:3]
        ]
    record["total_wall_s"] = round(time.monotonic() - t_start, 2)
    # The key keeps the reference record's name, so the records line up.
    record["master_jax_backend_used"] = backend_used()
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    summary = {k: v for k, v in record.items() if k not in ("search", "top3")}
    summary["search_summary"] = {k: v for k, v in record["search"].items() if k != "history"}
    print(json.dumps(summary))
    print(f"artifact written to {args.out}", flush=True)


def run_holdout(args) -> None:
    """Score the search winners on a DISJOINT fresh-noise draw of the same
    synthetic task (same class prototypes, independent sample stream) at the
    full schedule — the paper-style final number.  Run after the worker has
    exited; it trains on this process's card (or the CPU under --tiny)."""
    import numpy as np

    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.utils.datasets import load_cifar10, synthetic_images

    with open(args.artifact) as f:
        record = json.load(f)
    full_cfg, n_data, n_holdout, _ = _config(args)

    x, y, meta = load_cifar10(n=n_data)
    assert meta["synthetic"], "holdout mode assumes the synthetic task (no archives here)"
    # Same prototypes (seed=0), independent sample stream — see
    # utils/datasets.synthetic_images(sample_seed=...).
    x_te, y_te, te_meta = synthetic_images(
        n_holdout, x.shape[1:], int(np.max(y)) + 1, seed=0, sample_seed=777
    )
    genomes = [
        {k: tuple(v) for k, v in entry["genes"].items()} for entry in record["top3"]
    ]
    t0 = time.monotonic()
    accs = GeneticCnnModel.train_and_score(x, y, x_te, y_te, genomes, **full_cfg)
    record["holdout"] = {
        "n_holdout": n_holdout,
        "holdout_source": te_meta["source"],
        "wall_s": round(time.monotonic() - t0, 2),
        "top3_holdout_acc": [round(float(a), 4) for a in accs],
        "best_holdout_acc": round(float(accs[0]), 4),
        "best_fitness_cv5": record["top3"][0]["fitness_cv5"],
    }
    with open(args.artifact, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record["holdout"]))
    print(f"holdout appended to {args.artifact}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="role", required=True)
    m = sub.add_parser("master")
    m.add_argument("--port", type=int, default=56730)
    m.add_argument("--job-timeout", type=float, default=3600.0)
    m.add_argument("--fitness-store", default="")
    m.add_argument("--tiny", action="store_true", help="CPU rehearsal shapes")
    m.add_argument("--generations", type=int, default=None,
                   help=f"generations to evolve (default {GENERATIONS}; 3 under --tiny); "
                        "0 evaluates the initial population only")
    m.add_argument("--out", default="scripts/torch_northstar_run.json")
    h = sub.add_parser("holdout")
    h.add_argument("--artifact", default="scripts/torch_northstar_run.json")
    h.add_argument("--tiny", action="store_true", help="CPU rehearsal shapes")
    args = ap.parse_args(argv)
    {"master": run_master, "holdout": run_holdout}[args.role](args)


if __name__ == "__main__":
    main()
