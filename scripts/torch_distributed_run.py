"""A distributed Genetic-CNN search on the card: a master without a card,
the training done by a port worker process on the CUDA card.

The port's counterpart of the reference's distributed hardware run
(``scripts/distributed_tpu_run.py``), with the same subcommands, flags and
record keys: a master (``GeneticAlgorithm`` over a ``DistributedPopulation``
with the broker embedded) drives proxy generations plus one
reference-default full-schedule generation, served by
``python -m gentun_tpu_torch.distributed.worker``; afterwards, once the
worker has exited, the ``single`` subcommand runs the same search in one
process for the comparison.

Shapes follow BASELINE config #4: CIFAR-10-sized data, S=(3, 4, 5), pop=20;
the configurations are ``bench_torch.py``'s PROXY and FULL.

Usage (two processes, master first):

    python3 scripts/torch_distributed_run.py master --port 56720 \
        --generations 10 --out scripts/torch_distributed_run.json
    python3 -m gentun_tpu_torch.distributed.worker --port 56720 \
        --species genetic-cnn --dataset cifar10 --n 10000 --capacity 20

    # afterwards (the worker has exited), the comparison run:
    python3 scripts/torch_distributed_run.py single --generations 10 \
        --out scripts/torch_distributed_single.json

``--tiny`` (both subcommands) is the CPU rehearsal: tiny shapes, and the
jobs' configuration names the CPU (``mesh="cpu"``), so the worker trains
there; the worker then takes ``--n 96``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402

POP = 20
N_DATA = 10_000

# bench_torch.py's exact schedules.
COMMON = dict(
    nodes=(3, 4, 5),
    kernels_per_layer=(32, 64, 128),
    batch_size=256,
    dense_units=256,
    compute_dtype="bfloat16",
    seed=0,
)
PROXY = dict(COMMON, kfold=2, epochs=(1,), learning_rate=(0.01,))
FULL = dict(COMMON, kfold=5, epochs=(20, 4, 1), learning_rate=(1e-2, 1e-3, 1e-4))
TINY_N = 96


def _schedules(args):
    """(proxy, full, n_data): the tiny variants name the CPU."""
    if getattr(args, "tiny", False):
        tiny = dict(COMMON, kernels_per_layer=(4, 4, 4), batch_size=32, dense_units=16,
                    mesh="cpu")
        return (
            dict(tiny, kfold=2, epochs=(1,), learning_rate=(0.01,)),
            dict(tiny, kfold=2, epochs=(2, 1), learning_rate=(1e-2, 1e-3)),
            TINY_N,
        )
    return dict(PROXY), dict(FULL), N_DATA


def _speculative_fill(flag):
    if not flag:
        return False
    if flag == "bucket":
        return True
    try:
        spec_fill = int(flag)
    except ValueError:
        raise SystemExit(
            f"--speculative-fill must be '', 'bucket', or a positive int; got {flag!r}")
    if spec_fill < 1:
        raise SystemExit(f"--speculative-fill int target must be >= 1, got {spec_fill}")
    return spec_fill


def run_master(args) -> None:
    # The master never touches the card: the worker owns it, and the master
    # is bookkeeping and the broker.
    from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual
    from gentun_tpu_torch.distributed import DistributedPopulation
    from gentun_tpu_torch.utils.device_state import backend_used

    assert not backend_used(), "the master must not use the CUDA device"
    proxy_cfg, full_cfg, n_data = _schedules(args)

    record = {
        "workload": "distributed cifar10 genetic-cnn search (BASELINE config #4 shape)",
        "pop": POP,
        "proxy_schedule": f"kfold={proxy_cfg['kfold']} epochs={proxy_cfg['epochs']}",
        "full_schedule": f"kfold={full_cfg['kfold']} epochs={full_cfg['epochs']} "
                         f"lr={full_cfg['learning_rate']}",
        "n_data": n_data,
        "card": bench_torch.card_line(args.tiny),
    }
    t_start = time.monotonic()
    spec_fill = _speculative_fill(args.speculative_fill)
    record["speculative_fill"] = args.speculative_fill or "off"
    with DistributedPopulation(
        GeneticCnnIndividual,
        size=POP,
        seed=0,
        additional_parameters=dict(proxy_cfg),
        host="127.0.0.1",
        port=args.port,
        job_timeout=args.job_timeout,
        evaluate_retries=3,
        fitness_store=args.fitness_store or None,
        speculative_fill=spec_fill,
    ) as pop:
        print(f"broker listening on {pop.broker_address}; waiting for a worker", flush=True)
        ga = GeneticAlgorithm(pop, seed=0)
        t0 = time.monotonic()
        best = ga.run(args.generations)
        proxy_wall = time.monotonic() - t0
        record["proxy"] = {
            "generations": args.generations,
            "wall_s": round(proxy_wall, 2),
            "best_fitness": best.get_fitness(),
            "evaluated_total": sum(h["evaluated"] for h in ga.history),
            "history": ga.history,
        }
        evaluated = record["proxy"]["evaluated_total"]
        # individuals/hour/card over the whole proxy search, with the card
        # count the workers reported per generation.
        n_chips = max((h.get("n_chips", 1) for h in ga.history), default=1)
        record["proxy"]["individuals_per_hour_per_chip"] = round(
            evaluated / (proxy_wall / 3600.0) / n_chips, 2)
        record["proxy"]["n_chips"] = n_chips

        if not args.skip_full:
            # One reference-default full-schedule generation over the final
            # population's genomes, as fresh individuals.
            genomes = [ind.get_genes() for ind in ga.population]
            full_inds = [GeneticCnnIndividual(genes=g, additional_parameters=dict(full_cfg))
                         for g in genomes]
            full_pop = DistributedPopulation(
                GeneticCnnIndividual,
                individual_list=full_inds,
                additional_parameters=dict(full_cfg),
                broker=pop.broker,
                job_timeout=args.job_timeout,
                evaluate_retries=3,
            )
            t0 = time.monotonic()
            shipped = full_pop.evaluate()
            full_wall = time.monotonic() - t0
            fits = [ind.get_fitness() for ind in full_pop]
            record["full"] = {
                "wall_s": round(full_wall, 2),
                "shipped_jobs": shipped,
                "eval_stats": dict(full_pop.eval_stats),
                "individuals_per_hour_per_chip": round(
                    shipped / (full_wall / 3600.0)
                    / max(1, full_pop.eval_stats.get("n_chips", 1)), 2),
                "best_full_fitness": max(fits),
                "mean_full_fitness": sum(fits) / len(fits),
                "fitnesses": fits,
            }
    record["total_wall_s"] = round(time.monotonic() - t_start, 2)
    # The master never used the card: all compute ran in the worker.  The
    # key keeps the reference record's name, so the records line up.
    record["master_jax_backend_used"] = backend_used()
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k not in ("proxy", "full")}
                     | {"proxy_summary": {k: v for k, v in record["proxy"].items()
                                          if k != "history"}}))
    print(f"artifact written to {args.out}", flush=True)


def run_single(args) -> None:
    """The comparison run: the same search in one process, on this
    process's card (run it after the worker has exited)."""
    from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual, Population
    from gentun_tpu_torch.utils.datasets import load_cifar10

    proxy_cfg, full_cfg, n_data = _schedules(args)
    x, y, meta = load_cifar10(n=n_data)
    record = {"data": meta.get("source"), "pop": POP, "card": bench_torch.card_line(args.tiny)}
    pop = Population(
        GeneticCnnIndividual,
        x_train=x,
        y_train=y,
        size=POP,
        seed=0,
        additional_parameters=dict(proxy_cfg),
    )
    ga = GeneticAlgorithm(pop, seed=0)
    t0 = time.monotonic()
    best = ga.run(args.generations)
    proxy_wall = time.monotonic() - t0
    evaluated = sum(h["evaluated"] for h in ga.history)
    record["proxy"] = {
        "generations": args.generations,
        "wall_s": round(proxy_wall, 2),
        "best_fitness": best.get_fitness(),
        "evaluated_total": evaluated,
        "individuals_per_hour_per_chip": round(evaluated / (proxy_wall / 3600.0), 2),
        "history": ga.history,
    }
    if not args.skip_full:
        genomes = [ind.get_genes() for ind in ga.population]
        full_inds = [GeneticCnnIndividual(x_train=x, y_train=y, genes=g,
                                          additional_parameters=dict(full_cfg))
                     for g in genomes]
        full_pop = Population(
            GeneticCnnIndividual,
            x_train=x,
            y_train=y,
            individual_list=full_inds,
            additional_parameters=dict(full_cfg),
        )
        t0 = time.monotonic()
        trained = full_pop.evaluate()
        full_wall = time.monotonic() - t0
        fits = [ind.get_fitness() for ind in full_pop]
        record["full"] = {
            "wall_s": round(full_wall, 2),
            "trained": trained,
            "individuals_per_hour_per_chip": round(trained / (full_wall / 3600.0), 2),
            "best_full_fitness": max(fits),
            "mean_full_fitness": sum(fits) / len(fits),
            "fitnesses": fits,
        }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"artifact written to {args.out}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="role", required=True)
    m = sub.add_parser("master")
    m.add_argument("--port", type=int, default=56720)
    m.add_argument("--generations", type=int, default=10)
    m.add_argument("--job-timeout", type=float, default=3600.0)
    m.add_argument("--fitness-store", default="")
    m.add_argument("--speculative-fill", default="",
                   help="'' = off, 'bucket' = fill only pop-bucket padding "
                        "slots (free), or an int batch target (e.g. 16) for "
                        "aggressive cache warm-up")
    m.add_argument("--out", default="scripts/torch_distributed_run.json")
    s = sub.add_parser("single")
    s.add_argument("--generations", type=int, default=10)
    s.add_argument("--out", default="scripts/torch_distributed_single.json")
    for p in (m, s):
        p.add_argument("--tiny", action="store_true",
                       help="CPU rehearsal shapes; the jobs run on the CPU")
        p.add_argument("--skip-full", action="store_true",
                       help="leave out the full-schedule generation")
    args = ap.parse_args(argv)
    {"master": run_master, "single": run_single}[args.role](args)


if __name__ == "__main__":
    main()
