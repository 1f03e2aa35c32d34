"""Full-schedule convergence run of the PyTorch port → docs/TORCH_RESULTS.md.

The port's counterpart of ``scripts/convergence.py``.  BASELINE config #1:
Genetic CNN on an MNIST stand-in (sklearn's digits upscaled, the only
offline real data), S=(3, 5), pop=10, searched at the REFERENCE-DEFAULT
fitness schedule: kfold=5, epochs=(20, 4, 1), lr=(1e-2, 1e-3, 1e-4)
(SURVEY.md §3.4).  After the search, the best architecture is retrained on
the full search split and scored on a held-out 20% test split
(``GeneticCnnModel.train_and_score``).  On the card by default; ``--tiny``
is the CPU smoke (narrow widths, kfold 2, one epoch).

    python3 scripts/torch_convergence.py [--generations 50]
    python3 scripts/torch_convergence.py --tiny

Writes ``docs/TORCH_RESULTS.md`` and ``scripts/torch_convergence.json``
(with the card's name and power limit).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual, Population  # noqa: E402
from gentun_tpu_torch.models.cnn import GeneticCnnModel  # noqa: E402
from gentun_tpu_torch.utils.datasets import load_mnist  # noqa: E402

FULL_SCHEDULE = dict(
    nodes=(3, 5),
    kernels_per_layer=(20, 50),
    kfold=5,
    epochs=(20, 4, 1),
    learning_rate=(1e-2, 1e-3, 1e-4),
    batch_size=128,
    dense_units=500,
    seed=0,
)
#: ``--tiny``: the same protocol at CPU smoke size.
TINY_SCHEDULE = dict(FULL_SCHEDULE, kernels_per_layer=(4, 4), dense_units=16, kfold=2,
                     epochs=(1,), learning_rate=(0.01,), batch_size=32)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=50)
    ap.add_argument("--population", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "TORCH_RESULTS.md"))
    ap.add_argument("--json-out", default=os.path.join(REPO, "scripts", "torch_convergence.json"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fitness-store", default=None, metavar="PATH",
                    help="persist/reuse measured fitnesses across runs "
                         "(utils/fitness_store.py); repeated runs over the "
                         "same data retrain only unseen architectures")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU smoke: narrow widths, kfold 2, one epoch, 200 images")
    args = ap.parse_args(argv)
    cpu = args.tiny or args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("torch_convergence: no CUDA device; pass --device cpu (or --tiny) to run on "
              "the CPU", file=sys.stderr)
        return 2
    schedule = dict(TINY_SCHEDULE if args.tiny else FULL_SCHEDULE,
                    mesh="cpu" if cpu else "auto")

    x, y, meta = load_mnist(n=200 if args.tiny else None)
    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(len(x))
    n_test = len(x) // 5
    test_idx, search_idx = perm[:n_test], perm[n_test:]
    x_search, y_search = x[search_idx], y[search_idx]
    x_test, y_test = x[test_idx], y[test_idx]
    print(f"data: {meta['source']} — search {len(x_search)}, held-out test {len(x_test)}")

    fitness_cache = None
    if args.fitness_store:
        from gentun_tpu_torch.utils import load_fitness_cache

        fitness_cache = load_fitness_cache(args.fitness_store)
        if fitness_cache:
            print(f"fitness store: {len(fitness_cache)} known architecture(s) loaded")

    pop = Population(
        GeneticCnnIndividual,
        x_train=x_search,
        y_train=y_search,
        size=args.population,
        seed=args.seed,
        additional_parameters=dict(schedule),
        fitness_cache=fitness_cache,
    )
    ga = GeneticAlgorithm(pop, seed=args.seed)
    t0 = time.monotonic()
    best = ga.run(args.generations)
    search_s = time.monotonic() - t0

    if args.fitness_store:
        from gentun_tpu_torch.utils import save_fitness_cache

        total = save_fitness_cache(ga.population.fitness_cache, args.fitness_store)
        print(f"fitness store: {total} architecture(s) persisted")

    t0 = time.monotonic()
    test_acc = float(GeneticCnnModel.train_and_score(
        x_search, y_search, x_test, y_test, [best.get_genes()], **schedule)[0])
    holdout_s = time.monotonic() - t0

    # clone_with shares ONE fitness-cache dict across all generations, so
    # the final population's cache counts every architecture trained.
    trained = len(ga.population.fitness_cache)
    device = bench_torch.card_line(cpu)
    lines = [
        "# Full-schedule convergence run of the PyTorch port (BASELINE config #1)",
        "",
        "The port's counterpart of `RESULTS.md` (which records the JAX package's",
        "run and stays as it is); search efficacy, GA against random sampling,",
        "is `docs/TORCH_SEARCH.md`.",
        "",
        f"- Data: {meta['source']} ({len(x)} images; real handwritten digits — the",
        "  only offline MNIST stand-in, see SURVEY.md §0).",
        f"- Search: S=(3,5), pop={args.population}, {args.generations} generations,",
        f"  fitness = {schedule['kfold']}-fold CV mean val accuracy at epochs="
        f"{schedule['epochs']}, lr={schedule['learning_rate']}, batch "
        f"{schedule['batch_size']}.",
        f"- Search wall time: {search_s / 60:.1f} min on {device};",
        f"  {trained} distinct architectures trained (fitness cache + canonical-key",
        "  dedup answer the rest).",
        "",
        "## Search curve (best CV fitness per generation)",
        "",
        "| generation | best CV acc | evaluated (new trainings) |",
        "|---|---|---|",
    ]
    for rec in ga.history:
        lines.append(f"| {rec['generation']} | {rec['best_fitness']:.4f} | {rec['evaluated']} |")
    lines += [
        "",
        "## Final result",
        "",
        f"- Best architecture: `{json.dumps(best.get_genes())}`",
        f"- Best CV fitness (search metric): **{best.get_fitness():.4f}**",
        f"- Held-out test accuracy (retrained on the full search split): **{test_acc:.4f}**",
        "",
        "The digits stand-in is ~2.4% of MNIST's training data at a quarter of",
        "its resolution, so this is an architecture-search convergence artifact,",
        "not an MNIST-parity claim (`scripts/torch_parity.py` is that check).",
        "",
        _curve_summary(ga.history),
        "",
        "## Reproduce",
        "",
        "```bash",
        f"python3 scripts/torch_convergence.py --generations {args.generations} "
        f"--population {args.population} --seed {args.seed}" + (" --tiny" if args.tiny else ""),
        "```",
        "",
    ]
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    record = {
        "config": {"generations": args.generations, "population": args.population,
                   "seed": args.seed, "tiny": args.tiny,
                   "schedule": {k: list(v) if isinstance(v, tuple) else v
                                for k, v in schedule.items()}},
        "card": device,
        "data": meta["source"],
        "search_wall_s": search_s,
        "holdout_wall_s": holdout_s,
        "distinct_architectures_trained": trained,
        "best_genes": best.get_genes(),
        "best_cv_fitness": best.get_fitness(),
        "holdout_test_accuracy": test_acc,
        "history": ga.history,
    }
    with open(args.json_out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {args.out}: best CV {best.get_fitness():.4f}, test {test_acc:.4f}")
    return 0


def _curve_summary(history) -> str:
    """One line about what the curve shows."""
    fits = [rec["best_fitness"] for rec in history]
    if not fits:
        return "No generations were run (--generations 0): no search curve."
    if len(fits) >= 2 and fits[-1] > fits[0]:
        return (
            f"The search curve improves from {fits[0]:.4f} (generation 0) to "
            f"{fits[-1]:.4f}; the held-out score checks that the best architecture "
            "generalises."
        )
    return (
        f"The best CV fitness was flat at {fits[0]:.4f}: the random generation-0 "
        "population already held the best architecture found, so this run shows "
        "the search machinery (caching and dedup kept re-evaluation free) and "
        "held-out generalisation, not fitness improvement over generations."
    )


if __name__ == "__main__":
    raise SystemExit(main())
