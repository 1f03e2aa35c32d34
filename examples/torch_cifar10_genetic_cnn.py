"""BASELINE config #2 on the PyTorch/CUDA port: Genetic CNN on CIFAR-10, S=(3,4,5), 20 individuals.

The port's counterpart of ``examples/cifar10_genetic_cnn.py``, with the same
arguments and defaults, and the north-star workload: the whole population
trains as one population-batched program per generation on the card
(``models/cnn.py``, the hand-written conv kernels of ``csrc/``), under
``RussianRouletteGA`` (the Genetic-CNN paper's selection).  It runs on the
CUDA card; ``--device cpu`` asks for the CPU (small ``--kernels`` and
``--n-images`` for a smoke run), and ``--checkpoint PATH`` makes the search
resumable: run it again with the same arguments after a crash and it goes
on from the last finished generation.

    python3 examples/torch_cifar10_genetic_cnn.py --generations 1
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from gentun_tpu_torch import GeneticCnnIndividual, Population, RussianRouletteGA
from gentun_tpu_torch.utils import Checkpointer, EvalTimer
from gentun_tpu_torch.utils.datasets import load_cifar10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=50)
    ap.add_argument("--population", type=int, default=20)
    ap.add_argument("--n-images", type=int, default=10_000)
    ap.add_argument("--kfold", type=int, default=2)
    ap.add_argument("--epochs", type=int, nargs="+", default=[1])
    ap.add_argument("--lr", type=float, nargs="+", default=[0.01])
    ap.add_argument("--kernels", type=int, nargs="+", default=[32, 64, 128],
                    help="filters per stage (smaller = faster smoke runs)")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--dense-units", type=int, default=256)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the CUDA card (default) or, when asked, the CPU")
    args = ap.parse_args(argv)

    x, y, meta = load_cifar10(n=args.n_images)
    print(f"data: {meta['source']} ({len(x)} images)")

    pop = Population(
        GeneticCnnIndividual,
        x_train=x,
        y_train=y,
        size=args.population,
        seed=0,
        additional_parameters=dict(
            nodes=(3, 4, 5),
            kernels_per_layer=tuple(args.kernels),
            kfold=args.kfold,
            epochs=tuple(args.epochs),
            learning_rate=tuple(args.lr),
            batch_size=args.batch_size,
            dense_units=args.dense_units,
            compute_dtype="bfloat16",
            seed=0,
            mesh="auto" if args.device == "cuda" else "cpu",
        ),
    )
    # Roulette selection, per the Genetic-CNN paper the reference implements.
    ga = RussianRouletteGA(pop, seed=0)
    checkpointer = Checkpointer(args.checkpoint) if args.checkpoint else None
    timer = EvalTimer()
    with timer.measure(args.population * args.generations, label="search"):
        best = ga.run(args.generations, checkpointer=checkpointer)
    print(f"best architecture: {best.get_genes()}")
    print(f"best fitness (mean val acc): {best.get_fitness():.4f}")
    print(f"throughput: {timer.summary()}")
    return {"best_genes": best.get_genes(), "best_fitness": best.get_fitness(),
            "generation": ga.generation, "history": ga.history,
            "throughput": timer.summary()}


if __name__ == "__main__":
    main()
