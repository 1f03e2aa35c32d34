"""BASELINE config #5 on the PyTorch/CUDA port: deep Genetic CNN on CIFAR-100, S=(5,5,5), pop=50.

The port's counterpart of ``examples/cifar100_deep.py``, with the same
arguments and defaults: 50 individuals with 10+10+10 = 30 DAG bits each
(2^30 search space), filters (64, 128, 256), dense 512, 100-way
classification, batch 256, bf16, the proxy fitness schedule (kfold=2, one
epoch).  It runs on the CUDA card; ``--device cpu`` asks for the CPU
(small ``--kernels``/``--n-images`` for a smoke run), and ``--checkpoint
PATH`` makes the search resumable: run it again with the same arguments
after a crash and it goes on from the last finished generation.

    python3 examples/torch_cifar100_deep.py --generations 1
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from gentun_tpu_torch import GeneticCnnIndividual, Population, RussianRouletteGA
from gentun_tpu_torch.utils import Checkpointer, EvalTimer
from gentun_tpu_torch.utils.datasets import load_cifar100


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=20)
    ap.add_argument("--population", type=int, default=50)
    ap.add_argument("--n-images", type=int, default=10_000)
    ap.add_argument("--kernels", type=int, nargs="+", default=[64, 128, 256],
                    help="filters per stage (smaller = faster smoke runs)")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--dense-units", type=int, default=512)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the CUDA card (default) or, when asked, the CPU")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint file: resume from it, save to it every generation")
    args = ap.parse_args(argv)

    x, y, meta = load_cifar100(n=args.n_images)
    print(f"data: {meta['source']} ({len(x)} images, 100 classes)")

    pop = Population(
        GeneticCnnIndividual,
        x_train=x,
        y_train=y,
        size=args.population,
        seed=0,
        additional_parameters=dict(
            nodes=(5, 5, 5),
            kernels_per_layer=tuple(args.kernels),
            kfold=2,
            epochs=(1,),
            learning_rate=(0.01,),
            batch_size=args.batch_size,
            dense_units=args.dense_units,
            compute_dtype="bfloat16",
            seed=0,
            mesh="auto" if args.device == "cuda" else "cpu",
        ),
    )
    ga = RussianRouletteGA(pop, seed=0)
    checkpointer = Checkpointer(args.checkpoint) if args.checkpoint else None
    timer = EvalTimer()
    with timer.measure(args.population * args.generations, label="deep-search"):
        best = ga.run(args.generations, checkpointer=checkpointer)
    print(f"best architecture: {best.get_genes()}")
    print(f"best fitness: {best.get_fitness():.4f}")
    print(f"throughput: {timer.summary()}")
    return {"best_genes": best.get_genes(), "best_fitness": best.get_fitness(),
            "generation": ga.generation, "throughput": timer.summary()}


if __name__ == "__main__":
    main()
