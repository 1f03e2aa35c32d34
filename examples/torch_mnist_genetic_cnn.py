"""BASELINE config #1 on the PyTorch/CUDA port: Genetic CNN on MNIST, S=(3,5), 10 individuals.

The port's counterpart of ``examples/mnist_genetic_cnn.py``, with the same
arguments and defaults, except that ``--device cpu`` asks for the CPU
where the JAX example's ``--cpu`` did; the default is the CUDA card.  Data
loads offline (sklearn digits upscaled, or real MNIST from an ``mnist.npz``
in ``GENTUN_TPU_DATA``).  ``--checkpoint PATH`` makes the search
resumable.

    python3 examples/torch_mnist_genetic_cnn.py --generations 5
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual, Population
from gentun_tpu_torch.utils import Checkpointer
from gentun_tpu_torch.utils.datasets import load_mnist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=5)
    ap.add_argument("--population", type=int, default=10)
    ap.add_argument("--kfold", type=int, default=3)
    ap.add_argument("--epochs", type=int, nargs="+", default=[3])
    ap.add_argument("--lr", type=float, nargs="+", default=[0.01])
    ap.add_argument("--n-images", type=int, default=None, help="subsample the dataset")
    ap.add_argument("--kernels", type=int, nargs="+", default=[20, 50],
                    help="filters per stage (smaller = faster smoke runs)")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--dense-units", type=int, default=500)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the CUDA card (default) or, when asked, the CPU")
    args = ap.parse_args(argv)

    if args.n_images is not None and args.n_images <= 0:
        raise SystemExit(f"--n-images must be positive, got {args.n_images}")
    x, y, meta = load_mnist(**({"n": args.n_images} if args.n_images is not None else {}))
    print(f"data: {meta['source']} ({len(x)} images)")

    pop = Population(
        GeneticCnnIndividual,
        x_train=x,
        y_train=y,
        size=args.population,
        seed=0,
        additional_parameters=dict(
            nodes=(3, 5),
            kernels_per_layer=tuple(args.kernels),
            kfold=args.kfold,
            epochs=tuple(args.epochs),
            learning_rate=tuple(args.lr),
            batch_size=args.batch_size,
            dense_units=args.dense_units,
            seed=0,
            mesh="auto" if args.device == "cuda" else "cpu",
        ),
    )
    ga = GeneticAlgorithm(pop, seed=0)
    if args.checkpoint:
        ckpt = Checkpointer(args.checkpoint)
        if ckpt.resume(ga):
            print(f"resumed at generation {ga.generation}")
        ga.set_checkpointer(ckpt)
    best = ga.run(args.generations)
    print(f"best architecture: {best.get_genes()}")
    print(f"best fitness (mean val acc): {best.get_fitness():.4f}")
    return {"best_genes": best.get_genes(), "best_fitness": best.get_fitness(),
            "generation": ga.generation}


if __name__ == "__main__":
    main()
