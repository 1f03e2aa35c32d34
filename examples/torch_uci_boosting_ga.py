"""BASELINE config #3 on the PyTorch/CUDA port: hyperparameter GA on UCI tables.

The port's counterpart of ``examples/uci_boosting_ga.py``, with the same
arguments and defaults.  The boosting species is the host-side control
path: its fitness is k-fold CV of a gradient-boosted tree model (real
``xgb.cv`` where xgboost is installed, sklearn's ``HistGradientBoosting``
otherwise) and never touches the card, so this example has no device to
choose.  The UCI wine and breast-cancer tables come with sklearn.

    python3 examples/torch_uci_boosting_ga.py --generations 10
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from gentun_tpu_torch import BoostingIndividual, GeneticAlgorithm, Population
from gentun_tpu_torch.utils.datasets import load_uci_binary, load_uci_wine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["wine", "binary"], default="wine")
    ap.add_argument("--generations", type=int, default=10)
    ap.add_argument("--population", type=int, default=20)
    ap.add_argument("--kfold", type=int, default=5)
    args = ap.parse_args(argv)

    x, y, meta = load_uci_wine() if args.dataset == "wine" else load_uci_binary()
    print(f"data: {meta['source']} ({x.shape[0]} rows, {x.shape[1]} features)")

    pop = Population(
        BoostingIndividual,
        x_train=x,
        y_train=y,
        size=args.population,
        seed=0,
        additional_parameters={"kfold": args.kfold, "seed": 0},
    )
    best = GeneticAlgorithm(pop, seed=0).run(args.generations)
    print(f"best hyperparameters: {best.get_genes()}")
    print(f"best fitness (CV accuracy): {best.get_fitness():.4f}")
    return {"best_genes": best.get_genes(), "best_fitness": best.get_fitness()}


if __name__ == "__main__":
    main()
