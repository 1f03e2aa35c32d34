"""BASELINE config #4 on the PyTorch/CUDA port: distributed search — master broker + GPU workers.

The port's counterpart of ``examples/distributed_search.py``, with the same
roles and arguments.  The broker is embedded in the master, so there are
two roles:

    # on the master host (no training data needed):
    python examples/torch_distributed_search.py master --port 5672 --password s3cret

    # on each GPU host (owns its copy of the data), one worker per card:
    python examples/torch_distributed_search.py worker --host <master-ip> \
        --port 5672 --password s3cret --capacity 20

    # or an all-in-one local demo (master + 2 in-process workers):
    python examples/torch_distributed_search.py demo

``--capacity 20`` lets one worker take a pop-20 generation at once and
train it as one population-batched program on its card.  The installable
worker (``python -m gentun_tpu_torch.distributed.worker``) takes the same
role with more options.  The jobs' device is part of the master's
configuration: ``--device cpu`` (master and demo) ships ``mesh="cpu"``, so
workers train on the CPU; the default is each worker's CUDA card, and a
worker without one fails its jobs with the device error.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import threading

CNN_PARAMS = dict(
    nodes=(3, 4, 5),
    kernels_per_layer=(32, 64, 128),
    kfold=2,
    epochs=(1,),
    learning_rate=(0.01,),
    batch_size=256,
    dense_units=256,
    compute_dtype="bfloat16",
    seed=0,
)


def _params(args, **overrides):
    params = dict(CNN_PARAMS, **overrides)
    if args.device == "cpu":
        params["mesh"] = "cpu"
    return params


def run_master(args):
    from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual
    from gentun_tpu_torch.distributed import DistributedPopulation

    with DistributedPopulation(
        GeneticCnnIndividual,
        size=args.population,
        seed=0,
        additional_parameters=_params(args),
        host="0.0.0.0",
        port=args.port,
        password=args.password or None,
        # A transient worker failure or straggler timeout re-ships only the
        # unfinished individuals instead of killing the run.
        evaluate_retries=3,
        # Architectures measured by any previous search against this store
        # are answered from the file and never reshipped.
        fitness_store=args.fitness_store or None,
        speculative_fill=args.speculative_fill,
    ) as pop:
        print(f"broker listening on port {pop.broker_address[1]}; waiting for workers")
        best = GeneticAlgorithm(pop, seed=0).run(args.generations)
        print(f"best architecture: {best.get_genes()}")
        print(f"best fitness: {best.get_fitness():.4f}")


def run_worker(args):
    from gentun_tpu_torch import GeneticCnnIndividual
    from gentun_tpu_torch.distributed import GentunClient
    from gentun_tpu_torch.utils.datasets import load_cifar10

    x, y, meta = load_cifar10(n=args.n_images)
    print(f"worker data: {meta['source']} ({len(x)} images)")
    GentunClient(
        GeneticCnnIndividual,
        x,
        y,
        host=args.host,
        port=args.port,
        password=args.password or None,
        capacity=args.capacity,
    ).work()


def run_demo(args):
    """Master + 2 worker threads in one process (localhost, small shapes)."""
    from gentun_tpu_torch import GeneticAlgorithm, GeneticCnnIndividual
    from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient
    from gentun_tpu_torch.utils.datasets import load_cifar10

    params = _params(args, nodes=tuple(args.nodes), kernels_per_layer=tuple(args.kernels),
                     dense_units=32, batch_size=args.batch_size)
    x, y, _ = load_cifar10(n=args.n_images)
    with DistributedPopulation(
        GeneticCnnIndividual, size=args.population, seed=0,
        additional_parameters=params, port=0,
    ) as pop:
        _, port = pop.broker_address
        stop = threading.Event()
        workers = [threading.Thread(
            target=lambda: GentunClient(
                GeneticCnnIndividual, x, y, port=port, capacity=3
            ).work(stop_event=stop),
            daemon=True,
        ) for _ in range(2)]
        for t in workers:
            t.start()
        try:
            best = GeneticAlgorithm(pop, seed=0).run(args.generations)
            print(f"demo best fitness: {best.get_fitness():.4f}")
        finally:
            stop.set()
            for t in workers:
                t.join(timeout=30)


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="role", required=True)
    m = sub.add_parser("master")
    m.add_argument("--port", type=int, default=5672)
    m.add_argument("--password", default="")
    m.add_argument("--population", type=int, default=20)
    m.add_argument("--generations", type=int, default=50)
    m.add_argument("--fitness-store", default="",
                   help="cross-run fitness store path (utils/fitness_store.py)")
    m.add_argument("--speculative-fill", action="store_true",
                   help="fill compile-bucket padding slots with speculative "
                        "elite mutants (free tail-generation cache warm-up)")
    w = sub.add_parser("worker")
    w.add_argument("--host", default="127.0.0.1")
    w.add_argument("--port", type=int, default=5672)
    w.add_argument("--password", default="")
    w.add_argument("--capacity", type=int, default=20)
    w.add_argument("--n-images", type=int, default=10_000)
    d = sub.add_parser("demo")
    d.add_argument("--generations", type=int, default=2)
    d.add_argument("--population", type=int, default=6)
    d.add_argument("--n-images", type=int, default=512)
    d.add_argument("--nodes", type=int, nargs="+", default=[3, 4, 5])
    d.add_argument("--kernels", type=int, nargs="+", default=[8, 8, 8])
    d.add_argument("--batch-size", type=int, default=64)
    for p in (m, d):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where workers train the jobs: the CUDA card "
                            "(default) or, when asked, the CPU")
    args = ap.parse_args(argv)
    {"master": run_master, "worker": run_worker, "demo": run_demo}[args.role](args)


if __name__ == "__main__":
    main()
