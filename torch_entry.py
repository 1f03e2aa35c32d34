"""Entry points of the PyTorch port: a single-card forward check and a dry run.

The port's counterparts of ``__graft_entry__.py``'s ``entry()`` and
``dryrun_multichip()`` (which drive the JAX package and stay as they are).

- :func:`entry` returns ``(forward, example_args)`` for the flagship
  ``MaskedGeneticCnn`` (BASELINE config #2: S=(3,4,5), filters (32,64,128),
  dense 256, 10 classes) with one genome, its initial params drawn as the
  fitness path draws them, on the CUDA card; ``device="cpu"`` asks for the
  CPU.  ``forward(*example_args)`` returns float32 logits ``(1, 8, 10)``.
- :func:`dryrun_multichip` runs one tiny complete k-fold CV (decode, masks,
  init, train steps, gradients, SGD, eval) through the production path:
  for ``n_devices=1`` in this process on the card; for ``n_devices > 1``
  as that many rank processes of one ``torch.distributed`` group (the
  port's unit is one process per card), on a ``(pop, data)`` mesh of
  ``(n/2, 2)`` ranks for even ``n``, so both axes run.  With ``n`` cards
  each rank takes its own over NCCL; with fewer, the ranks share the card
  over gloo, and the output says so.  ``device="cpu"`` runs the ranks on
  the CPU over gloo.
"""

from __future__ import annotations

import numpy as np

FLAGSHIP_GENES = {
    "S_1": (1, 0, 1),
    "S_2": (1, 1, 0, 1, 0, 1),
    "S_3": (1, 0, 1, 0, 1, 0, 1, 0, 1, 0),
}


def entry(device=None):
    """``(forward, (model, x, masks))`` for the flagship forward step."""
    import torch

    from gentun_tpu_torch.models import cnn
    from gentun_tpu_torch.ops.dag import stack_genome_masks

    dev = cnn._resolve_device("auto" if device is None else device)
    nodes = (3, 4, 5)
    model = cnn.MaskedGeneticCnn(nodes, (32, 64, 128), 1, (32, 32, 3), dense_units=256,
                                 n_classes=10, dropout_rate=0.5, compute_dtype="float32",
                                 device=dev)
    init = cnn._init_population_params(model, 1, 0, cnn._genome_hashes([FLAGSHIP_GENES]))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(init[name][0])
    masks = [{k: torch.as_tensor(v, device=dev) for k, v in stage.items()}
             for stage in stack_genome_masks([FLAGSHIP_GENES], nodes)]
    x = torch.zeros((8, 3, 32, 32), dtype=torch.float32, device=dev)

    @torch.no_grad()
    def forward(model, x, masks):
        with cnn.exact_numerics():
            return model(x, masks)

    return forward, (model, x, masks)


def _tiny_cv(mesh):
    """The dry run's workload: 4 genomes of S=(3,4,5), filters 8, on 64
    random 8×8×3 images, kfold 2, one epoch, float32."""
    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=64).astype(np.int32)
    genomes = [
        {"S_1": tuple(int(b) for b in rng.integers(0, 2, 3)),
         "S_2": tuple(int(b) for b in rng.integers(0, 2, 6)),
         "S_3": tuple(int(b) for b in rng.integers(0, 2, 10))}
        for _ in range(4)
    ]
    return GeneticCnnModel.cross_validate_population(
        x, y, genomes, nodes=(3, 4, 5), kernels_per_layer=(8, 8, 8), kfold=2, epochs=(1,),
        learning_rate=(0.05,), batch_size=16, dense_units=16, compute_dtype="float32", seed=0,
        mesh=mesh)


def _dryrun_rank(n_devices: int, rank: int, port: int, backend: str, device: str) -> None:
    """One rank of :func:`dryrun_multichip`'s group (run in its own process)."""
    from gentun_tpu_torch.parallel import mesh as mesh_mod
    from gentun_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", n_devices, rank, backend=backend)
    try:
        pop_axis = n_devices // 2 if n_devices % 2 == 0 else n_devices
        mesh = mesh_mod.auto_mesh(pop_axis=pop_axis, data_axis=n_devices // pop_axis,
                                  device=None if device == "auto" else device)
        accs = _tiny_cv(mesh)
        if accs.shape != (4,) or not np.isfinite(accs).all():
            raise RuntimeError(f"dryrun_multichip rank {rank}: bad accuracies {accs!r}")
        if multihost.is_leader():
            print(f"dryrun_multichip OK: {n_devices} ranks, backend {backend}, mesh "
                  f"{mesh.shape['pop']}x{mesh.shape['data']} on {mesh.device}, pop=4, "
                  f"accs={np.round(accs, 3)}", flush=True)
    finally:
        multihost.shutdown()


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0) -> None:
    """One tiny complete CV on the card (``n_devices=1``) or over ``n_devices``
    rank processes; raises when a rank fails or there is no card (unless
    ``device="cpu"``)."""
    import os
    import socket
    import subprocess
    import sys

    import torch

    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n == 1:
        accs = _tiny_cv("auto" if device is None else device)
        if accs.shape != (4,) or not np.isfinite(accs).all():
            raise RuntimeError(f"dryrun_multichip: bad accuracies {accs!r}")
        print(f"dryrun_multichip OK: 1 process, pop=4, accs={np.round(accs, 3)}")
        return
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"dryrun_multichip({n}): no CUDA device; pass device='cpu' to run the "
                "ranks on the CPU")
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= n else "gloo"
        if backend == "gloo":
            print(f"dryrun_multichip: {cards} card(s) for {n} ranks: the ranks share "
                  f"them over gloo (NCCL needs one card per rank)", flush=True)
    else:
        backend = "gloo"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    try:
        for rank in range(n):
            code = (f"import torch_entry; torch_entry._dryrun_rank({n}, {rank}, {port}, "
                    f"{backend!r}, {str(device or 'auto')!r})")
            procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=repo,
                                          env=dict(env, LOCAL_RANK=str(rank))))
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise RuntimeError(f"dryrun_multichip({n}): rank exit codes {rcs}")
