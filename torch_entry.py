"""Entry points of the PyTorch port: a single-card forward check and a dry run.

The port's counterparts of ``__graft_entry__.py``'s ``entry()`` and
``dryrun_multichip()`` (which drive the JAX package and stay as they are).

- :func:`entry` returns ``(forward, example_args)`` for the flagship
  ``MaskedGeneticCnn`` (BASELINE config #2: S=(3,4,5), filters (32,64,128),
  dense 256, 10 classes) with one genome, its initial params drawn as the
  fitness path draws them, on the CUDA card; ``device="cpu"`` asks for the
  CPU.  ``forward(*example_args)`` returns float32 logits ``(1, 8, 10)``.
- :func:`dryrun_multichip` runs one tiny complete k-fold CV (decode, masks,
  init, train steps, gradients, SGD, eval) through the production path on
  the card for ``n_devices=1``.  The port has no multi-card placement yet:
  ``n_devices > 1`` raises ``NotImplementedError``.
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


def dryrun_multichip(n_devices: int) -> None:
    """One tiny complete CV on the card; more than one card is not ported."""
    if n_devices != 1:
        raise NotImplementedError(
            f"dryrun_multichip({n_devices}): the port places work on one CUDA card; "
            "multi-card placement is not ported yet")
    from gentun_tpu_torch.models.cnn import GeneticCnnModel

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=64).astype(np.int32)
    genomes = [
        {"S_1": tuple(int(b) for b in rng.integers(0, 2, 3)),
         "S_2": tuple(int(b) for b in rng.integers(0, 2, 6)),
         "S_3": tuple(int(b) for b in rng.integers(0, 2, 10))}
        for _ in range(2)
    ]
    accs = GeneticCnnModel.cross_validate_population(
        x, y, genomes, nodes=(3, 4, 5), kernels_per_layer=(8, 8, 8), kfold=2, epochs=(1,),
        learning_rate=(0.05,), batch_size=16, dense_units=16, compute_dtype="float32", seed=0,
        mesh="auto")
    if accs.shape != (2,) or not np.isfinite(accs).all():
        raise RuntimeError(f"dryrun_multichip: bad accuracies {accs!r}")
    print(f"dryrun_multichip OK: 1 card, pop=2, accs={np.round(accs, 3)}")
