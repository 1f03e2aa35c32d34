"""Population-axis helpers for the batched trainer: pure host math.

The jax-free half of the JAX package's ``parallel/mesh.py``: compile-shape
bucketing (:func:`pop_bucket`), population padding (:func:`pad_population`)
and the per-genome cost model with its size classes
(:func:`cnn_genome_cost`, :func:`classify_genome_cost`).  The device half
(``auto_mesh``, ``shard_cv_args``: multi-device placement) is not ported
yet; the port runs on one device.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

__all__ = [
    "pad_population",
    "pop_bucket",
    "GenomeCost",
    "cnn_genome_cost",
    "classify_genome_cost",
    "SIZE_SMALL",
    "SIZE_BIG",
    "SIZE_MICRO",
    "SIZE_CLASSES",
]

#: Size classes the per-device memory budget sorts genomes into.  The class
#: decides the ``(pop, data)`` split: ``small`` keeps the wide-pop vmap
#: path (bit-identical to the pre-budget behavior), ``big`` runs one
#: genome per program with the batch sharded across the FULL data axis,
#: ``micro`` is ``big`` plus microbatch gradient accumulation.
SIZE_SMALL = "small"
SIZE_BIG = "big"
SIZE_MICRO = "micro"
SIZE_CLASSES = (SIZE_SMALL, SIZE_BIG, SIZE_MICRO)


def pop_bucket(n: int) -> int:
    """Round SMALL population batches up to a power of two (≤ 16).

    The population axis is a compile-time shape: a GA's later generations
    evaluate whatever the fitness cache didn't answer — small, varying
    batches (5, 2, 1, ...) — and each distinct size would otherwise pay a
    full XLA compile (minutes for CIFAR-scale configs).  Bucketing bounds a
    search to at most {2, 4, 8, 16} small shapes plus the full-population
    shape; waste is < 2× and only where the absolute cost is small.  Batches
    ≥ 16 stay exact — they are the dominant cost and occur at one stable
    size (the full population).

    The floor is 2, not 1: XLA compiles a singleton population axis to a
    different program (the vmap axis collapses) whose float rounding can
    flip a prediction vs the same genome trained in a wider batch —
    breaking the batch-composition purity that ``_genome_hashes`` buys
    (measured: one-sample accuracy flip at pop=1 on CPU).  Bucket 2 keeps
    every padded batch on the same multi-slot program family.

    The port runs eagerly and compiles nothing, but keeps the same buckets:
    the padded population is what the batched trainer runs, so the port's
    program shapes (and cuDNN's algorithm choices) follow the reference's.
    ``populations._compile_bucket`` mirrors it.
    """
    if n >= 16:
        return n
    b = 2
    while b < n:
        b *= 2
    return b


class GenomeCost(NamedTuple):
    """Per-genome memory footprint estimate, in bytes (pure host math).

    - ``param_bytes``: train-resident parameter state for ONE genome —
      params, SGD momentum, and one gradient tree, all float32.  Replicated
      along ``data``, so it never shrinks with the data axis.
    - ``act_bytes_per_example``: activations one training example keeps
      live for the backward pass, in the compute dtype.  Scales with the
      per-device batch shard, so the data axis divides it.
    """

    param_bytes: int
    act_bytes_per_example: int


def cnn_genome_cost(
    nodes: Sequence[int],
    filters: Sequence[int],
    input_shape: Sequence[int],
    dense_units: int,
    n_classes: int,
    compute_dtype: str = "bfloat16",
    stage_exit_conv: bool = False,
) -> GenomeCost:
    """Cost model for one ``MaskedGeneticCnn`` genome — integer math only.

    No device objects, cheap enough for a dispatch hot path.  Derived from the stage-DAG
    supergraph the evaluator actually compiles (``models/cnn.py``): every
    stage runs its entry conv plus ALL ``k`` node convs regardless of the
    mask bits (masks are data, not structure), so the footprint is a
    function of the config's widths, not of which edges a genome enables.

    Parameter state counts 3× float32 (params + momentum + grads);
    activations count one live copy per conv output per example at the
    stage's spatial resolution (halved by each 2×2 pool), in the compute
    dtype.  A model, not a measurement — monotone in stage widths, node
    counts, and batch size, which is all classification needs.
    """
    dtype_bytes = 2 if "16" in str(compute_dtype) else 4
    h, w = int(input_shape[0]), int(input_shape[1])
    c_in = int(input_shape[2]) if len(input_shape) > 2 else 1
    param_count = 0
    act_per_ex = h * w * c_in * dtype_bytes  # the input itself
    for k, f in zip(nodes, filters):
        k, f = int(k), int(f)
        param_count += 9 * c_in * f + f          # entry Conv3x3
        param_count += k * (9 * f * f + f)       # node Conv3x3s
        if stage_exit_conv:
            param_count += 9 * f * f + f
        # Live conv outputs per example: entry + k nodes + merged output
        # (+ the optional exit conv), all at (h, w, f).
        act_per_ex += (k + 2 + (1 if stage_exit_conv else 0)) * h * w * f * dtype_bytes
        h, w = max(1, h // 2), max(1, w // 2)    # 2x2 max-pool
        c_in = f
    flat = h * w * c_in
    param_count += flat * int(dense_units) + int(dense_units)
    param_count += int(dense_units) * int(n_classes) + int(n_classes)
    act_per_ex += (flat + int(dense_units)) * dtype_bytes + int(n_classes) * 4
    return GenomeCost(int(3 * 4 * param_count), int(act_per_ex))


def classify_genome_cost(
    cost: GenomeCost,
    batch_size: int,
    n_devices: int,
    budget_bytes: int,
) -> Tuple[str, int]:
    """Sort one genome's cost against a per-device budget → ``(class, microbatch)``.

    - ``small``: params + full-batch activations fit one device (<= budget,
      so an exactly-at-budget genome stays on the wide-pop path);
      microbatch 1.
    - ``big``: fits only with the per-step batch sharded across the FULL
      data axis of ``n_devices`` (params replicate; activations divide);
      microbatch 1.
    - ``micro``: even a full-axis batch shard oversubscribes — returns the
      smallest divisor of ``batch_size`` whose per-device micro-slice fits,
      for gradient accumulation.

    A genome that cannot hold its parameter state plus ONE example within
    the budget is unevaluable at any factoring: loud ``ValueError``, never
    a silent misclassification.
    """
    b = int(batch_size)
    n = max(1, int(n_devices))
    budget = int(budget_bytes)
    if b < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if budget < 1:
        raise ValueError(f"device budget must be positive bytes, got {budget_bytes}")
    if cost.param_bytes + cost.act_bytes_per_example * b <= budget:
        return SIZE_SMALL, 1
    avail = budget - cost.param_bytes
    if avail < cost.act_bytes_per_example:
        raise ValueError(
            f"device budget {budget} bytes cannot hold this genome's parameter "
            f"state ({cost.param_bytes} bytes) plus one training example "
            f"({cost.act_bytes_per_example} bytes of activations) — the genome "
            f"is unevaluable at any (pop, data) factoring; raise the budget or "
            f"shrink the architecture")
    per_shard = -(-b // n)  # ceil: examples per device at the full data axis
    if cost.act_bytes_per_example * per_shard <= avail:
        return SIZE_BIG, 1
    for a in range(2, b + 1):
        if b % a == 0 and cost.act_bytes_per_example * (-(-(b // a) // n)) <= avail:
            return SIZE_MICRO, a
    return SIZE_MICRO, b  # a=b always fits per the one-example check above


def pad_population(genomes: Sequence[Any], multiple: int) -> Tuple[List[Any], int]:
    """Pad the genome list to a multiple of the pop-axis size.

    Padding repeats the last genome; callers slice the results back to the
    original length.  Returns (padded_list, original_length).
    """
    n = len(genomes)
    if multiple <= 1 or n % multiple == 0:
        return list(genomes), n
    padded = list(genomes) + [genomes[-1]] * (multiple - n % multiple)
    return padded, n
