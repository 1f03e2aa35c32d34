"""The ``(pop, data)`` mesh of the batched trainer, and its host math.

The host half is pure integer math that the dispatch plane uses without
touching a device: compile-shape bucketing (:func:`pop_bucket`), population
padding (:func:`pad_population`), the per-genome cost model with its size
classes (:func:`cnn_genome_cost`, :func:`classify_genome_cost`), and the
mesh arithmetic (:func:`mesh_factor`, :func:`host_worker_capacity`,
:func:`job_size_class`, the worker's ``--mesh`` override).

The device half lays an evaluation over the ranks of a ``torch.distributed``
group, one rank per card (``multihost.py``).  :func:`auto_mesh` factors the
world into a :class:`Mesh`: rank ``r`` sits at row ``r // data`` of the
``pop`` axis and column ``r % data`` of the ``data`` axis.  A pop row trains
its own slice of the population with no communication; the ranks of a row
split each step's batch and all-reduce the gradients over the row's group.
:func:`shard_cv_args` cuts one rank's share out of a CV call's inputs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

__all__ = [
    "Mesh",
    "auto_mesh",
    "mesh_axis_sizes",
    "shard_cv_args",
    "pad_population",
    "pop_bucket",
    "mesh_factor",
    "host_worker_capacity",
    "job_size_class",
    "parse_mesh_spec",
    "set_mesh_override",
    "get_mesh_override",
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


def _largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap (>=1)."""
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def mesh_factor(n_devices: int, pop_size: Optional[int] = None,
                size_class: str = "small") -> Tuple[int, int]:
    """The ``(pop, data)`` factoring of ``n_devices`` devices.

    Pure integer math — no device objects, no backend init — so the
    dispatch plane (worker capacity derivation, broker-side sizing) can
    reason about mesh shapes without touching a device.  :func:`auto_mesh`
    builds its mesh from this factoring, so a worker's advertised mesh shape
    and its evaluation mesh agree.

    ``size_class`` (see :data:`SIZE_CLASSES`) flips the preference: the
    default ``small`` puts devices on the communication-free ``pop`` axis
    first; ``big``/``micro`` pin the narrow-pop ``(1, n)`` extreme so an
    over-budget genome's activations shard across the FULL data axis.
    """
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if size_class not in SIZE_CLASSES:
        raise ValueError(
            f"size_class must be one of {SIZE_CLASSES}, got {size_class!r}")
    if size_class != SIZE_SMALL:
        return 1, n
    cap = n if pop_size is None else max(1, int(pop_size))
    pop_axis = _largest_divisor_leq(n, cap)
    return pop_axis, n // pop_axis


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
    shapes follow the reference's.  Its fitnesses do not depend on the
    bucket (a slot's arithmetic is the same at any width).
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


#: Memo for :func:`job_size_class`, keyed on the cost-relevant wire-config
#: values.  A generation ships ONE ``additional_parameters`` config for its
#: whole population, so the dispatch hot path (one classify per dispatched
#: job) is a pure cache hit in steady state — what keeps the per-job cost
#: inside the ≤2 %-of-dispatch gate (``scripts/broker_throughput.py``).
#: Bounded: distinct configs are one-per-session-generation rare, but a
#: hostile stream of unique configs must not grow the broker unboundedly.
_JOB_CLASS_CACHE: Dict[tuple, str] = {}
_JOB_CLASS_CACHE_MAX = 4096


def _hashable(v: Any) -> Any:
    return tuple(v) if isinstance(v, list) else v


def job_size_class(params: Optional[Mapping[str, Any]], n_devices: int = 1) -> str:
    """Size class for a dispatch-plane job from its wire config dict.

    The jax-free entry point the broker's dispatch counter, the worker's
    ``_chunk_jobs``, and the master's fill target share.  Returns
    ``small`` whenever the feature is off (no ``device_budget`` in the
    shipped config) or the config lacks the fields the cost model needs
    (``input_shape``/``n_classes`` are usually inferred worker-side from
    the data) — degrading exactly like the broker's ``_parse_mesh``
    treats a malformed mesh advert, because dispatch must route jobs from
    any master version, while the evaluator's own classification stays
    loud (``models/cnn.py``).  Note ``small`` vs not is independent of
    ``n_devices``; the axis width only moves the big/micro boundary.
    """
    if not params:
        return SIZE_SMALL
    budget = params.get("device_budget")
    if not budget:
        return SIZE_SMALL
    try:
        input_shape = params.get("input_shape")
        n_classes = params.get("n_classes")
        if not input_shape or not n_classes:
            return SIZE_SMALL
        key = (
            _hashable(params.get("nodes")),
            _hashable(params.get("kernels_per_layer")),
            _hashable(input_shape),
            n_classes,
            params.get("dense_units"),
            params.get("batch_size"),
            params.get("compute_dtype"),
            params.get("stage_exit_conv"),
            budget,
            n_devices,
        )
        hit = _JOB_CLASS_CACHE.get(key)
        if hit is not None:
            return hit
        cost = cnn_genome_cost(
            tuple(params.get("nodes", (3, 5))),
            tuple(params.get("kernels_per_layer", (20, 50))),
            tuple(input_shape),
            int(params.get("dense_units", 500)),
            int(n_classes),
            str(params.get("compute_dtype", "bfloat16")),
            bool(params.get("stage_exit_conv", False)),
        )
        klass, _ = classify_genome_cost(
            cost, int(params.get("batch_size", 128)), n_devices, int(budget))
        if len(_JOB_CLASS_CACHE) >= _JOB_CLASS_CACHE_MAX:
            _JOB_CLASS_CACHE.clear()
        _JOB_CLASS_CACHE[key] = klass
        return klass
    except (TypeError, ValueError):
        # Unevaluable or malformed configs still need a dispatch decision;
        # the worker's evaluator raises the loud error with full context.
        return SIZE_SMALL


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """Parse the operator mesh override ``"POPxDATA"`` → ``(pop, data)``.

    Loud ``ValueError`` on anything malformed or non-positive; the worker
    CLI converts it to ``SystemExit``.  Whether the product factors the
    actual device count is checked where the count is known
    (``GentunClient._derive_mesh_capacity``), so a stale
    override is re-validated on every :meth:`GentunClient.remesh`.
    """
    parts = str(spec).strip().lower().split("x")
    if len(parts) != 2:
        raise ValueError(
            f"mesh override must be 'POPxDATA' (e.g. '4x2'), got {spec!r}")
    try:
        pop_axis, data_axis = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"mesh override must be 'POPxDATA' with integer axes, got {spec!r}")
    if pop_axis < 1 or data_axis < 1:
        raise ValueError(
            f"mesh override axes must be positive, got {pop_axis}x{data_axis}")
    return pop_axis, data_axis


#: Process-wide operator mesh override (worker ``--mesh POPxDATA``).
#: Read by the worker's capacity derivation when the caller pins no
#: explicit axes; it never rides the wire config (cache keys and fitness
#: fingerprints stay untouched).
_MESH_OVERRIDE: Optional[Tuple[int, int]] = None


def set_mesh_override(axes: Optional[Tuple[int, int]]) -> None:
    """Install (or clear, with ``None``) the process-wide mesh override."""
    global _MESH_OVERRIDE
    if axes is not None:
        pop_axis, data_axis = int(axes[0]), int(axes[1])
        if pop_axis < 1 or data_axis < 1:
            raise ValueError(
                f"mesh override axes must be positive, got {pop_axis}x{data_axis}")
        axes = (pop_axis, data_axis)
    _MESH_OVERRIDE = axes


def get_mesh_override() -> Optional[Tuple[int, int]]:
    return _MESH_OVERRIDE


def host_worker_capacity(n_devices: int, slots_per_device: int = 2,
                         size_class: str = SIZE_SMALL,
                         pop_axis: Optional[int] = None,
                         data_axis: Optional[int] = None) -> Tuple[int, int, int]:
    """Derive a host-level worker's capacity from its local device mesh.

    Returns ``(capacity, pop_axis, data_axis)``.  The host (not the chip)
    is the unit of fleet membership: one worker drives every local device
    through the ``(pop, data)`` mesh, and its dispatch window must be a
    shape the compiled evaluator actually wants — so capacity is derived,
    never typed in:

    - start from ``slots_per_device × pop_axis`` (default 2 per device:
      the compile-bucket floor, so even a 1-device host evaluates on the
      stable multi-slot program family);
    - round up to the compile bucket (:func:`pop_bucket`), so a full
      window is one already-cached compile shape;
    - if the bucket shape and the pop-axis size disagree (non-power-of-two
      device counts), step up into the exact-shape regime (≥ 16) and round
      to the next pop-axis multiple — every full window then shards with
      ZERO padding waste.

    Power-of-two hosts land on {2, 4, 8, 16} for 1/2/4/8 devices: always
    a compile bucket AND a pop-axis multiple, so steady-state windows
    never pad and never recompile.

    ``size_class`` derives the per-class window instead: ``big``/``micro``
    jobs run one genome per program on a ``(1, n_devices)`` mesh, so the
    window is exactly 1 — no bucketing, no padding, the frame IS the job.
    Explicit ``pop_axis``/``data_axis`` (the worker's ``--mesh POPxDATA``
    override) replace the heuristic factoring for the small class; their
    product must equal ``n_devices`` (loud ``ValueError`` otherwise, which
    ``remesh()`` re-raises if the device count changed under an override).
    """
    n = int(n_devices)
    if size_class not in SIZE_CLASSES:
        raise ValueError(
            f"size_class must be one of {SIZE_CLASSES}, got {size_class!r}")
    if size_class != SIZE_SMALL:
        return 1, 1, n
    if pop_axis is not None or data_axis is not None:
        if pop_axis is None or data_axis is None:
            raise ValueError(
                "mesh override requires both pop_axis and data_axis")
        pop_axis, data_axis = int(pop_axis), int(data_axis)
        if pop_axis < 1 or data_axis < 1:
            raise ValueError(
                f"mesh override axes must be positive, got {pop_axis}x{data_axis}")
        if pop_axis * data_axis != n:
            raise ValueError(
                f"mesh override {pop_axis}x{data_axis} does not factor "
                f"{n} local devices")
    else:
        pop_axis, data_axis = mesh_factor(n)
    cap = pop_axis * max(1, int(slots_per_device))
    b = pop_bucket(cap)
    if b % pop_axis:
        b = max(16, cap)
        b += (-b) % pop_axis
    return b, pop_axis, data_axis


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


# ---------------------------------------------------------------------------
# The device half: a (pop, data) grid of ranks
# ---------------------------------------------------------------------------


class Mesh:
    """A ``(pop, data)`` grid of the world's ranks, seen from this rank.

    ``shape`` is ``{"pop": P, "data": D}``; this rank sits at ``row`` (its
    slice of the population) and ``col`` (its share of every batch);
    ``device`` is where it computes; ``data_group`` is the process group of
    its row (``None`` when ``D`` is 1: a row of one rank needs no
    collective).
    """

    def __init__(self, pop_axis: int, data_axis: int, rank: int, device, data_group):
        self.shape = {"pop": int(pop_axis), "data": int(data_axis)}
        self.row, self.col = divmod(int(rank), int(data_axis))
        self.device = device
        self.data_group = data_group

    @property
    def row_leaders(self) -> List[int]:
        """The rank at column 0 of each row, in row order."""
        return [r * self.shape["data"] for r in range(self.shape["pop"])]

    def __repr__(self) -> str:
        return (f"Mesh(pop={self.shape['pop']}, data={self.shape['data']}, "
                f"row={self.row}, col={self.col}, device={self.device})")


def auto_mesh(
    pop_size: Optional[int] = None,
    pop_axis: Optional[int] = None,
    data_axis: Optional[int] = None,
    size_class: str = SIZE_SMALL,
    device=None,
) -> Optional[Mesh]:
    """Factor the world's ranks into a ``(pop, data)`` mesh.

    Preference order: put ranks on the communication-free ``pop`` axis (up
    to ``pop_size``); spill the rest onto ``data``.  Returns ``None`` when
    the world is one process, so one card stays annotation-free.

    Explicit ``pop_axis``/``data_axis`` override the heuristic (their
    product must equal the world size; non-positive values are a loud
    ``ValueError`` on every world size).  When the caller pins no axes, the
    process-wide operator override (:func:`set_mesh_override`, the worker's
    ``--mesh POPxDATA``) applies; ``size_class`` ``big`` or ``micro`` beats
    both and forces ``(1, world)``, so the batch spreads over every rank.
    ``device`` is where this rank computes (default: its card,
    ``multihost.local_device``).  Collective on first use of a shape: every
    rank calls it with the same arguments.
    """
    from . import multihost

    for name, axis in (("pop_axis", pop_axis), ("data_axis", data_axis)):
        if axis is not None and axis < 1:
            raise ValueError(
                f"{name} must be a positive integer, got {axis} "
                f"(omit the argument to let auto_mesh factor the ranks itself)")
    if size_class not in SIZE_CLASSES:
        raise ValueError(
            f"size_class must be one of {SIZE_CLASSES}, got {size_class!r}")
    n = multihost.process_count()
    if n == 1:
        return None
    if size_class != SIZE_SMALL:
        pop_axis, data_axis = 1, n
    elif pop_axis is None and data_axis is None and _MESH_OVERRIDE is not None:
        pop_axis, data_axis = _MESH_OVERRIDE
    if pop_axis is not None or data_axis is not None:
        if pop_axis is None:
            pop_axis = n // data_axis
        elif data_axis is None:
            data_axis = n // pop_axis
        if pop_axis * data_axis != n:
            raise ValueError(f"pop_axis*data_axis = {pop_axis}*{data_axis} != {n} ranks")
    else:
        pop_axis, data_axis = mesh_factor(n, pop_size)
    if device is None:
        device = multihost.local_device()
    return Mesh(pop_axis, data_axis, multihost.process_index(), device,
                multihost.row_group(pop_axis, data_axis))


def mesh_axis_sizes(mesh: Optional[Mesh]) -> Tuple[int, int]:
    if mesh is None:
        return 1, 1
    return mesh.shape["pop"], mesh.shape["data"]


def data_shard(n: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """``[lo, hi)``: this rank's rows of ``n`` split over the data axis in
    contiguous shares that differ by at most one row."""
    if mesh is None:
        return 0, n
    d, c = mesh.shape["data"], mesh.col
    q, r = divmod(int(n), d)
    lo = c * q + min(c, r)
    return lo, lo + q + (1 if c < r else 0)


def shard_cv_args(
    mesh: Mesh,
    params: Optional[Mapping[str, Any]],
    masks_stacked: List[Dict[str, Any]],
    hashes,
    batch_idx,
    microbatch: int = 1,
):
    """This rank's share of a batched CV call's inputs.

    Layouts as the executor builds them (``models/cnn.py``): ``params``
    ``(kfold, P, ...)``, masks ``(P, ...)``, ``hashes (P, 2)``,
    ``batch_idx (kfold, steps, batch)``.

    - ``params``, masks and ``hashes``: the pop row's slice of the P slots.
      A slot's initial params and its per-(fold, genome) dropout generators
      are seeded from its hash alone, so slicing the hashes slices both
      (``params=None`` when the caller draws them from the row's hashes).
    - ``batch_idx``: the data column's rows of each step, taken inside each
      of the ``microbatch`` slices, so a micro-slice's share is the
      column's share of that slice.
    - The dataset and the validation rows are replicated: the caller places
      them whole on each rank (one upload per rank).

    Returns ``(params, masks, hashes, batch_idx, batch_rows)``;
    ``batch_rows`` is ``(lo, hi, n)``: this rank holds rows ``[lo, hi)`` of
    each micro-slice of ``n`` rows, which the train step needs to draw the
    one-process dropout stream and to divide each loss by the whole slice.
    """
    pop = mesh.shape["pop"]
    n_slots = len(hashes)
    if n_slots % pop:
        raise ValueError(f"{n_slots} population slots do not divide over a pop axis of {pop}")
    per = n_slots // pop
    rows = slice(mesh.row * per, (mesh.row + 1) * per)
    if params is not None:
        params = {k: v[:, rows] for k, v in params.items()}
    masks = [{k: v[rows] for k, v in stage.items()} for stage in masks_stacked]
    kfold, steps, batch = batch_idx.shape
    micro = batch // int(microbatch)
    lo, hi = data_shard(micro, mesh)
    local = batch_idx.reshape(kfold, steps, int(microbatch), micro)[..., lo:hi]
    return (params, masks, hashes[rows],
            local.reshape(kfold, steps, int(microbatch) * (hi - lo)), (lo, hi, micro))
