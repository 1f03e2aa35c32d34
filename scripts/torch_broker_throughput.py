"""Control-plane throughput: how many fitness jobs/sec can the broker move?

One H100 ("NVIDIA H100 80GB HBM3, 700.00 W") evaluates config #2's proxy
cell at 16,353.0 individuals/hour ≈ 4.54 jobs/sec *per card*
(``chip_smoke.py`` phase 3).  This micro-benchmark measures the
master-side ceiling — the embedded asyncio TCP/JSON broker moving
genes-out/fitness-back round trips through real sockets against real
``GentunClient`` workers running trivial evaluations — so the "broker
feeds N cards" claim in the docs is a measured number, not a hope.

CPU-only, a few seconds: `python scripts/torch_broker_throughput.py`.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import statistics
import sys
import threading
import time
import timeit

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import Individual, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import GentunClient, JobBroker  # noqa: E402
from gentun_tpu_torch.telemetry import lineage  # noqa: E402
from gentun_tpu_torch.telemetry import spans as spans_mod  # noqa: E402
from gentun_tpu_torch.telemetry.registry import get_registry  # noqa: E402


#: Config #2's proxy evaluations a second on one card: 16,353.0 individuals
#: an hour on "NVIDIA H100 80GB HBM3, 700.00 W" (``chip_smoke.py`` phase 3).
CARD_PROXY_JOBS_PER_S = 16_353.0 / 3600.0


class NoopIndividual(Individual):
    def build_spec(self, **params):
        return genetic_cnn_genome((4, 4))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


def run(n_jobs: int = 2000, n_workers: int = 4, capacity: int = 16,
        n_sessions: int = 1, trace_ctx: bool = False,
        forensics: bool = False) -> dict:
    """One benchmark pass.  ``n_sessions=1`` is the single-tenant path
    (the fair-share scheduler degenerates to FIFO: one lane, no quota or
    weight bookkeeping on the hot path); ``n_sessions>1`` splits the same
    job count across that many open sessions round-robin, exercising the
    weighted-DRR dispatch lanes + per-session books for real — the delta
    between the two is the multi-tenant scheduler's per-job overhead.

    ``trace_ctx`` propagates a per-job trace context the way the master
    submit paths do; ``forensics`` additionally turns the lineage plane on
    for the pass (per-job ``dispatched`` ledger records broker-side,
    per-job ``device`` spans worker-side, chip-second billing on ingest) —
    the pair measures the search-forensics plane's broker overhead."""
    data = (np.zeros(1, np.float32), np.zeros(1, np.float32))
    rng = np.random.default_rng(0)
    payloads = {
        f"j{i}": {
            "genes": {
                "S_1": [int(b) for b in rng.integers(0, 2, 6)],
                "S_2": [int(b) for b in rng.integers(0, 2, 6)],
            },
            "additional_parameters": {"nodes": (4, 4)},
        }
        for i in range(n_jobs)
    }
    # Telemetry on for the duration: the broker stamps each dispatch and
    # observes the result round trip into the ``dispatch_rtt_s`` histogram,
    # so the benchmark reports per-job control-plane latency percentiles
    # alongside aggregate throughput.  Under the default worker prefetch
    # the RTT includes local-queue residence on the worker — it measures
    # the full dispatch→result pipeline, not socket latency alone.
    get_registry().reset()
    spans_mod.enable()
    if forensics:
        lineage.reset_ledger()
        lineage.enable()
    if trace_ctx:
        # Both gate passes carry a trace context so their wire frames are
        # comparable; forensic_context stamps the fz flag only when the
        # lineage plane is on — the master submit paths' exact contract.
        for i, payload in enumerate(payloads.values()):
            payload["trace"] = lineage.forensic_context(
                {"trace_id": f"bench{i:05d}", "span_id": f"b{i:05d}"})
    broker = JobBroker(port=0).start()
    stop = threading.Event()
    threads = []
    try:
        _, port = broker.address
        for _ in range(n_workers):
            t = threading.Thread(
                target=lambda: GentunClient(
                    NoopIndividual, *data, port=port, capacity=capacity,
                    heartbeat_interval=1.0, reconnect_delay=0.1,
                ).work(stop_event=stop),
                daemon=True,
            )
            t.start()
            threads.append(t)
        t0 = time.monotonic()
        if n_sessions > 1:
            sessions = [broker.open_session(f"bench-{s}") for s in range(n_sessions)]
            shares = [{} for _ in sessions]
            for i, (job_id, payload) in enumerate(payloads.items()):
                shares[i % n_sessions][job_id] = payload
            for sess, share in zip(sessions, shares):
                broker.submit(share, session=sess)
        else:
            broker.submit(payloads)
        results = broker.gather(list(payloads), timeout=120.0)
        wall = time.monotonic() - t0
        assert len(results) == n_jobs
        rtt = get_registry().histogram("dispatch_rtt_s")
        out: dict = {
            "n_jobs": n_jobs,
            "n_workers": n_workers,
            "capacity": capacity,
            "n_sessions": n_sessions,
            "wall_s": round(wall, 3),
            "jobs_per_sec": round(n_jobs / wall, 1),
            # one card consumes CARD_PROXY_JOBS_PER_S proxy jobs/sec
            "chips_fed_at_proxy_rate": int(n_jobs / wall / CARD_PROXY_JOBS_PER_S),
            "dispatch_rtt_s": {
                "count": rtt.count,
                "p50": round(rtt.quantile(0.50), 6),
                "p90": round(rtt.quantile(0.90), 6),
                "p99": round(rtt.quantile(0.99), 6),
            },
        }
        if forensics:
            # Proof the pass really paid the forensics bill: every job's
            # device span was shipped home and charged to the ledger.
            out["device_spans_billed"] = len(lineage.get_ledger().cells())
        return out
    finally:
        stop.set()
        broker.stop()
        spans_mod.disable()
        if forensics:
            lineage.disable()
            lineage.reset_ledger()


def run_forensics_gate(n_pairs: int = 5, batch_jobs: int = 2000,
                       n_workers: int = 4, capacity: int = 16) -> dict:
    """Lineage-on vs lineage-off dispatch overhead, measured honestly on a
    one-core CI box.

    Two instruments, because the box cannot resolve the signal end to end:

    1. **A/B rates (informational)** — ONE broker and fleet stay alive and
       alternating off/on batches flow through it in an ABBA ladder
       (off,on / on,off / ...) so monotonic drift cancels instead of
       always taxing one side, with ``gc.collect()`` leveling the
       collector between batches and the first (warmup) pair excluded.
       Even so, per-batch rates on a contended single core swing +-8% —
       an order of magnitude above the true ~0.5% signal — so these rates
       bound the overhead but cannot gate at 2%.

    2. **The gate** — the exact instructions lineage-on adds per
       dispatched job (one ``dispatched`` ledger record; the per-frame
       device-span scan at ingest) are timed directly (micro-timed over
       20k calls, deterministic to sub-percent), and divided by the
       measured per-job dispatch cost from the A/B off batches.  In the
       saturated single-core limit, added-CPU-per-job over cost-per-job
       IS the throughput delta — computed at a resolution wall-clock A/B
       cannot reach, and conservatively (noise cannot push it negative,
       and every added instruction counts)."""
    data = (np.zeros(1, np.float32), np.zeros(1, np.float32))
    rng = np.random.default_rng(1)
    get_registry().reset()
    spans_mod.enable()
    lineage.reset_ledger()
    broker = JobBroker(port=0).start()
    stop = threading.Event()
    rates: dict = {"off": [], "on": []}
    try:
        _, port = broker.address
        for _ in range(n_workers):
            threading.Thread(
                target=lambda: GentunClient(
                    NoopIndividual, *data, port=port, capacity=capacity,
                    heartbeat_interval=1.0, reconnect_delay=0.1,
                ).work(stop_event=stop),
                daemon=True,
            ).start()
        batch = 0
        for pair in range(n_pairs):
            order = ("off", "on") if pair % 2 == 0 else ("on", "off")
            for side in order:
                gc.collect()
                if side == "on":
                    lineage.enable()
                payloads = {
                    f"g{batch}-{i}": {
                        "genes": {
                            "S_1": [int(b) for b in rng.integers(0, 2, 6)],
                            "S_2": [int(b) for b in rng.integers(0, 2, 6)],
                        },
                        "additional_parameters": {"nodes": (4, 4)},
                    }
                    for i in range(batch_jobs)
                }
                t0 = time.monotonic()
                broker.submit(payloads)
                results = broker.gather(list(payloads), timeout=120.0)
                wall = time.monotonic() - t0
                if side == "on":
                    lineage.disable()
                assert len(results) == batch_jobs
                if pair >= 1:  # the first pair is warmup
                    rates[side].append(round(batch_jobs / wall, 1))
                batch += 1
    finally:
        stop.set()
        broker.stop()
        spans_mod.disable()
        lineage.disable()
        lineage.reset_ledger()
    pair_deltas = [round((off - on) / off * 100.0, 2)
                   for off, on in zip(rates["off"], rates["on"])]

    # -- the gate: directly timed per-job lineage cost ---------------------
    spans_mod.enable()
    lineage.enable()
    try:
        n = 20000
        t_record_s = timeit.timeit(
            lambda: lineage.record(
                "dispatched", "0123456789abcdef", job="j-bench",
                worker="bench-w0", rung=0, session=None),
            number=n) / n
        # Representative worker report frame: the spans a capacity-16 batch
        # ships home with NO device spans in it (raw-submit masters never
        # stamp the fz flag) — the scan is the only on-cost at ingest.
        frame = [{"type": "span", "kind": k, "dur_s": 0.001, "attrs": {}}
                 for k in ("eval", "train", "train", "train")]
        t_scan_s = timeit.timeit(
            lambda: lineage.observe_records(frame, "bench-w0"),
            number=n) / n
    finally:
        lineage.disable()
        spans_mod.disable()
    per_job_added_us = round((t_record_s + t_scan_s / capacity) * 1e6, 3)
    off_median = statistics.median(rates["off"])
    per_job_dispatch_us = round(1e6 / off_median, 1)
    overhead_pct = round(per_job_added_us / per_job_dispatch_us * 100.0, 3)
    return {
        "n_pairs": n_pairs,
        "batch_jobs": batch_jobs,
        "ab_off_jobs_per_sec": rates["off"],
        "ab_on_jobs_per_sec": rates["on"],
        "ab_pair_overhead_pct": pair_deltas,
        "per_job_dispatch_us": per_job_dispatch_us,
        "per_job_added_us": per_job_added_us,
        "dispatched_record_us": round(t_record_s * 1e6, 3),
        "ingest_scan_us_per_frame": round(t_scan_s * 1e6, 3),
        "overhead_pct": overhead_pct,
        "gate_max_pct": 2.0,
        "within_gate": overhead_pct <= 2.0,
    }


def run_compile_probe_gate(per_job_dispatch_us: float,
                           capacity: int = 16) -> dict:
    """Compile-cache probe overhead on the dispatch hot path, micro-timed.

    A worker with ``--compile-cache-url`` runs one ``scan_publish()``
    after every evaluation batch (client.py ``_evaluate_batch``).  In the
    steady state — nothing newly compiled — that call is a single
    ``os.stat`` on the kernel cache dir and an mtime compare, and THAT is
    the only recurring cost the compile cache adds to the dispatch loop
    (prefetch runs once per join/remesh, publishes ride a background
    flusher).  Same instrument as the forensics gate: time the probe
    directly over 20k calls, amortize over the batch (one probe serves
    ``capacity`` jobs), divide by the measured per-job dispatch cost —
    deterministic on a one-core box where wall-clock A/B is +-8% noise."""
    import tempfile

    from gentun_tpu_torch.distributed.compile_service import (
        CompileService,
        CompileServiceClient,
    )

    svc = CompileService(port=0).start()
    tmp = tempfile.mkdtemp(prefix="compile-probe-")
    try:
        client = CompileServiceClient(svc.url, cache_dir=tmp,
                                      fingerprint="bench-fp")
        # A realistic warm state: entries exist, were published, and the
        # dir mtime is settled — every timed call takes the no-op path.
        for i in range(4):
            with open(os.path.join(tmp, f"entry_{i}"), "wb") as fh:
                fh.write(b"b" * 4096)
        client.scan_publish()
        assert client.flush(10.0)
        assert client.scan_publish() == 0  # steady state reached
        n = 20000
        t_probe_s = timeit.timeit(client.scan_publish, number=n) / n
        client.close()
    finally:
        svc.stop()
    probe_us = round(t_probe_s * 1e6, 3)
    per_job_added_us = round(t_probe_s / capacity * 1e6, 3)
    overhead_pct = round(per_job_added_us / per_job_dispatch_us * 100.0, 3)
    return {
        "probe_us": probe_us,
        "batch_capacity": capacity,
        "per_job_added_us": per_job_added_us,
        "per_job_dispatch_us": per_job_dispatch_us,
        "overhead_pct": overhead_pct,
        "gate_max_pct": 2.0,
        "within_gate": overhead_pct <= 2.0,
    }


def run_surrogate_gate(per_job_dispatch_us: float) -> dict:
    """Score-on-breed hot-path cost of the surrogate rung −1, micro-timed.

    A gated master (``AsyncEvolution(surrogate=...)``) pays one
    ``SurrogateGate.decide`` per bred child: encode the genome, dot it
    against the ridge weights, bisect the score into the rolling window,
    take the quantile cut, and park the pending decision.  Same
    instrument as the forensics/compile gates: the call is timed directly
    over 20k invocations against a TRAINED model with a FULL window (the
    steady-state worst case — an untrained or degraded gate short-circuits
    to admit-all) on the standard 12-bit (4,4) stage-DAG genome, then
    divided by the measured per-job dispatch cost — deterministic where
    wall-clock A/B on this box is +-8% noise."""
    from gentun_tpu_torch.surrogate import FitnessSurrogate, SurrogateGate

    rng = np.random.default_rng(7)
    genomes = [
        {"S_1": tuple(int(b) for b in rng.integers(0, 2, 6)),
         "S_2": tuple(int(b) for b in rng.integers(0, 2, 6))}
        for _ in range(64)
    ]
    gate = SurrogateGate(FitnessSurrogate(min_train=32, refit_every=32),
                         eta=4, window=64, min_window=16)
    gate.prepare(genomes[0], maximize=True)
    for g in genomes:
        gate.observe_result(g, 0, float(sum(sum(v) for v in g.values())))
    assert gate.surrogate.trained, "bench model must be trained"
    for g in genomes:  # fill the rolling window to capacity
        gate.decide(g)
    assert len(gate._scores) == gate.window
    spans_mod.enable()
    try:
        # Batched loop, min of 3 repeats: a per-call lambda + next(cycle)
        # costs ~0.35us — 4% of the budget — and single samples on this
        # box carry scheduler noise the min rejects.
        batch = list(itertools.islice(itertools.cycle(genomes), 2000))
        decide = gate.decide

        def _loop():
            for g in batch:
                decide(g)

        reps, inner = 3, 10
        t_decide_s = min(timeit.repeat(_loop, number=inner, repeat=reps)) / (
            inner * len(batch))
    finally:
        spans_mod.disable()
    per_job_added_us = round(t_decide_s * 1e6, 3)
    overhead_pct = round(per_job_added_us / per_job_dispatch_us * 100.0, 3)
    return {
        "decide_us": per_job_added_us,
        "genome_bits": sum(len(v) for v in genomes[0].values()),
        "window": gate.window,
        "per_job_added_us": per_job_added_us,
        "per_job_dispatch_us": per_job_dispatch_us,
        "overhead_pct": overhead_pct,
        "gate_max_pct": 2.0,
        "within_gate": overhead_pct <= 2.0,
    }


def run_sizeclass_gate(per_job_dispatch_us: float) -> dict:
    """Size-aware dispatch cost of the big-genome regime, micro-timed.

    With a ``device_budget`` on the wire, every dispatch classifies the
    job (``jobs_dispatched_total{genome_size_class=…}``), the worker's
    ``_chunk_jobs`` classifies each job once more to partition frames by
    class, and the master's fill target classifies once per breed round —
    all through ``parallel.mesh.job_size_class``: the full host-side cost
    model (stage-DAG params + activations) plus the budget comparison.
    Same instrument as the forensics/compile/surrogate gates: the
    steady-state worst case (budget present, all fields populated, class
    lands ``big`` so no early-out fires) timed directly over batched
    invocations, divided by the measured per-job dispatch cost."""
    from gentun_tpu_torch.parallel.mesh import cnn_genome_cost, job_size_class

    cost = cnn_genome_cost((3, 5), (20, 50), (28, 28, 1), 500, 10)
    wire = {
        "nodes": (3, 5), "kernels_per_layer": (20, 50),
        "input_shape": (28, 28, 1), "n_classes": 10, "dense_units": 500,
        "batch_size": 128, "compute_dtype": "bfloat16",
        "device_budget": cost.param_bytes + cost.act_bytes_per_example * 32,
    }
    assert job_size_class(wire, 8) == "big", "bench config must classify big"
    batch = [wire] * 2000

    def _loop():
        for params in batch:
            job_size_class(params, 8)

    reps, inner = 3, 10
    t_classify_s = min(timeit.repeat(_loop, number=inner, repeat=reps)) / (
        inner * len(batch))
    per_job_added_us = round(t_classify_s * 1e6, 3)
    overhead_pct = round(per_job_added_us / per_job_dispatch_us * 100.0, 3)
    return {
        "classify_us": per_job_added_us,
        "per_job_added_us": per_job_added_us,
        "per_job_dispatch_us": per_job_dispatch_us,
        "overhead_pct": overhead_pct,
        "gate_max_pct": 2.0,
        "within_gate": overhead_pct <= 2.0,
    }


def run_aggregator_gate(per_job_dispatch_us: float,
                        interval_s: float = 2.0) -> dict:
    """Fleet-metrics push-path cost on a pushing process, micro-timed.

    A process wired to a metrics aggregator pays NOTHING per metric write
    (the ``DeltaSnapshotter`` reads instruments only at flush time) — the
    recurring cost is one ``TelemetryPusher._build_payload()`` per flush
    interval: a full O(#instruments) memoization scan plus payload dicts
    for whatever moved.  (The HTTP POST itself rides the background
    flusher thread, but on a saturated one-core box its CPU is real, so
    the scan — the deterministic part — is what the gate times.)  Same
    instrument as the forensics/compile/surrogate/sizeclass gates: build
    a representative fleet-process registry (~130 series), time the
    steady-state scan with a realistic handful of moved instruments per
    flush, amortize over the jobs one flush interval spans at the
    measured dispatch rate, divide by per-job dispatch cost."""
    from gentun_tpu_torch.telemetry.aggregator import TelemetryPusher
    from gentun_tpu_torch.telemetry.registry import MetricsRegistry

    reg = MetricsRegistry()
    # A representative pushing process: the metric catalog is ~40 names,
    # label fan-out (sessions, workers, size classes) multiplies series.
    for i in range(32):
        reg.counter(f"bench_counter_{i}").inc()
    for i in range(16):
        for session in ("a", "b", "c"):
            reg.counter("bench_labeled_total", session=session,
                        idx=str(i)).inc()
    for i in range(24):
        reg.gauge(f"bench_gauge_{i}").set(float(i))
    for i in range(8):
        h = reg.histogram(f"bench_hist_{i}")
        for v in (0.01, 0.1, 1.0):
            h.observe(v)
    n_series = sum(len(v) for v in reg.snapshot().values())
    # The URL is never dialed: _build_payload is pure in-process work.
    pusher = TelemetryPusher("http://127.0.0.1:9", role="worker",
                             instance="bench", interval=interval_s,
                             full_every=1000000, registry=reg)
    pusher._build_payload()  # prime the memoization (first scan ships all)

    movers = [reg.counter(f"bench_counter_{i}") for i in range(8)]

    def _flush():
        for c in movers:  # a realistic flush: a few counters moved
            c.inc()
        pusher._build_payload()

    reps, inner = 3, 2000
    t_flush_s = min(timeit.repeat(_flush, number=inner, repeat=reps)) / inner
    # One flush serves every job dispatched during the interval.
    jobs_per_flush = interval_s * 1e6 / per_job_dispatch_us
    per_job_added_us = round(t_flush_s / jobs_per_flush * 1e6, 4)
    overhead_pct = round(per_job_added_us / per_job_dispatch_us * 100.0, 3)
    return {
        "registry_series": n_series,
        "flush_scan_us": round(t_flush_s * 1e6, 3),
        "push_interval_s": interval_s,
        "jobs_per_flush": int(jobs_per_flush),
        "per_job_added_us": per_job_added_us,
        "per_job_dispatch_us": per_job_dispatch_us,
        "overhead_pct": overhead_pct,
        "gate_max_pct": 2.0,
        "within_gate": overhead_pct <= 2.0,
    }


def run_wire_gate(per_job_dispatch_us: float, capacity: int = 16) -> dict:
    """Encode-once wire fast path vs the seed's per-dispatch encode, A/B
    micro-timed at a capacity-sized window (DISTRIBUTED.md "Wire fast
    path").

    The seed control plane serialized every job THREE times before its
    first byte hit a socket — a single-entry validation ``encode()`` at
    submit, a ``len(encode(entry))`` sizing pass at dispatch, and the
    entry's share of the batch-frame ``encode()`` — and a requeue re-paid
    the last two.  The fast path pays ``build_job_wire`` once per job
    (one dumps per field, genes through the fragment cache, the shared
    params object deduped batch-wide) and every dispatch after that is a
    byte join.  Both sides pay ``genome_key`` (the seed hashed every job
    at enqueue too), so the A/B isolates serialization honestly.

    Three lifecycle points, same instrument as the other gates (batched
    min-of-repeats micro-timing — wall-clock A/B on this box is ±8%
    noise, an order of magnitude above nothing here):

    - **cold**: first submit→dispatch of a never-seen genome (fresh
      fragment cache) — the GA common case; THE GATED NUMBER, ≥30%.
    - **warm**: re-submission of a known genome (fragment-cache hit) —
      ASHA promotion re-dispatch, duplicate genomes across generations.
    - **redispatch**: disconnect/straggler requeue of an open job —
      cached entry bytes, pure frame join.
    """
    from gentun_tpu_torch.distributed.protocol import (
        GenomeFragmentCache,
        build_job_wire,
        encode,
        jobs_frame,
    )

    rng = np.random.default_rng(5)
    shared_params = {"nodes": (4, 4)}  # one copied dict per submit (server.py)
    payloads = {
        f"w{i}": {
            "genes": {
                "S_1": [int(b) for b in rng.integers(0, 2, 6)],
                "S_2": [int(b) for b in rng.integers(0, 2, 6)],
            },
            "additional_parameters": shared_params,
            "trace": {"trace_id": f"wire{i:04d}", "span_id": f"w{i:04d}"},
        }
        for i in range(capacity)
    }
    items = list(payloads.items())

    def legacy_window():
        batch = []
        for job_id, payload in items:
            lineage.genome_key(payload.get("genes"))
            encode({"type": "jobs", "jobs": [{"job_id": job_id, **payload}]})
            entry = {"job_id": job_id, **payload}
            len(encode(entry))
            batch.append(entry)
        encode({"type": "jobs", "jobs": batch})

    def fast_cold():
        cache = GenomeFragmentCache()
        memo: dict = {}
        wires = [build_job_wire(j, p, lineage.genome_key(p["genes"]), cache, memo)
                 for j, p in items]
        jobs_frame([jw.v1 for jw in wires])

    warm_cache = GenomeFragmentCache()
    for j, p in items:
        build_job_wire(j, p, lineage.genome_key(p["genes"]), warm_cache)

    def fast_warm():
        memo: dict = {}
        wires = [build_job_wire(j, p, lineage.genome_key(p["genes"]), warm_cache, memo)
                 for j, p in items]
        jobs_frame([jw.v1 for jw in wires])

    wires = [build_job_wire(j, p, lineage.genome_key(p["genes"]), warm_cache)
             for j, p in items]

    def legacy_redispatch():
        batch = []
        for job_id, payload in items:
            entry = {"job_id": job_id, **payload}
            len(encode(entry))
            batch.append(entry)
        encode({"type": "jobs", "jobs": batch})

    def fast_redispatch():
        jobs_frame([jw.v1 for jw in wires])

    def _us_per_job(fn, number=300, repeat=5):
        return round(
            min(timeit.repeat(fn, number=number, repeat=repeat))
            / number / capacity * 1e6, 3)

    legacy_us = _us_per_job(legacy_window)
    cold_us = _us_per_job(fast_cold)
    warm_us = _us_per_job(fast_warm)
    legacy_rq_us = _us_per_job(legacy_redispatch)
    fast_rq_us = _us_per_job(fast_redispatch)
    cold_reduction = round((1.0 - cold_us / legacy_us) * 100.0, 1)
    return {
        "capacity": capacity,
        "legacy_us_per_job": legacy_us,
        "fast_cold_us_per_job": cold_us,
        "fast_warm_us_per_job": warm_us,
        "legacy_redispatch_us_per_job": legacy_rq_us,
        "fast_redispatch_us_per_job": fast_rq_us,
        "cold_reduction_pct": cold_reduction,
        "warm_reduction_pct": round((1.0 - warm_us / legacy_us) * 100.0, 1),
        "redispatch_reduction_pct": round(
            (1.0 - fast_rq_us / legacy_rq_us) * 100.0, 1),
        "per_job_dispatch_us": per_job_dispatch_us,
        "gate_min_reduction_pct": 30.0,
        "within_gate": cold_reduction >= 30.0,
    }


def run_journal_gate(per_job_dispatch_us: float,
                     fsync_interval: float = 0.05) -> dict:
    """Dispatch-journal hot-path overhead gate (DISTRIBUTED.md "Broker
    crash safety & admission control"): journaling must cost the dispatch
    hot path ≤ 2% of per-job dispatch cost.

    The journal's contract makes this cheap by construction: a record is
    a preformatted string appended to an in-memory list (``record_dispatch``
    is one ``%``-format plus a ``list.append``); the ``write()`` is paid
    only on the inline non-fsync drain every ``MAX_BUFFER`` records, and
    the ``fsync()`` only on the broker loop's ``fsync_interval`` tick.  So
    the honest per-job bill is: (append cost of the submit+dispatch+
    complete records, inline drains included, micro-timed) + (one batched
    fsync amortized over the jobs a dispatch interval spans at the
    measured dispatch rate).  Same denominator as every other gate.
    """
    import os
    import tempfile

    from gentun_tpu_torch.distributed.journal import DispatchJournal

    payload = {
        "genes": {"S_1": [0, 1, 0, 1, 0, 1], "S_2": [1, 0, 1, 0, 1, 0]},
        "additional_parameters": {"nodes": (4, 4)},
    }
    with tempfile.TemporaryDirectory() as td:
        jrn = DispatchJournal(os.path.join(td, "gate.journal"),
                              fsync_interval=fsync_interval)
        jrn.open()
        seq = [0]

        # THE GATED NUMBER's append half: the one record the dispatch
        # loop writes per job (preformatted %-format + list.append;
        # inline non-fsync drains every MAX_BUFFER records included).
        def dispatch_record():
            i = seq[0]
            seq[0] += 1
            jrn.record_dispatch("j%08d" % i)

        # Informational: the full per-job record bundle across the
        # lifecycle (submit pays a payload dumps on the ENQUEUE path,
        # complete on the result-ingest path — neither is the dispatch
        # hot path, but both ride the same buffer).
        def lifecycle_records():
            i = seq[0]
            seq[0] += 1
            jid = "k%08d" % i
            jrn.record_submit(jid, "default", "gk%08d" % i, payload)
            jrn.record_dispatch(jid)
            jrn.record_complete(jid, 0.5, parked=False)

        number, repeat = 2000, 5
        append_us = round(
            min(timeit.repeat(dispatch_record, number=number, repeat=repeat))
            / number * 1e6, 3)
        lifecycle_us = round(
            min(timeit.repeat(lifecycle_records, number=number, repeat=repeat))
            / number * 1e6, 3)

        # One fsync per interval covers every job dispatched inside it at
        # the measured all-in dispatch rate; bill each job its share.
        jobs_per_fsync = max(1.0,
                             fsync_interval / (per_job_dispatch_us * 1e-6))
        batch = min(int(jobs_per_fsync), 4000)
        fsync_s = []
        for r in range(8):
            for i in range(batch):
                jrn.record_dispatch("f%d-%08d" % (r, i))
            t0 = time.perf_counter()
            jrn.flush()
            fsync_s.append(time.perf_counter() - t0)
        fsync_us_per_job = round(min(fsync_s) / jobs_per_fsync * 1e6, 3)
        jrn.close()

    per_job_added = round(append_us + fsync_us_per_job, 3)
    overhead_pct = round(per_job_added / per_job_dispatch_us * 100.0, 2)
    return {
        "fsync_interval_s": fsync_interval,
        "append_us_per_job": append_us,
        "lifecycle_records_us_per_job": lifecycle_us,
        "fsync_us_per_job_amortized": fsync_us_per_job,
        "jobs_per_fsync": round(jobs_per_fsync, 1),
        "per_job_added_us": per_job_added,
        "per_job_dispatch_us": per_job_dispatch_us,
        "overhead_pct": overhead_pct,
        "gate_max_pct": 2.0,
        "within_gate": overhead_pct <= 2.0,
    }


def run_placement_gate(per_job_dispatch_us: float) -> dict:
    """Placement-aware dispatch cost in a mixed fleet, micro-timed.

    With preemptible and stable members both live, every scheduler pop
    filters candidates through ``job_prefers_preemptible``: two dict
    lookups (the payload and its fidelity rung) plus a memoized
    ``parallel.mesh.job_size_class`` call — and the dispatch loop builds
    one ``_placeable_for`` closure per worker pass.  The steady-state
    worst case per job is two classifications (the head peeked once by a
    wrong-class worker, then popped by the right one), so the gate bills
    both.  Same instrument as the forensics/compile/surrogate/sizeclass
    gates: batched min-of-repeats with the size-class memo warm (every
    genome classifies once, then dispatch/requeue/peek all hit the
    cache), divided by the measured per-job dispatch cost."""
    from gentun_tpu_torch.utils import fidelity_fingerprint

    broker = JobBroker(port=0)  # never started: _payloads + the check only
    params = {"nodes": (4, 4)}
    fp = fidelity_fingerprint(params)
    n = 2000
    for i in range(n):
        broker._payloads[f"p{i}"] = {
            "genes": {"S_1": [0, 1, 0, 1, 0, 1], "S_2": [1, 0, 1, 0, 1, 0]},
            "additional_parameters": params,
            "fidelity": {"v": 1, "rung": i % 3, "fingerprint": fp},
        }
    job_ids = [f"p{i}" for i in range(n)]
    pre_filter = broker._placeable_for(True)
    stable_filter = broker._placeable_for(False)
    for jid in job_ids:
        pre_filter(jid)  # warm the size-class memo (steady state)
    assert pre_filter("p0") and stable_filter("p1"), \
        "bench payloads must split across placement classes"

    def _loop():
        for jid in job_ids:
            stable_filter(jid)  # wrong-class head peek
            pre_filter(jid)     # right-class pop

    reps, inner = 3, 10
    t_pair_s = min(timeit.repeat(_loop, number=inner, repeat=reps)) / (
        inner * n)
    per_job_added_us = round(t_pair_s * 1e6, 3)
    overhead_pct = round(per_job_added_us / per_job_dispatch_us * 100.0, 3)
    return {
        "checks_per_job": 2,
        "check_us": round(t_pair_s / 2 * 1e6, 3),
        "per_job_added_us": per_job_added_us,
        "per_job_dispatch_us": per_job_dispatch_us,
        "overhead_pct": overhead_pct,
        "gate_max_pct": 2.0,
        "within_gate": overhead_pct <= 2.0,
    }


def run_pack_gate(per_job_dispatch_us: float) -> dict:
    """Window-packer cost per job on the dispatch path, micro-timed.

    With ``pack_windows=True`` every dispatched job pays exactly three
    packer touches: one pack-key assembly (filter the cached envelope
    tuple through ``pack_envelope`` + one memoized ``job_size_class``
    call), one ``WindowPacker.add`` (deque append + dict upkeep), and a
    1/step share of the window ``take`` (deque pops + one stats sample
    per window).  The loop below runs that full add→take lifecycle over
    a realistic two-tenant stream at a capacity-8 window step — the
    fill/flush policy around it reuses the same ``pop_next``/credit
    bookkeeping the unpacked path already pays, so the packer's own
    touches ARE the added cost.  Same instrument as the other gates:
    batched min-of-repeats divided by the measured per-job dispatch
    cost."""
    from gentun_tpu_torch.distributed.packing import WindowPacker
    from gentun_tpu_torch.distributed.protocol import (
        GenomeFragmentCache,
        build_job_wire,
        pack_envelope,
    )
    from gentun_tpu_torch.parallel.mesh import job_size_class

    params = {"nodes": (4, 4)}
    cache = GenomeFragmentCache()
    n, step = 2048, 8
    jobs = []
    for i in range(n):
        payload = {
            "genes": {"S_1": [0, 1, 0, 1, 0, 1], "S_2": [1, 0, 1, 0, 1, 0]},
            "additional_parameters": params,
        }
        jw = build_job_wire(f"p{i}", payload, f"gk{i % 64}", cache)
        jobs.append((f"t{i % 2}", f"p{i}", jw, payload))
    job_size_class(params)  # warm the memo (steady state, like dispatch)
    packer = WindowPacker(0.05)

    def _loop():
        for sid, jid, jw, payload in jobs:
            key = (pack_envelope(jw.env),
                   job_size_class(payload.get("additional_parameters")))
            packer.add(sid, jid, key, key[1], True, 0.0)
            if packer.held >= step:
                packer.take(packer.groups()[0], step, step, 0.0)
        for g in packer.groups():  # drain the tail window
            packer.take(g, len(g), step, 0.0)

    reps, inner = 3, 10
    per_job_s = min(timeit.repeat(_loop, number=inner, repeat=reps)) / (
        inner * n)
    per_job_added_us = round(per_job_s * 1e6, 3)
    overhead_pct = round(per_job_added_us / per_job_dispatch_us * 100.0, 3)
    return {
        "window_step": step,
        "per_job_added_us": per_job_added_us,
        "per_job_dispatch_us": per_job_dispatch_us,
        "overhead_pct": overhead_pct,
        "gate_max_pct": 2.0,
        "within_gate": overhead_pct <= 2.0,
    }


def _measure_broker_rate(broker, n_jobs: int, n_workers: int,
                         capacity: int) -> float:
    """Jobs/sec through ONE live broker with its own fresh workers.

    Workers are joined (not just signalled) before returning so the next
    shard measured in a serial-isolation sweep gets the whole core."""
    data = (np.zeros(1, np.float32), np.zeros(1, np.float32))
    rng = np.random.default_rng(0)
    payloads = {
        f"j{i}": {
            "genes": {
                "S_1": [int(b) for b in rng.integers(0, 2, 6)],
                "S_2": [int(b) for b in rng.integers(0, 2, 6)],
            },
            "additional_parameters": {"nodes": (4, 4)},
        }
        for i in range(n_jobs)
    }
    stop = threading.Event()
    threads = []
    try:
        _, port = broker.address
        for _ in range(n_workers):
            t = threading.Thread(
                target=lambda: GentunClient(
                    NoopIndividual, *data, port=port, capacity=capacity,
                    heartbeat_interval=1.0, reconnect_delay=0.1,
                ).work(stop_event=stop),
                daemon=True,
            )
            t.start()
            threads.append(t)
        t0 = time.monotonic()
        broker.submit(payloads)
        results = broker.gather(list(payloads), timeout=120.0)
        wall = time.monotonic() - t0
        assert len(results) == n_jobs
        return n_jobs / wall
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)


def run_shard_curve(n_jobs: int = 800, n_workers: int = 2,
                    capacity: int = 16) -> dict:
    """Aggregate throughput at 1/2/4 broker shards (DISTRIBUTED.md
    "Horizontal broker sharding").

    Every shard of a rung is RESIDENT simultaneously — asyncio loop,
    listener socket and scheduler threads all alive — but each shard is
    LOADED in serial isolation with its own fresh workers, and the
    rung's aggregate is the sum of per-shard rates.  Rationale: this
    host has very few cores (``nproc`` recorded below); wall-clock
    concurrent shard stacks just timeslice one core (measured 1.03× for
    two concurrent stacks), which would falsely report "sharding does
    not scale".  Shards share no lock, event loop, socket or journal —
    the broker has zero cross-shard coordination by construction — so
    the sum of isolated rates is the aggregate a deployment with a core
    per shard gets, while measuring with all shards resident still
    charges each rate for its neighbours' memory and thread footprint.

    Balance is the ring's own census over 512 synthetic session ids —
    the placement skew a real fleet of masters would see."""
    from gentun_tpu_torch.distributed.shard import ShardRing, shard_id

    out: dict = {
        "methodology": (
            "serial-isolation: all shards resident, each loaded alone "
            "with fresh workers; aggregate = sum of per-shard rates "
            "(shards share no state; concurrent wall-clock measurement "
            "on a near-single-core host only measures timeslicing)"),
        "nproc": os.cpu_count(),
        "n_jobs_per_shard": n_jobs,
        "n_workers_per_shard": n_workers,
        "capacity": capacity,
        "rungs": [],
    }
    n_keys = 512
    for n_shards in (1, 2, 4):
        brokers = [JobBroker(port=0).start() for _ in range(n_shards)]
        try:
            rates = [
                _measure_broker_rate(b, n_jobs, n_workers, capacity)
                for b in brokers
            ]
            ring = ShardRing([shard_id(b.address) for b in brokers])
            shares = sorted(
                ring.census(f"s-{i:04d}" for i in range(n_keys)).values())
            out["rungs"].append({
                "shards": n_shards,
                "per_shard_jobs_per_sec": [round(r, 1) for r in rates],
                "aggregate_jobs_per_sec": round(sum(rates), 1),
                "ring_balance_min_share": round(shares[0] / n_keys, 3),
                "ring_balance_max_share": round(shares[-1] / n_keys, 3),
            })
        finally:
            for b in brokers:
                b.stop()
    r1 = out["rungs"][0]["aggregate_jobs_per_sec"]
    r2 = out["rungs"][1]["aggregate_jobs_per_sec"]
    out["scale_1_to_2"] = round(r2 / r1, 2)
    out["gate_min_scale"] = 1.8
    out["within_gate"] = out["scale_1_to_2"] >= 1.8
    return out


def run_shard_route_gate(per_job_dispatch_us: float) -> dict:
    """Session→shard routing cost on the sharded submit path, micro-timed.

    A sharded master hashes the session id onto the consistent-hash ring
    (one blake2b digest + one bisect over the sorted vnode points) to
    pick the home broker.  In production that happens once per submit
    *batch*, but the gate bills it once per *job* — the conservative
    worst case of single-job submits — and requires it to stay <=2% of
    the measured per-job dispatch cost.  Same instrument as the other
    gates: batched min-of-repeats divided by the forensics gate's
    dispatch denominator."""
    from gentun_tpu_torch.distributed.shard import ShardRing

    ring = ShardRing([f"10.0.0.{i}:7777" for i in range(4)])
    keys = [f"s-{i:04d}" for i in range(2000)]
    for k in keys:
        ring.home(k)  # warm (allocator, bisect module, digest dispatch)

    def _loop():
        for k in keys:
            ring.home(k)

    reps, inner = 5, 10
    t_s = min(timeit.repeat(_loop, number=inner, repeat=reps)) / (
        inner * len(keys))
    per_job_added_us = round(t_s * 1e6, 3)
    overhead_pct = round(per_job_added_us / per_job_dispatch_us * 100.0, 3)
    return {
        "ring_shards": 4,
        "per_job_added_us": per_job_added_us,
        "per_job_dispatch_us": per_job_dispatch_us,
        "overhead_pct": overhead_pct,
        "gate_max_pct": 2.0,
        "within_gate": overhead_pct <= 2.0,
    }


#: The control planes whose per-job cost rides the dispatch hot path and
#: is therefore held to the 2% gate.  (artifact key, display name) —
#: each `out[key]` block carries `per_job_added_us` / `overhead_pct`.
HOT_PATH_GATED_PLANES = (
    ("forensics", "lineage plane (on)"),
    ("compile_probe", "compile-cache probe"),
    ("surrogate", "surrogate decide"),
    ("sizeclass", "size-class classify"),
    ("aggregator_push", "aggregator push scan"),
    ("journal", "dispatch journal (on)"),
    ("placement", "placement class check"),
    ("shard_route", "shard route (ring home)"),
    ("packing", "window packer (pack on)"),
)

HOT_PATH_GATE_MAX_PCT = 2.0


def hot_path_table(out: dict) -> dict:
    """The consolidated per-job hot-path cost table as DATA: one row per
    gated plane plus the wire-encode reference rows.  Embedded in the
    stdout JSON artifact so CI can assert the 2% gate from the committed
    numbers instead of eyeballing stderr."""
    rows = [{
        "plane": "dispatch (measured, all-in)",
        "per_job_us": out["forensics"]["per_job_dispatch_us"],
        "gated": False,
    }]
    for key, name in HOT_PATH_GATED_PLANES:
        rows.append({
            "plane": name,
            "key": key,
            "per_job_us": out[key]["per_job_added_us"],
            "overhead_pct": out[key]["overhead_pct"],
            "gated": True,
        })
    for name, us_key, red_key in (
        ("wire encode: seed (cold)", "legacy_us_per_job", None),
        ("wire encode: fast (cold)", "fast_cold_us_per_job",
         "cold_reduction_pct"),
        ("wire encode: fast (warm)", "fast_warm_us_per_job",
         "warm_reduction_pct"),
        ("wire encode: requeue", "fast_redispatch_us_per_job",
         "redispatch_reduction_pct"),
    ):
        row = {"plane": name, "per_job_us": out["wire"][us_key],
               "gated": False}
        if red_key is not None:
            row["reduction_pct"] = out["wire"][red_key]
        rows.append(row)
    return {
        "rows": rows,
        "gate_max_pct": HOT_PATH_GATE_MAX_PCT,
        "within_gate": all(r["overhead_pct"] <= HOT_PATH_GATE_MAX_PCT
                           for r in rows if r["gated"]),
    }


def _print_hot_path_table(out: dict) -> None:
    """Human rendering of :func:`hot_path_table` → stderr (stdout is the
    JSON artifact).  One row per gated plane, so 'what does a dispatched
    job pay' has a single answer in the benchmark output."""
    rows = out["hot_path_table"]["rows"]
    w = max(len(r["plane"]) for r in rows)
    print(f"\nper-job hot-path cost ({out['n_workers']} workers, "
          f"capacity {out['capacity']}):", file=sys.stderr)
    for r in rows:
        if r["gated"]:
            note = f"{r['overhead_pct']}% of dispatch"
        elif "reduction_pct" in r:
            note = f"-{r['reduction_pct']}%"
        else:
            note = ""
        print(f"  {r['plane']:<{w}}  {r['per_job_us']:>9.3f} us  {note}",
              file=sys.stderr)


def main() -> dict:
    # Single-tenant pass first (the historical headline numbers), then the
    # same workload split across 4 fair-share sessions: the difference is
    # the weighted-DRR scheduler's control-plane cost per job, made
    # visible here so a scheduler regression shows up in the artifact, not
    # in a production master's throughput graph.
    out = run()
    multi = run(n_sessions=4)
    single_rate, drr_rate = out["jobs_per_sec"], multi["jobs_per_sec"]
    out["scheduler"] = {
        "single_tenant_fifo_jobs_per_sec": single_rate,
        "drr_4_sessions_jobs_per_sec": drr_rate,
        # Per-job cost of the DRR path vs the single-lane pop: positive =
        # overhead, small negative = noise floor (the runs race real
        # sockets and threads).
        "per_job_overhead_us": round((1.0 / drr_rate - 1.0 / single_rate) * 1e6, 1),
        "overhead_pct": round((single_rate - drr_rate) / single_rate * 100.0, 2),
        "drr_dispatch_rtt_s": multi["dispatch_rtt_s"],
    }

    # Search-forensics overhead gate (docs/OBSERVABILITY.md "Search
    # forensics"): turning the lineage plane on must cost the broker's
    # dispatch hot path <=2% throughput — with lineage on, every dispatch
    # and requeue builds a ledger record and every result ingest scans the
    # shipped span list for device spans.
    out["forensics"] = run_forensics_gate()
    assert out["forensics"]["within_gate"], (
        f"search-forensics dispatch overhead "
        f"{out['forensics']['overhead_pct']}% exceeds the 2% gate "
        f"({out['forensics']['per_job_added_us']}us added on "
        f"{out['forensics']['per_job_dispatch_us']}us/job dispatch)")

    # Compile-cache probe gate (DISTRIBUTED.md "Fleet-wide compile
    # cache"): the per-batch publish-scan probe a --compile-cache-url
    # worker runs on the dispatch loop must also stay <=2% of per-job
    # dispatch cost.  Reuses the forensics gate's measured dispatch cost
    # so both gates divide by the same denominator.
    out["compile_probe"] = run_compile_probe_gate(
        out["forensics"]["per_job_dispatch_us"])
    assert out["compile_probe"]["within_gate"], (
        f"compile-cache probe overhead "
        f"{out['compile_probe']['overhead_pct']}% exceeds the 2% gate "
        f"({out['compile_probe']['per_job_added_us']}us added on "
        f"{out['compile_probe']['per_job_dispatch_us']}us/job dispatch)")

    # Surrogate rung −1 gate (DISTRIBUTED.md "Surrogate rung −1"): the
    # score-on-breed decide a gated master pays per bred child must also
    # stay <=2% of per-job dispatch cost.  Same denominator again.
    out["surrogate"] = run_surrogate_gate(
        out["forensics"]["per_job_dispatch_us"])
    assert out["surrogate"]["within_gate"], (
        f"surrogate score-on-breed overhead "
        f"{out['surrogate']['overhead_pct']}% exceeds the 2% gate "
        f"({out['surrogate']['per_job_added_us']}us added on "
        f"{out['surrogate']['per_job_dispatch_us']}us/job dispatch)")

    # Big-genome size-class gate (DISTRIBUTED.md "Big-genome regime"):
    # the per-job cost-model classification the dispatch plane runs when
    # a device_budget is on the wire must also stay <=2% of per-job
    # dispatch cost.  Same denominator again.
    out["sizeclass"] = run_sizeclass_gate(
        out["forensics"]["per_job_dispatch_us"])
    assert out["sizeclass"]["within_gate"], (
        f"size-class classification overhead "
        f"{out['sizeclass']['overhead_pct']}% exceeds the 2% gate "
        f"({out['sizeclass']['per_job_added_us']}us added on "
        f"{out['sizeclass']['per_job_dispatch_us']}us/job dispatch)")

    # Fleet-aggregation push-path gate (OBSERVABILITY.md "Fleet
    # aggregation & SLOs"): the periodic snapshot-delta scan a pushing
    # process pays must stay <=2% of per-job dispatch cost, amortized
    # over the jobs one flush interval spans.  Same denominator again.
    out["aggregator_push"] = run_aggregator_gate(
        out["forensics"]["per_job_dispatch_us"])
    assert out["aggregator_push"]["within_gate"], (
        f"aggregator push-path overhead "
        f"{out['aggregator_push']['overhead_pct']}% exceeds the 2% gate "
        f"({out['aggregator_push']['per_job_added_us']}us added on "
        f"{out['aggregator_push']['per_job_dispatch_us']}us/job dispatch)")

    # Wire fast-path gate (DISTRIBUTED.md "Wire fast path"): the encode-once
    # dispatch path must cut per-job serialization cost ≥30% vs the seed's
    # encode-per-dispatch path at the cold (first-dispatch) lifecycle point —
    # warm and requeue reductions are reported alongside.  Same denominator
    # as every other gate for the consolidated table.
    out["wire"] = run_wire_gate(out["forensics"]["per_job_dispatch_us"])
    assert out["wire"]["within_gate"], (
        f"wire fast path saves only {out['wire']['cold_reduction_pct']}% "
        f"of per-job encode cost ({out['wire']['fast_cold_us_per_job']}us vs "
        f"{out['wire']['legacy_us_per_job']}us legacy) — below the 30% gate")

    # Dispatch-journal gate (DISTRIBUTED.md "Broker crash safety &
    # admission control"): steady-state journaling — append-only records
    # with the fsync batched on the broker loop's interval tick — must
    # cost the dispatch hot path <=2% of per-job dispatch cost.  Same
    # denominator again.
    out["journal"] = run_journal_gate(out["forensics"]["per_job_dispatch_us"])
    assert out["journal"]["within_gate"], (
        f"dispatch-journal overhead {out['journal']['overhead_pct']}% "
        f"exceeds the 2% gate ({out['journal']['per_job_added_us']}us added "
        f"on {out['journal']['per_job_dispatch_us']}us/job dispatch)")

    # Placement gate (DISTRIBUTED.md "Autoscaling & preemptible
    # capacity"): the per-pop placement-class check a mixed fleet adds to
    # the dispatch hot path must also stay <=2% of per-job dispatch cost.
    # Same denominator again.
    out["placement"] = run_placement_gate(
        out["forensics"]["per_job_dispatch_us"])
    assert out["placement"]["within_gate"], (
        f"placement class-check overhead "
        f"{out['placement']['overhead_pct']}% exceeds the 2% gate "
        f"({out['placement']['per_job_added_us']}us added on "
        f"{out['placement']['per_job_dispatch_us']}us/job dispatch)")

    # Shard-route gate (DISTRIBUTED.md "Horizontal broker sharding"):
    # the consistent-hash home() a sharded master pays per submit must
    # also stay <=2% of per-job dispatch cost.  Same denominator again.
    out["shard_route"] = run_shard_route_gate(
        out["forensics"]["per_job_dispatch_us"])
    assert out["shard_route"]["within_gate"], (
        f"shard-route overhead {out['shard_route']['overhead_pct']}% "
        f"exceeds the 2% gate ({out['shard_route']['per_job_added_us']}us "
        f"added on {out['shard_route']['per_job_dispatch_us']}us/job "
        f"dispatch)")

    # Window-packing gate (DISTRIBUTED.md "Cross-session window
    # packing"): the per-job pack-key + packer add/take bookkeeping a
    # pack_windows=True broker adds to the dispatch hot path must also
    # stay <=2% of per-job dispatch cost.  Same denominator again.
    out["packing"] = run_pack_gate(out["forensics"]["per_job_dispatch_us"])
    assert out["packing"]["within_gate"], (
        f"window-packer overhead {out['packing']['overhead_pct']}% "
        f"exceeds the 2% gate ({out['packing']['per_job_added_us']}us "
        f"added on {out['packing']['per_job_dispatch_us']}us/job dispatch)")

    # Horizontal shard curve (DISTRIBUTED.md "Horizontal broker
    # sharding"): aggregate throughput at 1/2/4 resident shards, each
    # measured in serial isolation (see run_shard_curve's docstring for
    # why wall-clock concurrency is the wrong instrument on this host).
    # Gated at >=1.8x aggregate going 1 -> 2 shards.
    out["shard_curve"] = run_shard_curve()
    assert out["shard_curve"]["within_gate"], (
        f"1->2 shard aggregate scaling {out['shard_curve']['scale_1_to_2']}x "
        f"below the 1.8x gate: {out['shard_curve']['rungs']}")

    out["hot_path_table"] = hot_path_table(out)
    assert out["hot_path_table"]["within_gate"], (
        "a gated hot-path plane exceeds the "
        f"{HOT_PATH_GATE_MAX_PCT}% dispatch-overhead gate: "
        f"{[r for r in out['hot_path_table']['rows'] if r['gated'] and r['overhead_pct'] > HOT_PATH_GATE_MAX_PCT]}")
    _print_hot_path_table(out)

    # Informational (not gated): the full per-job accounting fare.  When a
    # master runs full forensics it stamps `fz` into the propagated trace
    # and every job additionally pays a worker-side `device` span, ~250
    # wire bytes, a histogram re-observe and a ledger billing at ingest —
    # a fixed ~tens-of-microseconds per job, so it only registers at
    # noop-evaluation rates like this benchmark's (real evaluations run
    # milliseconds to minutes).  Median of 3 passes per side against the
    # same single-pass noise the gate sidesteps.
    full_off = [run(n_jobs=4000, trace_ctx=True) for _ in range(3)]
    full_on = [run(n_jobs=4000, trace_ctx=True, forensics=True)
               for _ in range(3)]
    off_rate = statistics.median(r["jobs_per_sec"] for r in full_off)
    on_rate = statistics.median(r["jobs_per_sec"] for r in full_on)
    out["forensics"]["full_accounting"] = {
        "off_jobs_per_sec": off_rate,
        "on_jobs_per_sec": on_rate,
        "per_job_cost_us": round((1.0 / on_rate - 1.0 / off_rate) * 1e6, 1),
        "device_spans_billed": max(r["device_spans_billed"] for r in full_on),
    }
    assert out["forensics"]["full_accounting"]["device_spans_billed"] > 0, \
        "full-accounting pass billed no device spans — the plane never engaged"
    return out


if __name__ == "__main__":
    path = out_path("torch_broker_throughput.json")
    out = stamp(main())
    print(json.dumps(out))
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}", file=sys.stderr)