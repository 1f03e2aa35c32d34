"""Worker launcher: ``python -m gentun_tpu_torch.distributed.worker``.

The reference starts workers as hand-written scripts wrapping
``GentunClient`` (gentun examples [PUB]; SURVEY.md §3.3).  This module is
the installable equivalent — point it at the master and a local dataset and
it consumes jobs until killed:

    python -m gentun_tpu_torch.distributed.worker \
        --host <master-ip> --port 5672 --password s3cret \
        --species genetic-cnn --dataset mnist --capacity 8

A worker process drives one CUDA device: ``--capacity N`` is the window
of jobs it trains as one population-batched program (20 for a pop-20
generation in one program; the default 1 runs a genome per program, at the
launch floor of a 2-slot program).  ``--capacity auto`` derives the window
from the worker's ``(pop, data)`` mesh, which on one card is ``1x1``
(window 2).

All model hyperparameters (``additional_parameters``) arrive from the
master with each job, so the worker needs only its species and its copy of
the training data — genes in, fitness out (SURVEY.md §1).  Jobs from a
multi-fidelity master additionally carry a ``fidelity`` tag
(``protocol.py``); the client cross-checks it against the shipped config
and answers an unknown or mislabeled tag with a structured ``fail`` frame
instead of training a wrong-schedule measurement — a mixed-version fleet
degrades to per-job refusals, never to silent rung poisoning.  Tagless
jobs from pre-ladder masters evaluate unchanged.

One worker over several cards, on one host or many: start this command
once per card, each with the same ``--coordinator`` (rank 0's host and a
free port) and ``--num-processes``, and its own ``--process-id``:

    # on each host, once per card, RANK = 0 .. N-1 (LOCAL_RANK picks the card)
    LOCAL_RANK=$LOCAL python -m gentun_tpu_torch.distributed.worker \
        --host <master-ip> --password s3cret \
        --species genetic-cnn --dataset cifar10 --capacity auto \
        --coordinator <rank0-host>:29500 --num-processes N --process-id $RANK

The ranks form one ``torch.distributed`` group over NCCL (``parallel/
multihost.py``); ranks that share a card run over ``--backend gloo``.  Rank 0
connects to the master and broadcasts each window of jobs to the other
ranks; every rank trains its share of the ``(pop, data)`` mesh
(``--mesh POPxDATA`` pins a factoring of the N ranks).  The followers exit
when the leader's loop ends (a shutdown sentinel rides the last broadcast).
If the leader is killed outright, each follower's watchdog sees its store
port gone and exits with code 17 within ~10 s: restart the command on every
rank together.  The master needs no action: unacked jobs redeliver.

A worker that finds no CUDA device still joins, and fails each job it
takes with the device error (a ``fail`` frame the master retries
elsewhere); it never answers with a CPU fitness.  Only a master whose job
parameters carry ``mesh="cpu"`` (tests) has its jobs run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging


def _load_dataset(name: str, data_dir=None, n=None):
    import numpy as np

    from ..utils import datasets as ds

    if n is not None and n <= 0:
        # Validate BEFORE the loaders see n: a negative value would raise a
        # raw numpy error (or a huge one allocate) inside the loader.
        raise SystemExit(f"--n must be positive, got {n}")
    # `n` forwards to the loaders that accept it (so npz archives larger
    # than the loader default stay reachable)...
    n_kw = {"n": n} if n is not None else {}
    loaders = {
        "mnist": lambda: ds.load_mnist(**n_kw, data_dir=data_dir),
        "cifar10": lambda: ds.load_cifar10(**n_kw, data_dir=data_dir),
        "cifar100": lambda: ds.load_cifar100(**n_kw, data_dir=data_dir),
        "uci-wine": lambda: ds.load_uci_wine(),
        "uci-binary": lambda: ds.load_uci_binary(),
    }
    if name not in loaders:
        raise SystemExit(f"unknown dataset {name!r}; choose from {sorted(loaders)}")
    if name.startswith("uci-") and data_dir is not None:
        # The UCI tables are fixed sklearn datasets with no npz override —
        # don't let the flag silently no-op.
        raise SystemExit(f"--data-dir is not supported for dataset {name!r}")
    x, y, meta = loaders[name]()
    if n is not None:
        if len(x) < n:
            # Loaders cannot conjure rows an npz archive or sklearn table
            # doesn't have, so undersupply is a loud error here rather than
            # a silently smaller dataset.
            raise SystemExit(f"--n {n} not satisfiable for {name!r} ({len(x)} examples available)")
        if len(x) > n:
            # Only the UCI loaders reach here (the image loaders subsample
            # to `n` themselves); enforce the flag uniformly regardless.
            idx = np.random.default_rng(0).permutation(len(x))[:n]
            x, y = x[idx], y[idx]
    return x, y, meta


def _species(name: str):
    from ..individuals import BoostingIndividual, GeneticCnnIndividual, XgboostIndividual

    table = {
        "genetic-cnn": GeneticCnnIndividual,
        "boosting": BoostingIndividual,
        "xgboost": XgboostIndividual,  # reference 11-gene genome
    }
    if name not in table:
        raise SystemExit(f"unknown species {name!r}; choose from {sorted(table)}")
    return table[name]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gentun_tpu_torch.distributed.worker",
        description="gentun_tpu_torch fitness worker (owns the data, trains shipped genes)",
    )
    ap.add_argument("--host", default="127.0.0.1", help="master broker host")
    ap.add_argument("--port", type=int, default=5672, help="master broker port")
    ap.add_argument("--broker-urls", default=None, metavar="HOST:PORT,...",
                    help="comma-separated broker shard addresses (horizontal "
                         "sharding — DISTRIBUTED.md 'Horizontal broker "
                         "sharding').  The worker multi-homes: one "
                         "connection, credit window, and backoff per shard, "
                         "so a dead shard never blocks dispatch from healthy "
                         "ones.  Overrides --host/--port; a single address "
                         "behaves exactly like --host/--port")
    ap.add_argument("--password", default=None, help="broker shared token")
    ap.add_argument("--species", default="genetic-cnn", help="genetic-cnn | boosting | xgboost")
    ap.add_argument("--dataset", default="mnist",
                    help="mnist | cifar10 | cifar100 | uci-wine | uci-binary")
    ap.add_argument("--data-dir", default=None,
                    help="directory with {name}.npz overrides (or $GENTUN_TPU_DATA)")
    ap.add_argument("--n", type=int, default=None, help="subsample the dataset to n examples")
    ap.add_argument("--capacity", default="1",
                    help="jobs taken at once; >1 trains the batch as one "
                         "population-batched program.  'auto' switches on host-level "
                         "mesh mode: this ONE worker drives every local "
                         "device through the (pop, data) mesh and derives "
                         "its capacity from the mesh (compile bucket x "
                         "pop-axis size) instead of a typed-in number — "
                         "see DISTRIBUTED.md 'Host-level mesh workers'")
    ap.add_argument("--mesh", default=None, metavar="POPxDATA",
                    help="pin the (pop, data) factoring of the worker's ranks "
                         "(one per card) instead of the heuristic, e.g. --mesh "
                         "2x2 over --num-processes 4.  The axes must multiply "
                         "to the number of ranks (1 without --coordinator); "
                         "malformed or non-factoring values exit loudly.")
    ap.add_argument("--prefetch-depth", type=int, default=None,
                    help="jobs queued locally BEYOND capacity so the next "
                         "window is decoded while the current one trains "
                         "(double buffering).  Default: capacity.  0 restores "
                         "the serial pre-pipelining loop; clamped to "
                         "4 x capacity.  See DISTRIBUTED.md 'Pipelined dispatch'.")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--n-chips", type=int, default=None,
                    help="override the advertised accelerator chip count "
                         "(default: torch.cuda.device_count() for the CNN "
                         "species, 1 otherwise)")
    ap.add_argument("--max-jobs", type=int, default=None, help="exit after this many results")
    ap.add_argument("--fitness-store", default=None,
                    help="read-only cross-run fitness cache (utils/fitness_store.py "
                         "JSON): jobs whose genes+config were measured by a prior "
                         "run are answered without retraining.  Not available with "
                         "--coordinator (multihost) — see GentunClient.")
    ap.add_argument("--cache-url", default=None, metavar="URL",
                    help="shared fitness-memoization service "
                         "(distributed/fitness_service.py), e.g. "
                         "http://cache-host:9736: look up each job's genes+"
                         "config before training and publish fresh fitnesses "
                         "back (write-behind).  Layers OVER --fitness-store; "
                         "degrades to local-only when unreachable.  Not "
                         "available with --coordinator (multihost).")
    ap.add_argument("--compile-cache-url", default=None, metavar="URL",
                    help="fleet-wide kernel-library cache service "
                         "(distributed/compile_service.py), e.g. "
                         "http://cache-host:9737: fetch the fleet's built "
                         "kernel library for this platform at join (before "
                         "advertising capacity and before the first nvcc "
                         "run), and publish it if this worker builds it "
                         "first (write-behind).  Degrades to local builds "
                         "when unreachable.  The library is native code: "
                         "use only a compile service you trust.  Not "
                         "available with --coordinator (multihost).")
    ap.add_argument("--aggregator-url", default=None, metavar="URL",
                    help="fleet metrics aggregator "
                         "(telemetry/aggregator.py), e.g. "
                         "http://agg-host:9100: push this worker's metric "
                         "snapshots there every few seconds under its "
                         "--worker-id, feeding the fleet /metrics, the "
                         "/statusz version-skew table, and the SLO engine "
                         "behind /alertz.  Fail-open with cooldown — "
                         "aggregator downtime never touches evaluation.")
    ap.add_argument("--fault-plan", default=None, metavar="PATH",
                    help="chaos testing: JSON FaultPlan (distributed/faults.py) "
                         "injected into this worker's client hooks")
    ap.add_argument("--preempt", action="store_true",
                    help="advertise this worker as PREEMPTIBLE capacity: the "
                         "broker routes cheap rung-0 probes here and pins "
                         "high-rung promotions to stable workers.  SIGUSR1 "
                         "acts as the preemption deadline signal — the worker "
                         "self-drains through the ordinary SIGTERM drain path "
                         "with the requeue attributed to preemption.  See "
                         "DISTRIBUTED.md 'Autoscaling & preemptible capacity'.")
    ap.add_argument("--preempt-after", type=float, default=None,
                    metavar="SECONDS",
                    help="self-preempt after SECONDS (implies --preempt): a "
                         "deterministic deadline for chaos studies, "
                         "equivalent to receiving SIGUSR1 then")
    ap.add_argument("--wire-v1", action="store_true",
                    help="advertise NO wire capabilities: pin this worker to "
                         "the v1 frame set even against a jobs2-capable "
                         "broker (ops kill switch for the wire fast path — "
                         "see DISTRIBUTED.md 'Wire fast path')")
    ap.add_argument("--telemetry", action="store_true",
                    help="collect spans for evaluated job groups and ship "
                         "them to the master in result frames (equivalent to "
                         "GENTUN_TPU_TELEMETRY=1; see docs/OBSERVABILITY.md)")
    ap.add_argument("--ops-port", type=int, default=None, metavar="PORT",
                    help="serve the live ops plane (/metrics /healthz /statusz "
                         "/debugz/flight) on 127.0.0.1:PORT and arm the flight "
                         "recorder; 0 picks an ephemeral port (logged).  Off "
                         "by default — see docs/OBSERVABILITY.md 'Live ops "
                         "plane'.")
    ap.add_argument("--ops-host", default="127.0.0.1", metavar="ADDR",
                    help="bind address for --ops-port (default 127.0.0.1; "
                         "bind a routable address only on a trusted network "
                         "— the endpoints are unauthenticated)")
    mh = ap.add_argument_group(
        "multi-host",
        "run ONE logical worker as several processes, one per card, on one "
        "host or many.  Launch this command once per card with the same "
        "--coordinator and --num-processes and its own --process-id; rank 0 "
        "talks to the master, the others join its evaluations.")
    mh.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="rank 0's host and a free port (its TCP store)")
    mh.add_argument("--num-processes", type=int, default=None,
                    help="ranks in the worker (one per card)")
    mh.add_argument("--process-id", type=int, default=None, help="this process's rank")
    mh.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend (default nccl, which needs a card per "
                         "rank; ranks that share a card must ask for gloo)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    # Validate operator-visible knobs HERE, loudly: GentunClient clamps
    # silently (max(1, capacity), prefetch into [0, 4*capacity]) because a
    # library caller may compute them, but a typed-out `--capacity 0` is a
    # mistake the operator should hear about, not a worker that quietly
    # runs with different numbers than its command line says.
    if str(args.capacity).strip().lower() == "auto":
        # Host-level mesh worker: capacity derives from the local device
        # mesh inside GentunClient.
        args.capacity = "auto"
    else:
        try:
            args.capacity = int(args.capacity)
        except ValueError:
            raise SystemExit(
                f"--capacity must be a positive integer or 'auto', got {args.capacity!r}")
        if args.capacity <= 0:
            raise SystemExit(f"--capacity must be a positive integer, got {args.capacity}")
    if args.mesh is not None:
        from ..parallel.mesh import parse_mesh_spec

        try:
            args.mesh = parse_mesh_spec(args.mesh)
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}")
    if args.prefetch_depth is not None and args.prefetch_depth < 0:
        raise SystemExit(f"--prefetch-depth must be >= 0, got {args.prefetch_depth}")
    if args.preempt_after is not None:
        if args.preempt_after <= 0:
            raise SystemExit(
                f"--preempt-after must be > 0 seconds, got {args.preempt_after}")
        args.preempt = True  # a deadline only makes sense on preemptible capacity
    if args.ops_port is not None and not 0 <= args.ops_port <= 65535:
        raise SystemExit(f"--ops-port must be in [0, 65535], got {args.ops_port}")
    if args.cache_url is not None:
        from .fitness_service import parse_cache_url

        try:
            args.cache_url = parse_cache_url(args.cache_url)
        except ValueError as e:
            raise SystemExit(f"--cache-url: {e}")
    if args.aggregator_url is not None:
        from ..telemetry.aggregator import parse_aggregator_url

        try:
            args.aggregator_url = parse_aggregator_url(args.aggregator_url)
        except ValueError as e:
            raise SystemExit(f"--aggregator-url: {e}")
    if args.compile_cache_url is not None:
        from .fitness_service import parse_cache_url

        try:
            args.compile_cache_url = parse_cache_url(args.compile_cache_url)
        except ValueError as e:
            raise SystemExit(f"--compile-cache-url: {e}")
    if args.telemetry:
        from ..telemetry import spans as tele_spans

        tele_spans.enable()
    if args.ops_port is not None:
        from ..telemetry.ops_server import start_ops_server

        ops = start_ops_server(port=args.ops_port, host=args.ops_host)
        logging.getLogger("gentun_tpu_torch.distributed").info(
            "ops plane serving on %s (/metrics /healthz /statusz /debugz/flight)",
            ops.url)
    if (args.num_processes is not None or args.process_id is not None
            or args.backend is not None) and args.coordinator is None:
        raise SystemExit("--num-processes/--process-id/--backend require --coordinator")
    multihost = args.coordinator is not None
    if multihost and args.fitness_store:
        raise SystemExit("--fitness-store is not supported with --coordinator "
                         "(a store present on one host but not another would "
                         "diverge the ranks' evaluations)")
    if multihost and args.cache_url:
        raise SystemExit("--cache-url is not supported with --coordinator "
                         "(same rank-divergence hazard as --fitness-store: a "
                         "cache hit on one host but not another would skip "
                         "training on some ranks only)")
    if multihost and args.compile_cache_url:
        raise SystemExit("--compile-cache-url is not supported with "
                         "--coordinator (the kernel cache dir is per host, so "
                         "the leader cannot prefetch for its followers)")
    if multihost and (args.num_processes is None or args.process_id is None):
        raise SystemExit("--coordinator requires --num-processes and --process-id")
    world = 1
    if multihost:
        from ..parallel import multihost as mh_mod

        try:
            mh_mod.initialize(args.coordinator, args.num_processes, args.process_id,
                              backend=args.backend)
        except ValueError as e:
            raise SystemExit(f"--coordinator: {e}")
        world = mh_mod.process_count()
    if args.mesh is not None and args.mesh[0] * args.mesh[1] != world:
        raise SystemExit(f"--mesh: {args.mesh[0]}x{args.mesh[1]} does not factor the "
                         f"worker's {world} rank(s) (one per card; --num-processes)")
    x, y, meta = _load_dataset(args.dataset, data_dir=args.data_dir, n=args.n)
    logging.getLogger("gentun_tpu_torch.distributed").info(
        "worker data: %s (%d examples, synthetic=%s)", meta.get("source", args.dataset),
        len(x), meta.get("synthetic"),
    )

    from .client import GentunClient
    from .protocol import AuthError

    injector = None
    if args.fault_plan is not None:
        from .faults import FaultInjector, FaultPlan

        with open(args.fault_plan, "r", encoding="utf-8") as fh:
            injector = FaultInjector(FaultPlan.from_json(fh.read()))
        logging.getLogger("gentun_tpu_torch.distributed").warning(
            "fault injection ACTIVE: %d spec(s) from %s", len(injector.plan.specs), args.fault_plan
        )

    try:
        client = GentunClient(
            _species(args.species),
            x,
            y,
            host=args.host,
            port=args.port,
            password=args.password,
            capacity=args.capacity,
            prefetch_depth=args.prefetch_depth,
            mesh_override=args.mesh,
            worker_id=args.worker_id,
            multihost=multihost,
            n_chips=args.n_chips,
            fitness_store=args.fitness_store,
            cache_url=args.cache_url,
            compile_cache_url=args.compile_cache_url,
            aggregator_url=args.aggregator_url,
            fault_injector=injector,
            wire_caps=() if args.wire_v1 else None,
            preemptible=args.preempt,
            broker_urls=([u.strip() for u in args.broker_urls.split(",") if u.strip()]
                         if args.broker_urls else None),
        )
    except ValueError as e:
        # Config errors the CLI could not pre-validate.  Exit loudly
        # instead of surfacing a traceback.
        raise SystemExit(str(e))
    # Elastic-fleet exit protocol (DISTRIBUTED.md "Elastic fleet"): first
    # SIGTERM/SIGINT asks for an orderly drain — finish the window being
    # trained, hand queued-but-unstarted jobs back to the broker, exit.  A
    # second signal stops without waiting (the broker's disconnect requeue
    # covers whatever was in flight).  Registration fails on non-main
    # threads (library embedding) — skip silently there, drain() is still
    # callable programmatically.
    import signal

    def _on_signal(signum, frame):
        if client.draining:
            logging.getLogger("gentun_tpu_torch.distributed").warning(
                "second signal: stopping without waiting for in-flight work")
            client.shutdown()
        else:
            logging.getLogger("gentun_tpu_torch.distributed").info(
                "drain requested (signal %d): finishing in-flight work, "
                "requeueing the rest; signal again to stop now", signum)
            client.drain()

    # Preemption deadline (DISTRIBUTED.md "Autoscaling & preemptible
    # capacity"): SIGUSR1 — or the --preempt-after timer for deterministic
    # studies — is "your capacity is being reclaimed".  It reuses the
    # drain machinery above verbatim, differing only in the wire-level
    # ``reason`` so the broker's requeue lineage attributes the churn to
    # preemption; a second SIGUSR1 escalates to shutdown like SIGTERM.
    def _on_preempt(signum=None, frame=None):
        if client.draining:
            client.shutdown()
            return
        logging.getLogger("gentun_tpu_torch.distributed").warning(
            "preemption deadline: self-draining (in-flight work finishes, "
            "queued jobs requeue to the fleet)")
        from ..telemetry.registry import get_registry

        get_registry().counter("preemptions_total",
                               worker=client.worker_id).inc()
        client.drain(reason="preempt")

    try:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
        if args.preempt:
            signal.signal(signal.SIGUSR1, _on_preempt)
    except ValueError:  # pragma: no cover - non-main-thread embedding
        pass
    if args.preempt_after is not None:
        import threading

        timer = threading.Timer(args.preempt_after, _on_preempt)
        timer.daemon = True
        timer.start()
    try:
        done = client.work(max_jobs=args.max_jobs)
    except AuthError as e:
        raise SystemExit(f"fatal: {e}")
    import torch

    from ..ops.pop_conv import LAUNCHES

    usage = {"kernel_launches": dict(LAUNCHES)}
    if torch.cuda.is_initialized():
        usage["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
        usage["peak_memory_reserved"] = torch.cuda.max_memory_reserved()
    if multihost:
        usage["rank"] = mh_mod.process_index()
        mh_mod.shutdown()
    logging.getLogger("gentun_tpu_torch.distributed").info(
        "worker exiting after %d job(s); %s", done, json.dumps(usage))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
