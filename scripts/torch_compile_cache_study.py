"""Acceptance study for the fleet-wide compile cache of the port's kernel
library (DISTRIBUTED.md "Fleet-wide compile cache").

The port compiles one thing at run time: ``ops/_build.py`` runs ``nvcc``
over ``gentun_tpu_torch/csrc/`` into ``libgentun_kernels_<hash>.so`` in the
kernel cache directory, and ``distributed/compile_service.py`` ships that
file between hosts.  Three measured acts, written to
``scripts/torch_compile_cache_study.json``:

1. **Cold join** (``nvcc`` and a card): what a freshly-joined host pays
   before it can launch a kernel, before vs after the service.  Before = an
   ``nvcc`` build of the library into an empty cache directory.  After = a
   fetch of the library from a ``CompileService`` plus its ``ctypes`` load.
   Both sides are micro-timed (``time.perf_counter`` around the exact
   call); the structural proof is that the warm host's cache directory
   gains no file when it loads, i.e. no build ran.

2. **Recompile storm** (``nvcc`` and a card): one host builds the library
   and publishes it; three late joiners, each a process with a cache
   directory of its own, start together, prefetch, then call
   ``_build.library()``.  Asserted: no late joiner runs ``nvcc`` or writes
   a new file, and each one's library has host 0's bytes.  The record keeps
   the reference's key ``recompile_storm_jax`` for this act.

3. **Service killed mid-search** (host only, seeded): a distributed
   OneMax search with the compile service killed after the first
   generation must finish bit-identical to a service-free single-process
   run, with exactly ONE ``compile_service_degraded`` event — cache
   downtime costs rebuilds, never correctness.

Acts 1 and 2 need ``nvcc`` and a CUDA card; without them the study exits
non-zero and names what is missing (it never loads a library built
elsewhere).  ``--acts 3`` runs act 3 alone, anywhere:

    python scripts/torch_compile_cache_study.py              # all three acts
    python scripts/torch_compile_cache_study.py --acts 3 --out /tmp/cc.json
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gentun_tpu_torch import GeneticAlgorithm, Individual, Population, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import DistributedPopulation, GentunClient  # noqa: E402
from gentun_tpu_torch.distributed.compile_service import (  # noqa: E402
    CompileService,
    CompileServiceClient,
    platform_fingerprint,
)
from gentun_tpu_torch.telemetry import spans as spans_mod  # noqa: E402
from gentun_tpu_torch.utils.records import SCRIPTS, stamp  # noqa: E402

#: Late joiners of act 2, each its own process and cache directory.
LATE_JOINERS = 3


# -- acts 1 + 2: the kernel library, built or fetched -------------------------

def missing_toolchain():
    """What acts 1-2 lack here (``nvcc``, a CUDA card), or None."""
    import torch

    from gentun_tpu_torch.ops import _build

    missing = []
    try:
        nvcc = _build._nvcc()
        if not os.path.exists(nvcc):
            missing.append(f"nvcc (not at {nvcc})")
    except RuntimeError as e:
        missing.append(f"nvcc ({e})")
    if not torch.cuda.is_available():
        missing.append("a CUDA card (torch.cuda.is_available() is False)")
    return ", ".join(missing) or None


def _build_into(cache_dir: str):
    """``nvcc``-build the library into ``cache_dir``; (path, seconds)."""
    from gentun_tpu_torch.ops import _build
    from gentun_tpu_torch.utils.kernel_cache import enable_compilation_cache

    assert enable_compilation_cache(cache_dir) == cache_dir
    assert not _build.library_path().exists(), "the cache directory is not empty"
    t0 = time.perf_counter()
    path = _build.build()
    return path, time.perf_counter() - t0


def _digest(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def run_cold_join_study() -> dict:
    """Micro-timed cold-join cost, before vs after the compile service."""
    from gentun_tpu_torch.ops import _build
    from gentun_tpu_torch.utils.kernel_cache import list_cache_entries

    root = tempfile.mkdtemp(prefix="compile-study-")
    saved = _build.build_dir()
    svc = CompileService(port=0).start()
    try:
        # BEFORE: a cold host pays the nvcc build.
        dir_a = os.path.join(root, "host_a")
        lib_a, t_compile = _build_into(dir_a)
        entries_a = list_cache_entries(dir_a)
        assert entries_a, "the build wrote no cache entry"

        # Host A publishes its library to the fleet.
        client_a = CompileServiceClient(svc.url, cache_dir=dir_a)
        client_a.scan_publish()
        assert client_a.flush(60.0), "publish queue failed to drain"
        client_a.close()

        # AFTER: host B joins cold — prefetch (micro-timed) ...
        dir_b = os.path.join(root, "host_b")
        client_b = CompileServiceClient(svc.url, cache_dir=dir_b)
        t0 = time.perf_counter()
        fetched = client_b.prefetch()
        t_fetch = time.perf_counter() - t0
        client_b.close()
        assert fetched == len(entries_a), (
            f"prefetch pulled {fetched}/{len(entries_a)} entries")

        # ... then needs the kernels: the cache must serve a LOAD.
        _build.use_build_dir(dir_b)
        before = set(list_cache_entries(dir_b))
        t0 = time.perf_counter()
        ctypes.CDLL(str(_build.build()))
        t_load = time.perf_counter() - t0
        after = set(list_cache_entries(dir_b))
        assert after == before, "warm host wrote new cache entries — it truly rebuilt"
        assert _digest(os.path.join(dir_b, lib_a.name)) == _digest(lib_a)
        library_bytes = lib_a.stat().st_size
    finally:
        _build.use_build_dir(saved)
        svc.stop()
        shutil.rmtree(root, ignore_errors=True)

    before_s = t_compile
    after_s = t_fetch + t_load
    print(f"[cold join] nvcc build {t_compile:.3f} s; fetch {t_fetch:.4f} s + load "
          f"{t_load:.4f} s of {library_bytes} bytes", flush=True)
    return {
        "program_entries": len(entries_a),
        "cold_join_before_s": round(before_s, 4),
        "cold_join_after_s": round(after_s, 4),
        "compile_s": round(t_compile, 4),
        "fetch_s": round(t_fetch, 4),
        "cache_load_s": round(t_load, 4),
        "speedup_x": round(before_s / after_s, 2) if after_s > 0 else None,
        "warm_host_wrote_new_entries": False,
    }


def late_joiner(cache_dir: str, url: str) -> dict:
    """One late joiner of the storm (run as its own process): prefetch into
    ``cache_dir``, then load the kernels through ``_build.library()``."""
    from gentun_tpu_torch.ops import _build
    from gentun_tpu_torch.utils.kernel_cache import enable_compilation_cache, list_cache_entries

    assert enable_compilation_cache(cache_dir) == cache_dir
    client = CompileServiceClient(url, cache_dir=cache_dir)
    fetched = client.prefetch()
    client.close()
    prefetched = set(list_cache_entries(cache_dir))
    _build.library()
    path = _build.library_path()
    return {"fetched": fetched, "new_files": sorted(set(list_cache_entries(cache_dir)) - prefetched),
            "nvcc_ran": bool(_build.build_log), "library": path.name,
            "sha256": _digest(path) if path.exists() else None}


def run_recompile_storm() -> dict:
    """The storm: late joiners must run ``nvcc`` ZERO times."""
    from gentun_tpu_torch.ops import _build
    from gentun_tpu_torch.utils.kernel_cache import list_cache_entries

    root = tempfile.mkdtemp(prefix="compile-storm-")
    saved = _build.build_dir()
    svc = CompileService(port=0).start()
    compiles_per_host, joiners = {}, {}
    try:
        # Host 0 pays the build and publishes.
        dir_0 = os.path.join(root, "host0")
        lib_0, _ = _build_into(dir_0)
        n_artifacts = len(list_cache_entries(dir_0))
        compiles_per_host["host0"] = n_artifacts
        client_0 = CompileServiceClient(svc.url, cache_dir=dir_0)
        client_0.scan_publish()
        assert client_0.flush(60.0)
        client_0.close()

        # Hosts 1-3 join at once: each prefetches, then needs the kernels.
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs = {f"host{h}": subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--late-joiner",
             os.path.join(root, f"host{h}"), svc.url],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for h in range(1, LATE_JOINERS + 1)}
        for host, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{host} failed ({proc.returncode}):\n{err[-3000:]}"
            joiners[host] = json.loads(out.strip().splitlines()[-1])
        want = _digest(lib_0)
        for host, j in joiners.items():
            assert j["fetched"] == n_artifacts, f"{host} prefetched {j['fetched']}/{n_artifacts}"
            assert not j["nvcc_ran"] and not j["new_files"], f"{host} truly rebuilt: {j}"
            assert j["library"] == lib_0.name and j["sha256"] == want, (
                f"{host}'s library is not host 0's bytes: {j}")
            compiles_per_host[host] = len(j["new_files"]) + int(j["nvcc_ran"])
    finally:
        _build.use_build_dir(saved)
        svc.stop()
        shutil.rmtree(root, ignore_errors=True)

    total = sum(compiles_per_host.values())
    assert total == n_artifacts, "the library was built more than once"
    print(f"[storm] host 0 built {n_artifacts} library; {LATE_JOINERS} late joiners ran nvcc "
          f"{sum(int(j['nvcc_ran']) for j in joiners.values())} times, each loaded host 0's "
          f"bytes", flush=True)
    return {
        "program_shapes": 1,
        "artifacts": n_artifacts,
        "compiles_per_host": compiles_per_host,
        "fleet_wide_true_compiles": total,
        "max_compiles_per_shape_fleet_wide": 1,
        "late_joiner_true_compiles": 0,
    }


# -- act 3: service killed mid-search ----------------------------------------

DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))


class OneMax(Individual):
    """Deterministic host-only fitness: local and distributed runs are
    comparable bit-for-bit (same pattern as scripts/torch_chaos_run.py)."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


class _ListSink:
    def __init__(self):
        self.records = []

    def record(self, rec):
        self.records.append(rec)


def _snapshot(ga):
    return {
        "history": [r["best_fitness"] for r in ga.history],
        "final": [
            {"genes": {k: list(v) for k, v in ind.get_genes().items()},
             "fitness": ind.get_fitness()}
            for ind in ga.population
        ],
    }


def run_service_killed_study() -> dict:
    """Kill the compile service mid-search: bit-identical, ONE event."""
    generations, pop_size, pop_seed, ga_seed = 4, 8, 42, 7

    ref = GeneticAlgorithm(
        Population(OneMax, *DATA, size=pop_size, seed=pop_seed), seed=ga_seed)
    ref.run(generations)

    root = tempfile.mkdtemp(prefix="compile-kill-")
    cache_dir = os.path.join(root, "kernels")
    saved_env = os.environ.get("GENTUN_TORCH_CACHE_DIR")
    os.environ["GENTUN_TORCH_CACHE_DIR"] = cache_dir
    sink = _ListSink()
    spans_mod.enable()
    spans_mod.set_run_sink(sink)

    svc = CompileService(port=0).start()
    # Pre-seed one artifact under the worker's fingerprint (OneMax never
    # probes devices) so the join-time prefetch is exercised too.
    svc.publish(platform_fingerprint(probe_devices=False),
                [("entry_warm", b"warm-artifact")])

    stop = threading.Event()
    try:
        with DistributedPopulation(OneMax, size=pop_size, seed=pop_seed,
                                   port=0, job_timeout=60.0) as pop:
            _, port = pop.broker_address
            worker = GentunClient(
                OneMax, *DATA, port=port, capacity=4,
                heartbeat_interval=0.2, reconnect_delay=0.05,
                compile_cache_url=svc.url)
            t = threading.Thread(
                target=lambda: worker.work(stop_event=stop), daemon=True)
            t.start()
            ga = GeneticAlgorithm(pop, seed=ga_seed)

            def _kill_then_dirty():
                # Pull the plug mid-search, then dirty the local cache so
                # the next publish scan must talk to the dead service.
                while not ga.history:
                    time.sleep(0.005)
                svc.stop()
                with open(os.path.join(cache_dir, "entry_fresh"), "wb") as fh:
                    fh.write(b"freshly-compiled")

            killer = threading.Thread(target=_kill_then_dirty, daemon=True)
            killer.start()
            ga.run(generations)
            killer.join(timeout=10)
            stats = worker._compile_client.stats()

        identical = _snapshot(ga) == _snapshot(ref)
        assert identical, "compile-service kill perturbed the search"
        assert stats["fetched"] == 1, "join-time prefetch did not run"

        # Stop the worker: its close() runs the final publish scan, which
        # finds entry_fresh and must hit the dead service → degraded path.
        stop.set()
        t.join(timeout=10)
        deadline = time.monotonic() + 5.0
        evs = []
        while time.monotonic() < deadline:
            evs = [r for r in sink.records
                   if r.get("type") == "event"
                   and r["name"] == "compile_service_degraded"]
            if evs:
                break
            time.sleep(0.02)  # flusher may still be timing out on the POST
        assert len(evs) == 1, f"expected ONE degraded event, got {len(evs)}"
    finally:
        stop.set()
        try:
            svc.stop()
        except Exception:
            pass
        spans_mod.disable()
        spans_mod.set_run_sink(None)
        if saved_env is None:
            os.environ.pop("GENTUN_TORCH_CACHE_DIR", None)
        else:
            os.environ["GENTUN_TORCH_CACHE_DIR"] = saved_env
        shutil.rmtree(root, ignore_errors=True)

    return {
        "generations": generations,
        "bit_identical_to_service_free_run": True,
        "prefetched_artifacts": stats["fetched"],
        "degraded_events": len(evs),
        "worker_compile_cache": {k: stats[k] for k in
                                 ("fetched", "published", "degraded")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--acts", type=int, nargs="+", choices=(1, 2, 3), default=[1, 2, 3])
    ap.add_argument("--out", default=os.path.join(SCRIPTS, "torch_compile_cache_study.json"))
    ap.add_argument("--late-joiner", nargs=2, metavar=("CACHE_DIR", "URL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.late_joiner:
        print(json.dumps(late_joiner(*args.late_joiner)))
        return 0
    if {1, 2} & set(args.acts):
        missing = missing_toolchain()
        if missing:
            print(f"torch_compile_cache_study: acts 1-2 build the kernel library and need "
                  f"nvcc and a CUDA card; missing here: {missing}.  Run --acts 3 for the "
                  f"host-only act.", file=sys.stderr)
            return 2
    out = {}
    if 1 in args.acts:
        out["cold_join"] = run_cold_join_study()
    if 2 in args.acts:
        # The reference's key; here it holds the nvcc storm.
        out["recompile_storm_jax"] = run_recompile_storm()
    if 3 in args.acts:
        out["service_killed"] = run_service_killed_study()
    stamp(out)
    print(json.dumps(out, indent=2))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
