"""Measured HA artifact for the crash-safe broker: the
dispatch journal, restart re-adoption, and admission control exercised
the way DISTRIBUTED.md "Broker crash safety & admission control"
describes them, with every headline claim asserted and recorded.

Four arms, one JSON artifact (``scripts/torch_ha_study.json``):

- **restart_storm** — hundreds of short synthetic search sessions
  (``SessionClient`` tenants over the wire, 8 masters × 30 sessions × 3
  jobs) against a journaled broker that is SIGKILL-equivalently killed
  and journal-restarted THREE times mid-swarm.  Asserts zero lost
  searches (every session collects every result) and that the
  per-session best-fitness vector is bit-identical to a no-kill
  reference pass AND to the local analytic evaluation of the same
  genomes.

- **saturation** — a greedy tenant hammers ``submit`` past its
  token-bucket admission rate while the broker pushes metrics to a live
  aggregator running the STOCK SLO rules.  Asserts every rejection
  carries a positive ``retry_after_s``, the stock
  ``admission_rejection_burn`` rule trips on ``/alertz`` and
  self-clears once the pressure stops, and no admitted batch misses a
  result.

- **journal_gate** — re-measures broker dispatch throughput on this
  box and re-runs the ≤ 2% journaling-overhead gate against it
  (same code path as ``broker_throughput.run_journal_gate``).

- **wire_identity** — byte-level transcript comparison of an identical
  deterministic exchange (client handshake, session open/submit/result/
  close, worker handshake/dispatch) against a journal-off and a
  journal-on broker: the journal-off transcript must contain no
  crash-safety fields at all, and the journal-on transcript must differ
  ONLY by the optional ``boot_id``/``boot`` fields — journaling off is
  byte-identical to the pre-journal wire.

CPU-only, a few seconds: ``python scripts/torch_ha_study.py`` writes
``scripts/torch_ha_study.json``.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
import urllib.request

import numpy as np

_SCRIPT_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_SCRIPT_DIR))
sys.path.insert(0, _SCRIPT_DIR)

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import Individual, Population, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import (  # noqa: E402
    GentunClient,
    JobBroker,
    SessionClient,
)
from gentun_tpu_torch.distributed.protocol import MAX_MESSAGE_BYTES, decode, encode  # noqa: E402
from gentun_tpu_torch.telemetry import get_registry  # noqa: E402
from gentun_tpu_torch.telemetry.aggregator import MetricsAggregator  # noqa: E402
from gentun_tpu_torch.telemetry.slo import default_rules  # noqa: E402

DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))

N_MASTERS = 8
SESSIONS_PER_MASTER = 30
JOBS_PER_SESSION = 3
N_SESSIONS = N_MASTERS * SESSIONS_PER_MASTER
N_KILLS = 3
FSYNC_INTERVAL = 0.01
SLO_SCALE = 0.05  # 60 s window → 3 s: the study must see a trip AND a clear


class OneMax(Individual):
    """Deterministic bit-count fitness: distributed and local evaluations
    are comparable bit-for-bit, so "zero lost searches" is checkable."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def _worker(port, worker_id):
    stop = threading.Event()
    client = GentunClient(
        OneMax, *DATA, host="127.0.0.1", port=port, worker_id=worker_id,
        heartbeat_interval=0.2, reconnect_delay=0.05, reconnect_max_delay=0.5)
    threading.Thread(target=lambda: client.work(stop_event=stop),
                     daemon=True).start()
    return stop


def _onemax(genes) -> float:
    return float(sum(sum(g) for g in genes.values()))


def _session_genomes():
    """Deterministic per-session genome triples, shared by every arm."""
    out = []
    for i in range(N_SESSIONS):
        pop = Population(OneMax, *DATA, size=JOBS_PER_SESSION, seed=1000 + i)
        out.append([ind.get_genes() for ind in pop])
    return out


def _journal_path(tag: str) -> str:
    path = os.path.join(_SCRIPT_DIR, f".torch_ha_{tag}.journal")
    for p in (path, path + ".snap"):
        if os.path.exists(p):
            os.unlink(p)
    return path


def _cleanup_journal(path: str) -> None:
    for p in (path, path + ".snap"):
        if os.path.exists(p):
            os.unlink(p)


# ---------------------------------------------------------------------------
# Arm 1: restart storm
# ---------------------------------------------------------------------------


def _run_session(client: SessionClient, sid: str, genomes) -> float:
    """One short synthetic search: open → submit → collect all → close.
    Every wire step retries across broker death; resubmission rides the
    at-least-once path (duplicate completions of a deterministic fitness
    are idempotent)."""
    deadline = time.monotonic() + 120.0

    def _retry(fn):
        while True:
            try:
                return fn()
            except (OSError, ConnectionResetError, TimeoutError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)

    _retry(lambda: client.open_session(sid, weight=1.0))
    payloads = {f"{sid}-j{k}": {"genes": g} for k, g in enumerate(genomes)}
    _retry(lambda: client.submit(sid, dict(payloads)))
    pending = set(payloads)
    results: dict = {}
    last_progress = time.monotonic()
    while pending:
        if time.monotonic() > deadline:
            raise AssertionError(f"session {sid} lost jobs: {sorted(pending)}")
        got, failed = client.wait_any(sorted(pending), timeout=1.0)
        assert not failed, f"session {sid} failures: {failed}"
        if got:
            results.update(got)
            pending -= set(got)
            last_progress = time.monotonic()
        elif time.monotonic() - last_progress > 3.0:
            # A submit that died in the un-fsynced journal buffer is
            # GONE from the restarted broker — the master's retry is the
            # at-least-once contract, exactly like a reaped worker.
            _retry(lambda: client.submit(
                sid, {j: payloads[j] for j in pending}))
            last_progress = time.monotonic()
    try:
        _retry(lambda: client.close_session(sid))
    except Exception:
        pass  # close is best-effort bookkeeping; results are already home
    return max(results.values())


def _storm(port: int, genomes) -> list:
    """Drive the session storm; returns the per-session best-fitness list
    (index-aligned with ``genomes``)."""
    best = [None] * N_SESSIONS
    errors: list = []

    def _master(m: int):
        client = SessionClient("127.0.0.1", port, reconnect=True,
                               reconnect_window=60.0, reconnect_max_delay=0.5)
        try:
            for k in range(SESSIONS_PER_MASTER):
                i = m * SESSIONS_PER_MASTER + k
                best[i] = _run_session(client, f"ha-{i:03d}", genomes[i])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(f"master {m}: {type(e).__name__}: {e}")
        finally:
            client.close()

    threads = [threading.Thread(target=_master, args=(m,), daemon=True)
               for m in range(N_MASTERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors, f"storm masters failed: {errors}"
    assert all(b is not None for b in best), "storm left sessions unfinished"
    return best


def run_restart_storm() -> dict:
    genomes = _session_genomes()
    analytic = [max(_onemax(g) for g in triple) for triple in genomes]
    total_jobs = N_SESSIONS * JOBS_PER_SESSION

    # -- no-kill reference pass (journaled broker, no kill) ---------------
    get_registry().reset()
    ref_path = _journal_path("ref")
    broker = JobBroker(port=_free_port(), journal_path=ref_path,
                       journal_fsync_interval=FSYNC_INTERVAL).start()
    _, port = broker.address
    stops = [_worker(port, f"ref-w{i}") for i in range(4)]
    try:
        ref_best = _storm(port, genomes)
    finally:
        for s in stops:
            s.set()
        broker.stop()
        _cleanup_journal(ref_path)
    assert ref_best == analytic, "reference storm diverged from analytic"

    # -- kill arm: same storm, three SIGKILL+journal-restarts mid-swarm --
    get_registry().reset()
    kill_path = _journal_path("storm")
    broker = JobBroker(port=_free_port(), journal_path=kill_path,
                       journal_fsync_interval=FSYNC_INTERVAL).start()
    _, port = broker.address
    stops = [_worker(port, f"storm-w{i}") for i in range(4)]
    kills: list = []

    def _completes() -> int:
        jrn = broker._journal
        return (jrn.status()["records_total"].get("c", 0)
                if jrn is not None else -1)

    def _killer():
        for frac in (0.25, 0.5, 0.75):
            target = int(total_jobs * frac)
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline and _completes() < target:
                time.sleep(0.002)
            t0 = time.monotonic()
            broker.kill()   # journal buffer abandoned, like kill -9
            broker.start()  # same port, replayed from the journal
            kills.append({"at_completions": target,
                          "restart_wall_s": round(time.monotonic() - t0, 3)})

    killer = threading.Thread(target=_killer, daemon=True)
    t0 = time.monotonic()
    try:
        killer.start()
        kill_best = _storm(port, genomes)
        killer.join(timeout=120)
        wall = time.monotonic() - t0
        ops = broker._ops_status()
        leaked = broker.outstanding()
    finally:
        for s in stops:
            s.set()
        broker.stop()
        _cleanup_journal(kill_path)

    assert len(kills) == N_KILLS, f"only {len(kills)} kills fired"
    assert ops["restarts"] == N_KILLS and ops["epoch"] == N_KILLS + 1, ops
    identical = kill_best == ref_best
    assert identical, "kill-arm best-fitness vector diverged from reference"
    assert kill_best == analytic
    # Orphan results are the documented at-least-once residue of resubmits
    # racing completions across a kill; every other table must be empty.
    non_result = {k: v for k, v in leaked.items() if k != "results"}
    assert all(v == 0 for v in non_result.values()), f"leaked: {leaked}"

    return {
        "sessions": N_SESSIONS,
        "masters": N_MASTERS,
        "jobs_per_session": JOBS_PER_SESSION,
        "workers": 4,
        "kills": kills,
        "epoch_after_storm": ops["epoch"],
        "restarts": ops["restarts"],
        "journal": ops["journal"],
        "lost_searches": 0,
        "best_fitness_bit_identical_to_no_kill_reference": identical,
        "best_fitness_matches_analytic": True,
        "orphan_results_tolerated": leaked["results"],
        "broker_state_after_storm": leaked,
        "wall_s": round(wall, 3),
    }


# ---------------------------------------------------------------------------
# Arm 2: saturation + stock SLO rule
# ---------------------------------------------------------------------------


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=5.0) as resp:
        return json.loads(resp.read())


def _wait_for(predicate, timeout_s: float, poll_s: float = 0.1):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        got = predicate()
        if got:
            return got
        time.sleep(poll_s)
    return None


def run_saturation() -> dict:
    os.environ["GENTUN_TPU_AGG_PUSH_INTERVAL"] = "0.25"
    # Full resends carry the flatline the clear edge needs: at the scaled
    # 3 s window a heartbeat must land well inside it, or the rule abstains
    # (holds FIRING) instead of observing the counter go quiet.
    os.environ["GENTUN_TPU_AGG_FULL_EVERY"] = "3"
    get_registry().reset()
    agg = MetricsAggregator("127.0.0.1", 0,
                            slo_rules=default_rules(scale=SLO_SCALE),
                            slo_interval=0.25, instance_ttl=10.0)
    agg.start()
    broker = JobBroker(port=0, admission_rate=4.0, admission_burst=2.0,
                       aggregator_url=agg.url).start()
    _, port = broker.address
    stops = [_worker(port, f"sat-w{i}") for i in range(2)]
    client = SessionClient("127.0.0.1", port)
    expected: dict = {}    # admitted job_id -> analytic fitness
    collected: dict = {}   # admitted job_id -> delivered fitness
    outstanding: set = set()
    rejections: list = []
    genes_a = {"S_1": [1, 0, 1, 0, 1, 0], "S_2": [1, 1, 0, 0, 1, 1]}
    genes_b = {"S_1": [0, 1, 1, 1, 0, 0], "S_2": [1, 0, 0, 1, 0, 1]}
    try:
        sid = client.open_session("greedy", weight=1.0)
        # -- pressure: hammer submits far past 4 tokens/s -----------------
        t_pressure = time.monotonic()
        batch = 0
        while time.monotonic() - t_pressure < 2.5:
            with client._cond:
                since = client._error_seq
            ids = {f"sat-b{batch}-j{k}": {"genes": g}
                   for k, g in enumerate((genes_a, genes_b))}
            client.submit(sid, dict(ids))
            batch += 1
            verdict = None
            t_wait = time.monotonic()
            while verdict is None and time.monotonic() - t_wait < 2.0:
                with client._cond:
                    fresh = (list(client._errors)[-(client._error_seq - since):]
                             if client._error_seq > since else [])
                    rejected = [e for e in fresh
                                if e.get("code") == "admission"]
                if rejected:
                    verdict = ("rejected", rejected[-1])
                    break
                got, failed = client.wait_any(sorted(ids), timeout=0.05)
                assert not failed, failed
                if got:
                    # First result proves the batch was ADMITTED: book the
                    # whole batch, keep draining the rest later.
                    expected.update(
                        {j: _onemax(ids[j]["genes"]) for j in ids})
                    collected.update(got)
                    outstanding |= set(ids) - set(got)
                    verdict = ("admitted", got)
            assert verdict is not None, "submit neither admitted nor rejected"
            if verdict[0] == "rejected":
                err = verdict[1]
                retry = float(err.get("retry_after_s") or 0.0)
                assert retry > 0.0, f"rejection missing retry_after_s: {err}"
                rejections.append({"reason": err.get("reason"),
                                   "retry_after_s": retry})
        pressure_wall = time.monotonic() - t_pressure

        # -- the STOCK rule must trip on /alertz ... ----------------------
        fired = _wait_for(
            lambda: [a for a in _get_json(agg.url + "/alertz")["active"]
                     if a["rule"] == "admission_rejection_burn"],
            timeout_s=15.0)
        assert fired, "admission_rejection_burn never fired"
        t_fired = time.monotonic()

        # -- drain: no admitted batch may miss a result -------------------
        deadline = time.monotonic() + 30.0
        while outstanding and time.monotonic() < deadline:
            got, failed = client.wait_any(sorted(outstanding), timeout=1.0)
            assert not failed, failed
            collected.update(got)
            outstanding -= set(got)
        assert not outstanding, (
            f"admitted jobs missing results: {sorted(outstanding)}")
        assert collected == expected, "admitted results diverged from analytic"

        # -- ... and self-clear once the pressure stops -------------------
        cleared = _wait_for(
            lambda: not [a for a in _get_json(agg.url + "/alertz")["active"]
                         if a["rule"] == "admission_rejection_burn"] or None,
            timeout_s=30.0)
        assert cleared, "admission_rejection_burn never self-cleared"
        t_cleared = time.monotonic()
        ops = broker._ops_status()
    finally:
        client.close()
        for s in stops:
            s.set()
        broker.stop()
        agg.stop()
        os.environ.pop("GENTUN_TPU_AGG_PUSH_INTERVAL", None)
        os.environ.pop("GENTUN_TPU_AGG_FULL_EVERY", None)

    assert rejections, "pressure never produced an admission rejection"
    reasons = sorted({r["reason"] for r in rejections})
    return {
        "admission": {"rate": 4.0, "burst": 2.0},
        "pressure_wall_s": round(pressure_wall, 3),
        "batches_submitted": batch,
        "batches_admitted": batch - len(rejections),
        "rejections": len(rejections),
        "rejection_reasons": reasons,
        "retry_after_s_min": min(r["retry_after_s"] for r in rejections),
        "retry_after_s_max": max(r["retry_after_s"] for r in rejections),
        "admitted_jobs": len(expected),
        "admitted_jobs_missing_results": 0,
        "slo_rule": "admission_rejection_burn",
        "slo_scale": SLO_SCALE,
        "alert_fired_after_s": round(t_fired - t_pressure, 3),
        "alert_cleared_after_s": round(t_cleared - t_fired, 3),
        "rejected_by_session": ops["admission"]["rejected_by_session"],
    }


# ---------------------------------------------------------------------------
# Arm 3: journal hot-path gate (re-measured on this box)
# ---------------------------------------------------------------------------


def run_journal_gate_arm() -> dict:
    import broker_throughput as bt

    get_registry().reset()
    base = bt.run(n_jobs=1500, n_workers=4)
    per_job_us = round(1e6 / base["jobs_per_sec"], 1)
    gate = bt.run_journal_gate(per_job_dispatch_us=per_job_us)
    assert gate["within_gate"], gate
    return gate


# ---------------------------------------------------------------------------
# Arm 4: journal-off wire byte-identity
# ---------------------------------------------------------------------------


class _RawPeer:
    """Raw frame-level socket: captures the exact bytes the broker sends."""

    def __init__(self, port: int, hello: dict):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        self.sock.settimeout(5.0)
        self.rfile = self.sock.makefile("rb")
        self.frames: list = []  # raw bytes, in arrival order
        self.send(hello)

    def send(self, msg: dict) -> None:
        self.sock.sendall(encode(msg))

    def recv(self) -> dict:
        line = self.rfile.readline(MAX_MESSAGE_BYTES + 2)
        if not line:
            raise ConnectionError("broker closed connection")
        self.frames.append(line)
        return decode(line)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _wire_transcript(journal_path) -> dict:
    """One deterministic exchange; returns the raw frame transcripts."""
    kwargs = {}
    if journal_path is not None:
        kwargs = {"journal_path": journal_path,
                  "journal_fsync_interval": FSYNC_INTERVAL}
    broker = JobBroker(port=0, **kwargs).start()
    _, port = broker.address
    genes = {"S_1": [1, 0, 1, 0, 1, 0], "S_2": [1, 1, 0, 0, 1, 1]}
    client = worker = None
    try:
        client = _RawPeer(port, {"type": "hello", "role": "client",
                                 "token": None})
        assert client.recv()["type"] == "welcome"
        worker = _RawPeer(port, {"type": "hello", "worker_id": "probe-w",
                                 "capacity": 1})
        assert worker.recv()["type"] == "welcome"

        client.send({"type": "session_open", "session": "wire-probe",
                     "weight": 1.0})
        assert client.recv()["type"] == "session_ok"
        client.send({"type": "submit", "session": "wire-probe",
                     "jobs": [{"job_id": "wp-j0", "genes": genes}]})
        worker.send({"type": "ready", "credit": 1})
        jobs = worker.recv()
        assert jobs["type"] in ("jobs", "jobs2"), jobs
        worker.send({"type": "result", "job_id": "wp-j0",
                     "fitness": _onemax(genes)})
        results = client.recv()
        assert results["type"] == "results", results
        client.send({"type": "session_close", "session": "wire-probe"})
        assert client.recv()["type"] == "session_ok"
    finally:
        if client is not None:
            client.close()
        if worker is not None:
            worker.close()
        broker.stop()
    return {"client": client.frames, "worker": worker.frames}


def _strip_boot(frame: bytes) -> bytes:
    msg = decode(frame)
    msg.pop("boot_id", None)
    msg.pop("boot", None)
    return encode(msg)


def run_wire_identity() -> dict:
    get_registry().reset()
    off = _wire_transcript(None)
    on_path = _journal_path("wire")
    try:
        on = _wire_transcript(on_path)
    finally:
        _cleanup_journal(on_path)

    off_all = off["client"] + off["worker"]
    assert all(b"boot" not in f for f in off_all), (
        "journal-off broker leaked crash-safety fields onto the wire")
    boot_only_delta = True
    for side in ("client", "worker"):
        assert len(off[side]) == len(on[side])
        for f_off, f_on in zip(off[side], on[side]):
            # Journal-off frames ARE the baseline encoding: stripping the
            # optional boot fields from the journal-on frame must yield
            # the exact journal-off bytes.
            if _strip_boot(f_on) != f_off:
                boot_only_delta = False
    assert boot_only_delta, "journal on/off transcripts differ beyond boot"
    return {
        "frames_compared": len(off_all),
        "journal_off_has_no_boot_fields": True,
        "journal_on_delta_is_boot_fields_only": True,
        "client_frame_types": [decode(f)["type"] for f in off["client"]],
        "worker_frame_types": [decode(f)["type"] for f in off["worker"]],
    }


if __name__ == "__main__":
    out = {
        "restart_storm": run_restart_storm(),
        "saturation": run_saturation(),
        "journal_gate": run_journal_gate_arm(),
        "wire_identity": run_wire_identity(),
    }
    print(json.dumps(out, indent=2))
    path = out_path("torch_ha_study.json")
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
