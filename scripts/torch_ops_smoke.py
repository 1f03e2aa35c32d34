"""Measured ops-plane artifact: the stall→503→recovery story, recorded.

DISTRIBUTED.md records the dispatch plane's happy path and
``torch_chaos_run.json`` the unhappy one; this script records the *ops* story
(OBSERVABILITY.md "Live ops plane"): a seeded 2-worker search serving
``/metrics`` + ``/healthz`` + ``/statusz`` + ``/debugz/flight`` from an
in-process ops server while one worker is stalled mid-run by an injected
``hang`` fault.  A 20 Hz poller samples ``/healthz`` throughout and the
artifact asserts the acceptance sequence:

1. the fleet starts **healthy** (200),
2. the stalled job is flagged by the stall watchdog within its window
   and ``/healthz`` flips to **503** with a straggler reason,
3. the hang ends, the result lands, the flag clears, and ``/healthz``
   **recovers** to 200 with no operator action.

The broker's reaper is pinned out of the story (``heartbeat_timeout=30``
vs a 3 s hang) so the watchdog — not heartbeat reaping — is what acts.
Every ``/metrics`` scrape is validated against the Prometheus text
exposition grammar, and the flight recorder ring must hold the
``straggler_detected`` event afterwards.

CPU-only, a few seconds: `python scripts/torch_ops_smoke.py` writes
``scripts/torch_ops_smoke.json``.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gentun_tpu_torch.utils.records import out_path, stamp  # noqa: E402
from gentun_tpu_torch import GeneticAlgorithm, Individual, Population, genetic_cnn_genome  # noqa: E402
from gentun_tpu_torch.distributed import (  # noqa: E402
    DistributedPopulation,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    GentunClient,
)
from gentun_tpu_torch.telemetry.ops_server import start_ops_server, stop_ops_server  # noqa: E402
from gentun_tpu_torch.telemetry.registry import get_registry  # noqa: E402

GENERATIONS = 2
POP_SIZE = 8
POP_SEED, GA_SEED = 6, 6
HANG_S = 3.0
STRAGGLER_FLOOR_S = 0.75
DATA = (np.zeros(1, np.float32), np.zeros(1, np.float32))

# Prometheus text exposition grammar (the subset the registry emits):
# comment lines and `name{labels} value` / `name value` sample lines.
_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [0-9eE+.\-]+(?: [0-9]+)?$')


class OneMax(Individual):
    """Pure deterministic fitness — count of set bits."""

    def build_spec(self, **params):
        return genetic_cnn_genome(tuple(params.get("nodes", (4, 4))))

    def evaluate(self):
        return float(sum(sum(g) for g in self.genes.values()))


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def _validate_prometheus(text: str) -> dict:
    """Grammar-check an exposition page; returns family/sample counts."""
    families, samples = set(), 0
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        elif line.startswith("#"):
            continue
        else:
            assert _SAMPLE_RE.match(line), f"invalid exposition line: {line!r}"
            samples += 1
    return {"valid": True, "n_families": len(families), "n_samples": samples}


def _worker(port, injector=None, worker_id=None):
    stop = threading.Event()
    client = GentunClient(
        OneMax, *DATA, host="127.0.0.1", port=port,
        heartbeat_interval=0.2, reconnect_delay=0.1,
        worker_id=worker_id, fault_injector=injector,
    )
    t = threading.Thread(target=lambda: client.work(stop_event=stop), daemon=True)
    t.start()
    return stop


def run() -> dict:
    script_dir = os.path.dirname(os.path.abspath(__file__))
    flight_path = os.path.join(script_dir, ".torch_ops_flight.jsonl")
    srv = start_ops_server(port=0, flight_path=flight_path)

    # healthz timeline: (t_rel_s, status, straggler_reason?) at 20 Hz
    timeline = []
    stop_poll = threading.Event()
    t0 = time.monotonic()

    def _poll():
        while not stop_poll.is_set():
            code, body, _ = _get(srv.url + "/healthz")
            reasons = json.loads(body).get("reasons", [])
            timeline.append((round(time.monotonic() - t0, 3), code,
                             any("straggler" in r for r in reasons)))
            time.sleep(0.05)

    # w0 stalls its second eval batch well past the watchdog floor.  The
    # hang also silences its heartbeats; heartbeat_timeout=30 keeps the
    # reaper out — recovery below is the watchdog flag self-clearing when
    # the stalled result finally lands, nothing else.
    injector = FaultInjector(FaultPlan([
        FaultSpec(hook="worker_pre_eval", kind="hang", at=1, duration=HANG_S),
    ], seed=2026))

    poller = threading.Thread(target=_poll, daemon=True)
    try:
        with DistributedPopulation(
            OneMax, size=POP_SIZE, seed=POP_SEED, port=0,
            heartbeat_timeout=30.0,
            straggler_floor_s=STRAGGLER_FLOOR_S, straggler_k=4.0,
        ) as pop:
            _, port = pop.broker_address
            stops = [_worker(port, injector=injector, worker_id="w0"),
                     _worker(port, worker_id="w1")]
            poller.start()
            # healthy fleet before any stall
            code0, _, _ = _get(srv.url + "/healthz")
            try:
                ga = GeneticAlgorithm(pop, seed=GA_SEED)
                best = ga.run(GENERATIONS)
                wall = time.monotonic() - t0
                # one mid-quiescence statusz + metrics scrape for the record
                status_snap = json.loads(_get(srv.url + "/statusz")[1])
                m_code, m_body, m_ctype = _get(srv.url + "/metrics")
                f_code, f_body, _ = _get(srv.url + "/debugz/flight")
                final_code, final_body, _ = _get(srv.url + "/healthz")
            finally:
                stop_poll.set()
                poller.join(timeout=5.0)
                for s in stops:
                    s.set()
            leaked = pop.broker.outstanding()
    finally:
        stop_ops_server()
        if os.path.exists(flight_path):
            os.unlink(flight_path)

    # -- the acceptance sequence: 200 → 503 (straggler) → 200 -------------
    assert code0 == 200, "fleet not healthy at start"
    codes = [c for _, c, _ in timeline]
    assert 503 in codes, f"stall never flipped /healthz: {codes}"
    first_503 = next(t for t, c, _ in timeline if c == 503)
    assert any(s for _, c, s in timeline if c == 503), \
        "503 was not attributed to a straggler"
    assert final_code == 200, f"healthz never recovered: {final_body}"
    last_503 = max(t for t, c, _ in timeline if c == 503)
    recovered_at = next((t for t, c, _ in timeline if c == 200 and t > last_503),
                        round(wall, 3))
    assert all(v == 0 for v in leaked.values()), f"leaked broker state: {leaked}"

    # -- transitions, compressed: consecutive same-status samples merged --
    transitions = []
    for t, c, _ in timeline:
        if not transitions or transitions[-1]["status"] != c:
            transitions.append({"t_s": t, "status": c})
    assert [tr["status"] for tr in transitions][:3] == [200, 503, 200], \
        f"unexpected healthz sequence: {transitions}"

    # -- /metrics is valid exposition text, with the watchdog counters ----
    assert m_code == 200 and "version=0.0.4" in m_ctype
    metrics_text = m_body.decode("utf-8")
    prom = _validate_prometheus(metrics_text)
    assert 'stragglers_detected_total{worker="w0"}' in metrics_text
    snap = get_registry().snapshot()
    detected = sum(c["value"] for c in snap["counters"]
                   if c["name"] == "stragglers_detected_total")
    assert detected >= 1

    # -- the flight ring holds the straggler event for the black box ------
    assert f_code == 200
    flight_lines = [json.loads(l) for l in f_body.decode("utf-8").splitlines()]
    assert flight_lines[0]["type"] == "flight"
    assert any(r.get("name") == "straggler_detected" for r in flight_lines[1:])

    # -- statusz carried the fleet snapshot -------------------------------
    fleet = status_snap["fleet"]
    assert {w["worker_id"] for w in fleet["workers"]} <= {"w0", "w1"}

    # -- sanity: same seeds, no faults, no ops plane → same best fitness --
    clean = GeneticAlgorithm(
        Population(OneMax, *DATA, size=POP_SIZE, seed=POP_SEED), seed=GA_SEED)
    clean_best = clean.run(GENERATIONS)
    assert clean_best.get_fitness() == best.get_fitness(), \
        "ops-plane run diverged from the clean run"

    return {
        "generations": GENERATIONS,
        "population_size": POP_SIZE,
        "workers": 2,
        "seeds": {"population": POP_SEED, "ga": GA_SEED},
        "stall": {"hang_s": HANG_S, "straggler_floor_s": STRAGGLER_FLOOR_S,
                  "straggler_k": 4.0, "heartbeat_timeout_s": 30.0},
        "healthz": {
            "initial": code0,
            "transitions": transitions,
            "first_503_t_s": first_503,
            "recovered_t_s": recovered_at,
            "flagged_window_s": round(last_503 - first_503, 3),
            "final": final_code,
            "n_samples": len(timeline),
        },
        "stragglers_detected_total": detected,
        "metrics": prom,
        "flight": {"recorded": flight_lines[0]["recorded"],
                   "dropped": flight_lines[0]["dropped"],
                   "has_straggler_event": True},
        "fleet_workers_seen": sorted(w["worker_id"] for w in fleet["workers"]),
        "best_fitness": best.get_fitness(),
        "matches_clean_run_best": True,
        "wall_s": round(wall, 3),
    }


if __name__ == "__main__":
    out = run()
    print(json.dumps(out, indent=2))
    path = out_path("torch_ops_smoke.json")
    stamp(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {path}")
