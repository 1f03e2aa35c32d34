"""SLO-driven fleet autoscaler: the loop that closes sensors → actuators.

The fleet has had complete *sensors* since the aggregation PR (burn-rate
SLOs behind ``/alertz``, per-instance time-series rings) and complete
*actuators* since elastic membership (drain/join/advertise, live
capacity) — this daemon is the wire between them, the last unbuilt
control loop of the autoscaler.  It is a sibling of the fitness/compile/
aggregator services: stdlib HTTP, zero third-party deps, runs standalone
(``python -m gentun_tpu_torch.distributed.autoscaler --port 9092``) or
in-process for tests and studies.

The control loop, once per ``poll_interval``:

1. ``reap()`` the backend (collect members that already exited).
2. Read the aggregator's ``/alertz`` snapshot — in-process object or
   HTTP, the daemon never computes its own judgment.  Hysteresis is
   *borrowed* from the SLO state machine: an alert only reaches
   ``firing`` after its rule's ``for_s`` hold and only clears after
   ``clear_for_s``, so the autoscaler inherits exactly the damping the
   rules declare instead of inventing a second, disagreeing one.
3. Scale up while the saturation rule fires (stock:
   ``queue_depth_growth``), down while the idleness rule fires (stock:
   ``worker_idle_ratio``); saturation wins when both fire.  On top of
   the borrowed hysteresis: min/max-fleet clamps, a ``cooldown_s``
   between consecutive decisions, and edge detection via the alert's
   monotonic ``transition_seq`` — a poller that never sees the same
   firing episode twice cannot double-act on it, and a fire→clear→fire
   cycle between two polls still reads as a fresh edge.
4. Every decision lands as a ``{"type": "scale"}`` telemetry record —
   triggering rule, ``transition_seq``, ring evidence (the tail of the
   triggering series), from/to sizes, outcome — and in a bounded
   in-memory ring served on ``/decisionz``.  A fleet that never needs
   scaling writes nothing.

Backends implement the 4-method :class:`FleetBackend` protocol.  The
first real one, :class:`LocalProcessBackend`, spawns/SIGTERMs actual
``gentun-worker`` processes — SIGTERM is the worker's orderly-drain
signal, so a scale-down hands every prefetched-unstarted job back to
the broker before the process exits (the drain-race tier-1 test pins
this).  Studies plug in thread- or callback-backed fakes.

Metrics (docs/OBSERVABILITY.md): ``autoscaler_decisions_total{action,
rule}``, ``fleet_target_size``, ``scale_decision_seconds``.
"""

from __future__ import annotations

import json
import logging
import signal
import subprocess
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..telemetry import spans as _tele
from ..telemetry.registry import get_registry as _get_registry

__all__ = [
    "FleetBackend",
    "LocalProcessBackend",
    "AutoscalerDaemon",
    "main",
]

logger = logging.getLogger("gentun_tpu_torch.distributed")

#: Decisions kept for ``/decisionz`` (the durable copy is telemetry.jsonl).
_DECISION_RING = 256

#: Ring-evidence points attached to each decision record: enough to see
#: the breach shape without bloating every record with a full ring.
_EVIDENCE_TAIL = 16


class FleetBackend:
    """What the autoscaler scales: a pool of fleet members.

    Four methods, all called from the daemon's control-loop thread only:

    - :meth:`size` — members currently alive (spawned and not reaped).
    - :meth:`spawn` — start ``n`` new members; returns how many started.
    - :meth:`drain` — ask ``n`` members to exit ORDERLY (for processes:
      SIGTERM, the worker's drain signal — in-flight work finishes and
      queued jobs requeue); returns how many were signaled.  Members
      keep counting in :meth:`size` until they actually exit.
    - :meth:`reap` — collect members that exited; returns how many left
      since the last call.

    A backend never decides — it only executes.  Implementations must
    not block the loop for long (spawn is a fork/exec, drain a signal).
    """

    def size(self) -> int:
        raise NotImplementedError

    def spawn(self, n: int) -> int:
        raise NotImplementedError

    def drain(self, n: int) -> int:
        raise NotImplementedError

    def reap(self) -> int:
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        """Backend block for ``/statusz``; override for richer detail."""
        return {"kind": type(self).__name__, "size": self.size()}


class LocalProcessBackend(FleetBackend):
    """The first real backend: a local pool of worker PROCESSES.

    ``argv`` is the full worker command (e.g. ``[sys.executable, "-m",
    "gentun_tpu_torch.distributed.worker", "--port", "5672", ...]``); every
    spawn runs it verbatim, so whether members join as preemptible
    capacity is the operator's ``--preempt`` in the template, not a
    backend concern.  Drain sends SIGTERM — the worker CLI's first-signal
    orderly-drain path — to the NEWEST living members first (LIFO), so
    the longest-lived members, with their warm compile caches, survive a
    shrink.  Nothing is ever SIGKILLed here: a member that ignores its
    drain is the operator's supervisor's problem, and killing it would
    bypass the requeue handshake the drain exists for.
    """

    def __init__(self, argv: List[str]):
        if not argv:
            raise ValueError("LocalProcessBackend needs a non-empty argv")
        self.argv = list(argv)
        self._procs: List[subprocess.Popen] = []
        self._spawned_total = 0
        self._reaped_total = 0

    def size(self) -> int:
        return len(self._procs)

    def spawn(self, n: int) -> int:
        started = 0
        for _ in range(max(0, n)):
            try:
                self._procs.append(subprocess.Popen(self.argv))
            except OSError:
                logger.exception("autoscaler spawn failed: %s", self.argv)
                break
            started += 1
        self._spawned_total += started
        return started

    def drain(self, n: int) -> int:
        signaled = 0
        for proc in reversed(self._procs):
            if signaled >= max(0, n):
                break
            if proc.poll() is not None:
                continue  # already exited; reap() collects it
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                continue  # died between poll and signal: reap's problem
            signaled += 1
        return signaled

    def reap(self) -> int:
        live = [p for p in self._procs if p.poll() is None]
        reaped = len(self._procs) - len(live)
        self._procs = live
        self._reaped_total += reaped
        return reaped

    def describe(self) -> Dict[str, Any]:
        return {
            "kind": "LocalProcessBackend",
            "argv": self.argv,
            "size": self.size(),
            "pids": [p.pid for p in self._procs],
            "spawned_total": self._spawned_total,
            "reaped_total": self._reaped_total,
        }


# -- HTTP plane --------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    """Request handler; ``self.server.autoscaler`` is the daemon."""

    server_version = "gentun-autoscaler/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 - silence stderr chatter
        pass

    def _send_json(self, code: int, obj: Any) -> None:
        body = json.dumps(obj, separators=(",", ":")).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - http.server API
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        asc = self.server.autoscaler  # type: ignore[attr-defined]
        if path in ("/", "/healthz"):
            self._send_json(200, {"status": "ok", **asc.stats()})
        elif path == "/statusz":
            self._send_json(200, asc.statusz())
        elif path == "/decisionz":
            self._send_json(200, asc.decisionz())
        else:
            self._send_json(404, {"error": f"no route {path}"})


# -- the daemon --------------------------------------------------------------


class AutoscalerDaemon:
    """Watches ``/alertz``, issues spawn/drain decisions to a backend.

    Parameters
    ----------
    backend:
        The :class:`FleetBackend` to actuate.
    aggregator:
        An in-process :class:`~gentun_tpu_torch.telemetry.aggregator.
        MetricsAggregator` (tests, studies) — or None with
        ``aggregator_url`` set for HTTP polling.  Exactly one source.
    aggregator_url:
        ``http://host:port`` of a remote aggregator.
    min_fleet, max_fleet:
        Hard clamps on the target size; decisions never leave the range.
    step:
        Members added/removed per decision.
    cooldown_s:
        Minimum seconds between consecutive scale decisions — the
        autoscaler's own damping ON TOP of the SLO machine's
        ``for_s/clear_for_s`` hysteresis.
    scale_up_rule, scale_down_rule:
        Rule names watched for saturation / idleness.  The stock pair
        (``queue_depth_growth``, ``worker_idle_ratio``) matches
        ``telemetry.slo.default_rules``.
    repeat_while_firing:
        When True (default) a still-firing alert keeps stepping the
        fleet once per cooldown window; False acts on fresh
        ``transition_seq`` edges only (deterministic decision counts for
        studies).
    """

    def __init__(
        self,
        backend: FleetBackend,
        aggregator=None,
        aggregator_url: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        min_fleet: int = 1,
        max_fleet: int = 8,
        step: int = 1,
        cooldown_s: float = 30.0,
        poll_interval: float = 2.0,
        scale_up_rule: str = "queue_depth_growth",
        scale_down_rule: str = "worker_idle_ratio",
        repeat_while_firing: bool = True,
        serve_http: bool = True,
    ):
        if (aggregator is None) == (aggregator_url is None):
            raise ValueError(
                "exactly one of aggregator / aggregator_url is required")
        if min_fleet < 0 or max_fleet < max(1, min_fleet):
            raise ValueError(
                f"bad fleet clamps: min={min_fleet} max={max_fleet}")
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        self.backend = backend
        self._agg = aggregator
        self._agg_url = aggregator_url.rstrip("/") if aggregator_url else None
        self.min_fleet = int(min_fleet)
        self.max_fleet = int(max_fleet)
        self.step = int(step)
        self.cooldown_s = float(cooldown_s)
        self.poll_interval = float(poll_interval)
        self.scale_up_rule = scale_up_rule
        self.scale_down_rule = scale_down_rule
        self.repeat_while_firing = bool(repeat_while_firing)
        self._decisions: List[Dict[str, Any]] = []
        self._decisions_total = 0
        self._poll_errors = 0
        self._polls = 0
        #: Last transition_seq ACTED ON per (rule, subject): the edge
        #: cursor.  Strictly monotonic on the engine side, so "seq I
        #: haven't seen" ⇔ "edge since my last act", poll races included.
        self._acted_seq: Dict[Tuple[str, str], int] = {}
        self._last_decision_t = 0.0
        self._started = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        if serve_http:
            self._httpd = ThreadingHTTPServer((host, port), _Handler)
            self._httpd.daemon_threads = True
            self._httpd.autoscaler = self  # type: ignore[attr-defined]

    # -- address -----------------------------------------------------------

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        return self._httpd.server_address[:2] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        addr = self.address
        return f"http://{addr[0]}:{addr[1]}" if addr else None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "AutoscalerDaemon":
        self._stop.clear()
        if self._httpd is not None:
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.25},
                name="autoscaler-http", daemon=True)
            self._http_thread.start()
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()
        logger.info(
            "autoscaler serving on %s (fleet [%d, %d], step %d, cooldown "
            "%.1fs, rules up=%s down=%s)", self.url or "<no http>",
            self.min_fleet, self.max_fleet, self.step, self.cooldown_s,
            self.scale_up_rule, self.scale_down_rule)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5.0)
            self._http_thread = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "AutoscalerDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.decide_once()
            except Exception:  # noqa: BLE001 - the loop must survive anything
                logger.exception("autoscaler decision pass failed")

    # -- aggregator reads --------------------------------------------------

    def _fetch_json(self, endpoint: str) -> Optional[Dict[str, Any]]:
        try:
            with urllib.request.urlopen(
                    f"{self._agg_url}{endpoint}", timeout=5.0) as resp:
                return json.loads(resp.read().decode())
        except Exception:  # aggregator down: skip the tick, fail open
            self._poll_errors += 1
            logger.debug("autoscaler poll failed: %s", endpoint, exc_info=True)
            return None

    def _alertz(self) -> Optional[Dict[str, Any]]:
        if self._agg is not None:
            return self._agg.alertz()
        return self._fetch_json("/alertz")

    def _ring_tail(self, series: str) -> List[List[float]]:
        """Evidence: the tail of the triggering rule's series ring."""
        if self._agg is not None:
            ringz = self._agg.ringz(name=series)
        else:
            ringz = self._fetch_json(f"/ringz?name={series}") or {}
        points: List[List[float]] = []
        for sp in ringz.get("series") or []:
            points.extend(sp.get("points") or [])
        points.sort()
        return points[-_EVIDENCE_TAIL:]

    # -- the decision ------------------------------------------------------

    @staticmethod
    def _firing(snapshot: Dict[str, Any], rule: str) -> List[Dict[str, Any]]:
        return [a for a in snapshot.get("alerts") or []
                if a.get("rule") == rule and a.get("state") == "firing"]

    def _rule_series(self, snapshot: Dict[str, Any], rule: str) -> Optional[str]:
        for r in snapshot.get("rules") or []:
            if r.get("name") == rule:
                return r.get("series")
        return None

    def decide_once(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """One control-loop pass; returns the decision record, if any.

        Public so tests and the study harness can drive the loop
        deterministically (exactly like ``MetricsAggregator.
        evaluate_slos``); the background thread calls nothing else.
        """
        now = time.time() if now is None else float(now)
        self._polls += 1
        self.backend.reap()
        snapshot = self._alertz()
        if snapshot is None:
            return None
        up = self._firing(snapshot, self.scale_up_rule)
        down = self._firing(snapshot, self.scale_down_rule)
        # Saturation beats idleness: a backlogged fleet with one idle
        # worker must grow, not shrink.
        action, alerts = ("up", up) if up else ("down", down) if down else (None, [])
        if action is None:
            return None
        # Edge-or-repeat gating: a transition_seq this cursor has not
        # acted on is always actionable (a fresh firing episode, even if
        # fire+clear+fire landed between two polls); a seq already acted
        # on re-triggers only in repeat_while_firing mode.  Cooldown
        # applies to both — it is the flap guard between decisions.
        trigger = None
        for a in alerts:
            key = (a["rule"], a.get("subject", "fleet"))
            if self._acted_seq.get(key, -1) < a.get("transition_seq", 0):
                trigger = a
                break
        if trigger is None and not self.repeat_while_firing:
            return None
        if now - self._last_decision_t < self.cooldown_s:
            return None
        trigger = trigger or alerts[0]
        size = self.backend.size()
        if action == "up":
            target = min(self.max_fleet, size + self.step)
        else:
            target = max(self.min_fleet, size - self.step)
        if target == size:
            return None  # clamped to a no-op: not a decision, no record
        t0 = time.perf_counter()
        if target > size:
            moved = self.backend.spawn(target - size)
            outcome = f"spawned {moved}"
        else:
            moved = self.backend.drain(size - target)
            outcome = f"drained {moved}"
        series = self._rule_series(snapshot, trigger["rule"])
        record = {
            "type": "scale",
            "action": action,
            "rule": trigger["rule"],
            "subject": trigger.get("subject", "fleet"),
            "transition_seq": trigger.get("transition_seq", 0),
            "firing_since": trigger.get("firing_since", 0.0),
            "value": trigger.get("value"),
            "threshold": trigger.get("threshold"),
            "evidence": self._ring_tail(series) if series else [],
            "from": size,
            "to": target,
            "outcome": outcome,
            "t": now,
        }
        self._acted_seq[(trigger["rule"], trigger.get("subject", "fleet"))] = (
            trigger.get("transition_seq", 0))
        self._last_decision_t = now
        self._decisions.append(record)
        if len(self._decisions) > _DECISION_RING:
            del self._decisions[: len(self._decisions) - _DECISION_RING]
        self._decisions_total += 1
        reg = _get_registry()
        reg.counter("autoscaler_decisions_total",
                    action=action, rule=trigger["rule"]).inc()
        reg.gauge("fleet_target_size").set(target)
        reg.histogram("scale_decision_seconds").observe(
            time.perf_counter() - t0)
        if _tele.enabled():
            _tele.emit_record(record)
        logger.info(
            "autoscaler scale %s: %d -> %d (%s; rule %s seq %d value %s)",
            action, size, target, outcome, trigger["rule"],
            record["transition_seq"], record["value"])
        return record

    # -- read side ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "uptime_s": round(time.time() - self._started, 3),
            "polls": self._polls,
            "poll_errors": self._poll_errors,
            "decisions_total": self._decisions_total,
            "fleet_size": self.backend.size(),
        }

    def statusz(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            **self.stats(),
            "config": {
                "min_fleet": self.min_fleet,
                "max_fleet": self.max_fleet,
                "step": self.step,
                "cooldown_s": self.cooldown_s,
                "poll_interval": self.poll_interval,
                "scale_up_rule": self.scale_up_rule,
                "scale_down_rule": self.scale_down_rule,
                "repeat_while_firing": self.repeat_while_firing,
                "aggregator": (self._agg_url if self._agg_url
                               else "<in-process>"),
            },
            "backend": self.backend.describe(),
            "acted_seq": {f"{r}/{s}": q
                          for (r, s), q in sorted(self._acted_seq.items())},
            "last_decision": self._decisions[-1] if self._decisions else None,
        }

    def decisionz(self) -> Dict[str, Any]:
        return {"decisions": list(self._decisions),
                "total": self._decisions_total}


# -- standalone entrypoint ---------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m gentun_tpu_torch.distributed.autoscaler`` — run the daemon."""
    import argparse
    import shlex

    ap = argparse.ArgumentParser(
        prog="python -m gentun_tpu_torch.distributed.autoscaler",
        description="SLO-driven fleet autoscaler (watches /alertz, "
                    "spawns/drains gentun-worker processes)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9092,
                    help="ops plane bind port (/statusz /decisionz /healthz)")
    ap.add_argument("--aggregator-url", required=True, metavar="URL",
                    help="the fleet aggregator to watch, e.g. "
                         "http://agg-host:9100 (its /alertz is the ONLY "
                         "judgment source — the daemon never computes SLOs)")
    ap.add_argument("--worker-cmd", required=True, metavar="CMD",
                    help="full worker command, shlex-split, run verbatim "
                         "per spawned member — include --preempt here to "
                         "grow with preemptible capacity, e.g. "
                         "\"python -m gentun_tpu_torch.distributed.worker --port "
                         "5672 --preempt\"")
    ap.add_argument("--min-fleet", type=int, default=1)
    ap.add_argument("--max-fleet", type=int, default=8)
    ap.add_argument("--step", type=int, default=1,
                    help="members added/removed per decision")
    ap.add_argument("--cooldown", type=float, default=30.0,
                    help="seconds between consecutive scale decisions "
                         "(flap guard on top of the SLO for_s/clear_for_s "
                         "hysteresis)")
    ap.add_argument("--poll-interval", type=float, default=2.0)
    ap.add_argument("--scale-up-rule", default="queue_depth_growth")
    ap.add_argument("--scale-down-rule", default="worker_idle_ratio")
    ap.add_argument("--edge-only", action="store_true",
                    help="act only on fresh alert transitions (default: a "
                         "still-firing alert keeps stepping once per "
                         "cooldown window)")
    ap.add_argument("--spawn-initial", action="store_true",
                    help="spawn min-fleet members at startup (default: "
                         "adopt whatever the operator already runs)")
    ap.add_argument("--telemetry", action="store_true",
                    help="emit {type: scale} records to the telemetry sink "
                         "(GENTUN_TPU_TELEMETRY=1 equivalent)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.telemetry:
        _tele.enable()
    from ..telemetry.aggregator import parse_aggregator_url

    try:
        agg_url = parse_aggregator_url(args.aggregator_url)
        backend = LocalProcessBackend(shlex.split(args.worker_cmd))
        daemon = AutoscalerDaemon(
            backend,
            aggregator_url=agg_url,
            host=args.host, port=args.port,
            min_fleet=args.min_fleet, max_fleet=args.max_fleet,
            step=args.step, cooldown_s=args.cooldown,
            poll_interval=args.poll_interval,
            scale_up_rule=args.scale_up_rule,
            scale_down_rule=args.scale_down_rule,
            repeat_while_firing=not args.edge_only,
        )
    except ValueError as e:
        raise SystemExit(f"autoscaler: {e}")
    if args.spawn_initial and args.min_fleet > 0:
        backend.spawn(args.min_fleet)
    daemon.start()
    print(f"autoscaler serving on {daemon.url} (/statusz /decisionz)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        daemon.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
