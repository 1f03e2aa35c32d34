"""Live ops endpoints: /metrics, /healthz, /statusz, /debugz/flight.

The scrape side of the observability plane (OBSERVABILITY.md "Live ops
plane").  Zero-dependency by construction: a stdlib
``ThreadingHTTPServer`` running in a daemon thread, so a master or
worker gains live introspection without growing a web framework — the
same constraint as ``registry.py``.

Endpoints (GET only):

- ``/metrics`` — the process registry via ``render_prometheus()``,
  scrape-ready text exposition format.
- ``/healthz`` — 200 ``{"status": "ok"}`` / 503 ``{"status":
  "unhealthy", "reasons": [...]}`` from :func:`health.check_health`:
  a *gating* heartbeat source gone silent past its timeout, or a
  watchdog-flagged straggler job, flips it; both self-heal.
- ``/statusz`` — JSON fleet/engine snapshot: uptime, pid, healthz
  verdict, per-source heartbeat ages, and every registered status
  provider (broker fleet table, engine progress, worker identity).
- ``/debugz/flight`` — the flight recorder ring as ndjson (404 when no
  recorder is active).

:func:`start_ops_server` is the one-call entry point the worker CLI's
``--ops-port`` uses: it enables the health plane, arms the flight
recorder (which enables span collection), and serves.  Everything it
turns on keeps the disabled-path contract — a process that never calls
it runs the untouched one-bool-read disabled paths.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from . import flight as _flight
from . import health as _health
from .registry import MetricsRegistry, get_registry

__all__ = ["OpsServer", "start_ops_server", "stop_ops_server", "active_ops_server"]

_active: Optional["OpsServer"] = None


class _Handler(BaseHTTPRequestHandler):
    # Tests and gentun-top poll rapidly; per-request stderr noise would
    # drown real logs.
    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):  # pragma: no cover
            pass

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj, indent=1, default=str).encode("utf-8"),
                   "application/json; charset=utf-8")

    def do_GET(self):  # noqa: N802 - stdlib dispatch name
        path = self.path.split("?", 1)[0]
        srv: "OpsServer" = self.server.ops  # type: ignore[attr-defined]
        if path == "/metrics":
            body = srv.registry.render_prometheus().encode("utf-8")
            self._send(200, body, "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            ok, reasons = _health.check_health()
            self._send_json(
                200 if ok else 503,
                {"status": "ok" if ok else "unhealthy",
                 "reasons": reasons,
                 "uptime_s": round(time.monotonic() - srv.t_start, 3)})
        elif path == "/statusz":
            ok, reasons = _health.check_health()
            self._send_json(200, {
                "uptime_s": round(time.monotonic() - srv.t_start, 3),
                "pid": srv.pid,
                "healthy": ok,
                "reasons": reasons,
                "heartbeats": _health.heartbeats(),
                **_health.status_snapshot(),
            })
        elif path == "/debugz/flight":
            rec = _flight.active()
            if rec is None:
                self._send_json(404, {"error": "no flight recorder active"})
            else:
                self._send(200, rec.render_jsonl(reason="debugz").encode("utf-8"),
                           "application/x-ndjson; charset=utf-8")
        else:
            self._send_json(404, {
                "error": f"unknown path {path!r}",
                "endpoints": ["/metrics", "/healthz", "/statusz", "/debugz/flight"],
            })


class OpsServer:
    """The HTTP surface; owns the daemon serve thread.

    ``port=0`` binds an ephemeral port (tests, multi-process fleets on
    one box) — read it back from :attr:`address` after :meth:`start`.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[MetricsRegistry] = None):
        import os

        self.registry = registry if registry is not None else get_registry()
        self.t_start = time.monotonic()
        self.pid = os.getpid()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.ops = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "OpsServer":
        # Version identity on every /metrics page this process serves —
        # the aggregator folds the pushed copy into the fleet version-skew
        # table, and a lone scraped process still self-identifies.
        from .buildinfo import set_build_info
        set_build_info(self.registry)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.25},
            name="gentun-ops-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def active_ops_server() -> Optional[OpsServer]:
    return _active


def start_ops_server(port: int = 0, host: str = "127.0.0.1",
                     registry: Optional[MetricsRegistry] = None,
                     flight_path: str = "flight.jsonl",
                     flight_capacity: int = _flight.DEFAULT_CAPACITY) -> OpsServer:
    """Turn the whole ops plane on: health beats gating /healthz, flight
    recorder armed (span collection enabled), HTTP endpoints serving.
    Replaces any previously started server."""
    global _active
    if _active is not None:
        stop_ops_server()
    _health.enable()
    _flight.enable(path=flight_path, capacity=flight_capacity)
    srv = OpsServer(host=host, port=port, registry=registry).start()
    _active = srv
    return srv


def stop_ops_server() -> None:
    """Stop the active server and switch the health/flight planes back
    off (span collection survives only if a RunTelemetry sink holds it)."""
    global _active
    srv = _active
    _active = None
    if srv is not None:
        srv.stop()
    _health.disable()
    _flight.disable()
