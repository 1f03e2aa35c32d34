"""Zero-dependency telemetry: the port's copy of the JAX package's plane.

- :mod:`.registry` — process-local counters/gauges/log-bucket histograms
  with Prometheus-text and JSONL renderers.
- :mod:`.spans` — monotonic-clock spans with trace_id/parent_id context
  that propagates across the distributed wire; no-op singleton fast path
  when disabled (the default).
- :mod:`.export` — ``RunTelemetry``: streams every span/event to a
  per-run ``telemetry.jsonl`` and summarises exact p50/p95/p99 per span
  kind plus counter totals, merged across worker reports.
- :mod:`.health`, :mod:`.flight`, :mod:`.ops_server` — heartbeats and the
  straggler watchdog, the flight recorder, and ``/metrics`` + ``/healthz``
  + ``/statusz`` + ``/debugz/flight`` on a stdlib HTTP server.
- :mod:`.aggregator`, :mod:`.slo`, :mod:`.buildinfo` — the fleet push
  gateway (the same wire as the JAX package's, so either package's
  pushers feed either aggregator), the burn-rate rule table, and the
  ``build_info`` gauge (torch, CUDA, driver and SM labels).
- :mod:`.lineage`, :mod:`.traceviz` — the per-genome lineage ledger with
  the device-seconds cost ledger, and the Chrome ``trace_event``
  converter of a run's ``telemetry.jsonl``.

The black-box canary of the JAX package is not ported yet.

Quick start::

    from gentun_tpu_torch import telemetry
    with telemetry.RunTelemetry("out/telemetry.jsonl"):
        ga.run(generations)
"""

from . import health, lineage, registry, spans  # noqa: F401
from .aggregator import (
    AGG_PROTOCOL,
    MetricsAggregator,
    TelemetryPusher,
    acquire_pusher,
    flush_active_pushers,
    parse_aggregator_url,
    release_pusher,
)
from .buildinfo import build_info_labels, set_build_info
from .export import RunTelemetry, active_run, end_run, start_run
from .flight import FlightRecorder
from .health import StallWatchdog
from .lineage import CostLedger, genome_key, get_ledger
from .ops_server import OpsServer, active_ops_server, start_ops_server, stop_ops_server
from .registry import (
    DEFAULT_BUCKETS,
    Counter,
    DeltaSnapshotter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from .slo import SeriesPoints, SloEngine, SloRule, default_rules
from .spans import (
    attach,
    capture,
    current_context,
    disable,
    enable,
    enabled,
    ingest,
    record_event,
    record_span,
    span,
)

__all__ = [
    "RunTelemetry",
    "start_run",
    "active_run",
    "end_run",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "get_registry",
    "DEFAULT_BUCKETS",
    "span",
    "record_span",
    "record_event",
    "enabled",
    "enable",
    "disable",
    "current_context",
    "attach",
    "capture",
    "ingest",
    "StallWatchdog",
    "FlightRecorder",
    "CostLedger",
    "genome_key",
    "get_ledger",
    "OpsServer",
    "start_ops_server",
    "stop_ops_server",
    "active_ops_server",
    "AGG_PROTOCOL",
    "MetricsAggregator",
    "TelemetryPusher",
    "acquire_pusher",
    "release_pusher",
    "flush_active_pushers",
    "parse_aggregator_url",
    "DeltaSnapshotter",
    "SloEngine",
    "SloRule",
    "SeriesPoints",
    "default_rules",
    "build_info_labels",
    "set_build_info",
]
