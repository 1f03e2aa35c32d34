"""Zero-dependency telemetry: the metrics registry, spans, lineage and health.

Only the four modules the GA engine and the fitness path call are ported so
far; the aggregator, exporters and ops server of the JAX package wait for
their own slice.
"""

from . import health, lineage, registry, spans

__all__ = ["health", "lineage", "registry", "spans"]
