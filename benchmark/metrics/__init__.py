"""Metric readers: one file a metric, ``read(run)`` giving its value or None."""
