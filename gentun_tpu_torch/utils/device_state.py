"""Tracks whether this process's fitness path has used the CUDA device.

The counterpart of the JAX package's ``utils/jax_state.py``.  The GA outer
loop (``algorithms.py``) is pure bookkeeping and must never be the code that
initializes CUDA just to normalise the individuals/hour/chip metric, so the
fitness entry point (``models/cnn.py``) calls :func:`mark_backend_used` right
before it first places work on a CUDA device, and the GA consults
:func:`backend_used` before it asks torch for a device count.

A false negative (some caller touches CUDA outside the fitness entry point)
only degrades the metric to per-host instead of per-card; it can never force
a CUDA initialization.
"""

from __future__ import annotations

_backend_used = False


def mark_backend_used() -> None:
    """Record that the CUDA device has been (or is about to be) used."""
    global _backend_used
    _backend_used = True


def backend_used() -> bool:
    """True once the fitness entry point has placed work on a CUDA device."""
    return _backend_used
