"""`build_info`: the version-skew tripwire gauge.

Every process that serves ``/metrics`` (ops server) or pushes to the
fleet aggregator stamps a single ``build_info`` gauge whose *labels*
carry the identity that matters operationally: package version, the
checkpoint schema, the fitness/compile wire protocols, the torch and CUDA
versions and, once the fitness path has used the card, its driver and SM
(``sm_90`` on Hopper).  The value is always 1 — Prometheus convention: information
rides in labels, and ``sum by (version) (build_info)`` counts processes
per build.  The aggregator folds the pushed gauges into the fleet
version-skew table on its ``/statusz``, which is where a half-upgraded
fleet becomes visible *before* the 409s start.

Imports are lazy and fail-soft: the telemetry plane must stay importable
on minimal installs (registry.py's zero-dependency constraint), and a
missing constant reports ``"unknown"`` rather than breaking metrics export.
Reading the labels never initializes CUDA: the driver and SM labels are
read only after the fitness path has placed work on the card
(``utils/device_state``), the same rule the GA's chip count follows.
"""

from __future__ import annotations

from typing import Dict, Optional

from .registry import MetricsRegistry, get_registry

__all__ = ["build_info_labels", "set_build_info"]

_CACHED: Optional[Dict[str, str]] = None
_DEVICE: Optional[Dict[str, str]] = None


def build_info_labels() -> Dict[str, str]:
    """The identity labels, computed once per process."""
    global _CACHED
    if _CACHED is not None:
        return _with_device(_CACHED)
    labels: Dict[str, str] = {}

    def probe(key: str, fn) -> None:
        try:
            labels[key] = str(fn())
        except Exception:  # noqa: BLE001 - identity is best-effort
            labels[key] = "unknown"

    probe("version", lambda: __import__(
        "gentun_tpu_torch").__version__)
    probe("checkpoint_schema", lambda: __import__(
        "gentun_tpu_torch.utils.checkpoint", fromlist=["CHECKPOINT_SCHEMA"]
    ).CHECKPOINT_SCHEMA)
    probe("fitness_protocol", lambda: __import__(
        "gentun_tpu_torch.utils.fitness_store", fromlist=["FITNESS_PROTOCOL"]
    ).FITNESS_PROTOCOL)
    probe("compile_protocol", lambda: __import__(
        "gentun_tpu_torch.distributed.compile_service", fromlist=["COMPILE_PROTOCOL"]
    ).COMPILE_PROTOCOL)
    # torch is optional on purpose: the GA outer loop and the telemetry
    # plane run without it.  Importing it does not initialize CUDA;
    # ``torch.version.cuda`` is the toolkit torch was built against.
    try:
        import torch

        labels["torch"] = str(torch.__version__)
        labels["cuda"] = str(torch.version.cuda or "none")
    except Exception:  # noqa: BLE001 - absent on minimal installs
        labels.setdefault("torch", "absent")
        labels.setdefault("cuda", "absent")
    _CACHED = labels
    return _with_device(labels)


def _with_device(labels: Dict[str, str]) -> Dict[str, str]:
    """``labels`` plus ``driver`` and ``sm`` once the fitness path has used
    the card (read then, once; CUDA is initialized by that time)."""
    global _DEVICE
    from ..utils.device_state import backend_used

    if _DEVICE is None and backend_used():
        device: Dict[str, str] = {}
        try:
            import torch

            major, minor = torch.cuda.get_device_capability()
            device["sm"] = f"sm_{major}{minor}"
            device["driver"] = _driver_version()
        except Exception:  # noqa: BLE001 - identity is best-effort
            device.setdefault("sm", "unknown")
            device.setdefault("driver", "unknown")
        _DEVICE = device
    return {**labels, **(_DEVICE or {})}


def _driver_version() -> str:
    """The CUDA driver's version (``12.8``), from the driver library that
    CUDA's initialization loaded into the process."""
    import ctypes

    version = ctypes.c_int()
    rc = ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(version))
    if rc != 0:
        raise RuntimeError(f"cuDriverGetVersion returned {rc}")
    return f"{version.value // 1000}.{version.value % 1000 // 10}"


def set_build_info(registry: Optional[MetricsRegistry] = None) -> None:
    """Stamp the ``build_info`` gauge (value 1) on ``registry``."""
    reg = registry if registry is not None else get_registry()
    reg.gauge("build_info", **build_info_labels()).set(1)
