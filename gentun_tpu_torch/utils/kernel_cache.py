"""The on-disk cache of the port's built CUDA kernels.

The counterpart of the JAX package's persistent XLA compilation cache
module, with the same public names.  The port compiles nothing at run time
but its hand-written kernels: ``ops/_build.py`` runs ``nvcc`` over
``csrc/`` once and writes ``libgentun_kernels_<source hash>.so`` into a
directory, where every later process that finds the library for the same
sources loads it instead of building.  That directory is this cache.

- The default is ``build/kernels/`` at the root of the checkout
  (git-ignored), so a checkout builds from its own sources;
  ``GENTUN_TORCH_CACHE_DIR=/path`` relocates it.
- ``GeneticCnnModel(cache_dir=...)`` (or ``additional_parameters``) points
  the build there: :func:`enable_compilation_cache`.
- An unwritable directory leaves the previous one in use, with a warning.

There is no uncached mode: ``ctypes`` loads the kernels from a file.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

from ..ops import _build

__all__ = [
    "cache_stats",
    "default_cache_dir",
    "enable_compilation_cache",
    "list_cache_entries",
    "register_publish_hook",
    "run_publish_hooks",
    "unregister_publish_hook",
]

logger = logging.getLogger("gentun_tpu_torch")

_failed_dirs: set = set()  # dirs that failed makedirs: don't retry or re-warn

# Publish hooks: a fleet-wide cache client registers its scan-and-publish
# here, so ``models/cnn.py`` can announce "a first build may just have
# written an entry" without importing the distributed plane.
_publish_hooks: list = []


def default_cache_dir() -> str:
    """``GENTUN_TORCH_CACHE_DIR`` if set, else ``build/kernels/`` of the checkout."""
    d = os.environ.get("GENTUN_TORCH_CACHE_DIR", "").strip()
    return d or str(_build.BUILD_DIR)


def enable_compilation_cache(cache_dir) -> Optional[str]:
    """Build the kernels into (and load them from) ``cache_dir``.

    Idempotent.  Returns the absolute directory, or ``None`` when it cannot
    be created; the directory in use before then stays in use.
    """
    if isinstance(cache_dir, bool) or not isinstance(cache_dir, (str, os.PathLike)):
        raise TypeError(
            f"cache_dir must be a directory path or None, got {cache_dir!r}: the kernels "
            "are loaded from a built library, so there is no uncached mode")
    path = os.path.abspath(os.path.expanduser(os.fspath(cache_dir)))
    if Path(path) == _build.build_dir():
        return path
    if path in _failed_dirs:
        return None
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        _failed_dirs.add(path)
        logger.warning("kernel cache dir %s is unusable (%s); the kernels keep building into %s",
                       path, e, _build.build_dir())
        return None
    _build.use_build_dir(path)
    logger.info("kernel cache at %s", path)
    return path


def list_cache_entries(cache_dir: Optional[str] = None) -> Dict[str, Tuple[int, float]]:
    """``{library name: (size_bytes, mtime)}`` of the built libraries.

    In-flight builds (``*.tmp.so``), dotfiles and subdirectories are
    skipped.  Defaults to the directory in use.  A missing directory is an
    empty cache, not an error.
    """
    d = cache_dir if cache_dir is not None else str(_build.build_dir())
    out: Dict[str, Tuple[int, float]] = {}
    try:
        with os.scandir(d) as it:
            for entry in it:
                if entry.name.startswith(".") or entry.name.endswith(".tmp.so"):
                    continue
                try:
                    if not entry.is_file(follow_symlinks=False):
                        continue
                    st = entry.stat(follow_symlinks=False)
                except OSError:
                    continue
                out[entry.name] = (st.st_size, st.st_mtime)
    except FileNotFoundError:
        return {}
    return out


def cache_stats(cache_dir: Optional[str] = None) -> Dict[str, Any]:
    """Entry count and total bytes, for ``/statusz``-style reporting."""
    current = str(_build.build_dir())
    d = cache_dir if cache_dir is not None else current
    entries = list_cache_entries(d)
    return {
        "dir": d,
        "enabled": os.path.abspath(d) == os.path.abspath(current),
        "entries": len(entries),
        "bytes": sum(size for size, _mtime in entries.values()),
    }


def register_publish_hook(fn: Callable[[], Any]) -> None:
    """Register a zero-argument callable to run after a possible first build."""
    if fn not in _publish_hooks:
        _publish_hooks.append(fn)


def unregister_publish_hook(fn: Callable[[], Any]) -> None:
    _publish_hooks[:] = [h for h in _publish_hooks if h != fn]


def run_publish_hooks() -> None:
    """Run the registered hooks; a failing hook never stops the caller.

    Called by ``models/cnn.py`` before each evaluation; with no hooks it is
    one empty-list iteration.
    """
    for fn in list(_publish_hooks):
        try:
            fn()
        except Exception:  # noqa: BLE001 - hook boundary by design
            logger.warning("kernel-cache publish hook %r failed", fn, exc_info=True)
