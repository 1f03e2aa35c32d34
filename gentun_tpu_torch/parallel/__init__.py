"""Multi-card parallelism: the ``(pop, data)`` mesh over ranks, and the process group.

``multihost`` is exposed lazily (PEP 562): it imports ``torch``, and the
dispatch plane (broker, master, worker re-chunking) uses the host half of
``mesh.py`` (size classes, ``mesh_factor``, ``host_worker_capacity``)
without loading it.
"""

from .mesh import auto_mesh, mesh_axis_sizes, pad_population, pop_bucket, shard_cv_args

__all__ = ["auto_mesh", "mesh_axis_sizes", "pad_population", "pop_bucket", "shard_cv_args",
           "multihost"]


def __getattr__(name):
    if name == "multihost":
        import importlib

        return importlib.import_module(f"{__name__}.multihost")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
