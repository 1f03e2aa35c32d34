"""Auxiliary subsystems: checkpoint/resume, cross-run fitness persistence,
offline dataset loaders, tracing and timing, the kernel cache, and the
device marker."""

from .checkpoint import CHECKPOINT_SCHEMA, Checkpointer, load_checkpoint
from .fitness_store import fidelity_fingerprint, load_fitness_cache, save_fitness_cache
from .kernel_cache import default_cache_dir, enable_compilation_cache
from .profiling import EvalTimer, trace

__all__ = [
    "Checkpointer",
    "load_checkpoint",
    "CHECKPOINT_SCHEMA",
    "load_fitness_cache",
    "save_fitness_cache",
    "fidelity_fingerprint",
    "EvalTimer",
    "trace",
    "enable_compilation_cache",
    "default_cache_dir",
]
