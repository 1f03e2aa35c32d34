"""Auxiliary subsystems: cross-run fitness persistence and the device marker."""

from .fitness_store import fidelity_fingerprint, load_fitness_cache, save_fitness_cache

__all__ = ["load_fitness_cache", "save_fitness_cache", "fidelity_fingerprint"]
