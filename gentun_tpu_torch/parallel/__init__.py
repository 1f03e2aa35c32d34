"""Population-axis helpers (the jax-free half of the JAX package's mesh module)."""

from .mesh import pad_population, pop_bucket

__all__ = ["pad_population", "pop_bucket"]
