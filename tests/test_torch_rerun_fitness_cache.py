"""The JAX package's ``tests/test_fitness_cache.py``, run against the port's copies."""

from _torch_rerun import load

load(globals(), "test_fitness_cache.py")
