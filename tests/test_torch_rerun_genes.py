"""The JAX package's ``tests/test_genes.py``, run against the port's copies."""

from _torch_rerun import load

load(globals(), "test_genes.py")
