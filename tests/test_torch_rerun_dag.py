"""The JAX package's ``tests/test_dag.py``, run against the port's copies."""

from _torch_rerun import load

load(globals(), "test_dag.py")
