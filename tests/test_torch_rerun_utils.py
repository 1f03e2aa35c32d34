"""The JAX package's ``tests/test_utils.py``, run against the port's copies."""

from _torch_rerun import load

load(globals(), "test_utils.py")
