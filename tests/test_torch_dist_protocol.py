"""The JAX package's ``tests/test_protocol.py``, run against the port's copy."""

from _torch_rerun import load

load(globals(), "test_protocol.py")
