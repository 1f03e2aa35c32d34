"""The JAX package's ``tests/test_broker_ha.py``, run against the port's copy."""

from _torch_rerun import load

load(globals(), "test_broker_ha.py")
