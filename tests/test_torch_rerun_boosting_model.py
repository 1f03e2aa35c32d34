"""The JAX package's ``tests/test_boosting_model.py``, run against the port's copies.

The fits run under one OpenMP thread: beside other test workers sklearn's
per-core threads spin against each other.
"""

import pytest
from _torch_rerun import load

load(globals(), "test_boosting_model.py")


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1):
        yield
