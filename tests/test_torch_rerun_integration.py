"""The JAX package's ``tests/test_integration.py``, run against the port's copies.

One seam: the port's CNN asks for the CPU with ``mesh="cpu"`` (its default
is the CUDA device).  It trains with one intra-op thread, as the port's
other test files do.
"""

import pytest
import torch
from _torch_rerun import load

load(globals(), "test_integration.py", subs=[(
    '            seed=0,\n        ),',
    '            seed=0,\n            mesh="cpu",\n        ),',
)])


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
