"""The JAX package's ``tests/test_fidelity.py``, run against the port's copies.

- ``TestWarmStartBank`` trains the port's CNN, so its configuration asks for
  the CPU with ``mesh="cpu"`` (the reference passes ``mesh=None``, its
  one-device mesh; the port's default is the CUDA device).
- ``TestWarmStartBank::test_warm_start_does_not_change_compiled_program_key``
  is left out: it holds ``_static_key``, the JAX package's key of a compiled
  XLA program, and the port compiles no program (its executor runs eager
  torch ops over prebuilt kernels), so there is no key for warm start to
  change.

The port's CNN trains here with one intra-op thread, as in the port's other
test files.
"""

import pytest
import torch
from _torch_rerun import load

load(globals(), "test_fidelity.py", subs=[(
    'seed=3, compute_dtype="float32", mesh=None)',
    'seed=3, compute_dtype="float32", mesh="cpu")',
)], leave_out=["TestWarmStartBank::test_warm_start_does_not_change_compiled_program_key"])


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
