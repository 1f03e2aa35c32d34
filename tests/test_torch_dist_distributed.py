"""The JAX package's ``tests/test_distributed.py``, run against the port's copy.

- ``TestDistributedFitnessPurity`` trains the port's CNN, so its
  configuration asks for the CPU (``mesh="cpu"``, the port's idiom; the
  default is the CUDA device).
- ``TestWorkerCli::test_module_entrypoint_serves_jobs`` is left out: under a
  parallel test run its two boosting jobs outlast the master's gather (the
  reference's own case fails that way).  Its counterpart,
  ``test_torch_dist_seams.py::test_worker_module_serves_tiny_cnn_jobs``,
  runs the port's worker module with bounds sized for a loaded machine.

The port's CNN trains here with one intra-op thread, as in the port's other
test files.
"""

import pytest
import torch
from _torch_rerun import load

load(globals(), "test_distributed.py",
     subs=[('compute_dtype="float32", seed=0)',
            'compute_dtype="float32", seed=0, mesh="cpu")')],
     leave_out=["TestWorkerCli::test_module_entrypoint_serves_jobs"])


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
