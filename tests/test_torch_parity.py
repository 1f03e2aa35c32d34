"""The JAX package's ``tests/test_parity.py``, run against the port's
``scripts/torch_parity.py`` (the same archive contract, loud skip, bands and
refusal of a synthetic fallback), on the CPU: the harness is asked for it
with ``--device cpu``, and the port's trainings run on one intra-op thread
(beside the other test workers, torch's default thread pool spins)."""

import pytest
import torch
from _torch_rerun import load


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


load(globals(), "test_parity.py", subs=[
    ('"scripts", "parity.py"', '"scripts", "torch_parity.py"'),
    ('    "--dense-units", "16", "--batch-size", "32",\n',
     '    "--dense-units", "16", "--batch-size", "32", "--device", "cpu",\n'),
])
