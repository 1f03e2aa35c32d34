"""The JAX package's ``tests/test_populations_speculative.py``, run against
the port's copies.

One seam: the port's model pads a population with ``parallel.mesh.pop_bucket``
itself (the reference's model keeps a private ``_pop_bucket`` beside it), so
the lockstep case holds the GA's mirror against that function.
"""

from _torch_rerun import load

load(globals(), "test_populations_speculative.py", subs=[(
    "from gentun_tpu_torch.models.cnn import _pop_bucket",
    "from gentun_tpu_torch.parallel.mesh import pop_bucket as _pop_bucket",
)])
