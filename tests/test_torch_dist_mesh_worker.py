"""The JAX package's ``tests/test_mesh_worker.py``, run against the port's copy.

Left out: ``TestDerivedCapacity::test_auto_probes_jax_for_jax_species``, which
counts jax's 8 virtual CPU devices.  Its counterpart,
``test_torch_dist_seams.py::test_auto_capacity_probes_cuda_device_count``,
holds the port's probe of ``torch.cuda.device_count()``.
"""

from _torch_rerun import load

load(globals(), "test_mesh_worker.py",
     leave_out=["TestDerivedCapacity::test_auto_probes_jax_for_jax_species"])
