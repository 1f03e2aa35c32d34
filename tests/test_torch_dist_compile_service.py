"""The JAX package's ``tests/test_compile_service.py``, run against the port's copy.

The port's kernel cache module (``utils/kernel_cache.py``) stands where the
reference's XLA cache module stands, with the same publish-hook names, and
the cache directory moves with ``GENTUN_TORCH_CACHE_DIR``.  Left out, each
with its counterpart in ``tests/test_torch_dist_seams.py``:

- ``TestPlatformFingerprint::test_components_name_the_compat_facts`` and
  ``test_xla_flags_change_the_fingerprint``: they name jax's fingerprint
  fields; the port fingerprints torch, CUDA, driver, SM, flags and sources.

The concurrent-publish case passes here because the port's client counts
the batch in flight (``CompileServiceClient.flush``); the loop in
``test_torch_dist_seams.py`` runs it 20 times.
"""

from _torch_rerun import load

load(globals(), "test_compile_service.py",
     subs=[("from gentun_tpu_torch.utils import xla_cache",
            "from gentun_tpu_torch.utils import kernel_cache as xla_cache"),
           ('monkeypatch.setenv("GENTUN_TPU_CACHE_DIR", str(cache_dir))',
            'monkeypatch.setenv("GENTUN_TORCH_CACHE_DIR", str(cache_dir))')],
     leave_out=["TestPlatformFingerprint::test_components_name_the_compat_facts",
                "TestPlatformFingerprint::test_xla_flags_change_the_fingerprint"])
