"""The JAX package's ``tests/test_forensics.py``, run against the port's copies.

One seam: the winner's-ancestry case loads the forensics CLI by path, which
is the port's ``scripts/torch_gentun_trace.py``.
"""

from _torch_rerun import load

load(globals(), "test_forensics.py", subs=[(
    '"scripts", "gentun_trace.py"))',
    '"scripts", "torch_gentun_trace.py"))',
)])
