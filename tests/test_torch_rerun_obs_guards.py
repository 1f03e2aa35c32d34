"""The JAX package's ``tests/test_obs_guards.py``, run against the port's copies.

Its scripts and artifact are the port's: ``_load_script`` loads
``scripts/torch_<name>.py`` (the metric-doc guard, the hot-path gate table
and the SLO timeline), and the gate table is read from the committed
``scripts/torch_broker_throughput.json``.  The metric-doc guard checks the
port's registry against ``docs/TORCH_OBSERVABILITY.md``.  Its gates (at
least 9 gated planes, each within 2%) stay as they are.
"""

from _torch_rerun import load

load(globals(), "test_obs_guards.py", subs=[
    ('os.path.join(REPO, "scripts", f"{name}.py"))',
     'os.path.join(REPO, "scripts", f"torch_{name}.py"))'),
    ('path = os.path.join(REPO, "scripts", "broker_throughput.json")',
     'path = os.path.join(REPO, "scripts", "torch_broker_throughput.json")'),
])
