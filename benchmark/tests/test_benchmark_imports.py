"""What the benchmark imports, compared by whole top-level module names."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
SOURCES = sorted(os.path.join(d, f) for d, _, files in os.walk(BENCH) for f in files
                 if f.endswith(".py") and os.sep + "tests" not in d[len(BENCH):])


def _imported(path):
    """Top-level names of the absolute imports in a file."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_file_imports_jax_the_jax_package_or_the_old_benches(path):
    names = _imported(path)
    assert not names & {"jax", "jaxlib", "flax", "gentun_tpu", "bench", "bench_torch",
                        "chip_smoke", "scripts"}
    if os.sep + "reference" + os.sep in path:
        assert "gentun_tpu_torch" not in names  # the reference takes nothing of the system


def test_the_system_is_entered_only_through_its_entry_and_its_spans():
    imports = set()
    for path in SOURCES:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
                imports |= {m for m in mods if m and m.split(".")[0] == "gentun_tpu_torch"}
    assert imports <= {"gentun_tpu_torch", "gentun_tpu_torch.models.cnn",
                       "gentun_tpu_torch.telemetry"}


def test_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "gentun_tpu_torch_shadow", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gentun_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["gentun_tpu", "jaxlib"]


def test_a_fresh_process_loads_none_of_them_with_the_system():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import run, cell, judge, readings, devtrace\n"
            "from benchmark.reference import gcnn\n"
            "c = cell.load('c2-proxy-p20'); c.driver(); c.readers(True); c.readers(False)\n"
            "import gentun_tpu_torch.models.cnn, gentun_tpu_torch.telemetry.spans\n"
            "print(run.forbidden_modules())\n") % ROOT
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
