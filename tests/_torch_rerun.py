"""Run a JAX-package test file's cases against the port's copies.

The distributed plane, the fitness and compile services and the canary are
copies in the port, so the JAX package's own tests are their specification.
:func:`load` reads a reference test file, points every import of the JAX
package at ``gentun_tpu_torch`` (plus any exact substitutions a file needs
for a seam the port rewrote), and executes it in the calling test module's
namespace, where pytest collects its cases as the module's own.  The
reference files stay untouched.  Tracebacks carry the reference file's line
numbers under the port module's file name.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, Tuple

TESTS = Path(__file__).resolve().parent
_REFERENCE = re.compile(r"gentun_tpu(?!_torch)\b")


def _compile(src: str, filename: str):
    tree = ast.parse(src, filename)
    try:  # pytest's assertion rewriting, so a failing case explains itself
        from _pytest.assertion.rewrite import rewrite_asserts

        rewrite_asserts(tree, src.encode(), filename)
    except Exception:  # noqa: BLE001 - plain asserts still check the same
        pass
    return compile(tree, filename, "exec")


def load(namespace: dict, reference: str, subs: Iterable[Tuple[str, str]] = (),
         leave_out: Iterable[str] = ()) -> None:
    """Define ``tests/<reference>``'s cases, retargeted at the port, in ``namespace``.

    ``subs`` are exact ``(old, new)`` replacements applied after the package
    rename; each must match, so a stale one fails loudly.  ``leave_out``
    names cases (``"test_x"`` or ``"TestClass::test_x"``) that are not
    collected; each must exist.
    """
    src = _REFERENCE.sub("gentun_tpu_torch", (TESTS / reference).read_text())
    for old, new in subs:
        if old not in src:
            raise AssertionError(f"{reference}: substitution target not found: {old!r}")
        src = src.replace(old, new)
    exec(_compile(src, namespace["__file__"]), namespace)  # noqa: S102
    for case in leave_out:
        owner, _, name = case.rpartition("::")
        target = namespace[owner] if owner else None
        if target is None:
            del namespace[name]
        else:
            if name not in vars(target):
                raise AssertionError(f"{reference}: no case {case}")
            delattr(target, name)
