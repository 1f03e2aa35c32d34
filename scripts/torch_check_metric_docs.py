"""Drift guard between the port's metrics registry and its catalog,
docs/TORCH_OBSERVABILITY.md.

A new ``reg.counter("...")`` needs a doc row, and a doc row must still
name a metric that exists.  This script checks both ways:

- **missing_from_docs** — instrument names registered in the codebase
  (literal first argument to ``.counter(`` / ``.gauge(`` /
  ``.histogram(``) in ``gentun_tpu_torch/`` with no row in any metric
  table of ``docs/TORCH_OBSERVABILITY.md``;
- **stale_doc_rows** — doc rows whose metric name no longer appears
  anywhere in ``gentun_tpu_torch/`` or ``scripts/torch_*.py`` (the metric
  was renamed or deleted and the catalog was not updated).

Exit status 0 when both lists are empty, 1 otherwise, so it can run as
a test (``tests/test_torch_rerun_obs_guards.py``) and as a pre-commit
sanity check:

    python scripts/torch_check_metric_docs.py          # human summary
    python scripts/torch_check_metric_docs.py --json   # machine-readable

Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC_PATH = os.path.join(REPO, "docs", "TORCH_OBSERVABILITY.md")

#: Literal first argument of an instrument registration/lookup.  Names
#: built from variables or f-strings do not match — those metrics must
#: be registered somewhere with a literal too (today every one is).
_INSTRUMENT_RE = re.compile(
    r"\.(?:counter|gauge|histogram)\(\s*\n?\s*\"([a-z][a-z0-9_]*)\"")

#: A metric-catalog table row: | `name` | counter/gauge/histogram | ...
_DOC_ROW_RE = re.compile(
    r"^\|\s*`([a-z][a-z0-9_]*)`\s*\|\s*(counter|gauge|histogram)\s*\|")

#: Registrations are collected from the library only — benchmark
#: harnesses in scripts/ may register synthetic metrics (e.g. the
#: aggregator push-scan probe's `bench_labeled_total`) that are not part
#: of the operator-facing surface.  The port's scripts still count for the
#: stale check: a doc row any source file mentions stays alive.  Each root
#: is (directory, file-name prefix).
_LIBRARY_ROOTS = (("gentun_tpu_torch", ""),)
_ALL_ROOTS = (("gentun_tpu_torch", ""), ("scripts", "torch_"))


def _py_files(repo: str = REPO, roots=_ALL_ROOTS) -> List[str]:
    out: List[str] = []
    for root, prefix in roots:
        for dirpath, _dirnames, filenames in os.walk(os.path.join(repo, root)):
            out.extend(os.path.join(dirpath, f) for f in filenames
                       if f.endswith(".py") and f.startswith(prefix))
    return sorted(out)


def code_metrics(repo: str = REPO) -> Dict[str, List[str]]:
    """name -> sorted list of repo-relative files registering it."""
    found: Dict[str, Set[str]] = {}
    for path in _py_files(repo, roots=_LIBRARY_ROOTS):
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        rel = os.path.relpath(path, repo)
        for name in _INSTRUMENT_RE.findall(src):
            found.setdefault(name, set()).add(rel)
    return {k: sorted(v) for k, v in sorted(found.items())}


def doc_metrics(doc_path: str = DOC_PATH) -> Dict[str, str]:
    """name -> declared type, from every metric table in the doc."""
    rows: Dict[str, str] = {}
    with open(doc_path, encoding="utf-8") as fh:
        for line in fh:
            m = _DOC_ROW_RE.match(line)
            if m:
                rows[m.group(1)] = m.group(2)
    return rows


def _name_in_code(name: str, sources: List[str]) -> bool:
    return any(f'"{name}"' in src or f"'{name}'" in src for src in sources)


def check(repo: str = REPO, doc_path: str = DOC_PATH) -> Dict[str, object]:
    code = code_metrics(repo)
    docs = doc_metrics(doc_path)
    missing = {n: files for n, files in code.items() if n not in docs}
    # Stale the other way: a doc row is stale only if its name appears in
    # NO source file at all (some rows document aliases or metrics whose
    # registration site builds the name dynamically — a plain string
    # mention anywhere keeps the row alive).
    sources = []
    for path in _py_files(repo):
        with open(path, encoding="utf-8") as fh:
            sources.append(fh.read())
    stale = sorted(n for n in docs if n not in code
                   and not _name_in_code(n, sources))
    return {
        "code_metrics": len(code),
        "doc_rows": len(docs),
        "missing_from_docs": missing,
        "stale_doc_rows": stale,
        "ok": not missing and not stale,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="registry <-> docs/TORCH_OBSERVABILITY.md drift guard")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    result = check()
    if args.json:
        json.dump(result, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        print(f"{result['code_metrics']} registry metrics in code, "
              f"{result['doc_rows']} doc rows")
        for name, files in result["missing_from_docs"].items():
            print(f"  MISSING doc row: {name}  (registered in "
                  f"{', '.join(files)})")
        for name in result["stale_doc_rows"]:
            print(f"  STALE doc row: {name}  (no longer in the codebase)")
        if result["ok"]:
            print("ok: catalog and registry agree")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
