"""Find a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<mix>.json``), the driver the
mix names (``drivers/<driver>.py``) and the reader of each metric it reports
(``metrics/<metric>.py``).  A cell, a mix, a driver or a metric is added as
new files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_module(base: str, kind: str, name: str):
    path = os.path.join(base, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    module_name = "benchmark.%s.%s" % (kind, name.replace(".", "_").replace("-", "_"))
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    metrics: Dict[str, List[Dict[str, Any]]]  # "end_to_end" / "per_layer" → entries
    base: str = HERE  # the directory holding traffic/, drivers/ and metrics/

    def driver(self):
        return _load_module(self.base, "drivers", self.traffic["driver"])

    def readers(self, trace: bool) -> Dict[str, Any]:
        """``{metric name: (entry, reader module)}`` of what this run reports."""
        kind = "per_layer" if trace else "end_to_end"
        return {m["name"]: (m, _load_module(self.base, "metrics", m["name"]))
                for m in self.metrics[kind]}


def load(workload: str, manifest_path: str = None, base: str = HERE) -> Cell:
    """The cell named ``workload`` and the metrics it reports, from the
    manifest (``BENCHMARK.json`` at the root; configuration files are named
    relative to its directory) and the parts under ``base``.  An end-to-end
    metric without ``workloads`` is every cell's; each per-layer metric
    lists the cells that report it."""
    manifest_path = manifest_path or os.path.join(ROOT, "BENCHMARK.json")
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {manifest_path}; there are {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(os.path.join(os.path.dirname(manifest_path), configs[entry["config"]]["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(base, "traffic", f"{entry['traffic']}.json")) as fh:
        traffic = json.load(fh)
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m for m in manifest["per_layer"] if workload in m["workloads"]]
    return Cell(name=workload, chips=int(entry["chips"]), config=config, traffic=traffic,
                metrics={"end_to_end": e2e, "per_layer": per_layer}, base=base)
