"""The harness finds a cell, its traffic mix and its metrics from new files
and entries alone, and every part the manifest names exists."""

import json
import os

import pytest

from benchmark import cell
from benchmark.tests.conftest import ROOT

MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def test_a_new_cell_mix_and_metric_are_found_by_name(tiny_manifest):
    path, base = tiny_manifest({"max_fitness_gap": 0.0})
    with open(path) as fh:
        manifest = json.load(fh)
    manifest["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                                  "source": "host_clock", "layer": "executor",
                                  "moves": "individuals_per_hour", "workloads": ["tiny-cell"]})
    with open(path, "w") as fh:
        json.dump(manifest, fh)
    with open(os.path.join(base, "metrics", "calls_in_window.py"), "w") as fh:
        fh.write("def read(run):\n    return len(run.calls)\n")
    c = cell.load("tiny-cell", path, base)
    assert c.traffic["pop"] == 6 and c.config["nodes"] == [3, 4]
    assert c.driver().__name__ == "benchmark.drivers.generation"
    readers = c.readers(trace=True)
    assert readers["calls_in_window"][1].read(type("R", (), {"calls": [1, 2]})()) == 2
    assert set(c.readers(trace=False)) == {"individuals_per_hour", "setup_s"}


def test_a_per_layer_metric_goes_to_the_cells_it_lists(tiny_manifest):
    path, base = tiny_manifest({"max_fitness_gap": 0.0})
    with open(path) as fh:
        manifest = json.load(fh)
    manifest["per_layer"][1]["workloads"] = ["another-cell"]
    with open(path, "w") as fh:
        json.dump(manifest, fh)
    names = [m["name"] for m in cell.load("tiny-cell", path, base).metrics["per_layer"]]
    assert manifest["per_layer"][0]["name"] in names
    assert manifest["per_layer"][1]["name"] not in names


@pytest.mark.parametrize("workload", [w["name"] for w in json.load(open(MANIFEST))["workloads"]])
def test_every_cell_of_the_manifest_has_its_parts(workload):
    c = cell.load(workload)
    assert c.chips == 1 and c.driver() is not None
    for trace in (False, True):
        assert c.readers(trace)
    assert set(c.config["limits"]) and int(c.traffic["judged"]) > 0
    with open(MANIFEST) as fh:
        manifest = json.load(fh)
    entry = next(e for e in manifest["configs"] if e["name"] == c.config["name"])
    assert sorted(entry["reduced"]) == sorted(c.config["reduced"])
