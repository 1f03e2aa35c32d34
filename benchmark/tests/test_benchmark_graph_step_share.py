"""The reader of ``graph_step_share`` on made-up runs: the share of train
steps the system replayed from its train step's CUDA graph, and nothing
where the program's ``train`` spans carry no ``graph_steps``."""

import numpy as np
import pytest

from benchmark.cell import _load_module
from benchmark.record import Call, Run
from benchmark.tests.conftest import ROOT


def _run(*calls):
    return Run(config={}, traffic={}, seed=0, setup_s=1.0, x=None, y=None, call_seed=0,
               calls=[Call(start=float(i), end=i + 0.9, genomes=[{}] * 2, fitness=np.zeros(2),
                           spans=spans) for i, spans in enumerate(calls)])


def _train(steps, **graph):
    return {"kind": "train", "dur_s": 0.1, "attrs": {"steps": steps, "pop": 2, **graph}}


def _read(run):
    return _load_module(f"{ROOT}/benchmark", "metrics", "graph_step_share").read(run)


def test_the_share_is_replayed_steps_over_all_steps():
    call = [{"kind": "cv_call", "dur_s": 0.9}, _train(19, graph_steps=18, captures=1),
            _train(19, graph_steps=19, captures=0), {"kind": "eval", "dur_s": 0.1}]
    assert _read(_run(call, call)) == pytest.approx(100.0 * 74 / 76)


def test_an_eager_program_reads_zero():
    call = [_train(3, graph_steps=0, captures=0), _train(3, graph_steps=0, captures=0)]
    assert _read(_run(call)) == 0.0


@pytest.mark.parametrize("calls", [([_train(19)],), ([],), ([{"kind": "eval", "dur_s": 0.1}],)],
                         ids=["no-graph-attrs", "no-spans", "no-train-spans"])
def test_nothing_to_read_gives_none(calls):
    assert _read(_run(*calls)) is None
