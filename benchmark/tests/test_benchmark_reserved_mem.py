"""The reader of ``reserved_mem_gib`` on made-up runs: the largest
``reserved_bytes`` of the system's ``cv_call`` spans over the window's
calls, in GiB, and nothing where no ``cv_call`` span carries it."""

import numpy as np
import pytest

from benchmark.cell import _load_module
from benchmark.record import Call, Run
from benchmark.tests.conftest import ROOT


def _run(*calls):
    return Run(config={}, traffic={}, seed=0, setup_s=1.0, x=None, y=None, call_seed=0,
               calls=[Call(start=float(i), end=i + 0.9, genomes=[{}] * 2, fitness=np.zeros(2),
                           spans=spans) for i, spans in enumerate(calls)])


def _cv_call(**attrs):
    return {"kind": "cv_call", "dur_s": 0.9, "attrs": {"pop": 2, "n_real": 2, "kfold": 2, **attrs}}


def _read(run):
    return _load_module(f"{ROOT}/benchmark", "metrics", "reserved_mem_gib").read(run)


def test_the_reading_is_the_largest_over_the_calls_in_gib():
    train = {"kind": "train", "dur_s": 0.1, "attrs": {"steps": 3, "reserved_bytes": 2 ** 40}}
    calls = ([_cv_call(reserved_bytes=3 * 2 ** 30), train],
             [_cv_call(reserved_bytes=5 * 2 ** 29)],
             [_cv_call(reserved_bytes=7 * 2 ** 30), _cv_call(reserved_bytes=2 ** 30)])
    assert _read(_run(*calls)) == pytest.approx(7.0)


@pytest.mark.parametrize("calls", [([_cv_call()],), ([],), ([{"kind": "cv_call", "dur_s": 0.9}],)],
                         ids=["no-counter", "no-spans", "no-attrs"])
def test_nothing_to_read_gives_none(calls):
    assert _read(_run(*calls)) is None
