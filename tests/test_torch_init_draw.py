"""The CPU init draw on a pool of host threads gives the calling thread's bits.

``_init_population_params`` draws each (fold, genome) stream from its own
generator into its own slices, on a pool of host threads once a stream holds
``_POOL_MIN_STREAM_ELEMENTS`` weights.  The reference here is a plain copy of
the loop that draws every stream on the calling thread, one after another.
Config #5's per-genome shapes (6.39 M weights a stream) engage the pool;
config #2's (0.32 M) stay on the calling thread.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch import nn

from gentun_tpu_torch.models import cnn as port_cnn

#: (nodes, filters, dense units, classes) of configs #2 and #5, on 32×32×3
SHAPES = {"config2": ((3, 4, 5), (8, 16, 32), 500, 10),
          "config5": ((5, 5, 5), (64, 128, 256), 512, 100)}
KFOLD = 2
HASHES = port_cnn._genome_hashes([{"S_1": (1, 0, 1)}, {"S_1": (0, 1, 1)}, {"S_1": (1, 1, 0)}])
_MODELS, _REFERENCES = {}, {}


@pytest.fixture(autouse=True)
def _four_intra_op_threads():
    """A thread budget of 4, so the pool engages whatever the host's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def _model(shape):
    if shape not in _MODELS:
        nodes, filters, dense, classes = SHAPES[shape]
        _MODELS[shape] = port_cnn.MaskedGeneticCnn(nodes, filters, 1, (32, 32, 3), dense, classes,
                                                   0.5, "float32", False)
    return _MODELS[shape]


def _serial_reference(model, kfold, seed, genome_hashes, domain=0):
    named = dict(model.named_parameters())
    n = len(genome_hashes)
    out = {
        name: torch.zeros((kfold, n, *p.shape[1:]), dtype=torch.float32)
        for name, p in named.items()
    }
    weights = [name for name in named if name.endswith(".weight")]
    for f in range(kfold):
        for i, (hi, lo) in enumerate(genome_hashes):
            g = torch.Generator()
            g.manual_seed(port_cnn._stream_seed(seed, port_cnn._INIT_DOMAIN, domain, f, hi, lo))
            for name in weights:
                w = out[name][f, i]
                fan_in = w.shape[-3] * 9 if w.dim() == 4 else w.shape[0]
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                w.mul_(float(np.sqrt(1.0 / fan_in)) / port_cnn._TRUNC_NORMAL_STD)
    return out


def _reference(shape, domain):
    if (shape, domain) not in _REFERENCES:
        _REFERENCES[shape, domain] = _serial_reference(_model(shape), KFOLD, 5, HASHES, domain)
    return _REFERENCES[shape, domain]


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == torch.float32 and a[name].shape == b[name].shape, name
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("domain", [0, port_cnn._HOLDOUT_DOMAIN], ids=["cv", "holdout"])
@pytest.mark.parametrize("shape, pooled", [("config5", True), ("config2", False)])
def test_the_draw_is_the_serial_loop_bit_for_bit(monkeypatch, shape, pooled, domain):
    model = _model(shape)
    streams, elements, threads = port_cnn._draw_plan(model, KFOLD, len(HASHES))
    per_stream = sum(p.numel() for name, p in model.named_parameters() if name.endswith(".weight"))
    assert (streams, elements) == (KFOLD * len(HASHES), KFOLD * len(HASHES) * per_stream)
    assert threads == (4 if pooled else 1)

    ran_on, teams = [], []
    real = port_cnn._draw_stream

    def spy(*args):
        ran_on.append(threading.current_thread())
        teams.append(torch.get_num_threads())
        real(*args)

    monkeypatch.setattr(port_cnn, "_draw_stream", spy)
    got = port_cnn._init_population_params(model, KFOLD, 5, HASHES, domain=domain)
    _assert_same_bits(got, _reference(shape, domain))
    assert len(ran_on) == streams
    if pooled:
        # each pool thread runs its ops alone; the caller's budget is untouched
        assert all(t.name.startswith("gentun-init-draw") for t in ran_on)
        assert set(teams) == {1} and torch.get_num_threads() == 4
    else:
        assert set(ran_on) == {threading.current_thread()} and set(teams) == {4}


def test_a_pooled_genome_draws_the_same_weights_in_any_slot():
    model = _model("config5")
    a = port_cnn._init_population_params(model, KFOLD, 5, HASHES)
    b = port_cnn._init_population_params(model, KFOLD, 5, HASHES[::-1])
    n = len(HASHES)
    for name in a:
        for i in range(n):
            assert torch.equal(a[name][:, i], b[name][:, n - 1 - i]), (name, i)


def test_two_threads_drawing_at_once_each_get_the_serial_bits():
    model = _model("config5")
    domains = (0, port_cnn._HOLDOUT_DOMAIN)
    start, got, errors = threading.Barrier(len(domains)), {}, []

    def draw(domain):
        try:
            start.wait(timeout=30)
            got[domain] = port_cnn._init_population_params(model, KFOLD, 5, HASHES, domain=domain)
        except Exception as e:  # noqa: BLE001 - handed to the test thread below
            errors.append(e)

    threads = [threading.Thread(target=draw, args=(d,)) for d in domains]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # the interpreter lock changes hands often
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    for domain in domains:
        _assert_same_bits(got[domain], _reference("config5", domain))


def test_a_failing_stream_raises_in_the_caller_after_every_stream_ended(monkeypatch):
    model = _model("config5")
    real, ended = port_cnn._draw_stream, []

    def fail_one(out, weights, f, i, stream_seed):
        if (f, i) == (1, 2):
            raise RuntimeError("stream (1, 2) failed")
        real(out, weights, f, i, stream_seed)
        ended.append((f, i))

    monkeypatch.setattr(port_cnn, "_draw_stream", fail_one)
    assert port_cnn._draw_plan(model, KFOLD, len(HASHES))[2] > 1
    with pytest.raises(RuntimeError, match=r"stream \(1, 2\) failed"):
        port_cnn._init_population_params(model, KFOLD, 5, HASHES)
    assert len(ended) == KFOLD * len(HASHES) - 1


def test_a_forked_child_makes_its_own_pool(monkeypatch):
    """A forked child inherits the pool object but none of its threads."""
    parent = port_cnn._draw_pool()
    assert port_cnn._draw_pool() is parent
    monkeypatch.setattr(port_cnn, "_DRAW_POOL", port_cnn._DRAW_POOL)  # the parent's, after
    monkeypatch.setattr(port_cnn.os, "getpid", lambda: -1)
    child = port_cnn._draw_pool()
    try:
        assert child is not parent
        assert parent.submit(int, "7").result(timeout=30) == 7  # left running
    finally:
        child.shutdown()
