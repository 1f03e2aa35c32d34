"""The needed-work counts against hand counts at a tiny configuration."""

import pytest

from benchmark import peaks, work
from benchmark.genomes import decode_stage

# One stage of 3 nodes and 4 filters over 4×4×2 images, dense 5, 3 classes;
# 8 images in two folds: 4 training rows, batch 2, 2 steps a fold, 4
# validation rows a fold.
CFG = dict(nodes=[3], kernels_per_layer=[4], input_shape=[4, 4, 2], dense_units=5, n_classes=3,
           n_train_images=8, kfold=2, epochs=[1], batch_size=2, compute_dtype="bfloat16")


def test_schedule_counts_rows_steps_and_validation_rows():
    assert work.schedule(CFG) == {"kfold": 2, "steps": 2, "batch": 2, "val_rows": 4}


def test_an_unconnected_node_costs_nothing():
    # bits (0→1, 0→2, 1→2) = (1, 0, 0): node 2 has no edge and is dropped
    st = decode_stage((1, 0, 0), 3)
    assert st.active == (True, True, False)
    assert st.entry == (True, False, False) and st.exit == (False, True, False)
    one = work.call_work(CFG, [{"S_1": (1, 0, 0)}], peaks)
    chain = work.call_work(CFG, [{"S_1": (1, 0, 1)}], peaks)  # 0→1, 1→2: three nodes kept
    conv_fwd = 2.0 * 2 * 4 * 4 * 9 * 4 * 4  # one node conv's forward on a batch of 2
    # training: 4 steps, each node conv forward, input and weight gradients
    assert chain.conv["train"].ops - one.conv["train"].ops == pytest.approx(4 * 3 * conv_fwd)


def test_conv_and_dense_operations_match_a_hand_count():
    w = work.call_work(CFG, [{"S_1": (1, 0, 0)}], peaks)
    entry = 2.0 * 16 * 9 * 2 * 4  # an image through the entry conv (2 → 4 channels)
    node = 2.0 * 16 * 9 * 4 * 4  # an image through a node conv
    dense = 2.0 * (4 * 2 * 2 * 5 + 5 * 3)  # pooled 2×2×4 → 5 → 3
    train_rows, eval_rows = 2 * 2 * 2, 2 * 4  # 2 folds × 2 steps × batch 2; 2 folds × 4 rows
    # training: forward + weight gradient of every conv, input gradient of all
    # but the entry conv (its input is the images); the dense head three times
    assert w.conv["train"].ops == pytest.approx(train_rows * (2 * entry + 3 * 2 * node))
    assert w.dense["train"].ops == pytest.approx(train_rows * 3 * dense)
    assert w.conv["eval"].ops == pytest.approx(eval_rows * (entry + 2 * node))
    assert w.flops("eval") == pytest.approx(eval_rows * (entry + 2 * node + dense))


def test_dag_bytes_match_a_hand_count():
    # the chain 0 → 1 with node 2 dropped, evaluation only: node 0 reads the
    # stage input, node 1 reads node 0; each writes its sum; the stage output
    # reads node 1 and writes the pooled quarter, all in bf16
    st = decode_stage((1, 0, 0), 3)
    e = 10
    ops, nbytes = work._dag(st, e, 2, train=False)
    assert nbytes == (2 * e + 2 * e + e + e / 4) * 2
    # training adds the window argmax (one byte a pooled element), node 1's
    # gradient (reads its output, the pooled gradient and argmax, writes),
    # node 0's (reads its output and node 1's input gradient, writes), and
    # the entry conv's (reads its output and node 0's input gradient, writes)
    _, train_bytes = work._dag(st, e, 2, train=True)
    extra = e / 4 + (e + e / 4 + e) * 2 + e / 4 + (2 * e + e) * 2 + (2 * e + e) * 2
    assert train_bytes == pytest.approx(nbytes + extra)


def test_a_stage_with_no_kept_node_pools_its_input_node():
    st = decode_stage((0, 0, 0), 3)
    assert not st.has_active
    _, nbytes = work._dag(st, 8, 4, train=False)
    assert nbytes == (8 + 2) * 4  # reads the entry conv's output, writes the pool


def test_each_bound_is_the_larger_of_its_two_times():
    w = work.Work()
    w.add(989.4e12, 0.0, 989.4e12, 3.35e12)
    w.add(0.0, 3.35e12, 989.4e12, 3.35e12)
    assert w.bound_s == pytest.approx(2.0)
