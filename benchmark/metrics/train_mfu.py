"""The train steps' share of the chip's peak, in %: the matrix operations the
window's genomes need in training (convs of the kept nodes forward and
backward, the dense head; ``work.py``) over the system's ``train`` spans'
time, against the bf16 tensor-core peak."""

from benchmark import peaks


def read(run):
    seconds = run.span_seconds("train")
    if seconds <= 0:
        return None
    peak = peaks.MATMUL_FLOPS[run.config["compute_dtype"]]
    return 100.0 * run.work().flops("train") / seconds / peak
