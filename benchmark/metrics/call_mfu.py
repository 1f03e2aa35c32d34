"""The whole calls' share of the chip's peak, in %: the matrix operations of
all training and evaluation the window's genomes need (real validation rows
only; ``work.py``) over the calls' wall time (the window, less the pause
where a traced run stops its profile), against the bf16 tensor-core peak.  It scales with individuals_per_hour, and bounds any gain claimed
after a kernel leaves the path."""

from benchmark import peaks


def read(run):
    peak = peaks.MATMUL_FLOPS[run.config["compute_dtype"]]
    w = run.work()
    return 100.0 * (w.flops("train") + w.flops("eval")) / run.calls_s / peak
