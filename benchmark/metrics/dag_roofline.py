"""The stage-DAG kernels' share of their roofline over the profiled calls, in %.

Bound: the least time for the DAG work the window's genomes need (kept
nodes' input sums, the stage outputs with their 2×2 pool, and in training
their gradients), bytes at the HBM peak or operations at the float32 vector
peak, whichever is larger (``work.py``).  Measured: the device time of the
system's DAG kernels, found by name in the profile."""

#: The kernels of ``csrc/pop_dag.cu``.
KERNELS = r"dag_node_input_kernel|dag_stage_out_kernel|dag_node_grad_kernel"


def read(run):
    if run.timeline is None:
        return None
    seconds = run.timeline.seconds_matching(KERNELS)
    if seconds <= 0:
        return None
    w = run.work(traced=True)
    return 100.0 * (w.dag["train"].bound_s + w.dag["eval"].bound_s) / seconds
