"""The conv kernels' share of their roofline over the profiled calls, in %.

Bound: the least time the chip could take for the 3×3 convs the window's
genomes need (forward, input and weight gradients of the entry convs and of
the kept nodes' convs; evaluation's forward over the real validation rows),
each the larger of its operations at the bf16 tensor-core peak and its
bytes at the HBM peak (``work.py``).  Measured: the device time of the
system's conv kernels, found by name in the profile."""

#: The conv kernels of ``csrc/pop_conv3x3.cu``.
KERNELS = r"fwd_bf16_kernel|fwd_fma_kernel|wgrad_bf16_kernel|wgrad_fma_kernel|wgrad_finalize_kernel"


def read(run):
    if run.timeline is None:
        return None
    seconds = run.timeline.seconds_matching(KERNELS)
    if seconds <= 0:
        return None
    w = run.work(traced=True)
    return 100.0 * (w.conv["train"].bound_s + w.conv["eval"].bound_s) / seconds
