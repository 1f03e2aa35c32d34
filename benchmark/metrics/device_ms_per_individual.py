"""Device time an individual takes, in ms: the union of device intervals over
the profiled calls (``devtrace.py``), divided by the individuals those calls
evaluated.  It follows the kernels' and copies' work and not the host's
pace, so it stays steady where the rate moves with the host."""


def read(run):
    tl = run.timeline
    n = sum(len(c.genomes) for c in run.calls if c.traced)
    if tl is None or tl.busy_s <= 0 or n == 0:
        return None
    return 1000.0 * tl.busy_s / n
