"""Share of the traced window in which no operation ran on the device, from
the profiler's timeline: 1 − (union of kernel, copy and set intervals) /
window, in %.  How far the host holds the card back."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
