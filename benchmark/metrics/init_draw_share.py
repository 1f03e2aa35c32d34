"""Share of the window's calls spent in the system's ``init_draw`` spans, in
%: the CPU draw of each call's initial weights, host time in which the
card waits for the call's first upload."""


def read(run):
    seconds = run.span_seconds("init_draw")
    if seconds <= 0:
        return None
    return 100.0 * seconds / run.calls_s
