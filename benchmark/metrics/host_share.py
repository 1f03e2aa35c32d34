"""Share of the window's calls spent outside the system's ``train`` and
``eval`` spans, in %: the CPU draw of the initial weights, the uploads and
the host's set-up of each call."""


def read(run):
    inside = run.span_seconds("train") + run.span_seconds("eval")
    if inside <= 0:
        return None
    return 100.0 * (1.0 - inside / run.calls_s)
