"""Milliseconds a train step, from the system's ``train`` spans (each ends
with a device synchronise) divided by the steps they carry."""


def read(run):
    steps = run.span_steps()
    if steps == 0:
        return None
    return 1000.0 * run.span_seconds("train") / steps
