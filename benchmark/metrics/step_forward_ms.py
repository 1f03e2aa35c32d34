"""Milliseconds a train step spends in its ``forward`` phase on the host's
clock: the model's forward and the loss, each micro-slice.  From the
``forward_s`` of the system's ``train`` spans over their steps
(``phases.step_ms``)."""

from benchmark import phases


def read(run):
    return phases.step_ms(run, "forward")
