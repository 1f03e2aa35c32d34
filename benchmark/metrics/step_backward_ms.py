"""Milliseconds a train step spends in its ``backward`` phase on the host's
clock: ``autograd.grad`` and the gradient sums.  From the
``backward_s`` of the system's ``train`` spans over their steps
(``phases.step_ms``)."""

from benchmark import phases


def read(run):
    return phases.step_ms(run, "backward")
