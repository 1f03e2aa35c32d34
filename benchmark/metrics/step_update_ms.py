"""Milliseconds a train step spends in its ``update`` phase on the host's
clock: the all-reduce, if any, and the SGD update of every parameter.  From the
``update_s`` of the system's ``train`` spans over their steps
(``phases.step_ms``)."""

from benchmark import phases


def read(run):
    return phases.step_ms(run, "update")
