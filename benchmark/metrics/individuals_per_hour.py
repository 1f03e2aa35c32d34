"""Individuals whose fitness came back from the window's whole calls, per
hour of the window (the first call's start to the last call's end).  The
reference's north-star unit: individuals evaluated per hour per chip."""


def read(run):
    return run.individuals / run.window_s * 3600.0
