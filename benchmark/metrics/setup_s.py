"""Seconds from the process's start to the first timed call: imports, the
card, the inputs, the kernel library (built with nvcc by a checkout's first
run, loaded from ``build/kernels`` by every later one) and the warm-up call."""


def read(run):
    return run.setup_s
