"""Closed loop of GA generations: one ``cross_validate_population`` call at a
time, as a generational GA waits for each generation's fitnesses.

Each call evaluates ``pop`` fresh genomes drawn from ``--seed`` and the
call's index, so no cache can answer it and every seed does the same work
(the system trains its whole stage supergraph whatever the genomes).  The
images upload once, in the warm-up call, and stay cached between calls, as
in a worker.  Set-up (imports, the card, the inputs, the kernel library and
one warm-up call of the same shapes) ends when the first timed call starts.
A call starts while the time spent so far plus the previous call's time
stays within ``seconds``; the first always starts.

In a traced run the system's telemetry spans are on and captured per call,
and the calls that start within the mix's ``traced_seconds`` run under the
profiler, each inside a ``record_function`` range the timeline reduction
finds; the profile stops between two calls.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from .. import data, devtrace, genomes
from ..record import Call, Run


def run(cell, seed: int, seconds: float, trace: bool, cache_dir: str, process_start: float,
        device, max_calls: int = None) -> Run:
    """The run's window; ``max_calls`` also ends it after that many calls."""
    import torch

    from gentun_tpu_torch.models.cnn import GeneticCnnModel
    from gentun_tpu_torch.telemetry import spans

    config, pop = cell.config, int(cell.traffic["pop"])
    x, y = data.images(config, seed)
    kwargs = data.call_kwargs(config, seed, cache_dir)
    cuda = device.type == "cuda"
    kwargs["mesh"] = "auto" if cuda else str(device)

    def evaluate(population):
        fit = GeneticCnnModel.cross_validate_population(x, y, population, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        return np.asarray(fit)

    evaluate(genomes.sample_genomes(config["nodes"], pop, seed, 0))
    peak_setup = torch.cuda.max_memory_allocated() if cuda else None
    if trace:
        spans.enable()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = devtrace.profiler() if trace else None
    traced_s = float(cell.traffic.get("traced_seconds", seconds))
    calls, profiled = [], None
    if prof is not None:
        prof.__enter__()
    try:
        t0 = time.monotonic()
        while not calls or ((time.monotonic() - t0) + (calls[-1].end - calls[-1].start) <= seconds
                            and len(calls) != max_calls):
            population = genomes.sample_genomes(config["nodes"], pop, seed, len(calls) + 1)
            traced = prof is not None
            with spans.capture() as records:
                marked = torch.profiler.record_function(devtrace.MARK) if traced else None
                with marked or contextlib.nullcontext():
                    start = time.monotonic()
                    fit = evaluate(population)
                end = time.monotonic()
            calls.append(Call(start, end, population, fit, list(records), traced))
            if traced and end - t0 >= traced_s:
                prof.__exit__(None, None, None)
                profiled, prof = prof, None
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            profiled = prof
        spans.disable()
    return Run(config=config, traffic=cell.traffic, seed=seed,
               setup_s=calls[0].start - process_start, calls=calls,
               x=x, y=y, call_seed=kwargs["seed"],
               timeline=devtrace.reduce(profiled) if profiled is not None else None,
               peak_setup_bytes=peak_setup,
               peak_window_bytes=torch.cuda.max_memory_allocated() if cuda else None)
