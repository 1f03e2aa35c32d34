"""Whether the window's answers are right: each judged genome's fitness
against the plain reference's, trained from the same inputs at the same
sizes.

The judged genomes are a sample, drawn from ``--seed``, of every genome the
window's calls evaluated.  From the gaps ``fitness − reference fitness``
over the sample it works out:

- ``fitness_shift``: the mean of the gaps with the fifth at each end left
  out, as a magnitude.  A precision one step below the configuration's
  trains worse and shifts the whole sample, while a single genome's fitness
  after a short training swings with any rounding.
- ``mean_abs_gap``: the mean magnitude of the gaps.  A training that is
  wrong for every genome (half of each batch left out), or answers handed
  to the wrong genomes, move each fitness without moving their mean.
- ``max_abs_gap``: the widest gap, printed beside them.

Each number that the configuration file's ``limits`` names is compared
against its limit.  Any answer that is not a number in [0, 1] fails the run
by itself.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import numpy as np

from .genomes import rng_for
from .reference.gcnn import Reference


def sample(run, n: int) -> List[Tuple[int, int]]:
    """``n`` (call, slot) pairs of the window, drawn from the seed."""
    pairs = [(i, j) for i, c in enumerate(run.calls) for j in range(len(c.genomes))]
    pick = rng_for(run.seed, 0x1D6E).choice(len(pairs), size=min(n, len(pairs)), replace=False)
    return [pairs[k] for k in sorted(pick)]


def gaps(run, device, precision: str = "float32", cache: dict = None) -> Dict[str, List[float]]:
    """For each judged genome: the system's fitness and the reference's, in
    ``precision``.  ``cache`` keeps reference fitnesses by precision, call
    and slot, for runs of one seed that evaluate the same genomes."""
    ref = Reference(run.x, run.y, run.config, run.call_seed, device)
    cache = {} if cache is None else cache
    out = {"answer": [], "reference": []}
    for i, j in sample(run, int(run.traffic["judged"])):
        out["answer"].append(float(run.calls[i].fitness[j]))
        if (precision, i, j) not in cache:
            cache[precision, i, j] = ref.fitness(run.calls[i].genomes[j], precision)
        out["reference"].append(cache[precision, i, j])
    return out


#: The share of the gaps left out at each end of the shift's mean.
TRIM = 0.2


def numbers(pairs: Dict[str, List[float]]) -> Dict[str, float]:
    gap = np.sort(np.asarray(pairs["answer"], np.float64) - np.asarray(pairs["reference"], np.float64))
    cut = int(TRIM * len(gap))
    kept = gap[cut:len(gap) - cut]
    return {"fitness_shift": float(abs(kept.mean())), "mean_abs_gap": float(np.abs(gap).mean()),
            "max_abs_gap": float(np.abs(gap).max())}


def verdict(run, device) -> Tuple[bool, int, Dict[str, Dict[str, float]]]:
    """``(correct, failed, checks)``: ``failed`` counts answers that are not a
    number in [0, 1]; ``checks`` maps each number compared to its value and
    limit."""
    fits = np.concatenate([np.asarray(c.fitness, np.float64) for c in run.calls])
    failed = int(np.count_nonzero(~(np.isfinite(fits) & (fits >= 0.0) & (fits <= 1.0))))
    limits = run.config["limits"]
    got = numbers(gaps(run, device))
    print("judged: " + ", ".join(f"{k} {v!r}" for k, v in got.items()), file=sys.stderr)
    checks = {"invalid_answers": {"value": failed, "limit": 0}}
    checks.update({k: {"value": got[k], "limit": limits[k]} for k in limits})
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, failed, checks
