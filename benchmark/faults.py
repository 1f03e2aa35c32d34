"""Faults planted underneath a run's timed path, for the check that decides
``correct``: each must make a run read ``correct`` false.  The benchmark's
own runs never plant one; ``readings.py`` does on the chip, and the tests
do on the CPU.

- ``state_unchanged``: a train step that returns its state unchanged;
- ``half_batch``: a train step that leaves out half of the batch and takes
  the mean over the rest;
- ``answers_moved``: each genome's fitness handed to the next genome of its
  call (the answers of a call moved round by one slot);
- ``labels_shifted``: the evaluation scores each prediction against the
  next class's label.
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = ("state_unchanged", "half_batch", "answers_moved", "labels_shifted")


@contextlib.contextmanager
def planted(fault: str, n_classes: int):
    """The system with ``fault`` planted inside the block."""
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}; there are {FAULTS}")
    import gentun_tpu_torch.models.cnn as cnn

    owner, name = (cnn.GeneticCnnModel, "cross_validate_population") \
        if fault == "answers_moved" else (cnn, "_eval_fold" if fault == "labels_shifted"
                                          else "_train_step")
    sound = owner.__dict__[name]
    if fault == "state_unchanged":
        def broken(*args, **kwargs):
            return None
    elif fault == "half_batch":
        def broken(model, masks, x, y, idx, *rest, **kwargs):
            return sound(model, masks, x, y, idx[: idx.shape[0] // 2], *rest, **kwargs)
    elif fault == "labels_shifted":
        def broken(model, masks, x, y, *rest, **kwargs):
            return sound(model, masks, x, (y + 1) % n_classes, *rest, **kwargs)
    else:
        @classmethod
        def broken(cls, *args, **kwargs):
            return np.roll(np.asarray(sound.__func__(cls, *args, **kwargs)), 1)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, sound)
