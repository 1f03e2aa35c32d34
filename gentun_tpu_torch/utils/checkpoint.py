"""Generation-boundary checkpoint/resume.

A copy of the JAX package's ``utils/checkpoint.py``, with the same file
format: at every generation boundary, persist {genes, fitness, RNG state,
history} as JSON — tiny, human-readable, and enough to resume a search
bit-exactly (the GA consumes randomness only from its own generator, whose
state is saved).

Fitness values are kept apart from the JAX package's: the state a port GA
writes carries ``fitness_protocol`` = ``utils.fitness_store.FITNESS_PROTOCOL``
(``"torch-1"``), and the port's ``GeneticAlgorithm.load_state_dict`` drops
every stored fitness and the fitness cache of a checkpoint stamped with
another protocol (one the JAX package wrote, say): genes, RNG state and
history resume, the current generation is measured again.

Model weights are deliberately NOT checkpointed: fitness evaluation is
stateless by design (every individual trains from scratch), so there is no
model state worth resuming — which is also why JSON suffices over orbax.

Schema versioning: every checkpoint written carries ``schema_version``.
Version history:

- **1** (implicit — files without the field): generational GA state only.
- **2**: adds the asynchronous steady-state scheduler state
  (``AsyncEvolution``: completion counters, dispatch-ordered in-flight
  children, ever-best individual) and the ``algorithm`` tag both loaders
  use to refuse each other's files.
- **3**: adds the multi-fidelity ladder state (``AsyncEvolution`` with
  ``fidelity_ladder=``): the ladder itself, per-rung completion records,
  per-member rung/promotion markers, per-rung best genomes, and in-flight
  entries widened from bare genes to ``{genes, rung, kind, member_index}``
  so an in-flight PROMOTION resumes as a promotion of the same ring
  member, not as a fresh child.  v2 files load (their in-flight lists
  read as rung-0 children), and ladderless runs still write a state v2
  readers would recognize field-for-field — the version is bumped because
  a v2 reader resuming a LADDERED file would silently drop every rung.
- **4**: adds the surrogate rung −1 state (``AsyncEvolution`` with
  ``surrogate=``): the ridge model (weights AND training samples), the
  rolling score window, pending gate decisions (admitted score awaiting
  its realized fitness), precision@k pairs, and the degradation flag —
  everything a killed master needs to resume the gated trajectory
  bit-identically.  v3 (and older) files load fine; the version is
  bumped because a v3 reader resuming a GATED file would silently drop
  the model and window, replaying admissions against empty state and
  diverging from the uninterrupted trajectory.

Loading is backward-compatible (a v1 file loads fine) but not
forward-compatible: a file stamped NEWER than this code understands is
refused loudly rather than half-restored.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Optional

__all__ = ["Checkpointer", "load_checkpoint", "namespaced_path",
           "CHECKPOINT_SCHEMA"]

#: Newest checkpoint layout this code can write and read (see the module
#: docstring for the version history).
CHECKPOINT_SCHEMA = 4


def _to_jsonable(obj: Any) -> Any:
    """numpy scalars/arrays → plain Python, recursively (RNG state has them)."""
    import numpy as np

    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _to_jsonable(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def namespaced_path(path: str, namespace: Optional[str]) -> str:
    """Insert a per-session namespace into a checkpoint path.

    ``search.json`` + namespace ``tenant-a`` → ``search.tenant-a.json``,
    so concurrent searches sharing one fleet (DISTRIBUTED.md "Multi-tenant
    search sessions") never clobber each other's checkpoints.  The
    namespace is sanitized to filename-safe characters; ``None``/empty
    returns the path unchanged.
    """
    if not namespace:
        return str(path)
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", str(namespace))
    root, ext = os.path.splitext(str(path))
    return f"{root}.{safe}{ext}" if ext else f"{root}.{safe}"


class Checkpointer:
    """Atomic JSON checkpoints, attached to a GA via ``set_checkpointer``.

    ``GeneticAlgorithm.evolve_population`` calls :meth:`save` after every
    generation; :meth:`resume` restores an algorithm to the last saved
    state.  Writes are tmp-file + rename, so a crash mid-write leaves the
    previous checkpoint intact.
    """

    def __init__(self, path: str, keep_history: bool = True,
                 namespace: Optional[str] = None):
        self.path = namespaced_path(path, namespace)
        self.namespace = str(namespace) if namespace else None
        self.keep_history = keep_history

    def save(self, algorithm) -> None:
        state = algorithm.state_dict()
        state["schema_version"] = CHECKPOINT_SCHEMA
        if not self.keep_history:
            state["history"] = state["history"][-1:]
        payload = json.dumps(_to_jsonable(state), separators=(",", ":"))
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt-", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            state = json.load(f)
        version = state.get("schema_version", 1)  # pre-versioning files are v1
        if version > CHECKPOINT_SCHEMA:
            raise ValueError(
                f"checkpoint {self.path!r} has schema version {version}, newer "
                f"than this code understands (max {CHECKPOINT_SCHEMA}) — "
                "refusing a partial restore; upgrade gentun_tpu_torch to resume it")
        return state

    def resume(self, algorithm) -> bool:
        """Restore ``algorithm`` from the checkpoint; True if one existed."""
        state = self.load()
        if state is None:
            return False
        algorithm.load_state_dict(state)
        return True


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    return Checkpointer(path).load()
