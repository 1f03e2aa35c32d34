"""Cross-run fitness persistence: never train the same architecture twice,
even across separate searches.

``Population.fitness_cache`` already spans generations within one search
and rides checkpoints within one resumed search (``utils/checkpoint.py``).
This module extends the reuse across PROCESSES and EXPERIMENTS, the same
way ``utils/xla_cache.py`` persists compilations: a plain JSON file of
``[cache_key, fitness]`` pairs that any number of runs can load, extend,
and merge.  The reference has no counterpart (its only reuse is in-memory
``get_fitness`` caching [PUB]); repeated experimentation — exactly the
workload a hyperparameter-search tool exists for — retrains everything.

Keys are ``Individual.cache_key()`` values (nested tuples of JSON-native
leaves; architecture-canonical for ``GeneticCnnIndividual``), serialized
with the checkpoint's tuple↔list convention.  Keys that embed non-JSON
values are skipped on save, like the checkpoint does — a dropped entry
only costs a retrain.

Usage::

    cache = load_fitness_cache("digits_s35.fitness.json")   # {} if absent
    pop = Population(GeneticCnnIndividual, ..., fitness_cache=cache)
    GeneticAlgorithm(pop, seed=0).run(50)
    save_fitness_cache(pop.fitness_cache, "digits_s35.fitness.json")

``save_fitness_cache`` MERGES with whatever is already in the file (other
runs may have written since we loaded), and writes atomically.

The cache key embeds ``additional_parameters``, so entries are only ever
reused for identical training configurations; a changed schedule or
dataset size produces disjoint keys.  Changed dataset CONTENT under the
same configuration is the caller's responsibility, exactly as with the
reference's in-memory cache — keep one file per dataset.

**Mixed-version fleets: all writers upgrade together.**  The payload
carries a ``version`` (file schema) besides ``protocol`` (fitness
semantics).  Writers REFUSE files whose version exceeds their own
``STORE_VERSION`` — refusing is the only safe move, because an older
writer's read-merge-write cycle would load a newer file as empty (its
loader ignores unknown protocols) and then rewrite it, silently
destroying every newer-protocol entry under the old stamp.  Readers
likewise ignore newer files rather than guessing at their schema.  The
consequence is operational, not mechanical: when a store file is shared
between machines (workers with ``--fitness-store``, masters with
``fitness_store=``), upgrade every writer to the same code revision
before any of them runs — a mixed fleet degrades to refusals (loud, no
data loss on the new side) but pre-``STORE_VERSION``-aware writers
(version 1) predate this guard and WILL clobber newer files; do not
point them at a shared store.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Any, Dict

__all__ = [
    "load_fitness_cache", "save_fitness_cache", "tuplify",
    "is_serializable_key", "fidelity_fingerprint", "key_digest",
    "FITNESS_PROTOCOL", "STORE_VERSION",
]

#: Fitness-measurement RNG protocol.  Bump whenever a model's fitness for
#: the SAME (cache_key, config, seed) changes incompatibly, so persisted
#: values from older protocols are never silently mixed with new
#: measurements (mixed protocols steer a search exactly the way the
#: content-hash purity work exists to prevent).  History:
#:   1 — per-slot PRNG keys (``split(PRNGKey(seed+f), pop)``), rounds 1-4:
#:       fitness depended on batch slot/composition;
#:   2 — content-hash keys (``models/cnn._genome_hashes``), round 5:
#:       fitness is a pure function of (architecture, config, seed);
#:   3 — 64-bit content hashes (blake2b split across two fold_in calls),
#:       round 6: init/dropout streams collision-free at 10k+ genomes.
#: The PyTorch port measures with its own streams (torch generators seeded
#: from the same content hashes) and its own kernels, so its values are
#: never the JAX package's: it stamps a value of its own, a string that can
#: never equal one of the integer protocols above, so a store or checkpoint
#: written by one package is dropped loudly by the other.
FITNESS_PROTOCOL = "torch-1"

#: File-schema version.  Bump together with any payload change; writers
#: refuse files with a NEWER version (see module docstring — an older
#: writer merging a newer file would load it as empty and clobber it).
#: History: 1 — original payload; 2 — version guard introduced;
#: 3 — entries carry a fidelity fingerprint (``[key, fitness, fp]``) so
#: proxy-rung and full-schedule measurements of the same genome can never
#: be conflated, even if the set of fidelity-relevant knobs changes
#: between code revisions (mismatched fingerprints drop loudly on load).
STORE_VERSION = 3

#: The ``additional_parameters`` knobs that change what a fitness number
#: MEANS (a 1-epoch 2-fold proxy measurement is not the full-schedule
#: fitness of the same genome).  The fingerprint below hashes exactly
#: this subset, so adding a knob here invalidates persisted entries that
#: predate it — loudly, via the v3 load-time cross-check — instead of
#: silently reusing a lower-fidelity number at a higher rung.
FIDELITY_KNOBS = ("kfold", "epochs", "learning_rate", "fitness_reps", "warm_start")


def fidelity_fingerprint(params: Any) -> str:
    """12-hex-char digest of the fidelity-relevant subset of ``params``.

    ``params`` may be a mapping (``additional_parameters`` as configured)
    or its frozen form (a tuple of sorted ``(key, value)`` pairs — the
    third component of a cache key).  Knobs absent from ``params`` are
    omitted from the digest, so configs that never mention a knob keep a
    stable fingerprint when defaults move.  This string is the wire
    ``fidelity.fingerprint`` field and the store's per-entry stamp.
    """
    import hashlib

    if not isinstance(params, dict):
        try:
            params = dict(params or ())
        except (TypeError, ValueError):
            params = {}
    subset = {k: params[k] for k in FIDELITY_KNOBS if k in params}
    blob = json.dumps({"v": 1, "knobs": subset}, sort_keys=True, default=str)
    return hashlib.blake2b(blob.encode(), digest_size=6).hexdigest()


def key_digest(key: Any) -> str:
    """16-hex-char (64-bit) blake2b content address of a cache key.

    The networked fitness service (``distributed/fitness_service.py``)
    addresses entries by this digest instead of shipping whole keys: the
    same width as the genome content hashes of FITNESS_PROTOCOL 3
    (collision-free at 10k+ genomes), computed over the key's canonical
    JSON serialization — so two runs that freeze the same architecture
    and config produce the same address without sharing any state.  The
    caller must hold a JSON-serializable key (``is_serializable_key``);
    tuples serialize as lists, which is fine because BOTH sides of every
    comparison go through the same ``json.dumps``.
    """
    import hashlib

    blob = json.dumps(key, separators=(",", ":"), default=str)
    return hashlib.blake2b(blob.encode(), digest_size=8).hexdigest()


def _key_fingerprint(key: Any) -> str:
    """Fingerprint of a cache key's embedded ``additional_parameters``.

    Every ``Individual.cache_key()`` shape ends with the frozen
    additional_parameters tuple; anything else fingerprints as "no
    fidelity knobs" (the empty-config digest), which is correct for
    synthetic test keys that carry no training config at all.
    """
    if isinstance(key, tuple) and key and isinstance(key[-1], tuple):
        return fidelity_fingerprint(key[-1])
    return fidelity_fingerprint({})


def tuplify(obj: Any) -> Any:
    """Inverse of JSON's tuple→list coercion.

    THE canonical definition of the cache-key serialization convention —
    the checkpoint (``algorithms.state_dict``) and this store share it, so
    a cache saved by either subsystem round-trips through the other.
    """
    if isinstance(obj, list):
        return tuple(tuplify(v) for v in obj)
    return obj


def is_serializable_key(key: Any) -> bool:
    """True when a cache key survives the JSON round trip.

    Keys that embed non-JSON values (bytes from ndarray params, arbitrary
    objects) are skipped by both persistence subsystems — never crash a
    search over a cache entry; a dropped one only costs a retrain.
    """
    try:
        json.dumps(key)
    except (TypeError, ValueError):
        return False
    return True


@contextlib.contextmanager
def _file_lock(path: str):
    """Exclusive advisory lock serializing read-merge-write cycles.

    Uses a sidecar ``<path>.lock`` (flock on the data file itself would be
    lost across the atomic rename).  Best-effort on platforms without
    fcntl — the write itself stays atomic either way.
    """
    try:
        import fcntl
    except ImportError:  # pragma: no cover - non-POSIX
        yield
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _read_store(path: str):
    """ONE read of the store file → ``(version, cache)``.

    The shared parse for load and save — the save path used to probe the
    version with its own ``json.load`` and then call the loader, parsing
    the file twice inside the same lock.  Missing file → ``(STORE_VERSION,
    {})``.  A NEWER-versioned file returns its version with an empty cache
    and is left untouched — callers own the refusal messaging (load warns
    and ignores, save errors and aborts).  Protocol mismatch warns here
    (both callers ignore such entries identically); corruption quarantines
    to ``<path>.corrupt`` and reads as version 1, empty.
    """
    if not os.path.exists(path):
        return STORE_VERSION, {}
    try:
        with open(path) as f:
            payload = json.load(f)
        version = payload.get("version", 1)
        if version > STORE_VERSION:
            return version, {}
        proto = payload.get("protocol", 1)
        if proto != FITNESS_PROTOCOL:
            import logging

            logging.getLogger("gentun_tpu_torch").warning(
                "fitness store %s was measured under RNG protocol %s "
                "(current: %s); IGNORING its entries — fitness values are "
                "not comparable across protocols, and mixing them would "
                "silently steer the search.  The file is left untouched; "
                "the next save rewrites it at the current protocol.",
                path, proto, FITNESS_PROTOCOL,
            )
            return version, {}
        cache: Dict[Any, float] = {}
        dropped = 0
        for entry in payload["entries"]:
            if len(entry) >= 3:
                # v3 entry: [key, fitness, fidelity fingerprint].  The
                # stamp was computed from the key at save time; recompute
                # and cross-check so entries written when a DIFFERENT set
                # of knobs counted as fidelity-relevant are dropped (a
                # retrain) instead of reused at the wrong rung.
                k, v, fp = entry[0], entry[1], entry[2]
                key = tuplify(k)
                if fp != _key_fingerprint(key):
                    dropped += 1
                    continue
            else:
                k, v = entry
                key = tuplify(k)
            cache[key] = float(v)
        if dropped:
            import logging

            logging.getLogger("gentun_tpu_torch").warning(
                "fitness store %s: dropped %d entr%s whose fidelity "
                "fingerprint no longer matches this code revision's "
                "FIDELITY_KNOBS — those genomes will retrain rather than "
                "reuse a measurement of unknown fidelity.",
                path, dropped, "y" if dropped == 1 else "ies",
            )
        return version, cache
    except (ValueError, KeyError, TypeError, AttributeError) as e:
        backup = path + ".corrupt"
        try:
            os.replace(path, backup)
        except OSError:
            backup = "<unmovable>"
        import logging

        logging.getLogger("gentun_tpu_torch").warning(
            "fitness store %s is unreadable (%s); starting empty, original "
            "kept at %s", path, e, backup,
        )
        return 1, {}


def load_fitness_cache(path: str) -> Dict[Any, float]:
    """Fitness cache from ``path`` (empty dict when the file doesn't exist).

    The returned dict is a plain ``fitness_cache`` for any Population.
    A corrupt or schema-mismatched file degrades to an empty cache with a
    loud warning (the original is preserved as ``<path>.corrupt``) — per
    this module's convention, a cache must NEVER crash a search, least of
    all at the end-of-run save that would lose the measurements.
    """
    version, cache = _read_store(path)
    if version > STORE_VERSION:
        import logging

        logging.getLogger("gentun_tpu_torch").warning(
            "fitness store %s has file-schema version %s, newer than "
            "this writer's %s; IGNORING it — upgrade this process "
            "before sharing the store (see utils/fitness_store.py).  "
            "The file is left untouched.",
            path, version, STORE_VERSION,
        )
        return {}
    return cache


def save_fitness_cache(cache: Dict[Any, float], path: str) -> int:
    """Merge ``cache`` into ``path`` atomically; returns total entries stored.

    The read-merge-write cycle runs under an exclusive file lock, so
    concurrent savers serialize instead of losing each other's new
    entries; on a key collision the in-memory value wins (it is the most
    recent measurement).  Non-JSON-serializable keys are skipped silently,
    per the checkpoint convention.
    """
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)  # before locking: works with or without fcntl
    with _file_lock(path):
        # A newer-versioned file must not be rewritten: our loader reads it
        # as empty, so the merge below would atomically replace it with only
        # this process's entries — destroying the newer fleet's measurements.
        # ONE read answers both the version guard and the merge base.
        existing_version, merged = _read_store(path)
        if existing_version > STORE_VERSION:
            import logging

            logging.getLogger("gentun_tpu_torch").error(
                "REFUSING to save fitness store %s: its file-schema "
                "version %s is newer than this writer's %s.  Upgrade "
                "this process, or point it at a different store file; "
                "these measurements were NOT persisted.",
                path, existing_version, STORE_VERSION,
            )
            return 0
        for k, v in cache.items():
            if not is_serializable_key(k):
                continue
            merged[k] = float(v)
        payload = {
            "version": STORE_VERSION,
            "protocol": FITNESS_PROTOCOL,
            "entries": [[k, v, _key_fingerprint(k)] for k, v in merged.items()],
        }
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".fitness-", suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, separators=(",", ":"))
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    return len(merged)
