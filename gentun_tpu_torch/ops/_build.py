"""Build the port's CUDA sources into one shared library at first use, and load it.

The sources are ``gentun_tpu_torch/csrc/*.cu`` and ``*.cuh``.  On the first
call of :func:`library` in a process, ``nvcc`` compiles them for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into
``build/kernels/libgentun_kernels_<hash>.so`` at the root of the checkout
(or the directory :func:`use_build_dir` names: ``utils/kernel_cache.py``
manages that knob), where ``<hash>`` covers the sources and the flags, so an
edited source builds anew and an unchanged one is loaded as it is.  The
library has a plain C interface and is loaded with ``ctypes``: pointers and
the stream pass as ``c_void_p``.  Importing this module needs neither ``nvcc`` nor a card; only
:func:`library` does.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

logger = logging.getLogger("gentun_tpu_torch")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_dir: Path = BUILD_DIR
#: The compiler's output of the build this process ran (``-Xptxas -v``:
#: registers, shared memory and spills per kernel); empty when it loaded a
#: library built earlier.
build_log = ""

#: Kernel launches per wrapper of the library, counted where a kernel is
#: launched and nowhere else (a CPU call launches nothing).  One table for
#: every wrapper module: ``pop_conv.LAUNCHES`` and ``pop_dag.LAUNCHES`` are it.
LAUNCHES: Dict[str, int] = {
    name: 0 for name in ("pop_conv3x3_fwd", "pop_conv3x3_wgrad", "pop_dag_node_input",
                         "pop_dag_stage_out", "pop_dag_node_grad")
}
#: Guards the read-modify-write of a count: evaluations on several threads
#: launch at once, and a bare ``+= 1`` can lose a count between them.
_launch_lock = threading.Lock()
#: Launches recorded while a stream is captured into a CUDA graph, by the
#: stream's handle: a captured launch runs only when the graph replays, and
#: :func:`add_launches` counts it then.
_recording: Dict[int, Dict[str, int]] = {}


def _current_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def count_launch(name: str) -> None:
    with _launch_lock:
        counts = _recording.get(_current_stream()) if _recording else None
        if counts is None:
            LAUNCHES[name] += 1
        else:
            counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Inside the block, record the launches issued to the current CUDA
    stream (a graph's capture) instead of counting them; yields the record,
    launches by wrapper.  Launches on other streams and threads count as
    before."""
    stream, counts = _current_stream(), {}
    with _launch_lock:
        _recording[stream] = counts
    try:
        yield counts
    finally:
        with _launch_lock:
            del _recording[stream]


def add_launches(counts: Mapping[str, int]) -> None:
    """Count launches issued without their wrappers: a graph's replay of
    what :func:`recording_launches` recorded."""
    with _launch_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "gentun_pop_conv3x3_fwd": (_I, [_I, _P, _P, _P, _P, *[_I] * 6, _L, _L, _P]),
    "gentun_pop_conv3x3_fwd_bf16_config": (_I, [_I, _P, _P, _P, _P, *[_I] * 6, _L, _L, _P]),
    "gentun_pop_conv3x3_fwd_bf16_pick": (_I, [_I] * 4),
    "gentun_pop_conv3x3_wgrad": (_I, [_I, *[_P] * 6, *[_I] * 8, _L, _L, _P]),
    "gentun_pop_conv3x3_wgrad_bf16_config": (_I, [_I, *[_P] * 6, *[_I] * 8, _L, _L, _P]),
    "gentun_pop_conv3x3_wgrad_bf16_pick": (_I, [_I] * 4),
    "gentun_pop_dag_node_input": (_I, [_I, _P, _P, _I, _P, _P, _P, _I, _P, *[_I] * 5, _P]),
    "gentun_pop_dag_stage_out": (_I, [_I, _P, _P, _I, *[_P] * 5, *[_I] * 6, _P]),
    "gentun_pop_dag_node_grad": (_I, [_I, *[_P] * 4, *[_I] * 3, *[_P] * 6, *[_I] * 5, _P]),
    "gentun_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no nvcc on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_dir() -> Path:
    """The directory the next build writes to and loads from."""
    return _build_dir


def use_build_dir(path) -> Path:
    """Build into (and load from) ``path`` from now on; returns it.  A
    library this process already loaded stays loaded: it is the build of
    the same sources."""
    global _build_dir
    with _lock:
        _build_dir = Path(path)
    return _build_dir


def source_hash() -> str:
    """16 hex digits over the ``nvcc`` flags and every source's name and bytes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    return _build_dir / f"libgentun_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its path.

    Each ``.cu`` compiles in an ``nvcc`` of its own, all at once, and one
    more links the objects; the library is written to a temporary name
    that is renamed into place, so no process ever loads a half-written
    file.  Processes that share the
    build directory (the ranks of a worker on one host) take an exclusive
    ``flock`` on it first: one builds, the others wait and load its file.
    The kernel drops the lock with its holder, so a killed build leaves no
    stale lock.  A failed build raises with the compiler's output.
    """
    global build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(out.parent, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        logger.info("building %s with nvcc", out)
        # One nvcc per source, all started together, then one link: the
        # build takes its slowest source's time, not the sum.
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = tmp.with_name(f"{tmp.stem}.{src.stem}.o")
            cmd = [_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
        try:
            if not failed:
                cmd = [_nvcc(), "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                logs.append(proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}")
        finally:
            for _, obj, _ in jobs:
                obj.unlink(missing_ok=True)
        build_log = "".join(logs)
        if failed:
            raise RuntimeError("\n".join(failed) + "\n" + build_log)
        os.replace(tmp, out)
        return out
    finally:
        os.close(fd)  # releases the lock


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc:
        msg = library().gentun_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
