"""Wall time of building the kernel library two ways, on a host with ``nvcc``.

``single``: one ``nvcc -shared`` over every ``csrc/*.cu``, which compiles
the sources one after another in a single compiler call.  ``parallel``:
:func:`gentun_tpu_torch.ops._build.build`, one ``nvcc -c`` for each source,
all started together, then one ``nvcc -shared`` link.  Each build writes into
a fresh directory under ``build/build_time/``, in the order single,
parallel, parallel, single, so that a warm file cache favours neither.
Prints one JSON object: each build's seconds and the host's CPU count.

    python3 -m gentun_tpu_torch.tools.build_time
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

from gentun_tpu_torch.ops import _build

OUT = _build.BUILD_DIR.parent / "build_time"


def single(out) -> float:
    """Seconds of one ``nvcc -shared`` over every ``.cu`` source."""
    cu = [str(p) for p in _build._sources() if p.suffix == ".cu"]
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    return took


def parallel(out) -> float:
    """Seconds of ``_build.build()`` into an empty directory."""
    _build.use_build_dir(out)
    t0 = time.perf_counter()
    _build.build()
    return time.perf_counter() - t0


def main() -> int:
    runs = []
    for i, (name, fn) in enumerate((("single", single), ("parallel", parallel),
                                    ("parallel", parallel), ("single", single))):
        out = OUT / f"{i}_{name}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        runs.append({"build": name, "s": fn(out)})
        print(f"[build_time] {name}: {runs[-1]['s']:.3f} s", file=sys.stderr)
    shutil.rmtree(OUT, ignore_errors=True)
    mean = lambda name: sum(r["s"] for r in runs if r["build"] == name) / 2
    print(json.dumps({"runs": runs, "single_mean_s": mean("single"),
                      "parallel_mean_s": mean("parallel"),
                      "sources": [p.name for p in _build._sources() if p.suffix == ".cu"],
                      "cpu_count": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
