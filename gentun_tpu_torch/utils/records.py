"""Where a study script writes its JSON record, and what machine it names.

A study keeps its fixed configuration and takes one flag, ``--out``; its
record carries a ``machine`` block: ``nvidia-smi``'s name and power limit
of the first card (None where there is no ``nvidia-smi``) and the host's
``os.cpu_count()``.  Nothing here initialises CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from typing import Any, Dict, Optional, Sequence

__all__ = ["host_record", "out_path", "stamp"]

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scripts")


def out_path(default_name: str, argv: Optional[Sequence[str]] = None) -> str:
    """``--out PATH`` from the command line, else ``scripts/<default_name>``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(SCRIPTS, default_name),
                    help=f"where to write the JSON record (default scripts/{default_name})")
    return ap.parse_args(argv).out


def host_record() -> Dict[str, Any]:
    """The card's ``nvidia-smi`` name and power limit, and the host's CPU count."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {"nvidia_smi": smi, "cpu_count": os.cpu_count()}


def stamp(record: Dict[str, Any]) -> Dict[str, Any]:
    """``record`` with its ``machine`` block added (in place)."""
    record["machine"] = host_record()
    return record
