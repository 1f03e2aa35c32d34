"""What a driver hands the metric readers and the judge: the calls of the
measured window, each with its genomes, answers and the system's spans, and
what the run measured around them."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from . import peaks, work
from .devtrace import Timeline


@dataclass
class Call:
    start: float  # host clock, seconds
    end: float
    genomes: List[Dict[str, tuple]]
    fitness: np.ndarray
    spans: List[Dict[str, Any]] = field(default_factory=list)  # the system's span records
    traced: bool = False  # ran under the profiler

    def span_seconds(self, kind: str) -> float:
        return sum(r["dur_s"] for r in self.spans if r.get("kind") == kind)


@dataclass
class Run:
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    setup_s: float
    calls: List[Call]
    x: np.ndarray  # the inputs, for the judge
    y: np.ndarray
    call_seed: int  # the seed the system's calls were given
    timeline: Optional[Timeline] = None  # traced runs only
    peak_setup_bytes: Optional[int] = None  # the allocator's peak before the window
    peak_window_bytes: Optional[int] = None  # and in it
    _work: Dict[bool, work.CallWork] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.calls[-1].end - self.calls[0].start

    @property
    def calls_s(self) -> float:
        """The calls' own time: the window less any pause between calls."""
        return sum(c.end - c.start for c in self.calls)

    @property
    def individuals(self) -> int:
        return sum(len(c.genomes) for c in self.calls)

    def work(self, traced: bool = False) -> work.CallWork:
        """The needed work of every call of the window, or of the profiled ones."""
        if traced not in self._work:
            self._work[traced] = work.total([work.call_work(self.config, c.genomes, peaks)
                                             for c in self.calls if c.traced or not traced])
        return self._work[traced]

    def span_seconds(self, kind: str) -> float:
        return sum(c.span_seconds(kind) for c in self.calls)

    def span_steps(self) -> int:
        return sum(int(r["attrs"]["steps"]) for c in self.calls for r in c.spans
                   if r.get("kind") == "train")
