"""Declarative SLO engine: burn-rate rules over aggregator time-series rings.

The aggregator (:mod:`gentun_tpu_torch.telemetry.aggregator`) keeps a bounded
ring of ``(t, value)`` points per fleet series; this module judges those
rings against a declarative rule table and drives an alert state machine
with hysteresis on both edges:

- **burn-rate, not point-in-time** — every rule measures a *delta over a
  window* (``increase``), a *ratio of two deltas* (``ratio``), or
  *sustained growth of a gauge* (``gauge_growth``).  A single slow scrape
  or one straggly job can never page anyone.
- **flap damping** — a breach must hold for ``for_s`` before an alert
  fires, and the condition must stay healthy for ``clear_for_s`` before
  it resolves.  Between those edges the alert neither re-fires nor
  flickers; a fire→clear→fire cycle inside ``2 * clear_for_s`` is counted
  in ``flaps`` so ``/alertz`` exposes noisy rules.
- **self-clearing** — resolution is an explicit ``clear`` transition (and
  a ``{"type": "alert"}`` telemetry record), never silence.

The engine is deliberately ignorant of HTTP and of the aggregator's
storage: it sees only a *view* callable ``view(name) -> [SeriesPoints]``
so unit tests drive it with hand-built rings.
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "SloRule",
    "SloEngine",
    "SeriesPoints",
    "default_rules",
]

#: Ratio denominators smaller than this count as "no traffic" — the rule
#: abstains rather than dividing noise by noise.
_MIN_DENOM = 1e-9


@dataclass
class SeriesPoints:
    """One fleet series as the engine sees it: labels + time-ordered ring.

    ``points`` are ``(t_monotonic_like, value)`` with counter values
    already reset-corrected by the aggregator (monotone across process
    restarts), so window deltas here are plain subtraction.
    """

    name: str
    labels: Dict[str, str]
    points: List[Tuple[float, float]]

    def window_delta(self, now: float, window_s: float) -> Optional[float]:
        """``v(now) - v(now - window)``; None with <2 usable points."""
        if len(self.points) < 2:
            return None
        cutoff = now - window_s
        first = None
        for t, v in self.points:
            if t >= cutoff:
                first = (t, v)
                break
        if first is None or first == self.points[-1]:
            return None
        return self.points[-1][1] - first[1]

    def window_span(self, now: float, window_s: float) -> float:
        """Observed time span of the points inside the window."""
        cutoff = now - window_s
        ts = [t for t, _ in self.points if t >= cutoff]
        return (ts[-1] - ts[0]) if len(ts) >= 2 else 0.0


@dataclass(frozen=True)
class SloRule:
    """One declarative burn-rate rule.

    ``kind``:

    - ``increase`` — Δ(sum of series matching ``series``) over
      ``window_s`` compared against ``threshold`` with ``op``.
    - ``ratio`` — Δ(series) / Δ(denom) over the window; ``denom`` may be
      the pseudo-series ``"__time__"`` (the observed wall span, giving
      time-fraction ratios like worker-idle), or a pattern whose matched
      deltas are summed.  ``denom_includes_series=True`` adds the
      numerator delta into the denominator (hit / (hit + miss) rates).
    - ``gauge_growth`` — fires when the gauge both grew by at least
      ``threshold`` over the window *and* is still at its window peak
      (backlog that is draining never alerts).

    ``series`` supports ``fnmatch`` wildcards (``*_degraded_total``).
    ``subject`` groups evaluation: ``"instance"`` judges each pushing
    process separately (one alert per sick worker), ``"fleet"`` sums
    everything first.  ``role`` restricts which instances participate.
    """

    name: str
    kind: str
    series: str
    threshold: float
    op: str = ">"
    denom: str = ""
    denom_includes_series: bool = False
    window_s: float = 60.0
    for_s: float = 10.0
    clear_for_s: float = 20.0
    subject: str = "fleet"  # or "instance"
    role: str = ""          # restrict to instances with this role label
    severity: str = "warn"  # or "page"
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ("increase", "ratio", "gauge_growth"):
            raise ValueError(f"rule {self.name}: unknown kind {self.kind!r}")
        if self.op not in (">", "<", ">=", "<="):
            raise ValueError(f"rule {self.name}: unknown op {self.op!r}")
        if self.kind == "ratio" and not self.denom:
            raise ValueError(f"rule {self.name}: ratio needs a denom")
        if self.subject not in ("fleet", "instance"):
            raise ValueError(f"rule {self.name}: subject must be "
                             f"fleet|instance, got {self.subject!r}")
        if self.window_s <= 0:
            raise ValueError(f"rule {self.name}: window_s must be positive")

    def compare(self, value: float) -> bool:
        if self.op == ">":
            return value > self.threshold
        if self.op == "<":
            return value < self.threshold
        if self.op == ">=":
            return value >= self.threshold
        return value <= self.threshold


def default_rules(scale: float = 1.0) -> List[SloRule]:
    """The stock fleet rule table.

    ``scale`` shrinks every window/hold uniformly — production keeps 1.0,
    studies and chaos drills run seconds-long searches and pass ~0.1 so
    the same rules (same thresholds, same shapes) judge a compressed
    timeline.  Thresholds are never scaled: a 60% idle fleet is sick at
    any timescale.
    """
    s = float(scale)
    if s <= 0:
        raise ValueError(f"scale must be positive, got {scale}")
    return [
        SloRule(
            name="worker_idle_ratio", kind="ratio",
            series="worker_idle_s_sum", denom="__time__",
            threshold=0.5, op=">",
            window_s=60.0 * s, for_s=10.0 * s, clear_for_s=20.0 * s,
            subject="instance", role="worker", severity="page",
            description="worker spent >50% of the window waiting for "
                        "jobs — dispatch starvation or a stalled master",
        ),
        SloRule(
            name="fitness_cache_hit_rate", kind="ratio",
            series="fitness_service_hits_total",
            denom="fitness_service_misses_total",
            denom_includes_series=True,
            threshold=0.05, op="<",
            window_s=120.0 * s, for_s=30.0 * s, clear_for_s=60.0 * s,
            subject="fleet", severity="warn",
            description="fleet fitness-cache hit rate collapsed — cache "
                        "restarted, version skew, or key churn",
        ),
        SloRule(
            name="compile_cache_hit_rate", kind="ratio",
            series="compile_cache_hits_total",
            denom="compile_cache_misses_total",
            denom_includes_series=True,
            threshold=0.05, op="<",
            window_s=120.0 * s, for_s=30.0 * s, clear_for_s=60.0 * s,
            subject="fleet", severity="warn",
            description="fleet compile-cache hit rate collapsed — every "
                        "worker is paying full XLA compiles",
        ),
        SloRule(
            name="straggler_rate", kind="increase",
            series="stragglers_detected_total",
            threshold=0.0, op=">",
            window_s=60.0 * s, for_s=5.0 * s, clear_for_s=30.0 * s,
            subject="fleet", severity="warn",
            description="straggler watchdog fired inside the window",
        ),
        SloRule(
            name="degraded_dependency", kind="increase",
            series="*_degraded_total",
            threshold=0.0, op=">",
            window_s=60.0 * s, for_s=0.0, clear_for_s=30.0 * s,
            subject="instance", severity="warn",
            description="a process marked a dependency degraded "
                        "(fitness/compile cache, surrogate, aggregator)",
        ),
        SloRule(
            name="admission_rejection_burn", kind="increase",
            series="admission_rejected_total",
            threshold=0.0, op=">",
            window_s=60.0 * s, for_s=5.0 * s, clear_for_s=20.0 * s,
            subject="fleet", severity="warn",
            description="broker admission control rejected session_open/"
                        "submit inside the window — fleet saturated or a "
                        "tenant over its token-bucket rate",
        ),
        SloRule(
            name="queue_depth_growth", kind="gauge_growth",
            series="session_queue_depth",
            threshold=8.0, op=">",
            window_s=60.0 * s, for_s=10.0 * s, clear_for_s=20.0 * s,
            subject="fleet", severity="page",
            description="session queue depth grew monotonically across "
                        "the window — submission outpacing the fleet",
        ),
        # -- canary plane (telemetry/canary.py): black-box probes of the
        # REAL serving path.  Error burn says "users can't get work
        # through"; latency says "they can, slowly"; correctness is the
        # zero-tolerance page — a golden genome came back with a fitness
        # that is not bit-equal to its sealed value, i.e. the fleet is
        # returning wrong answers and every live search is suspect.
        SloRule(
            name="canary_error_burn", kind="increase",
            series="canary_errors_total",
            threshold=0.0, op=">",
            window_s=60.0 * s, for_s=5.0 * s, clear_for_s=30.0 * s,
            subject="fleet", severity="warn",
            description="canary probes failed inside the window (open/"
                        "submit/result/verify stage) — the serving path "
                        "is broken the way a tenant would see it",
        ),
        SloRule(
            name="canary_latency", kind="ratio",
            series="canary_e2e_seconds_sum",
            denom="canary_e2e_seconds_count",
            threshold=30.0, op=">",
            window_s=120.0 * s, for_s=10.0 * s, clear_for_s=60.0 * s,
            subject="fleet", severity="warn",
            description="mean canary end-to-end probe latency exceeded "
                        "30 s — queueing or evaluation is degraded for "
                        "everyone, not just the probe",
        ),
        SloRule(
            name="canary_correctness", kind="increase",
            series="canary_fitness_drift_total",
            threshold=0.0, op=">",
            window_s=60.0 * s, for_s=0.0, clear_for_s=60.0 * s,
            subject="fleet", severity="page",
            description="a golden genome's fitness was NOT bit-equal to "
                        "its sealed value — the fleet is lying; quarantine "
                        "results since the last clean probe",
        ),
    ]


# -- alert state machine -----------------------------------------------------

_INACTIVE, _PENDING, _FIRING, _CLEARING = "inactive", "pending", "firing", "clearing"


@dataclass
class _AlertState:
    rule: SloRule
    subject: str
    state: str = _INACTIVE
    value: float = 0.0
    pending_since: float = 0.0
    fired_at: float = 0.0
    healthy_since: float = 0.0
    cleared_at: float = 0.0
    fires: int = 0
    flaps: int = 0
    last_transition: float = 0.0
    #: Engine-global monotonic counter stamped at every fire/clear edge.
    #: A poller that caches the last seq it saw detects a fire→clear→fire
    #: cycle even when both edges land between two polls — the seq moved
    #: by 2, where every timestamp-based scheme races the poll interval.
    transition_seq: int = 0
    #: Wall time of the CURRENT firing episode (0.0 while not firing).
    #: ``fired_at`` is "most recent fire ever" and survives the clear for
    #: flap accounting; ``firing_since`` is the edge-triggered view.
    firing_since: float = 0.0

    def public(self) -> Dict[str, Any]:
        return {
            "rule": self.rule.name,
            "severity": self.rule.severity,
            "subject": self.subject,
            "state": self.state,
            "value": round(self.value, 6),
            "threshold": self.rule.threshold,
            "op": self.rule.op,
            "fired_at": self.fired_at,
            "fires": self.fires,
            "flaps": self.flaps,
            "transition_seq": self.transition_seq,
            "firing_since": self.firing_since,
            "description": self.rule.description,
        }


class SloEngine:
    """Evaluates a rule table against a series view; owns alert lifecycle.

    ``view(name_pattern)`` must return ``List[SeriesPoints]`` whose labels
    include ``instance`` and ``role`` (the aggregator's ring adapter).
    ``evaluate`` returns the transitions that happened this pass —
    ``{"event": "fire"|"clear", ...alert}`` — which the caller turns into
    telemetry records; current state is always available via ``active``
    and ``snapshot`` (the ``/alertz`` payload).
    """

    def __init__(self, rules: Optional[List[SloRule]] = None):
        self.rules: List[SloRule] = list(rules if rules is not None
                                         else default_rules())
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self._alerts: Dict[Tuple[str, str], _AlertState] = {}
        self._history: List[Dict[str, Any]] = []
        self._max_history = 256
        # Monotonic across ALL alerts in this engine — one counter, not
        # per-rule, so a watcher can order interleaved transitions from
        # different rules with a single cursor.
        self._transition_seq = 0

    # -- measurement -------------------------------------------------------

    @staticmethod
    def _group(series: List[SeriesPoints], rule: SloRule) -> Dict[str, List[SeriesPoints]]:
        groups: Dict[str, List[SeriesPoints]] = {}
        for sp in series:
            if rule.role and sp.labels.get("role", "") != rule.role:
                continue
            subject = (sp.labels.get("instance", "unknown")
                       if rule.subject == "instance" else "fleet")
            groups.setdefault(subject, []).append(sp)
        return groups

    @staticmethod
    def _sum_delta(series: List[SeriesPoints], now: float,
                   window_s: float) -> Optional[float]:
        deltas = [d for d in (sp.window_delta(now, window_s) for sp in series)
                  if d is not None]
        return sum(deltas) if deltas else None

    def _measure(self, rule: SloRule, view: Callable[[str], List[SeriesPoints]],
                 now: float) -> Dict[str, float]:
        """subject -> measured value; subjects with no data are absent."""
        out: Dict[str, float] = {}
        num_series = view(rule.series)
        if rule.kind == "increase":
            for subject, group in self._group(num_series, rule).items():
                d = self._sum_delta(group, now, rule.window_s)
                if d is not None:
                    out[subject] = d
        elif rule.kind == "ratio":
            den_series = ([] if rule.denom == "__time__" else view(rule.denom))
            den_groups = self._group(den_series, rule)
            for subject, group in self._group(num_series, rule).items():
                num = self._sum_delta(group, now, rule.window_s)
                if num is None:
                    continue
                if rule.denom == "__time__":
                    den = max(sp.window_span(now, rule.window_s)
                              for sp in group)
                else:
                    den = self._sum_delta(den_groups.get(subject, []),
                                          now, rule.window_s)
                    if den is None:
                        continue
                if rule.denom_includes_series:
                    den += num
                if den <= _MIN_DENOM:
                    continue  # no traffic: abstain, never divide by ~0
                out[subject] = num / den
        else:  # gauge_growth
            for subject, group in self._group(num_series, rule).items():
                grew = 0.0
                at_peak = False
                for sp in group:
                    cutoff = now - rule.window_s
                    pts = [(t, v) for t, v in sp.points if t >= cutoff]
                    if len(pts) < 2:
                        continue
                    delta = pts[-1][1] - pts[0][1]
                    peak = max(v for _, v in pts)
                    grew = max(grew, delta)
                    at_peak = at_peak or pts[-1][1] >= peak - 1e-9
                if grew and at_peak:
                    out[subject] = grew
                elif group and any(len(sp.points) >= 2 for sp in group):
                    out[subject] = 0.0
        return out

    # -- lifecycle ---------------------------------------------------------

    def _transition(self, st: _AlertState, event: str, now: float) -> Dict[str, Any]:
        self._transition_seq += 1
        st.transition_seq = self._transition_seq
        rec = {"event": event, "t": now, **st.public()}
        self._history.append(rec)
        if len(self._history) > self._max_history:
            del self._history[: len(self._history) - self._max_history]
        st.last_transition = now
        return rec

    def evaluate(self, view: Callable[[str], List[SeriesPoints]],
                 now: Optional[float] = None) -> List[Dict[str, Any]]:
        now = time.time() if now is None else float(now)
        transitions: List[Dict[str, Any]] = []
        for rule in self.rules:
            measured = self._measure(rule, view, now)
            # Subjects never measured stay wherever they are until data
            # returns (a silent instance is the stale-instance sweep's
            # problem, not a phantom "recovered" signal).
            for subject, value in measured.items():
                key = (rule.name, subject)
                st = self._alerts.get(key)
                if st is None:
                    st = self._alerts[key] = _AlertState(rule=rule, subject=subject)
                st.value = value
                breach = rule.compare(value)
                if st.state == _INACTIVE:
                    if breach:
                        st.state = _PENDING
                        st.pending_since = now
                        if now - st.pending_since >= rule.for_s:
                            st.state = _FIRING
                            st.fired_at = now
                            st.firing_since = now
                            st.fires += 1
                            transitions.append(self._transition(st, "fire", now))
                elif st.state == _PENDING:
                    if not breach:
                        st.state = _INACTIVE
                    elif now - st.pending_since >= rule.for_s:
                        st.state = _FIRING
                        st.fired_at = now
                        st.firing_since = now
                        st.fires += 1
                        transitions.append(self._transition(st, "fire", now))
                elif st.state == _FIRING:
                    if not breach:
                        st.state = _CLEARING
                        st.healthy_since = now
                elif st.state == _CLEARING:
                    if breach:
                        st.state = _FIRING  # damped: no duplicate fire event
                    elif now - st.healthy_since >= rule.clear_for_s:
                        st.state = _INACTIVE
                        if now - st.fired_at <= 2 * rule.clear_for_s + rule.for_s:
                            st.flaps += 1
                        st.cleared_at = now
                        st.firing_since = 0.0
                        transitions.append(self._transition(st, "clear", now))
        return transitions

    # -- read side ---------------------------------------------------------

    def active(self) -> List[Dict[str, Any]]:
        return [st.public() for st in self._alerts.values()
                if st.state in (_FIRING, _CLEARING)]

    def snapshot(self) -> Dict[str, Any]:
        """The ``/alertz`` payload: active alerts, full state, history."""
        return {
            "active": self.active(),
            "alerts": [st.public() for st in self._alerts.values()
                       if st.state != _INACTIVE or st.fires],
            "history": list(self._history[-64:]),
            "rules": [{
                "name": r.name, "kind": r.kind, "series": r.series,
                "denom": r.denom or None, "op": r.op,
                "threshold": r.threshold, "window_s": r.window_s,
                "for_s": r.for_s, "clear_for_s": r.clear_for_s,
                "subject": r.subject, "role": r.role or None,
                "severity": r.severity, "description": r.description,
            } for r in self.rules],
        }


def match_series(pattern: str, name: str) -> bool:
    """fnmatch-style series matching (``*_degraded_total``)."""
    if any(ch in pattern for ch in "*?["):
        return fnmatch.fnmatchcase(name, pattern)
    return pattern == name
