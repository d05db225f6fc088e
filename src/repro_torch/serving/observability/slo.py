"""SLO classes and per-class attainment scoring.  A copy of
``repro/serving/observability/slo.py``.

An ``SLOClass`` is a named pair of targets — TTFT and end-to-end
latency, in seconds — and the ``SLOTracker`` scores every finished
request against its class.  Attainment (fraction of requests meeting
*both* targets) is the signal the ROADMAP's elastic scheduler will
steer on: a class under attainment wants more slots or a bigger token
budget, a class over it can donate.

Classes parse from the ``name:ttft:latency`` CLI form
(``--slo-class interactive:0.5:5``); targets may be ``-`` or empty to
leave that bound unchecked.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

DEFAULT_CLASS = "default"


@dataclass(frozen=True)
class SLOClass:
    """Targets for one priority class; ``None`` means unbounded."""

    name: str
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None

    def meets(self, ttft_s: Optional[float],
              latency_s: Optional[float]) -> bool:
        """True when both bounds hold (an unset bound always holds; a
        missing measurement fails a set bound)."""
        if self.ttft_s is not None:
            if ttft_s is None or ttft_s > self.ttft_s:
                return False
        if self.latency_s is not None:
            if latency_s is None or latency_s > self.latency_s:
                return False
        return True


def parse_slo_class(spec: str) -> SLOClass:
    """``name:ttft:latency`` -> SLOClass; ``-``/empty leaves a bound
    unset.  ``interactive:0.5:5`` == TTFT <= 0.5 s and latency <= 5 s."""
    parts = spec.split(":")
    if not parts[0]:
        raise ValueError(f"SLO class needs a name: {spec!r}")
    if len(parts) > 3:
        raise ValueError(f"SLO class is name:ttft:latency, got {spec!r}")

    def bound(s: Optional[str]) -> Optional[float]:
        if s is None or s in ("", "-"):
            return None
        v = float(s)
        if not math.isfinite(v) or v <= 0:
            raise ValueError(f"SLO bound must be positive finite: {spec!r}")
        return v

    return SLOClass(parts[0],
                    bound(parts[1] if len(parts) > 1 else None),
                    bound(parts[2] if len(parts) > 2 else None))


@dataclass
class _ClassScore:
    finished: int = 0
    met: int = 0
    ttft_viol: int = 0
    lat_viol: int = 0


class SLOTracker:
    """Scores finished requests against their class targets.  Classes
    with no configured targets still accumulate (with trivially-met
    bounds), so the attainment report always covers every class seen."""

    def __init__(self, classes: Optional[List[SLOClass]] = None):
        self.classes: Dict[str, SLOClass] = {
            c.name: c for c in (classes or [])}
        self._scores: Dict[str, _ClassScore] = {}

    def add_class(self, cls: SLOClass) -> None:
        self.classes[cls.name] = cls

    def observe(self, slo_class: str, ttft_s: Optional[float],
                latency_s: Optional[float]) -> bool:
        """Score one finished request; returns whether it met its SLO."""
        cls = self.classes.get(slo_class) or SLOClass(slo_class)
        sc = self._scores.get(slo_class)
        if sc is None:
            sc = self._scores[slo_class] = _ClassScore()
        sc.finished += 1
        ok = cls.meets(ttft_s, latency_s)
        if ok:
            sc.met += 1
        else:
            if cls.ttft_s is not None and (
                    ttft_s is None or ttft_s > cls.ttft_s):
                sc.ttft_viol += 1
            if cls.latency_s is not None and (
                    latency_s is None or latency_s > cls.latency_s):
                sc.lat_viol += 1
        return ok

    def attainment(self, slo_class: str) -> Optional[float]:
        sc = self._scores.get(slo_class)
        if sc is None or sc.finished == 0:
            return None
        return sc.met / sc.finished

    def report(self) -> Dict[str, dict]:
        """Per-class attainment: the launcher's exit report and the
        elastic scheduler's steering input."""
        out = {}
        for name in sorted(self._scores):
            sc, cls = self._scores[name], self.classes.get(name)
            out[name] = {
                "finished": sc.finished,
                "met": sc.met,
                "attainment": sc.met / sc.finished if sc.finished else None,
                "ttft_target_s": cls.ttft_s if cls else None,
                "latency_target_s": cls.latency_s if cls else None,
                "ttft_violations": sc.ttft_viol,
                "latency_violations": sc.lat_viol,
            }
        return out

    def reset(self) -> None:
        self._scores.clear()
