"""Metrics substrate for the serving stack: a ``MetricsRegistry`` of
counters, gauges, and streaming histograms, each with per-label views.
A copy of ``repro/serving/observability/metrics.py`` (numpy only); the
port keeps its own so that it never imports the JAX package.

Design constraints, in order:

  * **Host-side and allocation-light.**  Every engine tick is one call of
    the unified step; telemetry must never add a second one, and per-token
    bookkeeping must stay a dict lookup plus an add.  Histograms are
    log-bucketed (fixed count arrays), so p50/p90/p99 come without
    storing samples — a server that has decoded a billion tokens holds
    the same few hundred ints as one that decoded a thousand.
  * **Labels sum to totals.**  A labeled increment lands in both the
    per-label view and the aggregate, so ``sum(view().values()) ==
    value`` holds exactly whenever every increment carries a label
    (per-submodel token counts, per-class latency) — the invariant the
    tests pin.
  * **One percentile helper.**  ``percentile``/``percentile_or_none``
    serve the launcher's reports and the engine's snapshot; exact
    (sample-based) percentiles stay the ground truth for benchmark
    artifacts, histograms answer the streaming case.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from itertools import accumulate
from typing import Dict, Hashable, List, Optional

import numpy as np

# Per-metric label-view bound.  Long replays tag latency histograms and
# token counters with request-derived labels; without a cap a trace with
# a million distinct request ids grows a million dict entries per
# metric.  Labels beyond the cap fold into one explicit ``OVERFLOW``
# bucket — the labels-sum-to-totals invariant still holds exactly, the
# view just stops distinguishing the tail — and each fold bumps the
# registry's ``metrics.label_overflow`` warning counter (labeled by
# metric name) so the saturation is visible, not silent.
DEFAULT_MAX_LABELS = 64
OVERFLOW_LABEL = "overflow"


def percentile(xs, p: float, *, empty: float = float("nan")) -> float:
    """Exact percentile of a finite sample (numpy semantics), ``empty``
    when the sample is empty — the single shared helper for every
    launcher/benchmark percentile line."""
    xs = np.asarray(xs if isinstance(xs, np.ndarray) else list(xs))
    if xs.size == 0:
        return empty
    return float(np.percentile(xs, p))


def percentile_or_none(xs, p: float, ndigits: int = 4) -> Optional[float]:
    """``percentile`` rounded for JSON artifacts; None for an empty
    sample (JSON has no NaN)."""
    v = percentile(xs, p)
    return None if math.isnan(v) else round(v, ndigits)


class _LabelCap:
    """Shared label-routing for the three metric kinds: an unseen label
    past ``max_labels`` becomes ``OVERFLOW_LABEL`` (reserving one view
    slot for it), and the fold is reported to the registry's warning
    counter when one is attached."""

    __slots__ = ()

    def _route(self, label: Hashable) -> Hashable:
        if label is None or label in self._by_label:
            return label
        if len(self._by_label) >= max(self.max_labels - 1, 1) \
                and label != OVERFLOW_LABEL:
            self.label_overflows += 1
            if self._overflow_sink is not None:
                self._overflow_sink.inc(1.0, label=self.name)
            return OVERFLOW_LABEL
        return label


class Counter(_LabelCap):
    """Monotonic counter with an optional per-label breakdown."""

    __slots__ = ("name", "value", "_by_label", "max_labels",
                 "label_overflows", "_overflow_sink")

    def __init__(self, name: str, max_labels: int = DEFAULT_MAX_LABELS):
        self.name = name
        self.value = 0.0
        self._by_label: Dict[Hashable, float] = {}
        self.max_labels = max_labels
        self.label_overflows = 0
        self._overflow_sink = None

    def inc(self, n: float = 1.0, label: Hashable = None) -> None:
        self.value += n
        if label is not None:
            label = self._route(label)
            self._by_label[label] = self._by_label.get(label, 0.0) + n

    def view(self) -> Dict[Hashable, float]:
        return dict(self._by_label)

    def reset(self) -> None:
        self.value = 0.0
        self._by_label.clear()
        self.label_overflows = 0

    def summary(self) -> dict:
        out = {"type": "counter", "value": self.value}
        if self._by_label:
            out["by_label"] = self.view()
        if self.label_overflows:
            out["label_overflows"] = self.label_overflows
        return out


class Gauge(_LabelCap):
    """Point-in-time value (plus per-label values).  ``set_max`` keeps a
    running peak — the page-pool high-water marks."""

    __slots__ = ("name", "value", "_by_label", "max_labels",
                 "label_overflows", "_overflow_sink")

    def __init__(self, name: str, max_labels: int = DEFAULT_MAX_LABELS):
        self.name = name
        self.value = 0.0
        self._by_label: Dict[Hashable, float] = {}
        self.max_labels = max_labels
        self.label_overflows = 0
        self._overflow_sink = None

    def set(self, v: float, label: Hashable = None) -> None:
        if label is None:
            self.value = float(v)
        else:
            self._by_label[self._route(label)] = float(v)

    def set_max(self, v: float, label: Hashable = None) -> None:
        if label is None:
            self.value = max(self.value, float(v))
        else:
            label = self._route(label)
            if v > self._by_label.get(label, float("-inf")):
                self._by_label[label] = float(v)

    def view(self) -> Dict[Hashable, float]:
        return dict(self._by_label)

    def reset(self) -> None:
        self.value = 0.0
        self._by_label.clear()
        self.label_overflows = 0

    def summary(self) -> dict:
        out = {"type": "gauge", "value": self.value}
        if self._by_label:
            out["by_label"] = self.view()
        if self.label_overflows:
            out["label_overflows"] = self.label_overflows
        return out


class Histogram(_LabelCap):
    """Streaming histogram over geometric buckets: observations land in
    ``O(log)`` (a bisect over fixed edges), quantiles interpolate
    inside the covering bucket, and no sample is ever stored.  The
    relative quantile error is bounded by ``growth - 1`` per bucket
    (default ~7%), exact at the recorded min/max.  ``label`` routes the
    observation into a per-label child histogram as well as the
    aggregate, so label views sum to the total count.  Edges and counts
    are plain Python lists — a scalar ``np.searchsorted`` costs ~10x a
    ``bisect_left``, and ``observe`` sits on the engine's per-token
    path."""

    __slots__ = ("name", "_edges", "_counts", "count", "sum",
                 "min", "max", "_lo", "_hi", "_growth", "_by_label",
                 "max_labels", "label_overflows", "_overflow_sink")

    def __init__(self, name: str, lo: float = 1e-6, hi: float = 1e4,
                 growth: float = 1.07,
                 max_labels: int = DEFAULT_MAX_LABELS):
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError(f"bad histogram range ({lo}, {hi}, x{growth})")
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        self.name = name
        self._lo, self._hi, self._growth = lo, hi, growth
        self._edges: List[float] = \
            [lo * growth ** i for i in range(n + 1)]      # bucket uppers
        self._counts: List[int] = [0] * (n + 2)           # +under/overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._by_label: Dict[Hashable, "Histogram"] = {}
        self.max_labels = max_labels
        self.label_overflows = 0
        self._overflow_sink = None

    def observe(self, x: float, label: Hashable = None) -> None:
        x = float(x)
        self._counts[bisect_left(self._edges, x)] += 1
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if label is not None:
            label = self._route(label)
            child = self._by_label.get(label)
            if child is None:
                child = self._by_label[label] = Histogram(
                    f"{self.name}{{{label}}}", self._lo, self._hi,
                    self._growth)
            child.observe(x)

    def quantile(self, q: float) -> Optional[float]:
        """q in [0, 1]; None when empty."""
        if self.count == 0:
            return None
        target = max(q, 0.0) * self.count
        cum = list(accumulate(self._counts))
        i = bisect_left(cum, max(target, 1e-12))
        i = min(i, len(self._counts) - 1)
        lo = self._edges[i - 1] if i > 0 else self.min
        hi = self._edges[i] if i < len(self._edges) else self.max
        prev = cum[i - 1] if i > 0 else 0
        frac = (target - prev) / max(self._counts[i], 1)
        v = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return float(min(max(v, self.min), self.max))

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def view(self) -> Dict[Hashable, "Histogram"]:
        return dict(self._by_label)

    def reset(self) -> None:
        self._counts = [0] * len(self._counts)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._by_label.clear()
        self.label_overflows = 0

    def summary(self) -> dict:
        out = {
            "type": "histogram", "count": self.count,
            "sum": self.sum if self.count else 0.0,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean,
            "p50": self.quantile(0.50), "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }
        if self._by_label:
            out["by_label"] = {k: v.summary() for k, v in
                               self._by_label.items()}
        if self.label_overflows:
            out["label_overflows"] = self.label_overflows
        return out


class MetricsRegistry:
    """Name -> metric map with get-or-create constructors.  One registry
    per engine is the single read surface the stats line, the benchmark
    phases, and the SLO report all draw from."""

    # Name of the warning counter that records every label fold, labeled
    # by the saturated metric's name.
    OVERFLOW_COUNTER = "metrics.label_overflow"

    def __init__(self, max_labels: int = DEFAULT_MAX_LABELS):
        self._metrics: Dict[str, object] = {}
        self.max_labels = max_labels

    def _get(self, name: str, kind, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(name, *args, **kw)
            if name != self.OVERFLOW_COUNTER:
                m._overflow_sink = self.counter(self.OVERFLOW_COUNTER)
        elif not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        # the overflow counter itself is never capped: it carries one
        # label per *metric name*, which the registry already bounds
        if name == self.OVERFLOW_COUNTER:
            return self._get(name, Counter, 2 ** 30)
        return self._get(name, Counter, self.max_labels)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, self.max_labels)

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 1e4,
                  growth: float = 1.07) -> Histogram:
        return self._get(name, Histogram, lo, hi, growth,
                         self.max_labels)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self):
        return sorted(self._metrics)

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    def snapshot(self) -> Dict[str, dict]:
        """Every registered metric, summarized — the registry's one
        export format (the stats line, the bench JSON, and the README
        metrics catalog all read this shape)."""
        return {name: self._metrics[name].summary()
                for name in sorted(self._metrics)}
