"""Live anomaly detection over the serving metrics stream.  A copy of
``repro/serving/observability/anomaly.py``, run on the port's
``kv_cache.PagePool``.

Four online detectors, each a small O(1)-per-observation state machine
fed by the telemetry hooks the engine already calls — no new device
work, no sample retention beyond a bounded rolling window:

  * ``TickSpikeDetector`` — robust z-score of each tick's duration
    against a rolling window: the baseline is the window's p10 (the
    contention-free cost of a tick, the same estimator the CI overhead
    gate uses) and the scale is the MAD.  A tick that is both many MADs
    above the median AND a multiple of the p10 fires — one slow tick
    under shared-box contention does not (the median/MAD absorb it),
    a forced recompile or a pathological host stall does.
  * ``BurnRateDetector`` — multi-window SLO burn rate (the SRE
    alerting pattern): each finished request is met/violated against
    its class targets; burn = violation fraction / error budget.  An
    alert needs the burn to exceed the threshold in BOTH a short and a
    long window, so a single outlier cannot fire (short window alone is
    noisy) and a slow leak cannot hide (long window alone lags).
  * ``PoolLeakWatchdog`` — every N ticks compares the pool's
    ``used_pages`` against the pages actually referenced by live
    request tables.  Copy-on-write and prefix forks SHARE pages, so the
    expectation counts distinct page ids — fork-heavy traffic stays
    silent; a page that no live table can reach (a lost ref-release)
    fires.
  * ``AcceptCollapseDetector`` — rolling speculative accept rate vs the
    run's long-run rate: a draft circuit that silently stops agreeing
    with its parent (weights swapped, masks corrupted, verify window
    bug) collapses committed tok/tick long before throughput counters
    make it obvious.

``AnomalyMonitor`` bundles them behind the hook surface Telemetry
drives and collects structured ``Alert`` records that are exported into
the Chrome trace (instant events), the metrics snapshot, and the serve
exit report."""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

# -- alert kinds -------------------------------------------------------------
TICK_SPIKE = "tick_spike"
SLO_BURN = "slo_burn"
POOL_LEAK = "pool_leak"
ACCEPT_COLLAPSE = "accept_collapse"
RECOMPILE = "recompile"

ALERT_KINDS = (TICK_SPIKE, SLO_BURN, POOL_LEAK, ACCEPT_COLLAPSE, RECOMPILE)


@dataclass
class Alert:
    """One structured anomaly event (engine tick + clock it fired on)."""

    kind: str
    tick: int
    t: float                               # engine-clock seconds
    severity: str = "warning"              # "warning" | "critical"
    message: str = ""
    data: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"kind": self.kind, "tick": self.tick, "t": self.t,
                "severity": self.severity, "message": self.message,
                "data": dict(self.data)}


def _quantile(sorted_xs: List[float], q: float) -> float:
    """Nearest-rank quantile of an already-sorted sample."""
    i = min(len(sorted_xs) - 1, max(0, int(q * (len(sorted_xs) - 1))))
    return sorted_xs[i]


class TickSpikeDetector:
    """Robust z-score of tick duration vs a rolling window.

    Fires when a tick is ``z_thresh`` MADs above the rolling median AND
    at least ``min_ratio`` times the rolling p10 (the pooled-p10
    baseline).  The MAD floor (``scale_floor_frac`` of the median)
    keeps a near-constant-duration stream (MAD ~ 0) from firing on
    microsecond jitter.  ``cooldown`` ticks must pass between alerts so
    a sustained stall reports once per episode, not once per tick."""

    def __init__(self, window: int = 256, min_samples: int = 24,
                 z_thresh: float = 8.0, min_ratio: float = 3.0,
                 scale_floor_frac: float = 0.05, cooldown: int = 16):
        self.win: Deque[float] = deque(maxlen=window)
        self.min_samples = min_samples
        self.z_thresh = z_thresh
        self.min_ratio = min_ratio
        self.scale_floor_frac = scale_floor_frac
        self.cooldown = cooldown
        self._last_fire = -10**9

    def observe(self, tick: int, dur_s: float) -> Optional[dict]:
        """Feed one tick duration; returns alert data when it spikes.
        The spiking tick is NOT added to the window (a genuine anomaly
        must not drag the baseline up toward itself)."""
        fired = None
        if len(self.win) >= self.min_samples \
                and tick - self._last_fire >= self.cooldown:
            xs = sorted(self.win)
            med = _quantile(xs, 0.5)
            p10 = _quantile(xs, 0.10)
            mad = _quantile(sorted(abs(x - med) for x in xs), 0.5)
            scale = max(1.4826 * mad, self.scale_floor_frac * med, 1e-9)
            z = (dur_s - med) / scale
            if z > self.z_thresh and dur_s > self.min_ratio * max(p10, 1e-9):
                self._last_fire = tick
                fired = {"dur_s": dur_s, "z": round(z, 2),
                         "median_s": med, "p10_s": p10}
        if fired is None:
            self.win.append(dur_s)
        return fired


class BurnRateDetector:
    """Multi-window SLO burn-rate alerting for one class.

    ``budget`` is the allowed violation fraction (SLO 99% => 0.01);
    burn rate = observed violation fraction / budget.  Fires when burn
    exceeds ``burn_thresh`` over BOTH the short and the long window
    (each at least ``min_samples`` full), then resets the windows so
    one sustained violation episode reports once."""

    def __init__(self, budget: float = 0.1, burn_thresh: float = 2.0,
                 short_window: int = 16, long_window: int = 64,
                 min_samples: int = 8):
        if not 0 < budget < 1:
            raise ValueError(f"budget must be in (0, 1): {budget}")
        self.budget = budget
        self.burn_thresh = burn_thresh
        self.short: Deque[bool] = deque(maxlen=short_window)
        self.long: Deque[bool] = deque(maxlen=long_window)
        self.min_samples = min_samples

    def _burn(self, win: Deque[bool]) -> float:
        if not win:
            return 0.0
        return (sum(win) / len(win)) / self.budget

    def observe(self, violated: bool) -> Optional[dict]:
        self.short.append(bool(violated))
        self.long.append(bool(violated))
        if len(self.short) < max(self.min_samples, 1) \
                or len(self.long) < max(self.min_samples, 1):
            return None
        bs, bl = self._burn(self.short), self._burn(self.long)
        if bs >= self.burn_thresh and bl >= self.burn_thresh:
            data = {"short_burn": round(bs, 3), "long_burn": round(bl, 3),
                    "budget": self.budget,
                    "short_n": len(self.short), "long_n": len(self.long)}
            self.short.clear()
            self.long.clear()
            return data
        return None


class PoolLeakWatchdog:
    """Every ``every`` ticks: ``used_pages`` (pool pages neither free
    nor cached) must be explainable by the pages live request tables
    reference — COW/fork shares are counted once via distinct page ids,
    so legitimate sharing never fires.  ``slack_pages`` absorbs
    transient bookkeeping (e.g. deferred-reserve promises mid-tick)."""

    def __init__(self, every: int = 32, slack_pages: int = 0):
        self.every = max(1, every)
        self.slack_pages = slack_pages
        self._last_check = -1

    def due(self, tick: int) -> bool:
        return tick - self._last_check >= self.every

    def check(self, tick: int, used_pages: int,
              live_pages: int) -> Optional[dict]:
        """``live_pages`` = distinct pages referenced by live sequences
        (running + waiting-preempted still holding refs)."""
        self._last_check = tick
        leaked = used_pages - live_pages - self.slack_pages
        if leaked > 0:
            return {"used_pages": used_pages, "live_pages": live_pages,
                    "leaked_pages": leaked}
        return None


class AcceptCollapseDetector:
    """Rolling speculative accept rate vs the run's long-run rate.

    After ``min_drafted`` tokens establish a long-run baseline, an
    alert fires when the rolling-window accept rate drops below
    ``collapse_frac`` of that baseline (and below ``abs_floor``
    absolutely — a run whose baseline is already terrible should not
    alert on noise around terrible)."""

    def __init__(self, window: int = 64, min_drafted: int = 64,
                 collapse_frac: float = 0.5, abs_floor: float = 0.5):
        self.win: Deque[tuple] = deque(maxlen=window)   # (drafted, accepted)
        self.min_drafted = min_drafted
        self.collapse_frac = collapse_frac
        self.abs_floor = abs_floor
        self.total_drafted = 0
        self.total_accepted = 0
        self._fired = False

    def observe(self, drafted: int, accepted: int) -> Optional[dict]:
        if drafted <= 0:
            return None
        self.total_drafted += drafted
        self.total_accepted += accepted
        self.win.append((drafted, accepted))
        if self.total_drafted < self.min_drafted:
            return None
        wd = sum(d for d, _ in self.win)
        wa = sum(a for _, a in self.win)
        if wd < self.min_drafted // 2:
            return None
        rolling = wa / wd
        longrun = self.total_accepted / self.total_drafted
        collapsed = rolling < self.collapse_frac * longrun \
            and rolling < self.abs_floor
        if collapsed and not self._fired:
            self._fired = True          # once per collapse episode
            return {"rolling_accept": round(rolling, 4),
                    "longrun_accept": round(longrun, 4),
                    "window_drafted": wd}
        if not collapsed and rolling >= self.collapse_frac * longrun:
            self._fired = False         # recovered: re-arm
        return None


class AnomalyMonitor:
    """The detectors behind one hook surface (driven by ``Telemetry``).

    ``alerts`` accumulates structured records; ``on_alert`` (set by the
    Telemetry that owns the monitor) additionally routes each alert
    into the tick timeline and the metrics registry the moment it
    fires."""

    def __init__(self, *, spike: Optional[TickSpikeDetector] = None,
                 burn: Optional[Dict[str, float]] = None,
                 leak: Optional[PoolLeakWatchdog] = None,
                 accept: Optional[AcceptCollapseDetector] = None,
                 max_alerts: int = 1024):
        self.spike = spike if spike is not None else TickSpikeDetector()
        self._burn_kw = dict(burn or {})
        self._burn: Dict[str, BurnRateDetector] = {}   # per SLO class
        self.leak = leak if leak is not None else PoolLeakWatchdog()
        self.accept = accept if accept is not None \
            else AcceptCollapseDetector()
        self.alerts: Deque[Alert] = deque(maxlen=max_alerts)
        self.counts: Dict[str, int] = {}
        self.on_alert: Optional[Callable[[Alert], None]] = None
        self._tick = 0
        self._t = 0.0

    # -- emission ------------------------------------------------------------
    def _emit(self, kind: str, data: dict, severity: str = "warning",
              message: str = "") -> None:
        a = Alert(kind, self._tick, self._t, severity, message, data)
        self.alerts.append(a)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if self.on_alert is not None:
            self.on_alert(a)

    # -- hooks ---------------------------------------------------------------
    def on_tick(self, tick: int, t: float, dur_s: float, *,
                used_pages: Optional[int] = None,
                live_pages: Optional[Callable[[], int]] = None) -> None:
        """One engine tick: ``dur_s`` wall duration; ``live_pages`` is a
        zero-arg callable evaluated only when the leak watchdog is due
        (counting distinct pages walks every live table — cheap, but
        not every-tick cheap)."""
        self._tick, self._t = tick, t
        hit = self.spike.observe(tick, dur_s)
        if hit:
            self._emit(TICK_SPIKE, hit,
                       message=f"tick {tick} took {dur_s * 1e3:.1f}ms "
                               f"(z={hit['z']}, p10 "
                               f"{hit['p10_s'] * 1e3:.1f}ms)")
        if used_pages is not None and live_pages is not None \
                and self.leak.due(tick):
            hit = self.leak.check(tick, used_pages, live_pages())
            if hit:
                self._emit(POOL_LEAK, hit, severity="critical",
                           message=f"{hit['leaked_pages']} page(s) used "
                                   f"but unreachable from live tables")

    def on_finish(self, slo_class: str, met: bool, t: float) -> None:
        self._t = t
        det = self._burn.get(slo_class)
        if det is None:
            det = self._burn[slo_class] = BurnRateDetector(**self._burn_kw)
        hit = det.observe(not met)
        if hit:
            self._emit(SLO_BURN, {"slo_class": slo_class, **hit},
                       message=f"class {slo_class!r} burning "
                               f"{hit['short_burn']}x budget over both "
                               f"windows")

    def on_speculate(self, drafted: int, accepted: int, t: float) -> None:
        self._t = t
        hit = self.accept.observe(drafted, accepted)
        if hit:
            self._emit(ACCEPT_COLLAPSE, hit,
                       message=f"accept rate collapsed to "
                               f"{hit['rolling_accept']:.0%} (long-run "
                               f"{hit['longrun_accept']:.0%})")

    def on_compile(self, name: str, variant: str, dur_s: float,
                   post_warm: bool) -> None:
        """A compile cell (a step variant's first call, see
        ``profiler.py``) observed by the step profiler.  Compiles during
        warmup are expected; a compile AFTER the warmup boundary
        (``Engine.reset_stats``) is the classic silent perf regression
        and alerts."""
        if post_warm:
            self._emit(RECOMPILE,
                       {"step": name, "variant": variant,
                        "compile_s": round(dur_s, 4)},
                       message=f"post-warmup recompile of {variant} "
                               f"({dur_s * 1e3:.0f}ms)")

    # -- read side -----------------------------------------------------------
    def report(self) -> dict:
        """Counts + the retained alert records (JSON-ready)."""
        return {"counts": dict(self.counts),
                "alerts": [a.as_dict() for a in self.alerts]}

    def reset(self) -> None:
        """Warmup boundary: drop alerts and detector state (compile
        warm-marking lives in the profiler, not here)."""
        self.alerts.clear()
        self.counts.clear()
        self.spike = TickSpikeDetector(
            window=self.spike.win.maxlen,
            min_samples=self.spike.min_samples,
            z_thresh=self.spike.z_thresh, min_ratio=self.spike.min_ratio,
            scale_floor_frac=self.spike.scale_floor_frac,
            cooldown=self.spike.cooldown)
        self._burn.clear()
        self.accept = AcceptCollapseDetector(
            window=self.accept.win.maxlen,
            min_drafted=self.accept.min_drafted,
            collapse_frac=self.accept.collapse_frac,
            abs_floor=self.accept.abs_floor)
        self.leak = PoolLeakWatchdog(every=self.leak.every,
                                     slack_pages=self.leak.slack_pages)
        self._tick, self._t = 0, 0.0
