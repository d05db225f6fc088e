"""The port's anomaly detectors and metrics cardinality cap
(``repro_torch.serving.observability``), on synthetic streams.

A port of ``tests/test_anomaly.py``, one counterpart a test, on the
port's modules and its ``kv_cache.PagePool`` (the leak watchdog): the
tick-spike detector fires on an injected stall and not on jitter, during
warm-up or twice in one episode; the SLO burn-rate detector needs both
windows to burn; the pool-leak watchdog is silent on copy-on-write and
fork traffic and fires on an unreachable page; the accept-collapse
detector needs a baseline, fires once an episode and re-arms; label views
are capped into an ``overflow`` bucket with totals kept exactly.  The
modules are copies of the JAX package's, so beside those, the same
synthetic streams go through both packages' monitors and must raise the
same alerts, in the same order, with the same data.
"""
import pytest

from repro_torch.serving.kv_cache import PagePool
from repro_torch.serving.observability import (ACCEPT_COLLAPSE,
                                               OVERFLOW_LABEL, POOL_LEAK,
                                               RECOMPILE, SLO_BURN,
                                               TICK_SPIKE,
                                               AcceptCollapseDetector,
                                               AnomalyMonitor,
                                               BurnRateDetector, Counter,
                                               Histogram, MetricsRegistry,
                                               PoolLeakWatchdog,
                                               TickSpikeDetector)


# ---------------------------------------------------------------------------
# tick-spike detector
# ---------------------------------------------------------------------------
def test_spike_fires_on_stall_not_on_jitter():
    det = TickSpikeDetector(min_samples=24, cooldown=16)
    # healthy stream: ~2ms ticks with +-5% deterministic jitter
    for i in range(60):
        dur = 0.002 * (1.0 + 0.05 * ((-1) ** i))
        assert det.observe(i, dur) is None, f"jitter fired at tick {i}"
    hit = det.observe(60, 0.150)                   # a 75x stall
    assert hit is not None and hit["dur_s"] == 0.150
    assert hit["z"] > 8.0


def test_spike_warmup_window_and_cooldown():
    det = TickSpikeDetector(min_samples=24, cooldown=16)
    # during warm-up even a huge tick must not fire (no baseline yet)
    for i in range(23):
        assert det.observe(i, 0.002 if i else 1.0) is None
    for i in range(23, 50):
        det.observe(i, 0.002)
    # a sustained stall: first spike fires, the rest sit in cooldown
    assert det.observe(50, 0.5) is not None
    assert det.observe(51, 0.5) is None
    assert det.observe(60, 0.5) is None
    assert det.observe(66, 0.5) is not None        # cooldown elapsed


def test_spike_does_not_poison_its_own_baseline():
    det = TickSpikeDetector(min_samples=24, cooldown=0)
    for i in range(30):
        det.observe(i, 0.002)
    n = len(det.win)
    assert det.observe(30, 1.0) is not None
    # the anomalous tick must NOT enter the rolling window
    assert len(det.win) == n and max(det.win) < 0.01


# ---------------------------------------------------------------------------
# SLO burn rate
# ---------------------------------------------------------------------------
def test_burn_rate_fires_only_when_both_windows_burn():
    # budget 10%, threshold 2x => needs >= 20% violations in BOTH the
    # 4-sample short window and the 12-sample long window
    det = BurnRateDetector(budget=0.1, burn_thresh=2.0, short_window=4,
                           long_window=12, min_samples=4)
    # a short hot burst right at the start: long window is equally hot,
    # but nothing may fire before min_samples observations
    assert det.observe(True) is None
    assert det.observe(True) is None
    assert det.observe(True) is None
    hit = det.observe(True)                        # 4th: both windows 100%
    assert hit is not None
    assert hit["short_burn"] == 10.0 and hit["long_burn"] == 10.0
    # windows were cleared: the same episode does not re-fire
    assert det.observe(True) is None


def test_burn_rate_short_burst_diluted_by_long_window_stays_silent():
    det = BurnRateDetector(budget=0.1, burn_thresh=2.0, short_window=4,
                           long_window=12, min_samples=4)
    for _ in range(12):
        assert det.observe(False) is None
    # 1 violation in the short window = 25% short burn (2.5x), but the
    # long window sits at 1/12 (< 2x) -> silent, per the SRE pattern
    assert det.observe(True) is None
    for _ in range(3):
        assert det.observe(False) is None


def test_burn_rate_rejects_bad_budget():
    with pytest.raises(ValueError):
        BurnRateDetector(budget=0.0)


# ---------------------------------------------------------------------------
# pool-leak watchdog (against the real PagePool)
# ---------------------------------------------------------------------------
def test_leak_watchdog_silent_on_cow_fork_traffic():
    pool = PagePool(num_pages=32, page_size=4)
    pool.alloc(0, 16)                              # 4 pages
    # fork-heavy: many sequences SHARING the same pages (refcounts go
    # up, distinct page count does not)
    for dst in range(1, 6):
        pool.fork(0, dst)
    # COW: one fork diverges on a shared page
    pool.prepare_write(1, first_token=12, last_token=16)
    dog = PoolLeakWatchdog(every=1)
    assert pool.used_pages == pool.live_table_pages()
    assert dog.check(0, pool.used_pages, pool.live_table_pages()) is None
    # release the forks again — still balanced
    for dst in range(1, 6):
        pool.free_seq(dst)
    assert dog.check(1, pool.used_pages, pool.live_table_pages()) is None


def test_leak_watchdog_fires_on_unreachable_pages():
    pool = PagePool(num_pages=16, page_size=4)
    pool.alloc(0, 8)
    pool.alloc(1, 8)
    # simulate a lost ref-release: a table vanishes without freeing its
    # pages, so used_pages stays up while no live table can reach them
    pool._tables.pop(1)
    dog = PoolLeakWatchdog(every=4)
    assert not dog.due(2) and dog.due(3)           # first check after N ticks
    hit = dog.check(3, pool.used_pages, pool.live_table_pages())
    assert hit is not None and hit["leaked_pages"] == 2
    assert not dog.due(6) and dog.due(7)           # cadence honoured


# ---------------------------------------------------------------------------
# accept-rate collapse
# ---------------------------------------------------------------------------
def test_accept_collapse_fires_once_and_rearms_on_recovery():
    det = AcceptCollapseDetector(window=8, min_drafted=32,
                                 collapse_frac=0.5, abs_floor=0.5)
    # healthy baseline: 7/8 accepted
    for _ in range(8):
        assert det.observe(8, 7) is None
    # the draft circuit silently stops agreeing
    fired = [det.observe(8, 0) for _ in range(10)]
    hits = [h for h in fired if h]
    assert len(hits) == 1                          # once per episode
    assert hits[0]["rolling_accept"] < 0.5 * hits[0]["longrun_accept"]
    # recovery re-arms, a second collapse fires again
    for _ in range(16):
        det.observe(8, 8)
    assert any(det.observe(8, 0) for _ in range(10))


def test_accept_collapse_needs_baseline_first():
    det = AcceptCollapseDetector(window=8, min_drafted=64)
    # terrible from the very start: no baseline to collapse FROM
    assert all(det.observe(8, 0) is None for _ in range(32))


# ---------------------------------------------------------------------------
# the monitor facade
# ---------------------------------------------------------------------------
def test_monitor_routes_hooks_to_alerts_and_counts():
    mon = AnomalyMonitor(
        spike=TickSpikeDetector(min_samples=4, cooldown=0),
        burn=dict(budget=0.1, burn_thresh=2.0, short_window=2,
                  long_window=4, min_samples=2),
        accept=AcceptCollapseDetector(window=4, min_drafted=8),
        leak=PoolLeakWatchdog(every=1))
    seen = []
    mon.on_alert = seen.append
    for i in range(8):
        mon.on_tick(i, float(i), 0.002)
    mon.on_tick(8, 8.0, 1.0)                       # spike
    mon.on_tick(9, 9.0, 0.002, used_pages=10, live_pages=lambda: 7)
    for _ in range(2):
        mon.on_finish("interactive", met=False, t=10.0)
    for _ in range(4):
        mon.on_speculate(4, 4, t=11.0)
    for _ in range(8):
        mon.on_speculate(4, 0, t=12.0)
    mon.on_compile("unified_step", "C=8", 1.2, post_warm=False)  # warmup: ok
    mon.on_compile("unified_step", "C=2", 1.2, post_warm=True)   # regression
    kinds = {a.kind for a in seen}
    assert kinds == {TICK_SPIKE, POOL_LEAK, SLO_BURN, ACCEPT_COLLAPSE,
                     RECOMPILE}
    assert mon.counts[RECOMPILE] == 1              # warmup compile ignored
    rep = mon.report()
    assert rep["counts"] == mon.counts
    assert all({"kind", "tick", "t", "severity", "message", "data"}
               <= set(a) for a in rep["alerts"])
    mon.reset()
    assert mon.report() == {"counts": {}, "alerts": []}


# ---------------------------------------------------------------------------
# metrics label-cardinality cap
# ---------------------------------------------------------------------------
def test_counter_label_cap_folds_into_overflow_and_preserves_total():
    c = Counter("tokens", max_labels=3)
    for i in range(10):
        c.inc(2.0, label=f"submodel_{i}")
    # 2 real label views + the explicit overflow bucket, total exact
    view = c.view()
    assert set(view) == {"submodel_0", "submodel_1", OVERFLOW_LABEL}
    assert view[OVERFLOW_LABEL] == 16.0
    assert sum(view.values()) == c.value == 20.0
    assert c.label_overflows == 8
    assert c.summary()["label_overflows"] == 8
    # an already-seen label keeps routing to its own view
    c.inc(1.0, label="submodel_1")
    assert c.view()["submodel_1"] == 3.0


def test_histogram_label_cap_and_overflow_counts():
    h = Histogram("lat", max_labels=2)
    for i in range(6):
        h.observe(0.5, label=f"class_{i}")
    view = h.view()
    assert set(view) == {"class_0", OVERFLOW_LABEL}
    assert view[OVERFLOW_LABEL].count == 5
    assert h.count == 6 and h.label_overflows == 5


def test_registry_attaches_overflow_warning_counter():
    reg = MetricsRegistry(max_labels=2)
    c = reg.counter("by_submodel")
    g = reg.gauge("pool_util")
    for i in range(5):
        c.inc(label=f"s{i}")
        g.set(float(i), label=f"owner{i}")
    warn = reg.get(MetricsRegistry.OVERFLOW_COUNTER)
    # 4 folds from the counter + 4 from the gauge
    assert warn.value == 8.0
    assert warn.view() == {"by_submodel": 4.0, "pool_util": 4.0}
    assert set(g.view()) == {"owner0", OVERFLOW_LABEL}
    # reset clears the per-metric overflow tallies too
    c.reset()
    assert c.label_overflows == 0


def test_unlabelled_metrics_never_touch_the_cap():
    c = Counter("plain", max_labels=1)
    for _ in range(100):
        c.inc()
    assert c.value == 100.0 and c.view() == {} and c.label_overflows == 0


# ---------------------------------------------------------------------------
# the same streams through both packages
# ---------------------------------------------------------------------------
def _drive_monitor(obs):
    """One deterministic synthetic stream through a monitor of ``obs``
    (either package's observability module); returns its report."""
    import numpy as np
    mon = obs.AnomalyMonitor(
        spike=obs.TickSpikeDetector(min_samples=8, cooldown=4),
        burn=dict(budget=0.1, burn_thresh=2.0, short_window=3,
                  long_window=9, min_samples=3),
        accept=obs.AcceptCollapseDetector(window=6, min_drafted=24),
        leak=obs.PoolLeakWatchdog(every=5))
    rng = np.random.default_rng(11)
    for i in range(120):
        dur = 0.002 * (1.0 + 0.1 * rng.standard_normal())
        if i in (40, 41, 90):
            dur = 0.3                              # injected stalls
        leak = 3 if 60 <= i < 70 else 0
        mon.on_tick(i, i * 0.01, dur, used_pages=20 + leak,
                    live_pages=lambda: 20)
        if i % 3 == 0:
            mon.on_finish("interactive" if i % 2 else "batch",
                          met=bool(rng.uniform() < (0.3 if 50 < i < 80
                                                     else 0.97)),
                          t=i * 0.01)
        acc = 4 if i < 70 or i > 100 else 0
        mon.on_speculate(4, min(acc, int(rng.integers(2, 5))), t=i * 0.01)
    mon.on_compile("unified_step", "C=8,Sv=1,ens=False", 0.9, post_warm=True)
    return mon.report()


def test_both_packages_raise_the_same_alerts():
    from repro.serving import observability as jax_obs
    from repro_torch.serving import observability as obs
    mine, ref = _drive_monitor(obs), _drive_monitor(jax_obs)
    assert mine == ref
    assert {TICK_SPIKE, POOL_LEAK, SLO_BURN, ACCEPT_COLLAPSE,
            RECOMPILE} <= set(mine["counts"])


def test_both_packages_cap_labels_the_same():
    from repro.serving import observability as jax_obs
    from repro_torch.serving import observability as obs
    snaps = []
    for o in (obs, jax_obs):
        reg = o.MetricsRegistry(max_labels=3)
        c, h = reg.counter("tok"), reg.histogram("lat")
        for i in range(40):
            c.inc(i % 5, label=f"s{i % 7}")
            h.observe(0.01 * (i + 1), label=f"c{i % 4}")
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
