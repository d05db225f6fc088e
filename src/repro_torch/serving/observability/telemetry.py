"""The engine's one telemetry object: registry + lifecycle tracer +
tick timeline + SLO tracker behind a single set of hooks.  A copy of
``repro/serving/observability/telemetry.py``; ``on_tick`` also reads the
step profiler's completed CUDA events (the tick's host pull has passed
them by then).

The engine calls ``on_*`` at each lifecycle transition and ``on_tick``
once per device call; everything else (the periodic stats line, the
benchmark snapshot, the SLO exit report, the Perfetto export) *reads*
from here.  All hooks are host-side appends and dict updates (nothing
reaches the device), and each recorder can be switched off
independently (``Telemetry(tracer=False, timeline=False)`` is the
observability-off baseline the CI overhead gate compares against).

Lifecycle metrics use the engine clock (the ``arrival_time`` / ``now``
values the scheduler stamps onto requests) so trace-derived TTFT and
latency match the request timestamps exactly; the tick timeline uses
``time.perf_counter`` for microsecond phase spans.
"""
from __future__ import annotations

from typing import List, Optional

from . import trace as TR
from .anomaly import AnomalyMonitor
from .metrics import MetricsRegistry
from .profiler import StepProfiler
from .slo import DEFAULT_CLASS, SLOClass, SLOTracker
from .trace import RequestTracer, TickTimeline

# finished traces kept by default; a long-running server drops the
# oldest instead of growing without bound (launcher/tests that want
# everything pass trace_maxlen=None explicitly... via Telemetry(...))
TRACE_KEEP_DEFAULT = 4096


class Telemetry:
    def __init__(self, *, tracer: bool = True, timeline: bool = False,
                 slo_classes: Optional[List[SLOClass]] = None,
                 trace_maxlen: Optional[int] = TRACE_KEEP_DEFAULT,
                 profiler: bool = True, anomaly: bool = True):
        self.registry = MetricsRegistry()
        self.tracer: Optional[RequestTracer] = \
            RequestTracer(maxlen=trace_maxlen) if tracer else None
        self.timeline: Optional[TickTimeline] = \
            TickTimeline() if timeline else None
        self.slo = SLOTracker(slo_classes)
        self.profiler: Optional[StepProfiler] = \
            StepProfiler() if profiler else None
        self.anomaly: Optional[AnomalyMonitor] = \
            AnomalyMonitor() if anomaly else None
        if self.profiler is not None:
            self.profiler.on_compile = self._on_compile_event
        if self.anomaly is not None:
            self.anomaly.on_alert = self._on_alert
        self.engine_config: dict = {}
        # streaming latency distributions, labeled by SLO class; exact
        # sample percentiles (benchmarks) still come from request
        # timestamps via metrics.percentile — same ground truth, the
        # histograms are the no-sample-retention view
        self.ttft_s = self.registry.histogram("ttft_s")
        self.latency_s = self.registry.histogram("latency_s")
        self.queue_s = self.registry.histogram("queue_s")
        self.preempt_wait_s = self.registry.histogram("preempt_wait_s")
        self.tick_s = self.registry.histogram("tick_s")
        self.tokens_per_tick = self.registry.histogram(
            "tokens_per_tick", lo=0.5, hi=65536.0, growth=1.15)

    # -- wiring (engine construction time) -----------------------------------
    def set_engine_config(self, **cfg) -> None:
        """Stamp the engine's tuning knobs (kv_dtype,
        speculate_k, bank size, ...) into the trace metadata block and
        the metrics snapshot — two exported traces from differently
        configured engines must be tellable apart without filenames."""
        self.engine_config.update(cfg)
        if self.timeline is not None:
            self.timeline.set_metadata(**cfg)

    def _on_compile_event(self, ev) -> None:
        """Profiler observed a compile cell: first-class timeline span,
        registry counter, and (post-warmup) a recompile alert."""
        if self.timeline is not None:
            self.timeline.span("jit_compile", ev.t0, ev.t0 + ev.dur_s,
                               variant=ev.variant, post_warm=ev.post_warm)
        self.registry.counter("compiles").inc(
            label="post_warm" if ev.post_warm else "warmup")
        if self.anomaly is not None:
            self.anomaly.on_compile(ev.name, ev.variant, ev.dur_s,
                                    ev.post_warm)

    def _on_alert(self, alert) -> None:
        """Anomaly fired: structured instant in the trace export plus a
        per-kind counter — the alert is visible in Perfetto at the tick
        it fired, in ``Engine.metrics()``, and in the exit report."""
        if self.timeline is not None:
            self.timeline.instant(
                f"alert:{alert.kind}", tick=alert.tick,
                severity=alert.severity, message=alert.message,
                **{k: v for k, v in alert.data.items()
                   if isinstance(v, (int, float, str, bool))})
        self.registry.counter("alerts").inc(label=alert.kind)

    # -- request lifecycle hooks (engine clock) ------------------------------
    def on_submit(self, req, t: float) -> None:
        if self.tracer is not None:
            self.tracer.record(req.id, TR.SUBMIT, t,
                               prompt_len=req.prompt_len,
                               submodel=req.submodel_id,
                               slo_class=req.slo_class)

    def on_admit(self, req, t: float) -> None:
        if self.tracer is not None:
            self.tracer.record(req.id, TR.ADMIT, t, slot=req.slot,
                               cached=req.num_cached_tokens)
            if req.num_cached_tokens:
                self.tracer.record(req.id, TR.PREFIX_ADOPT, t,
                                   n=req.num_cached_tokens)
        if self.timeline is not None:
            self.timeline.instant("admit", req=req.id, slot=req.slot)

    def on_prefill_chunk(self, req, t: float, start: int, n: int) -> None:
        if self.tracer is not None:
            self.tracer.record(req.id, TR.PREFILL_CHUNK, t, start=start, n=n)

    def on_token(self, req, t: float, n: int = 1) -> None:
        if self.tracer is not None:
            self.tracer.record(req.id, TR.TOKEN, t, n=n)

    def on_speculate(self, req, t: float, drafted: int, accepted: int,
                     committed: int) -> None:
        if self.tracer is not None:
            self.tracer.record(req.id, TR.SPECULATE, t, drafted=drafted,
                               accepted=accepted, n=committed)
        if self.anomaly is not None:
            self.anomaly.on_speculate(drafted, accepted, t)

    def on_preempt(self, req, t: float) -> None:
        if self.tracer is not None:
            self.tracer.record(req.id, TR.PREEMPT, t,
                               context_len=req.context_len)
        if self.timeline is not None:
            self.timeline.instant("preempt", req=req.id)

    def on_finish(self, req, t: float) -> None:
        """Score + histogram the finished request.  Ensemble members
        share one delivered stream, so only the leader lands in the
        latency distributions and the SLO ledger (matching
        ``finished_streams``); the trace still closes for every member."""
        if self.tracer is not None:
            self.tracer.record(req.id, TR.FINISH, t,
                               tokens=len(req.out_tokens),
                               preemptions=req.num_preemptions)
        if req.group is not None and req is not req.group.leader:
            return
        cls = req.slo_class or DEFAULT_CLASS
        ttft = None if req.t_first_token is None \
            else req.t_first_token - req.arrival_time
        lat = t - req.arrival_time
        if ttft is not None:
            self.ttft_s.observe(ttft, label=cls)
        self.latency_s.observe(lat, label=cls)
        if req.t_admitted is not None:
            self.queue_s.observe(req.t_admitted - req.arrival_time,
                                 label=cls)
        if self.tracer is not None:
            tr = self.tracer.get(req.id)
            if tr is not None and tr.num_preemptions:
                self.preempt_wait_s.observe(tr.preempt_wait_s, label=cls)
        ok = self.slo.observe(cls, ttft, lat)
        if self.anomaly is not None:
            self.anomaly.on_finish(cls, ok, t)

    # -- per-tick hook (perf_counter clock) ----------------------------------
    def on_tick(self, tick: int, marks, slot_events=(), extra_spans=(),
                counters: Optional[dict] = None, tokens: int = 0,
                t: float = 0.0, used_pages: Optional[int] = None,
                live_pages=None, kv_read_bytes: int = 0) -> None:
        """``t`` is the engine-clock tick time (alerts are stamped with
        it); ``used_pages``/``live_pages`` feed the pool-leak watchdog
        (``live_pages`` a zero-arg callable, evaluated only when due);
        ``kv_read_bytes`` is the tick's estimated KV traffic for the
        roofline gauges."""
        dur = marks[-1] - marks[0]
        self.tick_s.observe(dur)
        if self.profiler is not None:
            self.profiler.drain()
        if tokens:
            self.tokens_per_tick.observe(tokens)
        if self.timeline is not None:
            self.timeline.add_tick(tick, marks, slot_events=slot_events,
                                   extra_spans=extra_spans,
                                   counters=counters)
        if self.anomaly is not None:
            self.anomaly.on_tick(tick, t, dur, used_pages=used_pages,
                                 live_pages=live_pages)
        # per-tick roofline gauges: what the device achieved this tick
        # vs. the kernel_bench reference rates (when set via the
        # profiler); device_step phase time is marks[3] - marks[2]
        if tokens and self.profiler is not None:
            dev = max(marks[3] - marks[2], 1e-9)
            r = self.registry
            r.gauge("achieved_tok_s").set(tokens / dev)
            if kv_read_bytes:
                r.gauge("achieved_kv_gb_s").set(kv_read_bytes / dev / 1e9)
            peaks = self.profiler.peaks
            if peaks.get("tok_s"):
                r.gauge("roofline_tok_frac").set(
                    tokens / dev / peaks["tok_s"])
            if peaks.get("kv_gb_s") and kv_read_bytes:
                r.gauge("roofline_kv_frac").set(
                    kv_read_bytes / dev / 1e9 / peaks["kv_gb_s"])

    # -- read side -----------------------------------------------------------
    def collect(self, engine) -> MetricsRegistry:
        """Publish the engine's current counters and pool/router/spec
        state into registry gauges (per-label views included), so one
        ``registry.snapshot()`` is the complete picture."""
        r, stats = self.registry, engine.stats
        for name, v in stats.as_dict().items():
            if isinstance(v, dict):
                g = r.gauge(name)
                for label, x in v.items():
                    g.set(x, label=label)
                g.set(sum(v.values()) if name == "tokens_by_submodel"
                      else max(v.values(), default=0.0))
            else:
                r.gauge(name).set(v)
        for name in ("accept_rate", "accepted_tok_per_tick",
                     "cobatch_ratio"):
            r.gauge(name).set(getattr(stats, name))
        hr = stats.prefix_hit_rate
        if hr is not None:
            r.gauge("prefix_hit_rate").set(hr)
        pool = r.gauge("pool_utilization")
        pool.set(engine.pool.utilization())
        for owner, util in engine.pool.utilization_by_owner().items():
            pool.set(util, label=owner)
        for name, v in engine.pool.stats().items():
            if not isinstance(v, dict):
                r.gauge(f"pool_{name}").set(v)
        if engine.pool.cache is not None:
            for name, v in engine.pool.cache.stats().items():
                r.gauge(f"prefix_cache_{name}").set(v)
        if engine.router is not None:
            g = r.gauge("router_load")
            for sid, load in enumerate(engine.router.loads):
                g.set(load, label=sid)
            routed = r.gauge("router_routed")
            for sid, n in enumerate(engine.router.routed):
                routed.set(n, label=sid)
        if engine.spec is not None:
            for name, v in engine.spec.stats().items():
                r.gauge(f"spec_{name}").set(v)
        r.gauge("preemptions").set(engine.preemptions)
        r.gauge("cache_evictions").set(engine.cache_evictions)
        if self.profiler is not None:
            r.gauge("compiles_total").set(self.profiler.compiles_total)
            r.gauge("compiles_post_warm").set(
                self.profiler.compiles_post_warm)
        if self.anomaly is not None:
            g = r.gauge("anomaly_alerts")
            g.set(sum(self.anomaly.counts.values()))
            for kind, n in self.anomaly.counts.items():
                g.set(n, label=kind)
        return r

    def snapshot(self, engine) -> dict:
        """The nested read surface: counters + derived rates + subsystem
        stats + latency/tick summaries + SLO attainment.  The launcher's
        stats line and the benchmark phases consume this instead of
        reaching into engine internals."""
        stats = engine.stats
        out = {
            "counters": stats.as_dict(),
            "derived": {
                "accept_rate": stats.accept_rate,
                "accepted_tok_per_tick": stats.accepted_tok_per_tick,
                "cobatch_ratio": stats.cobatch_ratio,
                "prefix_hit_rate": stats.prefix_hit_rate,
                "cache_evictions": engine.cache_evictions,
                "preemptions": engine.preemptions,
            },
            "pool": engine.pool.stats(),
            "latency": {
                "ttft_s": self.ttft_s.summary(),
                "latency_s": self.latency_s.summary(),
                "queue_s": self.queue_s.summary(),
                "preempt_wait_s": self.preempt_wait_s.summary(),
            },
            "tick": {
                "tick_s": self.tick_s.summary(),
                "tokens_per_tick": self.tokens_per_tick.summary(),
            },
            "slo": self.slo.report(),
        }
        if engine.pool.cache is not None:
            out["prefix_cache"] = engine.pool.cache.stats()
        if engine.router is not None:
            out["router"] = engine.router.stats()
        if engine.spec is not None:
            out["spec"] = engine.spec.stats()
        if self.tracer is not None:
            out["trace_events"] = self.tracer.num_events
        if self.timeline is not None:
            out["timeline_events"] = self.timeline.num_events
        if self.engine_config:
            out["config"] = dict(self.engine_config)
        if self.profiler is not None:
            # compute=False: never wait for an event in flight on the
            # stats-line path
            out["profiler"] = {
                "compiles_total": self.profiler.compiles_total,
                "compiles_post_warm": self.profiler.compiles_post_warm,
                "cost": self.profiler.cost_report(compute=False),
            }
        if self.anomaly is not None:
            out["alerts"] = self.anomaly.report()
        return out

    def reset(self) -> None:
        """Benchmark warmup boundary: drop every recorded sample/event so
        the measured phase starts clean (the engine's own counter reset
        lives in ``EngineStats.reset``)."""
        self.registry.reset()
        if self.tracer is not None:
            self.tracer.clear()
        if self.timeline is not None:
            self.timeline.clear()
        self.slo.reset()
        if self.anomaly is not None:
            self.anomaly.reset()
        if self.profiler is not None:
            # a reset IS the warmup boundary: compiles before it were
            # expected, compiles after it alert as regressions
            self.profiler.reset()
            self.profiler.mark_warm()
