"""The port's observability layer (``repro_torch.serving.observability``):
metrics registry, stats edge cases, lifecycle traces, Chrome trace
export and validation, SLO scoring, and the engine integration.

A port of ``tests/test_observability.py``, one counterpart a test, on the
port's modules and its engine on the CPU:
  * zero-denominator safety: a fresh engine reports 0.0 rates and a None
    ``prefix_hit_rate``, never a division crash;
  * registry label views sum exactly to their totals;
  * ``EngineStats.reset`` is dataclass-field-driven (every field,
    including dict-valued ones and the port's launch counters, returns to
    its declared default);
  * trace-derived TTFT/latency EQUAL the request-timestamp ground truth
    (lifecycle events are recorded on the engine clock);
  * the exported tick timeline is valid Chrome Trace Event JSON.
The modules other than the profiler are copies of the JAX package's, so
beside those, the same inputs go through both packages (histogram
observations, SLO scores, tracer events, a tick timeline) and must give
equal outputs; ``EngineStats`` keeps every JAX counter with its default.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro_torch.configs.base import get_model_config, reduced
from repro_torch.models.params import init_params
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.observability import (ADMIT, FINISH, PREEMPT,
                                               SUBMIT, TICK_PHASES, TOKEN,
                                               Counter, EngineStats,
                                               Histogram, MetricsRegistry,
                                               RequestTrace, RequestTracer,
                                               SLOClass, SLOTracker,
                                               Telemetry, TickTimeline,
                                               parse_slo_class, percentile,
                                               percentile_or_none,
                                               validate_chrome_trace)


# ---------------------------------------------------------------------------
# percentile helpers (the deduplicated serve.py/serving_bench.py helpers)
# ---------------------------------------------------------------------------
def test_percentile_matches_numpy_and_handles_empty():
    xs = [3.0, 1.0, 2.0, 5.0, 4.0]
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 99) == pytest.approx(np.percentile(xs, 99))
    assert math.isnan(percentile([], 50))
    assert percentile_or_none([], 50) is None
    assert percentile_or_none(xs, 50) == 3.0
    assert percentile_or_none([1.23456789], 50) == 1.2346  # rounded for JSON


# ---------------------------------------------------------------------------
# registry: counters / gauges / histograms with per-label views
# ---------------------------------------------------------------------------
def test_counter_label_views_sum_exactly_to_total():
    c = Counter("tokens")
    rng = np.random.default_rng(0)
    total = 0
    for _ in range(200):
        n = int(rng.integers(1, 9))
        c.inc(n, label=int(rng.integers(0, 4)))
        total += n
    assert c.value == total
    assert sum(c.view().values()) == c.value     # the labels-sum invariant
    assert set(c.view()) == {0, 1, 2, 3}


def test_histogram_label_views_sum_exactly_to_total():
    h = Histogram("lat")
    rng = np.random.default_rng(1)
    for _ in range(300):
        h.observe(float(rng.uniform(0.01, 2.0)),
                  label="interactive" if rng.uniform() < 0.5 else "batch")
    views = h.view()
    assert sum(v.count for v in views.values()) == h.count == 300
    assert sum(v.sum for v in views.values()) == pytest.approx(h.sum)


def test_histogram_quantiles_bounded_relative_error():
    h = Histogram("s")
    rng = np.random.default_rng(2)
    xs = rng.lognormal(mean=-2.0, sigma=1.0, size=5000)
    for x in xs:
        h.observe(float(x))
    for q in (0.50, 0.90, 0.99):
        exact = float(np.quantile(xs, q))
        approx = h.quantile(q)
        assert approx == pytest.approx(exact, rel=0.08)   # ~growth-1 error
    assert h.min == pytest.approx(xs.min())
    assert h.max == pytest.approx(xs.max())
    assert h.quantile(0.0) >= h.min
    assert h.quantile(1.0) <= h.max


def test_histogram_empty_and_reset():
    h = Histogram("x")
    assert h.quantile(0.5) is None and h.mean is None
    assert h.summary()["p50"] is None and h.summary()["count"] == 0
    h.observe(1.0, label="a")
    h.reset()
    assert h.count == 0 and h.view() == {}


def test_registry_get_or_create_and_kind_mismatch():
    r = MetricsRegistry()
    c = r.counter("n")
    assert r.counter("n") is c                   # get-or-create
    with pytest.raises(TypeError, match="already registered"):
        r.gauge("n")
    r.gauge("g").set_max(2.0)
    r.gauge("g").set_max(1.0)                    # peak keeps the max
    assert r.get("g").value == 2.0
    # the label-overflow warning counter is auto-registered as the sink
    # every capped metric reports folds into
    assert r.names() == ["g", MetricsRegistry.OVERFLOW_COUNTER, "n"]
    snap = r.snapshot()
    assert snap["n"]["type"] == "counter"
    r.reset()
    assert r.get("g").value == 0.0


# ---------------------------------------------------------------------------
# EngineStats: zero denominators + dataclass-field-driven reset
# ---------------------------------------------------------------------------
def test_fresh_stats_rates_are_safe_at_zero_denominators():
    s = EngineStats()
    assert s.cobatch_ratio == 0.0                # 0 non-empty ticks
    assert s.accept_rate == 0.0                  # 0 drafted
    assert s.accepted_tok_per_tick == 0.0        # 0 speculating slot-ticks
    assert s.prefix_hit_rate is None             # nothing cache-eligible


def test_prefix_hit_rate_none_only_when_nothing_eligible():
    s = EngineStats()
    s.cache_eligible_tokens = 10
    assert s.prefix_hit_rate == 0.0              # eligible but all missed
    s.cache_hit_tokens = 5
    assert s.prefix_hit_rate == 0.5


def test_stats_reset_is_field_driven():
    s = EngineStats()
    # dirty EVERY field, dict-valued ones included — a counter added
    # tomorrow is covered by construction, not by this list
    for f in dataclasses.fields(s):
        if f.default_factory is not dataclasses.MISSING:
            getattr(s, f.name)[0] = 7
        elif isinstance(f.default, float):
            setattr(s, f.name, 0.9)
        else:
            setattr(s, f.name, 13)
    assert s.as_dict() != EngineStats().as_dict()
    s.reset()
    assert s.as_dict() == EngineStats().as_dict()
    # dict fields are fresh objects, not shared defaults
    s.tokens_by_submodel[1] = 1
    assert EngineStats().tokens_by_submodel == {}


# ---------------------------------------------------------------------------
# SLO classes + tracker
# ---------------------------------------------------------------------------
def test_parse_slo_class_forms():
    c = parse_slo_class("interactive:0.5:5")
    assert c == SLOClass("interactive", 0.5, 5.0)
    assert parse_slo_class("batch:-:60") == SLOClass("batch", None, 60.0)
    assert parse_slo_class("loose") == SLOClass("loose", None, None)
    assert parse_slo_class("x:0.25") == SLOClass("x", 0.25, None)
    for bad in (":1:2", "a:b:c", "a:1:2:3", "a:-1:2", "a:inf:2"):
        with pytest.raises(ValueError):
            parse_slo_class(bad)


def test_slo_meets_semantics():
    c = SLOClass("i", ttft_s=0.5, latency_s=5.0)
    assert c.meets(0.5, 5.0)                     # bounds are inclusive
    assert not c.meets(0.6, 1.0)
    assert not c.meets(0.1, 6.0)
    assert not c.meets(None, 1.0)                # missing measurement fails
    assert SLOClass("free").meets(None, None)    # unbounded always holds


def test_slo_tracker_attainment_and_report():
    t = SLOTracker([SLOClass("i", 0.5, 5.0)])
    assert t.attainment("i") is None             # nothing scored yet
    assert t.observe("i", 0.2, 2.0) is True
    assert t.observe("i", 0.9, 2.0) is False     # ttft violation
    assert t.observe("i", 0.2, 9.0) is False     # latency violation
    assert t.observe("unseen", 99.0, 99.0) is True   # unconfigured class
    rep = t.report()
    assert rep["i"]["attainment"] == pytest.approx(1 / 3)
    assert rep["i"]["ttft_violations"] == 1
    assert rep["i"]["latency_violations"] == 1
    assert rep["unseen"]["ttft_target_s"] is None
    t.reset()
    assert t.report() == {}


# ---------------------------------------------------------------------------
# lifecycle traces
# ---------------------------------------------------------------------------
def test_request_trace_derived_metrics():
    tr = RequestTrace(7)
    tr.add(SUBMIT, 0.0)
    tr.add(ADMIT, 1.0, slot=0, cached=0)
    tr.add(TOKEN, 2.5, n=1)
    tr.add(PREEMPT, 3.0)
    tr.add(ADMIT, 4.5, slot=1, cached=0)         # re-admission
    tr.add(TOKEN, 5.0, n=3)
    tr.add(FINISH, 6.0, tokens=4)
    assert tr.ttft_s == 2.5
    assert tr.latency_s == 6.0
    assert tr.queue_s == 1.0                     # submit -> FIRST admit
    assert tr.preempt_wait_s == 1.5              # 3.0 -> 4.5
    assert tr.num_preemptions == 1
    assert tr.committed_tokens == 4


def test_tracer_ring_and_finish_transition():
    t = RequestTracer(maxlen=2)
    for rid in range(3):
        t.record(rid, SUBMIT, float(rid))
        assert t.live[rid].req_id == rid
        t.record(rid, FINISH, float(rid) + 1)
        assert rid not in t.live                 # finish retires the trace
    assert [tr.req_id for tr in t.finished] == [1, 2]   # ring dropped 0
    assert t.get(2).latency_s == 1.0
    t.clear()
    assert t.num_events == 0


# ---------------------------------------------------------------------------
# tick timeline -> Chrome Trace Event JSON
# ---------------------------------------------------------------------------
def _demo_timeline():
    tl = TickTimeline()
    t = 1000.0
    for tick in range(3):
        marks = [t, t + .001, t + .002, t + .010, t + .011]
        tl.add_tick(tick, marks,
                    slot_events=[(0, "decode", t + .002, t + .010,
                                  {"req": tick, "tokens": 1})],
                    extra_spans=[("draft", t + .001, t + .0015)],
                    counters={"used_pages": 4 + tick})
        t += 0.02
    tl.instant("preempt", t, req=9)
    return tl


def test_timeline_chrome_export_is_valid(tmp_path):
    tl = _demo_timeline()
    doc = tl.to_chrome()
    n = validate_chrome_trace(doc)
    assert n == tl.num_events + 3                # + process/thread metadata
    ev = doc["traceEvents"]
    engine_spans = [e for e in ev if e["ph"] == "X" and e["tid"] == 0]
    assert {e["name"] for e in engine_spans} \
        == set(TICK_PHASES) | {"draft"}
    assert any(e["ph"] == "C" for e in ev)       # counter track
    assert any(e["ph"] == "i" for e in ev)       # instants
    # slot 0 renders on tid 1 with a thread_name record
    names = {(e["tid"], e["args"]["name"]) for e in ev if e["ph"] == "M"
             and e["name"] == "thread_name"}
    assert (1, "slot 0") in names and (0, "engine phases") in names
    # timestamps are rebased to zero and non-negative
    assert min(e["ts"] for e in ev if "ts" in e) == 0.0
    path = tmp_path / "trace.json"
    assert tl.export(str(path)) == len(ev)
    validate_chrome_trace(json.loads(path.read_text()))


def test_validate_chrome_trace_rejects_bad_docs():
    with pytest.raises(ValueError, match="traceEvents"):
        validate_chrome_trace({"events": []})
    with pytest.raises(ValueError, match="non-empty"):
        validate_chrome_trace({"traceEvents": []})
    good = {"ph": "X", "pid": 0, "tid": 0, "name": "x", "ts": 0.0,
            "dur": 1.0}
    validate_chrome_trace({"traceEvents": [good]})
    for corrupt in (dict(good, ph="Z"), dict(good, name=""),
                    dict(good, dur=-1.0), dict(good, pid="zero"),
                    {k: v for k, v in good.items() if k != "ts"}):
        with pytest.raises(ValueError):
            validate_chrome_trace({"traceEvents": [good, corrupt]})


def test_timeline_rejects_wrong_mark_count():
    with pytest.raises(ValueError, match="marks"):
        TickTimeline().add_tick(0, [0.0, 1.0])


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    cfg = reduced(get_model_config("qwen3-1.7b"), dtype="float32")
    return cfg, init_params(cfg, 0, device="cpu")


def _drive(engine, reqs, **submit_kw):
    """Deterministic virtual clock: tick i happens at t = i + 1."""
    for prompt, gen in reqs:
        engine.submit(prompt, gen, arrival_time=0.0, **submit_kw)
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    engine.run(clock=clock)


def test_engine_traces_match_request_timestamps_exactly(tiny, tmp_path):
    cfg, params = tiny
    obs = Telemetry(timeline=True,
                    slo_classes=[parse_slo_class("default:3:50")])
    engine = Engine(cfg, params,
                    EngineConfig(num_slots=3, num_pages=64, page_size=8,
                                 max_prompt_len=32, max_new_tokens=5,
                                 token_budget=32, policy="on_demand",
                                 kv_dtype="float32",
                                 compute_dtype="float32"),
                    device="cpu", telemetry=obs)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32), 4)
            for n in (20, 9, 14, 6)]
    _drive(engine, reqs)

    finished = engine.sched.finished
    assert len(finished) == 4
    for req in finished:
        tr = obs.tracer.get(req.id)
        # THE acceptance criterion: trace-derived latency metrics equal
        # the scheduler's own timestamps, exactly — same clock, same
        # values, derived instead of hand-computed
        assert tr.ttft_s == req.t_first_token - req.arrival_time
        assert tr.latency_s == req.t_done - req.arrival_time
        assert tr.queue_s == req.t_admitted - req.arrival_time
        assert tr.committed_tokens == len(req.out_tokens)
        assert tr.prefill_tokens + tr.cached_tokens >= req.prompt_len - 1
        kinds = [e.kind for e in tr.events]
        assert kinds[0] == SUBMIT and kinds[-1] == FINISH

    # streaming histograms saw exactly the finished requests, labeled
    m = engine.metrics()
    lat = m["latency"]["latency_s"]
    assert lat["count"] == 4 and "default" in lat["by_label"]
    ttfts = sorted(r.t_first_token - r.arrival_time for r in finished)
    assert obs.ttft_s.count == 4
    assert obs.ttft_s.min == ttfts[0] and obs.ttft_s.max == ttfts[-1]
    # registry gauges mirror the engine counters after collect()
    assert m["counters"]["generated_tokens"] == engine.generated_tokens
    assert obs.registry.get("generated_tokens").value \
        == engine.generated_tokens
    assert m["slo"]["default"]["finished"] == 4

    # the exported timeline is schema-valid and covers every tick
    path = tmp_path / "tick_trace.json"
    engine.obs.timeline.export(str(path))
    doc = json.loads(path.read_text())
    validate_chrome_trace(doc)
    device_spans = [e for e in doc["traceEvents"]
                    if e["ph"] == "X" and e["name"] == "device_step"]
    assert len(device_spans) == engine.steps

    # reset_stats clears telemetry along with the counters
    engine.reset_stats()
    assert engine.steps == 0 and engine.stats.steps == 0
    assert obs.ttft_s.count == 0 and obs.tracer.num_events == 0
    assert obs.timeline.num_events == 0 and obs.slo.report() == {}


def test_engine_stats_attribute_shim(tiny):
    cfg, params = tiny
    engine = Engine(cfg, params,
                    EngineConfig(num_slots=2, num_pages=32, page_size=8,
                                 max_prompt_len=16, max_new_tokens=4,
                                 token_budget=16, kv_dtype="float32",
                                 compute_dtype="float32"), device="cpu")
    # fresh engine: rates are safe, hit rate is None (nothing eligible)
    assert engine.cobatch_ratio == 0.0
    assert engine.accept_rate == 0.0
    assert engine.accepted_tok_per_tick == 0.0
    assert engine.prefix_hit_rate is None
    # counters stay plain attributes, shimmed onto the stats dataclass
    engine.generated_tokens += 3
    assert engine.stats.generated_tokens == 3
    engine.tokens_by_submodel[1] = 5
    assert engine.stats.tokens_by_submodel == {1: 5}
    engine.reset_stats()
    assert engine.generated_tokens == 0


def test_engine_preemption_emits_trace_events(tiny):
    cfg, params = tiny
    engine = Engine(cfg, params,
                    EngineConfig(num_slots=2, num_pages=10, page_size=4,
                                 max_prompt_len=16, max_new_tokens=5,
                                 token_budget=16, policy="on_demand",
                                 kv_dtype="float32",
                                 compute_dtype="float32"), device="cpu")
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(1, cfg.vocab_size, (15,)).astype(np.int32), 5)
            for _ in range(2)]
    _drive(engine, reqs)
    assert engine.preemptions > 0                # the squeeze actually bit
    preempted = [r for r in engine.sched.finished if r.num_preemptions]
    assert preempted
    for req in preempted:
        tr = engine.obs.tracer.get(req.id)
        assert tr.num_preemptions == req.num_preemptions
        assert req.t_preempted is not None
        assert tr.preempt_wait_s > 0             # preempt -> re-admit gap
        # the re-prefill after preemption is visible as extra chunks
        assert tr.of_kind(PREEMPT)
    # preempt_wait histogram observed the preempted leaders
    assert engine.obs.preempt_wait_s.count == len(preempted)



# ---------------------------------------------------------------------------
# the same inputs through both packages
# ---------------------------------------------------------------------------
def test_stats_keep_every_jax_counter_and_its_default():
    from repro.serving.observability import EngineStats as JaxStats
    mine = {f.name: f for f in dataclasses.fields(EngineStats)}
    for f in dataclasses.fields(JaxStats):
        assert f.name in mine, f.name
        assert mine[f.name].default == f.default
        assert (mine[f.name].default_factory is dataclasses.MISSING) == \
            (f.default_factory is dataclasses.MISSING)
    # the port's own: both paged kernels' launches, parent and draft
    assert set(mine) - {f.name for f in dataclasses.fields(JaxStats)} == {
        "attn_launches", "decode_launches", "draft_attn_launches",
        "draft_decode_launches", "decode_ticks"}


def test_histograms_and_registry_equal_jax_on_the_same_observations():
    from repro.serving import observability as jax_obs
    from repro_torch.serving import observability as obs
    rng = np.random.default_rng(3)
    xs = rng.lognormal(-3.0, 1.5, 2000)
    labels = rng.integers(0, 6, 2000)
    snaps = []
    for o in (obs, jax_obs):
        reg = o.MetricsRegistry()
        h = reg.histogram("lat")
        t = reg.histogram("tok", lo=0.5, hi=65536.0, growth=1.15)
        c, g = reg.counter("n"), reg.gauge("peak")
        for x, lab in zip(xs, labels):
            h.observe(float(x), label=f"class{lab}")
            t.observe(float(x) * 1e3)
            c.inc(int(lab), label=int(lab))
            g.set_max(float(x))
        snaps.append((reg.snapshot(), [h.quantile(q) for q in
                                       (0.1, 0.5, 0.9, 0.99)],
                      obs.percentile(xs, 99), jax_obs.percentile(xs, 99)))
    assert snaps[0] == snaps[1]


def test_slo_scores_equal_jax():
    from repro.serving import observability as jax_obs
    from repro_torch.serving import observability as obs
    rng = np.random.default_rng(4)
    ttft, lat = rng.uniform(0, 0.1, 300), rng.uniform(0, 4, 300)
    specs = ["interactive:0.05:0.6", "batch:-:3.0", "loose"]
    reports = []
    for o in (obs, jax_obs):
        t = o.SLOTracker([o.parse_slo_class(s) for s in specs])
        verdicts = [t.observe(["interactive", "batch", "loose", "other"]
                              [i % 4],
                              None if i % 11 == 0 else float(x),
                              float(y))
                    for i, (x, y) in enumerate(zip(ttft, lat))]
        reports.append((verdicts, t.report(),
                        [o.parse_slo_class(s) for s in specs]))
    assert reports[0][0] == reports[1][0] and reports[0][1] == reports[1][1]
    assert [dataclasses.astuple(c) for c in reports[0][2]] == \
        [dataclasses.astuple(c) for c in reports[1][2]]


def test_tracer_and_timeline_equal_jax_on_the_same_events():
    from repro.serving import observability as jax_obs
    from repro_torch.serving import observability as obs
    out = []
    for o in (obs, jax_obs):
        tr = o.RequestTracer(maxlen=None)
        for rid in range(4):
            tr.record(rid, o.SUBMIT, 0.1 * rid, prompt_len=5 + rid)
            tr.record(rid, o.ADMIT, 0.1 * rid + 0.02, slot=rid, cached=0)
            tr.record(rid, o.PREFILL_CHUNK, 0.1 * rid + 0.03, start=0, n=5)
            if rid == 2:
                tr.record(rid, o.PREEMPT, 0.35, context_len=7)
                tr.record(rid, o.ADMIT, 0.5, slot=0, cached=4)
                tr.record(rid, o.PREFIX_ADOPT, 0.5, n=4)
            tr.record(rid, o.TOKEN, 0.1 * rid + 0.04, n=1)
            tr.record(rid, o.SPECULATE, 0.6, drafted=4, accepted=2, n=3)
            tr.record(rid, o.TOKEN, 0.6, n=3)
            tr.record(rid, o.FINISH, 0.7, tokens=4)
        derived = [(t.req_id, t.ttft_s, t.latency_s, t.queue_s,
                    t.preempt_wait_s, t.num_preemptions, t.committed_tokens,
                    t.prefill_tokens, t.cached_tokens,
                    [(e.kind, e.t, dict(e.data)) for e in t.events])
                   for t in tr.finished]
        tl = o.TickTimeline()
        tl.set_metadata(kv_dtype="float32", num_slots=2)
        t = 10.0
        for tick in range(5):
            tl.add_tick(tick, [t, t + .001, t + .002, t + .009, t + .010],
                        slot_events=[(tick % 2, "decode", t + .002, t + .009,
                                      {"req": tick, "tokens": 1})],
                        extra_spans=[("draft", t + .001, t + .0015)],
                        counters={"used_pages": 3 + tick})
            t += 0.02
        tl.instant("preempt", t, req=2)
        tl.span("jit_compile", 10.0, 10.5, variant="C=8", post_warm=False)
        doc = tl.to_chrome()
        assert doc["otherData"].pop("source").endswith(
            "serving.observability")
        out.append((derived, doc, o.validate_chrome_trace(doc)))
    assert out[0] == out[1]
