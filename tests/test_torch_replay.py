"""The port's traffic-trace record/replay, step profiler and serve CLI
(``repro_torch.serving.observability``, ``repro_torch.launch.serve``).

A port of ``tests/test_replay.py``, one counterpart a test, on the port's
modules and engine on the CPU:
  * a trace file round-trips exactly (records + meta) and malformed
    headers are rejected loudly;
  * replaying the same trace twice on one engine is byte-identical (same
    token-stream SHA-256, identical virtual-clock TTFT/latency), and a
    fresh engine over the same weights reproduces the digest;
  * the step profiler attributes compile cells to shape-bucket variants,
    reports each variant's time (``host_ms_*`` on the CPU, where the step
    is synchronous; ``device_ms_*`` from CUDA events on a card) in place
    of XLA's FLOPs/bytes, and flags a post-warmup compile (the induced
    fault: a prompt wider than any seen mints a new chunk-width bucket,
    standing in for ``jax.clear_caches()``) as a ``recompile`` alert that
    lands in the schema-validated Chrome trace export;
  * the engine config stamp reaches ``Engine.metrics()`` and the trace
    metadata.
The five tests of ``benchmarks/regression.py``'s gate (``test_gate_*``
and ``test_baseline_entry_is_the_committed_shape``) stay JAX-only until
that harness is ported.  The replay module is a copy of the JAX
package's: beside those, both packages write the same trace bytes, read
each other's files and give the same ``stream_digest``; and the serve
CLI records a trace on the CPU and replays it twice with one digest.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_model_config, reduced
from repro_torch.models.params import init_params
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.observability import (RECOMPILE, StepProfiler,
                                               Telemetry, TraceRecord,
                                               TraceRecorder, load_trace,
                                               replay, save_trace,
                                               stream_digest,
                                               validate_chrome_trace)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACES = os.path.join(ROOT, "benchmarks", "traces")


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced(get_model_config("qwen3-1.7b"), dtype="float32")
    return cfg, init_params(cfg, 0, device="cpu")


def make_engine(cfg, params, **over):
    kw = dict(num_slots=3, num_pages=64, page_size=8, max_prompt_len=32,
              max_new_tokens=6, token_budget=32, policy="on_demand",
              kv_dtype="float32", compute_dtype="float32")
    kw.update(over)
    return Engine(cfg, params, EngineConfig(**kw), device="cpu",
                  telemetry=Telemetry(timeline=True))


def small_trace(vocab, n=6, seed=9):
    rng = np.random.default_rng(seed)
    return [TraceRecord(arrival_s=0.004 * i,
                        prompt=list(rng.integers(1, vocab,
                                                 int(rng.integers(4, 12)))),
                        max_new_tokens=int(rng.integers(3, 7)))
            for i in range(n)]


# ---------------------------------------------------------------------------
# trace files
# ---------------------------------------------------------------------------
def test_trace_file_round_trip(tmp_path):
    rec = TraceRecorder(meta={"arch": "qwen3-1.7b", "note": "unit"})
    rec.add(0.25, [3, 1, 4], 5, slo_class="interactive", ensemble="mean",
            session="s0")
    rec.add(0.125, [2, 7], 3)
    path = tmp_path / "t.jsonl"
    assert rec.save(str(path)) == 2
    records, meta = load_trace(str(path))
    assert meta == {"arch": "qwen3-1.7b", "note": "unit"}
    # sorted by arrival on save
    assert [r.arrival_s for r in records] == [0.125, 0.25]
    assert records[1].prompt == [3, 1, 4]
    assert records[1].slo_class == "interactive"
    assert records[1].ensemble == "mean" and records[1].session == "s0"
    assert records[0].slo_class == "default" and records[0].ensemble is None


def test_trace_file_rejects_malformed(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text("")
    with pytest.raises(ValueError, match="empty"):
        load_trace(str(p))
    p.write_text('{"schema": "something-else", "version": 1}\n')
    with pytest.raises(ValueError, match="schema"):
        load_trace(str(p))
    p.write_text('{"schema": "horn-serving-trace", "version": 99}\n')
    with pytest.raises(ValueError, match="newer"):
        load_trace(str(p))
    p.write_text('{"schema": "horn-serving-trace", "version": 1}\n')
    with pytest.raises(ValueError, match="no records"):
        load_trace(str(p))


def test_stream_digest_is_order_canonical():
    a = stream_digest([(0, [1, 2]), (1, [3])])
    assert a == stream_digest([(0, [1, 2]), (1, [3])])
    assert a != stream_digest([(0, [1, 2]), (1, [4])])
    assert a != stream_digest([(1, [1, 2]), (0, [3])])


# ---------------------------------------------------------------------------
# record -> replay determinism
# ---------------------------------------------------------------------------
def test_replay_byte_identical_across_runs_and_engines(tiny):
    cfg, params = tiny
    records = small_trace(cfg.vocab_size)
    engine = make_engine(cfg, params)
    a = replay(engine, records)
    b = replay(engine, records)
    assert a.requests == b.requests == len(records)
    assert a.generated_tokens == b.generated_tokens > 0
    assert len(a.streams) == len(records)
    assert all(toks for _, toks in a.streams)
    # byte-identical greedy streams and exactly reproducible
    # virtual-clock TTFT/latency
    assert a.token_digest == b.token_digest
    assert a.ttft_s == b.ttft_s and a.latency_s == b.latency_s
    assert a.ticks == b.ticks and a.virtual_s == b.virtual_s
    # a FRESH engine over the same weights reproduces the digest too
    c = replay(make_engine(cfg, params), records)
    assert c.token_digest == a.token_digest


def test_replay_summary_uses_pooled_p10_not_wall(tiny):
    cfg, params = tiny
    engine = make_engine(cfg, params)
    records = small_trace(cfg.vocab_size)
    res = replay(engine, records)
    s = res.summary()
    assert s["tick_p10_wall_s"] == round(sorted(res.tick_wall_s)[
        int(0.10 * (len(res.tick_wall_s) - 1))], 6)
    assert s["decode_tok_s_p10"] == pytest.approx(
        res.generated_tokens / (s["tick_p10_wall_s"] * res.ticks), rel=1e-3)
    assert s["ttft_p99_s"] is not None and s["token_digest"]


# ---------------------------------------------------------------------------
# profiler: compile attribution, per-variant time, induced-fault alert
# ---------------------------------------------------------------------------
def test_profiler_attributes_compiles_and_costs(tiny):
    cfg, params = tiny
    engine = make_engine(cfg, params)
    records = small_trace(cfg.vocab_size)
    replay(engine, records)
    prof = engine.obs.profiler
    assert prof.compiles_total > 0                 # cold replay compiles
    assert prof.compiles_post_warm == 0            # ...but none post-warm
    cost = prof.cost_report()
    assert cost                                    # one entry per variant
    assert sum(c["compiles"] for c in cost.values()) == len(cost)
    for label, entry in cost.items():
        assert label.startswith("unified_step[C=")
        assert entry["calls"] >= entry["compiles"] == 1
        # the CPU step is synchronous: host wall time, never device_ms
        assert entry["host_ms_p50"] > 0 and entry["host_ms_total"] > 0
        assert not any(k.startswith("device_ms") for k in entry)


def test_induced_recompile_alert_lands_in_trace_export(tiny, tmp_path):
    cfg, params = tiny
    engine = make_engine(cfg, params)
    records = small_trace(cfg.vocab_size)
    # warm until a replay mints no new compile cell
    for _ in range(4):
        replay(engine, records)
        if engine.obs.profiler.compiles_total == 0:
            break
    assert engine.obs.profiler.compiles_total == 0
    # the induced fault: a prompt wider than any seen mints a new
    # chunk-width bucket after the warmup boundary
    wide = [TraceRecord(arrival_s=0.0, prompt=list(range(1, 31)),
                        max_new_tokens=3)]
    res = replay(engine, records + wide, reset=False)
    prof = engine.obs.profiler
    assert prof.compiles_post_warm > 0
    kinds = {a["kind"] for a in res.alerts}
    assert RECOMPILE in kinds
    # the alert is in the schema-validated Chrome export, alongside the
    # engine-config metadata stamp
    path = tmp_path / "fault.trace.json"
    engine.obs.timeline.export(str(path))
    doc = json.loads(path.read_text())
    validate_chrome_trace(doc)
    alert_events = [e for e in doc["traceEvents"]
                    if e.get("name") == f"alert:{RECOMPILE}"]
    assert alert_events and alert_events[0]["ph"] == "i"
    assert "post-warmup recompile" in alert_events[0]["args"]["message"]
    assert "C=32" in alert_events[0]["args"]["message"]
    compile_spans = [e for e in doc["traceEvents"]
                     if e.get("name") == "jit_compile"]
    assert compile_spans
    assert doc["otherData"]["engine_config"]["kv_dtype"] == "float32"


def test_engine_config_stamp_reaches_metrics_and_trace(tiny):
    cfg, params = tiny
    engine = make_engine(cfg, params, speculate_k=0)
    stamp = engine.obs.engine_config
    for key in ("kv_dtype", "compute_dtype", "speculate_k", "bank_size",
                "num_slots", "num_pages", "page_size", "token_budget",
                "policy", "device"):
        assert key in stamp, key
    assert stamp["kv_dtype"] == "float32" and stamp["speculate_k"] == 0
    assert stamp["device"] == "cpu"
    m = engine.metrics()
    assert m["config"] == stamp
    assert m["profiler"]["compiles_total"] == 0
    doc = engine.obs.timeline.to_chrome()
    meta_events = [e for e in doc["traceEvents"]
                   if e.get("ph") == "M"
                   and e.get("name") == "engine_config"]
    assert meta_events and meta_events[0]["args"]["kv_dtype"] == "float32"


def test_pinned_traces_are_loadable_and_self_describing():
    names = sorted(f[:-len(".jsonl")] for f in os.listdir(TRACES)
                   if f.endswith(".jsonl"))
    assert names == ["bursty_multiclass", "decode_heavy", "shared_prefix"]
    for name in names:
        records, meta = load_trace(os.path.join(TRACES, f"{name}.jsonl"))
        assert records, name
        assert meta["name"] == name
        # the meta must carry everything an engine is built from
        for key in ("arch", "slots", "pages", "page_size", "max_prompt",
                    "gen", "budget", "prefix_cache", "speculate_k",
                    "kv_dtype"):
            assert key in meta, (name, key)
        assert all(r.max_new_tokens <= meta["gen"] for r in records)
        assert all(len(r.prompt) <= meta["max_prompt"] for r in records)


# ---------------------------------------------------------------------------
# the same files and digests as the JAX package
# ---------------------------------------------------------------------------
def test_trace_files_and_digests_equal_jax(tmp_path):
    from repro.serving import observability as jax_obs
    rng = np.random.default_rng(12)
    recs = [dict(arrival_s=float(t), prompt=[int(x) for x in
                                            rng.integers(0, 512, n)],
                 max_new_tokens=int(g),
                 slo_class=["default", "interactive"][i % 2],
                 ensemble="mean_logit" if i % 3 == 0 else None,
                 submodel_id=i % 2 if i % 4 == 1 else None,
                 session=f"s{i}" if i % 5 == 0 else None)
            for i, (t, n, g) in enumerate(zip(
                np.cumsum(rng.exponential(0.1, 12)),
                rng.integers(3, 30, 12), rng.integers(2, 9, 12)))]
    meta = {"arch": "qwen3-1.7b", "tick_dt": 0.01, "slots": 4}
    mine, ref = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    save_trace(str(mine), [TraceRecord(**r) for r in recs], meta)
    jax_obs.save_trace(str(ref), [jax_obs.TraceRecord(**r) for r in recs],
                       meta)
    assert mine.read_bytes() == ref.read_bytes()
    # each package reads the other's file
    got, gmeta = load_trace(str(ref))
    jgot, jmeta = jax_obs.load_trace(str(mine))
    assert gmeta == jmeta == meta
    assert [r.as_dict() for r in got] == [r.as_dict() for r in jgot]
    streams = [(i, [int(x) for x in rng.integers(0, 512, int(n))])
               for i, n in enumerate(rng.integers(0, 20, 30))]
    assert stream_digest(streams) == jax_obs.stream_digest(streams)
    for path in sorted(os.listdir(TRACES)):
        p = os.path.join(TRACES, path)
        a, am = load_trace(p)
        b, bm = jax_obs.load_trace(p)
        assert am == bm and [r.as_dict() for r in a] == \
            [r.as_dict() for r in b]


# ---------------------------------------------------------------------------
# the serve CLI: record on the CPU, replay twice
# ---------------------------------------------------------------------------
def _serve(*argv):
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp")}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--device", "cpu", *argv], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_serve_cli_records_and_replays_with_one_digest(tmp_path):
    trace = tmp_path / "t.jsonl"
    out = _serve("--requests", "5", "--gen", "6", "--stream", "batch",
                 "--record-trace", str(trace), "--stats-every", "2",
                 "--slo-class", "default:0.5:5")
    assert f"recorded 5 requests -> {trace}" in out
    assert re.search(r"\[tick \d+\] ", out)         # --stats-every line
    assert "SLO [default] attainment" in out
    assert out.rstrip().splitlines()[-1].startswith("alerts:")
    records, meta = load_trace(str(trace))
    assert len(records) == 5 and meta["arch"] == "qwen3-1.7b"
    assert meta["device"] == "cpu"
    digests = []
    for i in range(2):
        chrome = tmp_path / f"replay{i}.json"
        # no --arch: the header carries it
        out = _serve("--replay", str(trace), "--trace-out", str(chrome))
        digests.append(re.search(r"digest ([0-9a-f]{64})", out).group(1))
        assert "alerts:" in out and "host ms p50" in out
        assert "compiles:" not in out               # no post-warm compile
        doc = json.loads(chrome.read_text())
        assert validate_chrome_trace(doc) > 0
        assert doc["otherData"]["engine_config"]["device"] == "cpu"
    assert digests[0] == digests[1]


@pytest.mark.cuda
def test_profiler_times_cuda_calls_with_events():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the events time the card's stream")
    prof = StepProfiler()
    a = torch.randn(1024, 1024, device="cuda")
    step = prof.wrap("mm", lambda x: x @ x, device="cuda")
    for _ in range(4):
        step(a)
    torch.cuda.synchronize()
    prof.drain()
    (label, entry), = prof.cost_report().items()
    assert entry["calls"] == 4 and entry["compiles"] == 1
    assert len(prof._variants[("mm", ((1024, 1024),), ())].samples) == 4
    assert entry["device_ms_p50"] > 0 and entry["device_ms_total"] > 0
    assert not any(k.startswith("host_ms") for k in entry)
