"""Replay parity: the port's engine against the JAX engine on the same
traces, the same weights and the same virtual clock.

``observability.replay`` drives an engine on a virtual clock, so the
greedy token streams, the tick count, TTFT and latency are functions of
the trace alone.  Replaying ``small_trace`` (as in
``tests/test_replay.py``) and the three pinned traces under
``benchmarks/traces/`` through ``repro.serving.Engine`` and
``repro_torch.serving.Engine`` holds the scheduler, the page pool, the
prefix cache with copy-on-write, speculation at K 4, SLO scoring and the
paged step against the reference at once.  Each pinned trace's engine is
built from its header meta the way the JAX package's regression harness
builds it (reduced config, f32 pools and compute, the draft of
``launch/serve.py::build_draft`` at the meta's ``draft_keep``); the
port's weights are the JAX weights carried over by ``load_jax_flat``.

The comparison runs in f32 end to end (``reduced(..., dtype="float32")``,
so the residual stream is f32 too) and every digest, tick count, TTFT,
latency, accept rate, SLO report and lifecycle event is equal outright.
At the regression harness's exact config (the reduced config's default
bf16 residual stream, f32 pools and compute) two pinned traces are equal
outright as well; ``decode_heavy`` parts at one named near-tie: draft call
6 (tick 26), request 2, third proposal, where the draft's top-2 logits
differ by 0.0078125, one bf16 ulp at 1.0 (port 403 over 306, JAX 306).
``test_decode_heavy_at_harness_dtype_parts_only_at_a_bf16_tie`` holds it
to that.

On a mismatch the assertion names the first diverging (virtual time,
request, event kind), not only the digest.  Whether the digests also
equal the pins in ``BENCH_serving.json["replay"]`` is printed, for
information only (the JAX engine no longer reproduces those pins either).
"""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs.base import get_model_config as jax_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.launch.serve import build_draft as jax_build_draft  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving.observability import Telemetry as JaxTelemetry  # noqa
from repro.serving.observability import TraceRecord as JaxRecord  # noqa
from repro.serving.observability import load_trace as jax_load  # noqa
from repro.serving.observability import parse_slo_class as jax_slo  # noqa
from repro.serving.observability import replay as jax_replay  # noqa: E402
from repro_torch.configs.base import get_model_config, reduced
from repro_torch.launch.serve import build_draft
from repro_torch.models.params import load_jax_flat
from repro_torch.serving import Engine, EngineConfig, Telemetry
from repro_torch.serving.observability import (TraceRecord, load_trace,
                                               parse_slo_class, replay)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACES = os.path.join(ROOT, "benchmarks", "traces")
PINNED = ("bursty_multiclass", "decode_heavy", "shared_prefix")


def carry(jcfg, cfg):
    params = jax_api.model_init(jax.random.key(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
            in jax.tree_util.tree_leaves_with_path(params)}
    return jcfg, params, cfg, load_jax_flat(flat, cfg, device="cpu")


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, JAX params, port cfg, port params) at the pinned traces'
    size: reduced qwen3-1.7b from ``key(0)``, as the regression harness
    builds it but in f32 end to end (``dtype="float32"``), the port's
    weights carried over from JAX's."""
    return carry(jax_reduced(jax_config("qwen3-1.7b"), dtype="float32"),
                 reduced(get_model_config("qwen3-1.7b"), dtype="float32"))


@pytest.fixture(scope="module")
def harness_weights():
    """The same at the regression harness's exact config: the reduced
    config's default bf16 residual stream."""
    return carry(jax_reduced(jax_config("qwen3-1.7b")),
                 reduced(get_model_config("qwen3-1.7b")))


def engine_kw(meta: dict) -> dict:
    """EngineConfig fields from a trace header, as the JAX package's
    ``benchmarks/regression.py::build_engine`` reads them."""
    psize = int(meta["page_size"])
    return dict(
        num_slots=int(meta["slots"]), num_pages=int(meta["pages"]),
        page_size=psize,
        max_prompt_len=-(-int(meta["max_prompt"]) // psize) * psize,
        max_new_tokens=int(meta["gen"]),
        token_budget=max(int(meta["budget"]), int(meta["slots"])),
        seed=int(meta.get("seed", 0)),
        policy=meta.get("policy", "on_demand"),
        prefix_cache=bool(meta.get("prefix_cache", True)),
        speculate_k=int(meta.get("speculate_k", 0)),
        kv_dtype=meta.get("kv_dtype", "float32"),
        compute_dtype=meta.get("compute_dtype", "float32"))


def build_pair(weights, meta: dict):
    """The JAX engine and the port's for one trace meta."""
    jcfg, jparams, cfg, params = weights
    kw = engine_kw(meta)
    draft_kw = dict(speculate=kw["speculate_k"], draft_circuit=0,
                    draft_keep=float(meta.get("draft_keep", 0.875)),
                    mask_block=16, seed=kw["seed"])
    slo = meta.get("slo_classes", [])
    jeng = JaxEngine(
        jcfg, jparams, JaxEngineConfig(**kw),
        draft=jax_build_draft(jcfg, jparams, None, **draft_kw),
        telemetry=JaxTelemetry(timeline=True, trace_maxlen=None,
                               slo_classes=[jax_slo(s) for s in slo]))
    peng = Engine(
        cfg, params, EngineConfig(**kw),
        draft=build_draft(cfg, params, None, **draft_kw), device="cpu",
        telemetry=Telemetry(timeline=True, trace_maxlen=None,
                            slo_classes=[parse_slo_class(s) for s in slo]))
    return jeng, peng


def events(engine) -> dict:
    """req id -> [(t, kind, data)] of every finished request's trace."""
    return {tr.req_id: [(e.t, e.kind, dict(e.data)) for e in tr.events]
            for tr in engine.obs.tracer.finished}


def first_divergence(jev: dict, pev: dict) -> str:
    """The earliest (virtual time, request, event) where the two engines'
    lifecycle traces part, or '' when they agree."""
    first = None
    for rid in sorted(set(jev) | set(pev)):
        a, b = jev.get(rid, []), pev.get(rid, [])
        for i in range(max(len(a), len(b))):
            ea = a[i] if i < len(a) else None
            eb = b[i] if i < len(b) else None
            if ea != eb:
                t = min(e[0] for e in (ea, eb) if e is not None)
                if first is None or t < first[0]:
                    first = (t, rid, ea, eb)
                break
    if first is None:
        return ""
    t, rid, ea, eb = first
    return (f"first divergence at virtual t={t} (tick "
            f"{round(t / 0.01)}), request {rid}: JAX {ea} vs port {eb}")


def compare(jres, pres, jeng, peng) -> None:
    why = first_divergence(events(jeng), events(peng))
    assert not why, why
    assert pres.token_digest == jres.token_digest
    assert pres.streams == jres.streams
    assert pres.ticks == jres.ticks
    assert pres.generated_tokens == jres.generated_tokens
    assert pres.ttft_s == jres.ttft_s
    assert pres.latency_s == jres.latency_s
    assert pres.accept_rate == jres.accept_rate
    assert pres.virtual_s == jres.virtual_s
    assert peng.obs.slo.report() == jeng.obs.slo.report()
    assert peng.stats.spec_drafted == jeng.stats.spec_drafted
    assert peng.preemptions == jeng.preemptions


def small_trace(vocab, n=6, seed=9):
    """``tests/test_replay.py::small_trace``, as records of both
    packages."""
    rng = np.random.default_rng(seed)
    recs = [dict(arrival_s=0.004 * i,
                 prompt=list(rng.integers(1, vocab,
                                          int(rng.integers(4, 12)))),
                 max_new_tokens=int(rng.integers(3, 7)))
            for i in range(n)]
    return [JaxRecord(**r) for r in recs], [TraceRecord(**r) for r in recs]


def test_small_trace_replay_matches_jax_engine(weights):
    # the engine of tests/test_replay.py::make_engine
    jcfg, jparams, cfg, params = weights
    kw = dict(num_slots=3, num_pages=64, page_size=8, max_prompt_len=32,
              max_new_tokens=6, token_budget=32, policy="on_demand",
              kv_dtype="float32", compute_dtype="float32")
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**kw),
                     telemetry=JaxTelemetry(timeline=True))
    peng = Engine(cfg, params, EngineConfig(**kw), device="cpu",
                  telemetry=Telemetry(timeline=True))
    jrecs, precs = small_trace(cfg.vocab_size)
    jres, pres = jax_replay(jeng, jrecs), replay(peng, precs)
    assert pres.generated_tokens > 0
    compare(jres, pres, jeng, peng)


@pytest.mark.parametrize("name", PINNED)
def test_pinned_trace_replay_matches_jax_engine(weights, name):
    path = os.path.join(TRACES, f"{name}.jsonl")
    precs, meta = load_trace(path)
    jrecs, jmeta = jax_load(path)
    assert meta == jmeta
    assert [r.as_dict() for r in precs] == [r.as_dict() for r in jrecs]
    tick_dt = float(meta.get("tick_dt", 0.01))
    jeng, peng = build_pair(weights, meta)
    jres = jax_replay(jeng, jrecs, tick_dt=tick_dt)
    pres = replay(peng, precs, tick_dt=tick_dt)
    compare(jres, pres, jeng, peng)
    if meta.get("speculate_k"):
        assert pres.accept_rate > 0
    with open(os.path.join(ROOT, "BENCH_serving.json")) as f:
        pin = json.load(f)["replay"][name]
    print(f"{name}: port digest {pres.token_digest[:16]} == JAX engine's; "
          f"== BENCH_serving.json pin {pin['token_digest'][:16]}: "
          f"{pres.token_digest == pin['token_digest']} (ticks "
          f"{pres.ticks} vs pinned {pin['ticks']})")


def pinned(name):
    path = os.path.join(TRACES, f"{name}.jsonl")
    precs, meta = load_trace(path)
    return jax_load(path)[0], precs, meta


@pytest.mark.parametrize("name", ["bursty_multiclass", "shared_prefix"])
def test_pinned_trace_at_harness_dtype_matches_jax_engine(harness_weights,
                                                          name):
    jrecs, precs, meta = pinned(name)
    jeng, peng = build_pair(harness_weights, meta)
    compare(jax_replay(jeng, jrecs), replay(peng, precs), jeng, peng)


def test_decode_heavy_at_harness_dtype_parts_only_at_a_bf16_tie(
        harness_weights, monkeypatch):
    """With a bf16 residual stream the draft's logits are bf16, and the
    two packages' f32 sums round to neighbouring bf16 values now and
    then.  The replays must agree draft for draft up to the first draft
    proposal that differs, and there the port's top-2 draft logits must be
    within one bf16 ulp (2^-7 at magnitude [1, 2)): a tie, not a fault."""
    from repro.serving.speculative import DraftRunner as JaxDraftRunner
    from repro_torch.core import steps as S
    from repro_torch.serving.speculative import DraftRunner
    proposals = {"jax": [], "port": []}
    logits, capturing = [], [False]

    def record(cls, tag):
        orig = cls.propose

        def propose(self, units, k, key):
            capturing[0] = tag == "port"
            if capturing[0]:
                logits.append([])
            try:
                drafts, q = orig(self, units, k, key)
            finally:
                capturing[0] = False
            proposals[tag].append({s: [int(t) for t in drafts[s, :k]]
                                   for s, _ in units})
            return drafts, q
        monkeypatch.setattr(cls, "propose", propose)

    record(JaxDraftRunner, "jax")
    record(DraftRunner, "port")
    paged_step = S.api.paged_step

    def capture(*a, **kw):
        out = paged_step(*a, **kw)
        if capturing[0]:
            logits[-1].append(out[0].float())
        return out
    monkeypatch.setattr(S.api, "paged_step", capture)

    jrecs, precs, meta = pinned("decode_heavy")
    jeng, peng = build_pair(harness_weights, meta)
    jax_replay(jeng, jrecs)
    replay(peng, precs)
    call = next(i for i, (a, b) in enumerate(zip(proposals["jax"],
                                                 proposals["port"]))
                if a != b)
    a, b = proposals["jax"][call], proposals["port"][call]
    slot = next(s for s in a if a[s] != b[s])
    j = next(i for i, (x, y) in enumerate(zip(a[slot], b[slot])) if x != y)
    top = logits[call][j][slot].topk(2)
    gap = float(top.values[0] - top.values[1])
    print(f"decode_heavy at the harness dtype: first differing draft call "
          f"{call}, slot {slot}, proposal {j}: JAX {a[slot][j]} port "
          f"{b[slot][j]}, the port's top-2 draft logit gap {gap}")
    assert a[slot][:j] == b[slot][:j]
    assert set(top.indices.tolist()) == {a[slot][j], b[slot][j]}
    assert gap <= 2.0 ** -7 * float(top.values[0].abs().clamp(min=1.0))
