"""The port's speculative decoding against the JAX package's.

A port of ``tests/test_speculative.py`` run on the port's engine on the
CPU (greedy speculative streams equal to non-speculative ones solo,
routed, under preemption, with the prefix cache, beside an ensemble, with
EOS inside a verify window; T > 0 reproducible; the budget split and its
pressure; the engine's validation; the draft materialized small).  Beside
them, the port against the JAX engine itself on the same weights
(``load_jax_flat``) in f32: speculative streams greedy and at T 0.8 (and
greedy on int8 pools) token for token with the same acceptance counts,
``DraftRunner.propose``'s drafts and distributions, and the verify alone
on seeded logits built so that every branch fires.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import HornConfig as JaxHorn  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.configs.base import get_model_config as jax_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.core import steps as JS  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ModelBank as JaxBank  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.speculative import DraftRunner as JaxDraftRunner  # noqa
from repro_torch.configs.base import HornConfig, get_model_config, reduced
from repro_torch.core import prng
from repro_torch.core import steps as S
from repro_torch.models import api
from repro_torch.models.params import load_jax_flat
from repro_torch.serving import (DraftRunner, Engine, EngineConfig,
                                 ModelBank, Request, Router,
                                 speculative_draft_len)

# a high-keep draft: with random weights, agreement (and so acceptance)
# tracks how much of the FFN the circuit keeps
KEEP = dict(enabled=True, keep_hidden=0.875, keep_input=1.0, block_size=16)
HORN, JHORN = HornConfig(**KEEP), JaxHorn(**KEEP)
ENGINE_KW = dict(num_slots=3, num_pages=64, page_size=4, max_prompt_len=32,
                 max_new_tokens=12, token_budget=24, policy="on_demand",
                 kv_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port model): reduced qwen3-1.7b in
    f32, the port's weights carried over from JAX's."""
    jcfg = jax_reduced(jax_config("qwen3-1.7b"), dtype="float32")
    params = jax_api.model_init(jax.random.key(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
            in jax.tree_util.tree_leaves_with_path(params)}
    cfg = reduced(get_model_config("qwen3-1.7b"), dtype="float32")
    return jcfg, params, cfg, load_jax_flat(flat, cfg, device="cpu")


@pytest.fixture(scope="module")
def draft(model):
    _, _, cfg, params = model
    return ModelBank(cfg, HORN, 1, seed=0).draft_model(0, params)


def mk(cfg, params, *, spec_k=0, draft=None, bank=None, router=None,
       **over):
    return Engine(cfg, params,
                  EngineConfig(**{**ENGINE_KW, "speculate_k": spec_k,
                                  **over}),
                  bank=bank, router=router, draft=draft, device="cpu")


def prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def outs(engine):
    return {r.id: list(r.out_tokens) for r in engine.sched.finished}


def drain(engine, reqs, gen=10, **kw):
    for p in reqs:
        engine.submit(p, gen, **kw)
    engine.run()
    return outs(engine)


# ---------------------------------------------------------------------------
# greedy: the speculative stream is the sequential stream
# ---------------------------------------------------------------------------
def test_greedy_solo_byte_identical_and_fewer_ticks(model, draft):
    _, _, cfg, params = model
    reqs = prompts(cfg.vocab_size, (7, 13, 5))
    base = mk(cfg, params)
    spec = mk(cfg, params, spec_k=4, draft=draft)
    assert drain(base, reqs) == drain(spec, reqs)
    # more than one committed token a speculating slot-tick, and strictly
    # fewer ticks than sequential decode
    assert spec.stats.accepted_tok_per_tick > 1.0
    assert spec.stats.spec_accepted > 0
    assert spec.stats.steps < base.stats.steps
    spec.pool.check_invariants()
    spec.spec.pool.check_invariants()
    assert spec.spec.pool.num_seqs == 0      # all draft state released
    assert spec.spec.stats()["live_seqs"] == 0
    # the draft's paged steps are counted apart from the parent's (0 on
    # the CPU, which runs the plain versions)
    assert spec.stats.draft_attn_launches == spec.stats.attn_launches == 0


def test_greedy_routed_byte_identical(model):
    _, _, cfg, params = model
    reqs = prompts(cfg.vocab_size, (7, 13, 5, 9))
    bank = ModelBank(cfg, HORN, 3, seed=0)
    base = mk(cfg, params, bank=ModelBank(cfg, HORN, 3, seed=0),
              router=Router(3, policy="explicit"))
    spec = mk(cfg, params, spec_k=4, bank=bank,
              router=Router(3, policy="explicit"),
              draft=bank.draft_model(0, params))
    for eng in (base, spec):
        for i, p in enumerate(reqs):
            eng.submit(p, 8, submodel_id=i % 3)
        eng.run()
    assert outs(base) == outs(spec)
    # drafts are verified under each slot's own circuit masks
    assert spec.stats.spec_drafted > 0
    assert spec.stats.accepted_tok_per_tick >= 1.0


def test_greedy_under_preemption_byte_identical(model, draft):
    # a pool tight enough that the speculating engine preempts too: the
    # rollback and the preempt paths must compose
    _, _, cfg, params = model
    reqs = prompts(cfg.vocab_size, (6, 9, 7, 8), seed=3)
    kw = dict(num_pages=12, max_prompt_len=16, token_budget=16,
              max_new_tokens=10)
    base = mk(cfg, params, **kw)
    spec = mk(cfg, params, spec_k=3, draft=draft, **kw)
    assert drain(base, reqs, gen=9) == drain(spec, reqs, gen=9)
    assert spec.preemptions > 0, "pool not tight enough to test preemption"
    spec.pool.check_invariants()
    assert spec.spec.pool.num_seqs == 0


def test_greedy_with_prefix_cache_and_shared_prompts(model, draft):
    # prefix-cache adoption and verify rollback interleave: truncated
    # draft tails never reach the publishable region, and cached pages
    # never leak into a verify chunk
    _, _, cfg, params = model
    rng = np.random.default_rng(5)
    system = rng.integers(1, cfg.vocab_size, (12,)).astype(np.int32)
    reqs = [np.concatenate([system,
                            rng.integers(1, cfg.vocab_size, (4 + i,))
                            .astype(np.int32)]) for i in range(3)]
    base = mk(cfg, params, prefix_cache=True)
    spec = mk(cfg, params, spec_k=4, draft=draft, prefix_cache=True)
    for eng in (base, spec):
        eng.submit(reqs[0], 10)
        eng.run()                  # publish the system prefix first
        for p in reqs[1:]:
            eng.submit(p, 10)
        eng.run()
    assert outs(base) == outs(spec)
    assert spec.stats.cache_hit_tokens > 0, \
        "shared prompts never hit the cache"
    spec.pool.check_invariants()


def test_greedy_cobatched_with_ensemble(model):
    # ensemble members decode in lockstep (never speculate) while a solo
    # slot of the same tick verifies drafts, in one call
    _, _, cfg, params = model
    bank = ModelBank(cfg, HORN, 3, seed=0)
    rng = np.random.default_rng(7)
    pe = rng.integers(1, cfg.vocab_size, (9,)).astype(np.int32)
    ps = rng.integers(1, cfg.vocab_size, (6,)).astype(np.int32)
    streams = []
    for spec_k in (0, 4):
        eng = mk(cfg, params, spec_k=spec_k,
                 bank=ModelBank(cfg, HORN, 3, seed=0), router=Router(3),
                 draft=bank.draft_model(0, params) if spec_k else None,
                 num_slots=5, num_pages=96, token_budget=40)
        g = eng.submit(pe, 8, ensemble="mean_logit")
        eng.submit(ps, 8)
        eng.run()
        streams.append((list(g.out_tokens), outs(eng)))
        if spec_k:
            assert eng.stats.spec_drafted > 0
    assert streams[0] == streams[1]


def test_eos_mid_verify_window_stops_exactly(model, draft):
    # an EOS the baseline emits mid-stream: the speculative engine stops
    # its commits at exactly that token
    _, _, cfg, params = model
    reqs = prompts(cfg.vocab_size, (7,), seed=1)
    stream = drain(mk(cfg, params), reqs)[0]
    eos = stream[len(stream) // 2]
    base = mk(cfg, params, eos_id=eos)
    spec = mk(cfg, params, spec_k=4, draft=draft, eos_id=eos)
    assert drain(base, reqs) == drain(spec, reqs)
    done = spec.sched.finished[0]
    assert done.out_tokens[-1] == eos
    assert eos not in done.out_tokens[:-1]


# ---------------------------------------------------------------------------
# temperature > 0: reproducible rejection sampling
# ---------------------------------------------------------------------------
def test_temperature_reproducible_and_clean(model, draft):
    _, _, cfg, params = model
    reqs = prompts(cfg.vocab_size, (7, 13, 5))
    runs = []
    for _ in range(2):
        eng = mk(cfg, params, spec_k=4, draft=draft, temperature=0.8)
        runs.append(drain(eng, reqs, gen=8))
        eng.pool.check_invariants()
        eng.spec.pool.check_invariants()
    assert runs[0] == runs[1], "same seeds must replay the same stream"
    assert eng.stats.spec_drafted > 0


def test_temperature_nonspec_path_unchanged_by_plumbing(model):
    # the S_v == 1 window at T > 0 is the classic (req_id, step) draw:
    # two fresh engines agree, and so does the JAX engine
    jcfg, jparams, cfg, params = model
    reqs = prompts(cfg.vocab_size, (7, 5))
    a = drain(mk(cfg, params, temperature=0.8), reqs, gen=6)
    b = drain(mk(cfg, params, temperature=0.8), reqs, gen=6)
    assert a == b
    jeng = JaxEngine(jcfg, jparams,
                     JaxEngineConfig(**{**ENGINE_KW, "temperature": 0.8}))
    assert drain(jeng, reqs, gen=6) == a


# ---------------------------------------------------------------------------
# budget accounting and validation
# ---------------------------------------------------------------------------
def test_speculative_budget_split():
    # each decode slot costs its pending token; the rest splits across
    # speculating slots, clamped to k and floored at plain decode
    assert speculative_draft_len(4, 24, 3, 3) == 4
    assert speculative_draft_len(4, 6, 3, 3) == 1
    assert speculative_draft_len(4, 3, 3, 3) == 0
    assert speculative_draft_len(4, 24, 3, 0) == 0
    assert speculative_draft_len(0, 24, 3, 3) == 0


def test_budget_pressure_degrades_gracefully(model, draft):
    # token_budget == num_slots: a full decode batch has no headroom (plain
    # decode ticks), but once slots free up the leftover budget drafts
    # again, identical throughout
    _, _, cfg, params = model
    reqs = prompts(cfg.vocab_size, (5, 7, 6))
    kw = dict(token_budget=3, num_slots=3)
    base = mk(cfg, params, **kw)
    spec = mk(cfg, params, spec_k=4, draft=draft, **kw)
    assert drain(base, reqs, gen=6) == drain(spec, reqs, gen=6)
    assert spec.stats.accepted_tok_per_tick >= 1.0


def test_engine_validates_draft_config(model, draft):
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="needs a DraftModel"):
        mk(cfg, params, spec_k=4)
    with pytest.raises(ValueError, match="speculate_k > 0"):
        mk(cfg, params, draft=draft)
    bad = dataclasses.replace(draft, cfg=dataclasses.replace(
        draft.cfg, vocab_size=cfg.vocab_size + 1))
    with pytest.raises(ValueError, match="vocab"):
        mk(cfg, params, spec_k=4, draft=bad)


def test_draft_model_is_materialized_small(model):
    # a low-keep circuit materializes at a smaller width (the high-keep
    # default may pad back to d_ff when a layer keeps every block)
    _, _, cfg, params = model
    half = HornConfig(enabled=True, keep_hidden=0.5, keep_input=1.0,
                      block_size=16)
    dm = ModelBank(cfg, half, 2, seed=0).draft_model(1, params)
    assert dm.cfg.d_ff < cfg.d_ff
    assert 0.0 < dm.kept_frac < 1.0
    assert dm.circuit == 1


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("temperature,kv_dtype", [
    (0.0, "float32"), (0.8, "float32"), (0.0, "int8")])
def test_speculative_streams_match_jax_engine(model, temperature, kv_dtype):
    """The same prompts through the port's speculating engine and the JAX
    engine's, with the same weights and draft circuit: identical streams
    token for token, and the same drafted, accepted and committed
    counts."""
    jcfg, jparams, cfg, params = model
    kw = {**ENGINE_KW, "speculate_k": 4, "temperature": temperature,
          "kv_dtype": kv_dtype}
    eng = Engine(cfg, params, EngineConfig(**kw),
                 draft=ModelBank(cfg, HORN, 1, seed=0).draft_model(0, params),
                 device="cpu")
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**kw),
                     draft=JaxBank(jcfg, JHORN, 1, seed=0).draft_model(
                         0, jparams))
    reqs = prompts(cfg.vocab_size, (7, 13, 5, 9), seed=4)
    got, want = drain(eng, reqs, gen=10), drain(jeng, reqs, gen=10)
    assert got == want
    assert eng.stats.spec_drafted == jeng.spec_drafted > 0
    assert eng.stats.spec_accepted == jeng.spec_accepted
    assert eng.stats.spec_committed == jeng.spec_committed
    assert eng.stats.steps == jeng.steps
    assert eng.spec.draft_calls == jeng.spec.draft_calls
    eng.spec.pool.check_invariants()
    assert eng.spec.pool.num_seqs == 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_draft_runner_propose_matches_jax(model, temperature):
    """``DraftRunner.propose`` on the same requests: the same drafts, and
    draft distributions within 1e-6, over a first proposal (a whole-prompt
    catch-up chunk) and a second after a partial accept."""
    jcfg, jparams, cfg, params = model
    kw = {**ENGINE_KW, "speculate_k": 4, "temperature": temperature}
    runner = DraftRunner(ModelBank(cfg, HORN, 1, seed=0).draft_model(
        0, params), EngineConfig(**kw), torch.device("cpu"))
    jrunner = JaxDraftRunner(JaxBank(jcfg, JHORN, 1, seed=0).draft_model(
        0, jparams), JaxEngineConfig(**kw))
    ps = prompts(cfg.vocab_size, (7, 11), seed=9)
    reqs, jreqs = [], []
    for i, p in enumerate(ps):
        for R, out in ((Request, reqs), (JaxRequest, jreqs)):
            r = R(id=10 + i, prompt=p, max_new_tokens=12)
            r.admit_seq, r.out_tokens = i, [int(p[0]), int(p[-1])]
            out.append(r)
    slots = (0, 2)                          # slot 1 does not draft
    for k, accepted in ((4, 2), (3, 0)):
        d, q = runner.propose(list(zip(slots, reqs)), k, prng.key(3))
        jd, jq = jrunner.propose(list(zip(slots, jreqs)), k,
                                 jax.random.key(3))
        assert d.shape == (3, k)
        np.testing.assert_array_equal(d[list(slots)],
                                      np.asarray(jd)[list(slots)])
        assert q.shape == np.asarray(jq).shape
        np.testing.assert_allclose(q.numpy()[list(slots)],
                                   np.asarray(jq)[list(slots)], atol=1e-6)
        if temperature > 0:
            np.testing.assert_allclose(q.sum(-1).numpy()[list(slots)], 1.0,
                                       atol=1e-5)
        for slot, r, jr in zip(slots, reqs, jreqs):
            # the verify's verdict: commit ``accepted`` drafts and a token
            new = [int(t) for t in d[slot, :accepted]] + [1]
            r.out_tokens += new
            jr.out_tokens += new
            runner.commit(r, accepted)
            jrunner.commit(jr, accepted)
            assert runner.pool.table(r.id) == jrunner.pool.table(jr.id)
    for r in reqs:
        runner.drop(r.id)
    runner.pool.check_invariants()
    assert runner.pool.num_seqs == 0 and runner.draft_calls == 2


def _verify_case(V=48, S_v=4, T=0.8, seed=0):
    """Seeded window logits [8, S_v, V], chunks, draft lengths and draft
    distributions built so that every branch of the verify fires: slot 0
    drafts the argmax and its q is half of p (all accepted, then the
    bonus), slot 1 a mismatch at its second draft with q one-hot on the
    least likely token (greedy correction; a rejection resample), slot 2
    drafts 2 of 3 (a slot clamped below the window), slot 3 does not
    speculate, slots 4-5 carry q = 2p unnormalized (accepted half the
    time; on rejection max(p - q, 0) vanishes and the resample falls back
    to p), slots 6-7 random q."""
    rng = np.random.default_rng(seed)
    B = 8
    logits = (rng.standard_normal((B, S_v, V)) * 2.0).astype(np.float32)
    lw = logits.astype(np.float64) / T
    p = np.exp(lw - lw.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = logits.argmax(-1)                            # [B, S_v]
    drafts = rng.integers(0, V, (B, S_v - 1))
    q = rng.dirichlet(np.ones(V), (B, S_v - 1))
    dl = np.array([3, 3, 2, 0, 3, 3, 3, 2])
    drafts[0] = top[0, :S_v - 1]
    q[0] = p[0, :S_v - 1] / 2
    drafts[1] = top[1, :S_v - 1]
    drafts[1, 1] = p[1, 1].argmin()
    q[1] = np.eye(V)[drafts[1]]
    drafts[2] = top[2, :S_v - 1]
    q[4:6] = 2 * p[4:6, :S_v - 1]
    tokens = np.zeros((B, S_v + 1), np.int32)        # a chunk bucket of 5
    tokens[:, 0] = rng.integers(0, V, B)
    tokens[:, 1:S_v] = drafts
    chunk_lens = np.where(dl > 0, dl + 1, 2).astype(np.int32)
    return {"logits": logits, "tokens": tokens, "chunk_lens": chunk_lens,
            "draft_lens": dl.astype(np.int32),
            "draft_probs": q.astype(np.float32),
            "req_ids": np.arange(B, dtype=np.int32) * 7 + 1,
            "sample_steps": np.array([3, 0, 5, 9, 1, 2, 4, 6], np.int32)}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_verify_matches_jax_on_seeded_logits(model, monkeypatch,
                                             temperature):
    """The unified step's verify alone: both steps see the same seeded
    window logits (``paged_step`` patched to return them) and the same
    chunks, draft lengths and draft distributions; ``sampled`` and
    ``accepted`` equal JAX's on every slot, across 6 root keys, and every
    branch fired: all drafts accepted with the bonus, a greedy mismatch,
    an accept and a rejection resample at T > 0, and the fallback of the
    residual to p."""
    jcfg, jparams, cfg, params = model
    case = _verify_case(T=temperature or 0.8)
    B, S_v = case["logits"].shape[:2]
    monkeypatch.setattr(jax_api, "paged_step", lambda *a, **kw: (
        jnp.asarray(case["logits"]), a[1]))
    monkeypatch.setattr(api, "paged_step", lambda *a, **kw: (
        torch.from_numpy(case["logits"]), a[1]))
    run = JaxRun(model=jcfg, shape=JaxShape("serve", "decode", 32, B),
                 horn=JaxHorn(enabled=False), compute_dtype="float32")
    jstep, _ = JS.make_unified_paged_step(run, None, num_pages=8,
                                          page_size=4,
                                          temperature=temperature,
                                          kv_dtype=jnp.float32)
    step = S.make_unified_paged_step(cfg, temperature=temperature)
    probs = case["draft_probs"] if temperature > 0 \
        else np.zeros((B, S_v - 1, 1), np.float32)
    ints = [case[k] for k in ("tokens", "chunk_lens")]
    per_slot = [case["req_ids"], case["sample_steps"],
                np.zeros(B, np.int32), np.arange(B, dtype=np.int32),
                np.zeros(B, np.int32), case["draft_lens"]]
    bt = np.zeros((B, 4), np.int32)
    starts = np.full(B, 6, np.int32)
    dl = case["draft_lens"]
    fired = set()
    for seed in range(6):
        jcache = JT.init_paged_cache(jcfg, 8, 4, dtype=jnp.float32)
        js, ja, _ = jstep(jparams, jcache, jnp.asarray(ints[0]),
                          jnp.asarray(starts), jnp.asarray(ints[1]),
                          jnp.asarray(bt),
                          *[jnp.asarray(x) for x in per_slot[:4]],
                          jnp.asarray(per_slot[4] > 0),
                          jnp.asarray(per_slot[5]), jnp.asarray(probs),
                          jax.random.key(seed))
        ts, ta = step(params, None, *[torch.from_numpy(x) for x in (
            ints[0], starts, ints[1], bt)],
            *[torch.from_numpy(x) for x in per_slot],
            torch.from_numpy(probs), prng.key(seed))
        js, ja = np.asarray(js), np.asarray(ja)
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(ta.numpy(), ja)
        assert ts.dtype == ta.dtype == torch.int32
        assert ja[3] == 0 and (ja <= dl).all()
        fired.update(
            f for f, hit in (("all+bonus", (ja == dl) & (dl > 0)),
                             ("rejected", ja < dl),
                             ("fallback", (ja < dl)[4:6].any()),
                             ("accept", (ja > 0)[4:8].any()))
            if np.any(hit))
        if temperature <= 0:
            break
    if temperature <= 0:
        assert ja[0] == 3 and ja[1] == 1 and ja[2] == 2
        assert fired >= {"all+bonus", "rejected"}
    else:
        assert ja[1] <= 1              # q one-hot on p's least likely token
        assert fired == {"all+bonus", "rejected", "fallback", "accept"}
