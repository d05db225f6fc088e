"""The port's multi-submodel serving against the JAX package's.

A port of ``tests/test_model_bank.py`` (bank masks, materialize, the
router, per-owner pool accounting, routed decode against a dedicated
one-circuit engine, ensembles against a dense per-circuit reference,
preemption, the incremental block-table sync) and of the ensemble cases of
``tests/test_prefix_cache.py``, run on the port's modules on the CPU.
Beside them, the port against the JAX package itself: the bank's masks
bit for bit for the same seed, and routed, ensemble and sampled token
streams identical to the JAX engine's in f32 on the same weights
(``load_jax_flat``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import HornConfig as JaxHorn  # noqa: E402
from repro.configs.base import get_model_config as jax_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.core.steps import make_ctx  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ModelBank as JaxBank  # noqa: E402
from repro.serving import Router as JaxRouter  # noqa: E402
from repro_torch.configs.base import HornConfig, get_model_config, reduced
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.models.params import load_jax_flat
from repro_torch.serving import (Engine, EngineConfig, ModelBank,
                                 PagePool, Router)

HORN = HornConfig(enabled=True, keep_hidden=0.5, keep_input=1.0,
                  block_size=16)
JHORN = JaxHorn(enabled=True, keep_hidden=0.5, keep_input=1.0,
                block_size=16)


def _cfg(**over):
    # float32 end to end so masked-parent vs materialized and paged vs
    # dense comparisons are exact or tight
    return reduced(get_model_config("qwen3-1.7b"), dtype="float32", **over)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port model): reduced qwen3-1.7b in
    f32, the port's weights carried over from JAX's."""
    jcfg = jax_reduced(jax_config("qwen3-1.7b"), dtype="float32")
    params = jax_api.model_init(jax.random.key(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
            in jax.tree_util.tree_leaves_with_path(params)}
    cfg = _cfg()
    return jcfg, params, cfg, load_jax_flat(flat, cfg, device="cpu")


def _clock():
    return iter(np.arange(1e6)).__next__


def _serve_masks_for(bank, ids):
    """Host-side gather of per-slot masks (what the unified step does on
    the device) for the dense reference forwards."""
    ids = np.asarray(ids)
    return {k: torch.from_numpy(v[ids]) for k, v in bank.masks.items()}


# ---------------------------------------------------------------------------
# bank construction
# ---------------------------------------------------------------------------
def test_bank_masks_shapes_determinism_and_liveness():
    cfg = _cfg()
    bank = ModelBank(cfg, HORN, 4, seed=3)
    assert set(bank.masks) == {"ffn"}            # keep_input=1 -> no input mask
    m = bank.masks["ffn"]
    assert m.shape == (4, cfg.num_layers, cfg.d_ff)
    assert set(np.unique(m)) <= {0.0, 1.0}
    # every circuit keeps >= 1 live block in every layer (stays connected)
    assert (m.sum(-1) > 0).all()
    # circuits are distinct and the draw is deterministic in the seed
    assert any(not np.array_equal(m[0], m[g]) for g in range(1, 4))
    again = ModelBank(cfg, HORN, 4, seed=3)
    assert np.array_equal(m, again.masks["ffn"])
    assert not np.array_equal(m, ModelBank(cfg, HORN, 4, seed=4).masks["ffn"])
    # subset re-indexes rows without redrawing
    sub = bank.subset([2])
    assert sub.num_submodels == 1
    assert np.array_equal(sub.masks["ffn"][0], m[2])
    fr = bank.kept_fractions()["ffn"]
    assert len(fr) == 4 and all(0 < f <= 1 for f in fr)


def test_bank_input_and_head_masks_when_configured():
    cfg = _cfg()
    horn = HornConfig(enabled=True, keep_hidden=0.5, keep_input=0.75,
                      block_size=16, mask_attention_heads=True)
    bank = ModelBank(cfg, horn, 3)
    assert set(bank.masks) == {"ffn", "input", "heads"}
    assert bank.masks["input"].shape == (3, cfg.d_model)
    assert bank.masks["heads"].shape == (3, cfg.num_layers, cfg.num_heads)
    assert (bank.masks["heads"].sum(-1) > 0).all()


@pytest.mark.parametrize("seed", [0, 1, 3, 2 ** 31 - 1])
@pytest.mark.parametrize("horn", [
    dict(keep_hidden=0.5, keep_input=1.0, block_size=16),
    dict(keep_hidden=0.5, keep_input=0.75, block_size=16,
         mask_attention_heads=True),
    dict(keep_hidden=0.25, keep_input=0.8, block_size=4, seed_salt=17),
], ids=["ffn", "ffn-input-heads", "block4-salt17"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-27b",
                                  "phi3.5-moe-42b"])
def test_bank_masks_equal_jax_bit_for_bit(arch, horn, seed):
    """The port's threefry draw gives JAX's ``ModelBank`` masks exactly,
    for every masked axis, and the same device tensors with the dense
    sentinel row appended."""
    jb = JaxBank(jax_reduced(jax_config(arch), dtype="float32"),
                 JaxHorn(enabled=True, **horn), 3, seed=seed)
    tb = ModelBank(reduced(get_model_config(arch), dtype="float32"),
                   HornConfig(enabled=True, **horn), 3, seed=seed)
    assert set(tb.masks) == set(jb.masks)
    for k, v in jb.masks.items():
        assert np.array_equal(tb.masks[k], v), k
    dev = tb.device_masks("cpu")
    for k, v in jb.device_masks().items():
        assert dev[k].dtype == torch.float32
        assert np.array_equal(dev[k].numpy(), np.asarray(v)), k
    assert tb.device_masks("cpu") is dev          # cached
    assert tb.device_bytes() == sum(t.numel() * 4 for t in dev.values())


def test_bank_rejects_ssm_arch():
    cfg = reduced(get_model_config("mamba2-2.7b"))
    with pytest.raises(ValueError, match="attention"):
        ModelBank(cfg, HORN, 2)


def test_bank_rejects_no_masked_axis():
    with pytest.raises(ValueError, match="no masked axes"):
        ModelBank(_cfg(), HornConfig(enabled=True, keep_hidden=1.0,
                                     keep_input=1.0), 2)


def test_moe_serve_masks_wait_for_moe_layers(model):
    """A "moe" serve mask reaches the MoE layers' expert hidden units: the
    port's prefill of reduced phi3.5-moe under a bank's "moe" rows equals
    the JAX prefill under the same rows (1e-4, f32).  A bank over an MoE
    config still cannot materialize, as in the JAX package."""
    _, _, cfg, params = model
    jmoe = jax_reduced(jax_config("phi3.5-moe-42b"), dtype="float32")
    jparams = jax_api.model_init(jax.random.key(1), jmoe)
    moe = reduced(get_model_config("phi3.5-moe-42b"), dtype="float32")
    mparams = load_jax_flat(
        {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
         jax.tree_util.tree_leaves_with_path(jparams)}, moe, device="cpu")
    bank = ModelBank(moe, HORN, 2)
    assert "moe" in bank.masks
    tok = np.random.default_rng(2).integers(1, moe.vocab_size, (2, 7))
    rows = {"moe": torch.from_numpy(bank.masks["moe"][[1, 0]])}
    got, _ = api.prefill(mparams, {"tokens": torch.from_numpy(tok)}, moe,
                         serve_masks=rows)
    want, _, _ = jax_api.prefill(
        jparams, {"tokens": jax.numpy.asarray(tok, jax.numpy.int32)}, jmoe,
        make_ctx(jmoe, None),
        serve_masks={"moe": jax.numpy.asarray(rows["moe"].numpy())})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    plain, _ = api.prefill(mparams, {"tokens": torch.from_numpy(tok)}, moe)
    assert not torch.allclose(got, plain)         # the mask did something
    with pytest.raises(ValueError, match="FFN-only|MoE"):
        bank.materialize(0, params)


# ---------------------------------------------------------------------------
# materialize: small weights == masked parent (the paper's memory claim)
# ---------------------------------------------------------------------------
def test_materialize_matches_masked_parent_logits(model):
    """Each circuit's physically smaller model gives the masked parent's
    logits (1e-4, f32), and the masked parent gives JAX's (1e-4)."""
    jcfg, jparams, cfg, params = model
    bank = ModelBank(cfg, HORN, 2, seed=1)
    jbank = JaxBank(jcfg, JHORN, 2, seed=1)
    rng = np.random.default_rng(0)
    tok = rng.integers(1, cfg.vocab_size, (2, 12))
    tokens = torch.from_numpy(tok)
    for g in range(2):
        small_cfg, small_params = bank.materialize(g, params)
        assert small_cfg.d_ff < cfg.d_ff          # physically smaller
        assert small_params.layers[0].mlp.wi.shape[1] == small_cfg.d_ff
        want, _ = api.prefill(params, {"tokens": tokens}, cfg,
                              serve_masks=_serve_masks_for(bank, [g, g]))
        got, _ = api.prefill(small_params, {"tokens": tokens}, small_cfg)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)
        jm = {k: jax.numpy.asarray(v[[g, g]]) for k, v in jbank.masks.items()}
        jwant, _, _ = jax_api.prefill(jparams, {"tokens": jax.numpy.asarray(
            tok, jax.numpy.int32)}, jcfg, make_ctx(jcfg, None),
            serve_masks=jm)
        np.testing.assert_allclose(want.numpy(), np.asarray(jwant),
                                   atol=1e-4, rtol=1e-4)
    draft = bank.draft_model(1, params)
    assert draft.circuit == 1 and 0 < draft.kept_frac < 1
    assert draft.cfg.d_ff == bank.materialize(1, params)[0].d_ff
    assert params.layers[0].mlp.wi.shape[1] == cfg.d_ff   # parent untouched


def test_materialize_rejects_non_ffn_masks(model):
    _, _, cfg, params = model
    horn = HornConfig(enabled=True, keep_hidden=0.5, keep_input=0.75,
                      block_size=16)
    bank = ModelBank(cfg, horn, 2)
    with pytest.raises(ValueError, match="FFN-only"):
        bank.materialize(0, params)
    with pytest.raises(ValueError, match="not in bank"):
        ModelBank(cfg, HORN, 2).materialize(2, params)


@pytest.mark.parametrize("key", ["input", "heads"])
def test_input_and_head_serve_masks_match_jax(model, key):
    """The "input" mask multiplies the embeddings and the "heads" mask
    mixes into the head mask, as in the JAX forward (1e-4, f32)."""
    jcfg, jparams, cfg, params = model
    horn = dict(keep_hidden=0.5, keep_input=0.75, block_size=16,
                mask_attention_heads=True)
    bank = ModelBank(cfg, HornConfig(enabled=True, **horn), 2, seed=5)
    jbank = JaxBank(jcfg, JaxHorn(enabled=True, **horn), 2, seed=5)
    tok = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 9))
    got, _ = api.prefill(params, {"tokens": torch.from_numpy(tok)}, cfg,
                         serve_masks={key: torch.from_numpy(
                             bank.masks[key][[0, 1]])})
    want, _, _ = jax_api.prefill(
        jparams, {"tokens": jax.numpy.asarray(tok, jax.numpy.int32)}, jcfg,
        make_ctx(jcfg, None),
        serve_masks={key: jax.numpy.asarray(jbank.masks[key][[0, 1]])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    plain, _ = api.prefill(params, {"tokens": torch.from_numpy(tok)}, cfg)
    assert not torch.allclose(got, plain)         # the mask did something


# ---------------------------------------------------------------------------
# router (ported from tests/test_model_bank.py)
# ---------------------------------------------------------------------------
def test_router_least_loaded_balances_and_releases():
    r = Router(3, policy="least_loaded")
    assert [r.route() for _ in range(3)] == [0, 1, 2]
    r.release(1)
    assert r.route() == 1                        # refills the gap
    assert r.loads == [1, 1, 1]
    with pytest.raises(ValueError):
        r.release(2)
        r.release(2)                             # more releases than routes


def test_router_hash_affinity_is_stable():
    r = Router(4, policy="hash")
    a = r.route(session="user-a")
    assert all(r.route(session="user-a") == a for _ in range(5))
    p = np.asarray([5, 6, 7], np.int32)
    g = r.route(prompt=p)
    assert r.route(prompt=p.copy()) == g         # prompt-bytes fallback
    with pytest.raises(ValueError):
        r.route()                                # nothing to hash
    # the same circuit as the JAX router for the same keys
    j = JaxRouter(4, policy="hash")
    for key in ("user-a", "user-b", 17):
        assert Router(4, policy="hash").route(session=key) == \
            j.route(session=key)
    assert Router(4, policy="hash").route(prompt=p) == j.route(prompt=p)


def test_router_explicit_and_validation():
    r = Router(2, policy="explicit")
    assert r.route(submodel_id=1) == 1
    with pytest.raises(ValueError):
        r.route()                                # explicit needs an id
    with pytest.raises(ValueError):
        r.route(submodel_id=7)
    # explicit id overrides any policy
    assert Router(4, policy="least_loaded").route(submodel_id=3) == 3
    with pytest.raises(ValueError, match="unknown policy"):
        Router(2, policy="random")
    r.acquire(0)
    assert r.stats() == {"policy": "explicit", "loads": {0: 1, 1: 1},
                         "routed": {0: 1, 1: 1}}


# ---------------------------------------------------------------------------
# pool owner accounting (ported from tests/test_model_bank.py)
# ---------------------------------------------------------------------------
def test_pool_utilization_by_owner():
    pool = PagePool(num_pages=9, page_size=4)
    pool.alloc_pages(0, 3, owner=0)
    pool.alloc_pages(1, 2, owner=1)
    pool.alloc_pages(2, 1, owner=0)
    by = pool.utilization_by_owner()
    assert by[0] == 4 / 8 and by[1] == 2 / 8
    assert pool.pages_by_owner() == {0: 4, 1: 2}
    assert sum(pool.pages_by_owner().values()) == pool.used_pages
    assert sum(by.values()) == pool.utilization()
    pool.check_invariants()
    pool.free_seq(0)
    pool.free_seq(2)
    assert 0 not in pool.utilization_by_owner()
    pool.check_invariants()


def test_pool_utilization_by_owner_exact_on_awkward_capacity():
    pool = PagePool(num_pages=8, page_size=4)
    for seq in range(7):
        pool.alloc_pages(seq, 1, owner="tenant")
    by = pool.utilization_by_owner()
    assert by == {"tenant": 1.0}
    assert sum(by.values()) == pool.utilization() == 1.0
    assert sum(pool.pages_by_owner().values()) == pool.used_pages == 7
    pool.check_invariants()


def test_pool_shared_page_attributed_once():
    pool = PagePool(num_pages=9, page_size=4, prefix_cache=True)
    pool.alloc_pages(0, 2, owner=0)
    pool.fork(0, 1, owner=1)                     # shares both pages
    pool.alloc_pages(2, 1, owner=1)
    assert pool.pages_by_owner() == {0: 2, 1: 1}
    assert sum(pool.pages_by_owner().values()) == pool.used_pages == 3
    assert sum(pool.utilization_by_owner().values()) == pool.utilization()
    pool.check_invariants()


# ---------------------------------------------------------------------------
# routed decode == dedicated engine == the JAX engine
# ---------------------------------------------------------------------------
ENGINE_KW = dict(num_pages=64, page_size=8, max_prompt_len=16,
                 max_new_tokens=5, token_budget=16, policy="on_demand",
                 kv_dtype="float32", compute_dtype="float32")


def _engine(cfg, params, bank, *, slots=2, temperature=0.0, router=None,
            draft=None, **kw):
    return Engine(cfg, params,
                  EngineConfig(num_slots=slots, temperature=temperature,
                               **{**ENGINE_KW, **kw}),
                  bank=bank, router=router, draft=draft, device="cpu")


def _jax_engine(jcfg, jparams, jbank, *, slots=2, temperature=0.0,
                router=None, draft=None, **kw):
    return JaxEngine(jcfg, jparams,
                     JaxEngineConfig(num_slots=slots, temperature=temperature,
                                     **{**ENGINE_KW, **kw}),
                     bank=jbank, router=router, draft=draft)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_routed_decode_byte_identical_to_dedicated_engine(model,
                                                          temperature):
    """A request routed through the multi-submodel engine (co-batched with
    another circuit's request in the same ticks) emits exactly the tokens
    a dedicated one-circuit engine gives, greedy and sampled, and the JAX
    engine's."""
    jcfg, jparams, cfg, params = model
    bank = ModelBank(cfg, HORN, 2, seed=1)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (6, 9)]

    multi = _engine(cfg, params, bank, temperature=temperature,
                    router=Router(2, policy="explicit"))
    reqs = [multi.submit(p, 5, submodel_id=g)
            for g, p in enumerate(prompts)]
    multi.run(clock=_clock())
    got = {r.submodel_id: list(r.out_tokens) for r in reqs}
    assert multi.stats.ticks_cobatched >= 1      # >= 2 circuits in a tick
    assert multi.stats.cobatch_ratio > 0
    assert set(multi.stats.tokens_by_submodel) == {0, 1}
    assert multi.stats.peak_util_by_submodel.keys() == {0, 1}
    assert multi.router.loads == [0, 0]          # released on finish
    multi.pool.check_invariants()
    assert multi.pool.used_pages == 0

    for g, p in enumerate(prompts):
        ded = _engine(cfg, params, bank.subset([g]), temperature=temperature,
                      router=Router(1, policy="explicit"))
        ded._next_id = reqs[g].id                # same (request, step) keys
        r = ded.submit(p, 5, submodel_id=0)
        ded.run(clock=_clock())
        assert list(r.out_tokens) == got[g], \
            f"submodel {g} diverged: {r.out_tokens} != {got[g]}"

    jeng = _jax_engine(jcfg, jparams, JaxBank(jcfg, JHORN, 2, seed=1),
                       temperature=temperature,
                       router=JaxRouter(2, policy="explicit"))
    jreqs = [jeng.submit(p, 5, submodel_id=g) for g, p in enumerate(prompts)]
    jeng.run(clock=_clock())
    assert {r.submodel_id: list(r.out_tokens) for r in jreqs} == got


def test_single_tenant_engine_unaffected_by_bank_plumbing(model):
    """No bank: the engine must not require (or accept) routing args."""
    _, _, cfg, params = model
    eng = _engine(cfg, params, None)
    with pytest.raises(ValueError, match="ModelBank"):
        eng.submit(np.asarray([1, 2], np.int32), 2, submodel_id=1)
    with pytest.raises(ValueError, match="ModelBank"):
        eng.submit(np.asarray([1, 2], np.int32), 2, ensemble="mean_logit")
    with pytest.raises(ValueError, match="ModelBank"):
        Engine(cfg, None, EngineConfig(), router=Router(2), device="cpu")


def test_engine_checks_bank_and_router(model):
    _, _, cfg, params = model
    bank = ModelBank(cfg, HORN, 2)
    other = ModelBank(_cfg(d_ff=64), HORN, 2)
    with pytest.raises(ValueError, match="built for"):
        _engine(cfg, params, other)
    with pytest.raises(ValueError, match="router spans 3"):
        _engine(cfg, params, bank, router=Router(3))
    eng = _engine(cfg, params, bank)
    assert eng.router.policy == "least_loaded"   # the default router
    with pytest.raises(ValueError, match="unknown combine"):
        eng.submit(np.arange(1, 4), 2, ensemble="median")
    with pytest.raises(ValueError, match="conflict"):
        eng.submit(np.arange(1, 4), 2, ensemble="mean_logit", submodel_id=0)
    with pytest.raises(ValueError, match="needs 2 slots"):
        _engine(cfg, params, bank, slots=1, token_budget=16).submit(
            np.arange(1, 4), 2, ensemble="mean_logit")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_bank_circuit_draft_serves_routed_requests(model, temperature):
    """A circuit of the serving bank drafts for requests routed over all
    its circuits (each verified under its own circuit's masks): the same
    streams and acceptance as the JAX engine's, greedy and sampled, and
    greedy the same streams as without speculation."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (6, 11, 8)]
    kw = dict(slots=3, temperature=temperature)
    bank = ModelBank(cfg, HORN, 3, seed=1)
    jbank = JaxBank(jcfg, JHORN, 3, seed=1)
    engines = [
        _engine(cfg, params, bank, router=Router(3, policy="explicit"),
                speculate_k=3, draft=bank.draft_model(2, params), **kw),
        _jax_engine(jcfg, jparams, jbank,
                    router=JaxRouter(3, policy="explicit"), speculate_k=3,
                    draft=jbank.draft_model(2, jparams), **kw),
        _engine(cfg, params, ModelBank(cfg, HORN, 3, seed=1),
                router=Router(3, policy="explicit"), **kw)]
    out = []
    for e in engines:
        rs = [e.submit(p, 5, submodel_id=g) for g, p in enumerate(prompts)]
        e.run(clock=_clock())
        out.append([(r.submodel_id, list(r.out_tokens)) for r in rs])
    assert out[0] == out[1]
    if temperature == 0.0:
        assert out[0] == out[2]
    eng, jeng = engines[:2]
    assert eng.stats.spec_drafted == jeng.spec_drafted > 0
    assert eng.stats.spec_accepted == jeng.spec_accepted
    assert eng.stats.spec_committed == jeng.spec_committed
    assert eng.spec.draft.circuit == 2 and eng.router.loads == [0] * 3


def test_int8_pools_serve_a_bank(model):
    """Int8 pools work with a bank, as in the JAX engine: the same routed
    streams as the JAX engine's int8 path."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 10, 7)]
    kw = dict(kv_dtype="int8", slots=3)
    eng = _engine(cfg, params, ModelBank(cfg, HORN, 3, seed=2), **kw)
    jeng = _jax_engine(jcfg, jparams, JaxBank(jcfg, JHORN, 3, seed=2), **kw)
    out = []
    for e in (eng, jeng):
        rs = [e.submit(p, 5) for p in prompts]
        e.run(clock=_clock())
        out.append([(r.submodel_id, list(r.out_tokens)) for r in rs])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# ensembles: on-device combine vs a dense per-circuit reference
# ---------------------------------------------------------------------------
def _dense_reference_ensemble(cfg, params, bank, prompt, max_new, combine):
    """Host-side oracle of an ensemble's shared-context semantics: the
    prompt context [0, L - 1) encoded once by the dense parent; each
    circuit encodes the last prompt token and its decode tail through its
    own masked FFNs; per-step logits combined (mean-logit argmax, or a
    majority vote over member argmaxes, ties to the lowest id) and the
    combined token fed back to every circuit."""
    G = bank.num_submodels
    L = len(prompt)
    buf = T.init_cache(cfg, 1, L + max_new, dtype=torch.float32,
                       device="cpu")
    if L > 1:
        _, shared = api.prefill(
            params, {"tokens": torch.tensor([prompt[:-1]])}, cfg)
        for (kb, vb), (k, v) in zip(buf, shared):
            kb[:, :L - 1] = k
            vb[:, :L - 1] = v
    caches = [[tuple(t.clone() for t in e) for e in buf] for _ in range(G)]

    def pick(step_logits):
        if combine == "mean_logit":
            return int(np.argmax(np.mean(step_logits, axis=0)))
        votes = np.bincount([int(np.argmax(lg)) for lg in step_logits],
                            minlength=cfg.vocab_size)
        return int(np.argmax(votes))

    toks = []
    feed = int(prompt[-1])
    for i in range(max_new):
        step_logits = []
        for g in range(G):
            lg, caches[g] = api.decode_step(
                params, caches[g], torch.tensor([[feed]]), L - 1 + i, cfg,
                serve_masks=_serve_masks_for(bank, [g]))
            step_logits.append(lg[0].numpy().astype(np.float32))
        toks.append(pick(step_logits))
        feed = toks[-1]
    return toks


@pytest.mark.parametrize("combine", ["mean_logit", "majority_vote"])
def test_ensemble_matches_dense_reference(model, combine):
    jcfg, jparams, cfg, params = model
    bank = ModelBank(cfg, HORN, 3, seed=2)
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, cfg.vocab_size, (7,)).astype(np.int32)
    max_new = 4
    want = _dense_reference_ensemble(cfg, params, bank,
                                     list(map(int, prompt)), max_new, combine)

    eng = _engine(cfg, params, bank, slots=3)
    group = eng.submit(prompt, max_new, ensemble=combine)
    eng.run(clock=_clock())
    for m in group.members:                      # one combined stream
        assert list(m.out_tokens) == want, \
            f"{combine}: {m.out_tokens} != {want}"
    assert group.finished
    assert eng.finished_streams() == [group.leader]
    eng.pool.check_invariants()
    assert eng.pool.used_pages == 0
    assert eng.router.loads == [0, 0, 0]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("combine", ["mean_logit", "majority_vote"])
def test_ensemble_and_solo_streams_match_jax_engine(model, combine,
                                                    temperature):
    """An ensemble co-batched with routed solo requests: every stream the
    JAX engine's, greedy and sampled (f32)."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (9, 5, 12)]
    kw = dict(slots=4, temperature=temperature, token_budget=24,
              max_prompt_len=16)
    eng = _engine(cfg, params, ModelBank(cfg, HORN, 3, seed=4), **kw)
    jeng = _jax_engine(jcfg, jparams, JaxBank(jcfg, JHORN, 3, seed=4), **kw)
    out = []
    for e in (eng, jeng):
        solo = e.submit(prompts[0], 5)
        group = e.submit(prompts[1], 5, ensemble=combine)
        late = e.submit(prompts[2], 4)
        e.run(clock=_clock())
        out.append((list(solo.out_tokens), list(group.out_tokens),
                    list(late.out_tokens), late.submodel_id,
                    e.prefill_tokens if e is jeng
                    else e.stats.prefill_tokens))
    assert out[0] == out[1]


def test_ensemble_group_survives_preemption_with_solo_traffic(model):
    """An ensemble group and a solo request squeezed into a tight pool:
    the group preempts and re-admits as one unit and everything drains,
    with the roomy engine's streams."""
    _, _, cfg, params = model
    bank = ModelBank(cfg, HORN, 2, seed=1)
    kw = dict(slots=3, page_size=4, max_prompt_len=8, max_new_tokens=6,
              token_budget=12)
    eng = _engine(cfg, params, bank, num_pages=8, **kw)
    roomy = _engine(cfg, params, bank, num_pages=64, **kw)
    prompt = np.arange(1, 7, dtype=np.int32)
    solo_p = np.arange(1, 8, dtype=np.int32)
    outs = {}
    for e in (eng, roomy):
        # solo first: the GROUP is the youngest unit and the preemption
        # victim; it must evict and re-admit as one lockstep unit
        solo = e.submit(solo_p, 6)
        g = e.submit(prompt, 6, ensemble="mean_logit")
        e.run(clock=_clock())
        outs[e] = (list(g.out_tokens), list(solo.out_tokens))
        assert len({tuple(m.out_tokens) for m in g.members}) == 1
        e.pool.check_invariants()
        assert e.pool.used_pages == 0
    assert eng.preemptions >= 1, "pool was never squeezed"
    assert outs[eng] == outs[roomy], "preemption changed ensemble output"


# ---------------------------------------------------------------------------
# ensemble prompt sharing (ported from tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------
SHARE_HORN = HornConfig(enabled=True, keep_hidden=0.5, keep_input=1.0,
                        block_size=4)


def _share_engine(cfg, params, *, prefix_cache, bank, temperature=0.0):
    return Engine(cfg, params,
                  EngineConfig(num_slots=3, num_pages=64, page_size=8,
                               max_prompt_len=32, max_new_tokens=5,
                               token_budget=32, temperature=temperature,
                               policy="on_demand", kv_dtype="float32",
                               compute_dtype="float32",
                               prefix_cache=prefix_cache),
                  bank=bank, router=Router(bank.num_submodels),
                  device="cpu")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("combine", ["mean_logit", "majority_vote"])
def test_ensemble_share_parity_and_prefill_savings(model, temperature,
                                                   combine):
    """With the prefix cache on, an ensemble emits the same combined
    stream as the per-member re-prefill path (greedy and sampled) while
    prefilling ~1/G of the tokens: the leader encodes the shared context
    once, members fork its pages and only their tails copy on write."""
    _, _, cfg, params = model
    G = 3
    bank = ModelBank(cfg, SHARE_HORN, G, seed=1)
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, cfg.vocab_size, (19,)).astype(np.int32)
    L = len(prompt)

    cold = _share_engine(cfg, params, prefix_cache=False, bank=bank,
                         temperature=temperature)
    gc = cold.submit(prompt, 5, ensemble=combine)
    cold.run()
    warm = _share_engine(cfg, params, prefix_cache=True, bank=bank,
                         temperature=temperature)
    gw = warm.submit(prompt, 5, ensemble=combine)
    warm.run()

    assert gw.out_tokens == gc.out_tokens
    for m in gw.members:
        assert list(m.out_tokens) == gw.out_tokens
    assert cold.stats.prefill_tokens == G * L
    assert warm.stats.prefill_tokens == (L - 1) + G
    assert warm.stats.prefill_tok_saved == (G - 1) * (L - 1)
    assert warm.stats.cow_page_copies == G - 1
    for eng in (cold, warm):
        eng.pool.check_invariants()
        assert eng.pool.used_pages == 0


def test_reserve_ensemble_fits_exactly_sized_pool(model):
    """An ensemble whose worst case exactly equals the pool's capacity
    serves without preemption under ``reserve`` (members COW the shared
    boundary page before the leader)."""
    _, _, cfg, params = model
    G = 3
    bank = ModelBank(cfg, SHARE_HORN, G, seed=1)
    prompt = np.random.default_rng(9).integers(
        1, cfg.vocab_size, (19,)).astype(np.int32)
    eng = Engine(cfg, params,
                 EngineConfig(num_slots=G, num_pages=6, page_size=8,
                              max_prompt_len=24, max_new_tokens=5,
                              token_budget=24, policy="reserve",
                              kv_dtype="float32", compute_dtype="float32",
                              prefix_cache=True),
                 bank=bank, router=Router(G), device="cpu")
    group = eng.submit(prompt, 5, ensemble="mean_logit")
    eng.run()
    assert group.finished and len(group.out_tokens) == 5
    assert eng.preemptions == 0, "reserve must never preempt"
    assert eng.stats.cow_page_copies == G - 1
    eng.pool.check_invariants()
    assert eng.pool.deferred_pages == 0


# ---------------------------------------------------------------------------
# incremental block-table sync (ported from tests/test_model_bank.py)
# ---------------------------------------------------------------------------
def test_block_table_sync_is_incremental(model):
    """Steady decode inside one page re-uploads no block-table row; only
    admissions, page-boundary growth and vacated slots sync."""
    _, _, cfg, params = model
    eng = Engine(cfg, params,
                 EngineConfig(num_slots=2, num_pages=8, page_size=16,
                              max_prompt_len=16, max_new_tokens=8,
                              token_budget=16, policy="reserve",
                              kv_dtype="float32", compute_dtype="float32"),
                 device="cpu")
    eng.submit(np.arange(1, 5, dtype=np.int32), 8)   # 4+8 tokens: 1 page
    eng.run(clock=_clock())
    assert eng.stats.steps >= 8
    assert eng.stats.bt_rows_synced == 1
    eng.submit(np.arange(1, 5, dtype=np.int32), 8)
    eng.run(clock=_clock())
    assert eng.stats.bt_rows_synced == 2


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def test_serve_cli_multi_submodel_sampled(capsys):
    """``launch/serve.py --submodels 3 --ensemble-frac 0.34 --temperature
    0.8`` at the reduced size on the CPU: every sequence finishes, done
    lines carry ``sub N`` tags and lockstep ensemble triplets, and the
    report ends with the co-batch ratio and tok/s per circuit."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "8", "--gen", "8",
                "--stream", "batch", "--submodels", "3", "--slots", "4",
                "--budget", "24", "--ensemble-frac", "0.34",
                "--temperature", "0.8"])
    out = capsys.readouterr().out
    done = [ln for ln in out.splitlines() if " done: " in ln]
    ens = [ln for ln in done if " ens " in ln]
    assert len(done) == 8 - len(ens) // 3 + len(ens)
    assert ens and len(ens) % 3 == 0
    assert all(" sub " in ln for ln in done)
    for g in range(3):
        assert f"sub{g}:" in out
    assert "co-batch ratio: " in out
    assert "temperature 0.8" in out


@pytest.mark.parametrize("argv", [["--speculate", "2"],
                                  ["--speculate", "2", "--submodels", "2"]])
def test_serve_cli_speculates(argv, capsys):
    """``--speculate 2`` on the dense parent (a draft-only bank at
    ``--draft-keep``) and over a bank of 2 circuits (circuit 0 drafts):
    every request finishes and the report prints the accept rate."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "4", "--gen", "6",
                "--stream", "batch", "--slots", "2", "--budget", "16"]
               + argv)
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines() if " done: " in ln]) == 4
    line = next(ln for ln in out.splitlines()
                if ln.startswith("speculative: accept rate "))
    assert "(K=2, circuit 0" in line and "draft calls 0" not in line
