"""The port's serving engine against the JAX package's.

Greedy token streams must be identical to the JAX ``Engine``'s on the setup
of ``tests/test_serving_engine.py::test_engine_matches_dense_decode`` (the
same weights, carried over with ``load_jax_flat``), and preemption must not
change a stream.  The pool and scheduler unit tests of that file, and the
engine-level prefix-cache checks of ``tests/test_prefix_cache.py``, run
against the port's copies.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import get_model_config as jax_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.configs.base import get_model_config, reduced  # noqa: E402
from repro_torch.core.steps import make_page_copy_step  # noqa: E402
from repro_torch.models.params import load_jax_flat  # noqa: E402
from repro_torch.serving import (Engine, EngineConfig, FCFSScheduler,  # noqa
                                 PagePool, PagePoolOOM, Request)

ARCHS = ["qwen3-1.7b", "gemma2-27b", "qwen1.5-4b", "gemma3-4b"]


def counting_clock():
    t = [0.0]

    def clk():
        t[0] += 1.0
        return t[0]
    return clk


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX params, port cfg, port model), reduced."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_reduced(jax_config(arch))
        params = jax_api.model_init(jax.random.key(0), jcfg)
        flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
                in jax.tree_util.tree_leaves_with_path(params)}
        tcfg = reduced(get_model_config(arch))
        out[arch] = (jcfg, params, tcfg,
                     load_jax_flat(flat, tcfg, device="cpu"))
    return out


def _serve(engine, prompts, max_new):
    for p in prompts:
        engine.submit(p, max_new)
    fin = engine.run(clock=counting_clock())
    return {r.id: list(r.out_tokens) for r in fin}


@pytest.mark.parametrize("budget", [256, 3, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_match_jax_engine(models, arch, budget):
    """2 slots, 3 requests (the third joins mid-flight), f32 pools and
    compute with the config's bf16 residual stream, as in the JAX test;
    budgets 3 and 5 split prompts across ticks.  Identical tokens."""
    jcfg, params, tcfg, model = models[arch]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, jcfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 11, 3)]
    kw = dict(num_slots=2, num_pages=32, page_size=8, max_prompt_len=16,
              max_new_tokens=4, token_budget=budget, policy="on_demand",
              kv_dtype="float32", compute_dtype="float32")
    want = _serve(JaxEngine(jcfg, params, JaxEngineConfig(**kw)), prompts, 4)
    eng = Engine(tcfg, model, EngineConfig(**kw), device="cpu")
    got = _serve(eng, prompts, 4)
    assert got == want
    eng.pool.check_invariants()
    assert eng.pool.used_pages == 0
    assert all(r.t_first_token is not None and r.t_done is not None
               for r in eng.sched.finished)


def _tight_or_roomy(cfg, model, num_pages, temperature=0.0):
    eng = Engine(cfg, model,
                 EngineConfig(num_slots=2, num_pages=num_pages, page_size=4,
                              max_prompt_len=8, max_new_tokens=8,
                              token_budget=16, policy="on_demand",
                              kv_dtype="float32", compute_dtype="float32",
                              temperature=temperature),
                 device="cpu")
    prompts = [np.arange(1, 9, dtype=np.int32),
               np.arange(1, 6, dtype=np.int32)]
    return eng, _serve(eng, prompts, 8)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preempted_request_output_is_byte_identical(models, temperature):
    """6 allocatable pages squeeze the pool, the younger sequence is
    preempted and re-prefilled, and its stream does not change, greedy or
    sampled (every draw is keyed by its request and step, not by the
    tick).  The roomy run also equals the JAX engine's."""
    jcfg, params, cfg, model = models["qwen3-1.7b"]
    tight, got = _tight_or_roomy(cfg, model, 7, temperature)
    assert tight.preemptions >= 1, "pool was never squeezed"
    tight.pool.check_invariants()
    assert tight.pool.used_pages == 0
    roomy, want = _tight_or_roomy(cfg, model, 64, temperature)
    assert roomy.preemptions == 0
    assert got == want, f"preemption changed output: {got} != {want}"
    jeng = JaxEngine(jcfg, params, JaxEngineConfig(
        num_slots=2, num_pages=64, page_size=4, max_prompt_len=8,
        max_new_tokens=8, token_budget=16, policy="on_demand",
        kv_dtype="float32", compute_dtype="float32",
        temperature=temperature))
    assert _serve(jeng, [np.arange(1, 9, dtype=np.int32),
                         np.arange(1, 6, dtype=np.int32)], 8) == want


def _prefix_engine(cfg, model, **kw):
    base = dict(num_slots=3, num_pages=64, page_size=8, max_prompt_len=32,
                max_new_tokens=5, token_budget=32, policy="on_demand",
                kv_dtype="float32", compute_dtype="float32")
    return Engine(cfg, model, EngineConfig(**{**base, **kw}), device="cpu")


def test_solo_prefix_hit_is_byte_identical(models):
    _, _, cfg, model = models["qwen3-1.7b"]
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (20,))
    cold = _prefix_engine(cfg, model, prefix_cache=False)
    want = _serve(cold, [prompt], 5)[0]
    warm = _prefix_engine(cfg, model, prefix_cache=True)
    r1 = warm.submit(prompt, 5)
    warm.run()
    r2 = warm.submit(prompt, 5)
    warm.run()
    assert list(r1.out_tokens) == list(r2.out_tokens) == want
    # 20-token prompt, 8-token pages, last token never cached: 2 full pages
    assert r2.num_cached_tokens == 16 and warm.stats.cache_hit_tokens == 16
    warm.pool.check_invariants()
    assert warm.pool.used_pages == 0 and warm.pool.cached_pages > 0


def test_live_pages_shared_across_concurrent_requests(models):
    _, _, cfg, model = models["qwen3-1.7b"]
    prompt = np.random.default_rng(4).integers(1, cfg.vocab_size, (17,))
    eng = _prefix_engine(cfg, model, prefix_cache=True, num_slots=2)
    r1 = eng.submit(prompt, 5)
    while not r1.out_tokens:                     # prefill + publish
        eng.step()
    r2 = eng.submit(prompt, 5)
    eng.run()
    assert r2.num_cached_tokens == 16
    assert list(r1.out_tokens) == list(r2.out_tokens)
    eng.pool.check_invariants()


def test_decode_is_one_tick_per_token(models):
    _, _, cfg, model = models["qwen3-1.7b"]
    eng = _prefix_engine(cfg, model, prefix_cache=True)
    _serve(eng, [np.arange(1, 9, dtype=np.int32)], 5)
    # 1 prefill tick (records token 1) + 4 decode ticks
    assert eng.stats.steps <= 6, f"{eng.stats.steps} ticks for 5 tokens"
    assert eng.stats.prefill_tokens == 8


@pytest.mark.parametrize("stream,long_frac", [("poisson", 0.0),
                                              ("batch", 0.25)])
def test_make_requests_draws_match_jax(stream, long_frac):
    """The same request stream as the JAX launcher for the same seed."""
    from repro.launch.serve import make_requests as jax_make_requests
    from repro_torch.launch.serve import make_requests

    kw = dict(stream=stream, max_prompt=64, gen=16, long_frac=long_frac)
    want = jax_make_requests(12, 512, np.random.default_rng(3), **kw)
    got = make_requests(12, 512, np.random.default_rng(3), **kw)
    assert len(got) == len(want)
    for (t0, p0, g0), (t1, p1, g1) in zip(got, want):
        assert t0 == t1 and g0 == g1 and np.array_equal(p0, p1)


def test_page_copy_duplicates_pages_in_every_layer():
    cache = [(torch.arange(4 * 3.).reshape(4, 3),
              torch.arange(4 * 3.).reshape(4, 3) + 100) for _ in range(2)]
    want = [tuple(p.clone() for p in pools) for pools in cache]
    make_page_copy_step()(cache, torch.tensor([2, 0]), torch.tensor([3, 0]))
    for (k, v), (k0, v0) in zip(cache, want):
        assert torch.equal(k[3], k0[2]) and torch.equal(v[3], v0[2])
        assert torch.equal(k[:3], k0[:3]) and torch.equal(v[:3], v0[:3])


def test_copy_on_write_copies_the_shared_page(models):
    """A write into a page another table maps swaps in a fresh page whose
    K/V bytes are the old page's, in every layer."""
    _, _, cfg, model = models["qwen3-1.7b"]
    eng = _prefix_engine(cfg, model, prefix_cache=True)
    req = eng.submit(np.arange(1, 13, dtype=np.int32), 5)
    while not req.out_tokens:
        eng.step()
    old = eng.pool.table(req.id)
    eng.pool.fork(req.id, 999)                   # a second holder
    eng._prepare_entry_write(req, 8, 12)         # writes into page 1
    new = eng.pool.table(req.id)
    assert new[0] == old[0] and new[1] != old[1]
    assert eng.stats.cow_page_copies == 1
    for pools in eng.cache:
        for pool in pools:
            assert torch.equal(pool[new[1]], pool[old[1]])
    eng.pool.free_seq(999)
    eng.run()
    eng.pool.check_invariants()


# ---------------------------------------------------------------------------
# page pool (ported from tests/test_serving_engine.py)
# ---------------------------------------------------------------------------
def test_pool_alloc_free_roundtrip():
    pool = PagePool(num_pages=9, page_size=4)
    t1 = pool.alloc(1, 10)          # 3 pages
    t2 = pool.alloc(2, 4)           # 1 page
    pool.check_invariants()
    assert len(t1) == 3 and len(t2) == 1
    assert pool.used_pages == 4 and pool.free_pages == 4
    assert pool.utilization() == pytest.approx(0.5)
    assert 0 not in t1 + t2         # null page never handed out
    pool.free_seq(1)
    pool.check_invariants()
    assert pool.used_pages == 1
    pool.free_seq(2)
    assert pool.used_pages == 0 and pool.free_pages == 8


def test_pool_oom_leaves_allocation_intact():
    pool = PagePool(num_pages=5, page_size=4)   # 4 allocatable
    pool.alloc(1, 12)                           # 3 pages
    with pytest.raises(PagePoolOOM):
        pool.alloc(2, 8)                        # needs 2, only 1 free
    pool.check_invariants()
    assert pool.num_seqs == 1
    pool.alloc(2, 4)
    pool.check_invariants()


def test_pool_ensure_grows_on_demand():
    pool = PagePool(num_pages=6, page_size=2)
    pool.alloc(7, 2)
    assert len(pool.table(7)) == 1
    pool.ensure(7, 3)                           # crosses page boundary
    assert len(pool.table(7)) == 2
    pool.ensure(7, 3)                           # idempotent
    assert len(pool.table(7)) == 2
    pool.check_invariants()


def test_pool_double_alloc_rejected():
    pool = PagePool(num_pages=6, page_size=2)
    pool.alloc(1, 2)
    with pytest.raises(ValueError):
        pool.alloc(1, 2)
    with pytest.raises(ValueError):
        pool.alloc_pages(1, 1)


def test_pool_alloc_pages():
    pool = PagePool(num_pages=6, page_size=2)
    t = pool.alloc_pages(1, 3)
    assert len(t) == 3 and 0 not in t
    pool.check_invariants()
    with pytest.raises(PagePoolOOM):
        pool.alloc_pages(2, 3)                      # only 2 free
    assert pool.num_seqs == 1
    pool.check_invariants()
    pool.free_seq(1)
    assert pool.free_pages == 5


# ---------------------------------------------------------------------------
# scheduler (ported from tests/test_serving_engine.py)
# ---------------------------------------------------------------------------
def _req(i, plen, max_new=4):
    return Request(id=i, prompt=np.zeros(plen, np.int32),
                   max_new_tokens=max_new)


def test_scheduler_fcfs_admission_and_eviction():
    pool = PagePool(num_pages=64, page_size=4)
    sched = FCFSScheduler(2, pool, policy="reserve")
    for i in range(4):
        sched.submit(_req(i, plen=4))
    admitted = sched.admit(now=0.0)
    assert [r.id for r in admitted] == [0, 1]
    assert not sched.admit(now=0.0)
    for t in range(4):
        sched.record_token(admitted[0].slot, 11, now=1.0)
    done = sched.evict_finished(now=2.0)
    assert [r.id for r in done] == [0]
    pool.check_invariants()
    joined = sched.admit(now=3.0)
    assert [r.id for r in joined] == [2]
    assert {r.id for r in sched.running.values()} == {1, 2}


def test_scheduler_no_head_of_line_bypass():
    pool = PagePool(num_pages=4, page_size=4)       # 3 allocatable pages
    sched = FCFSScheduler(4, pool, policy="reserve")
    sched.submit(_req(0, plen=12, max_new=4))       # needs 4 pages > 3 free
    sched.submit(_req(1, plen=1, max_new=1))        # would fit, must wait
    assert sched.admit(now=0.0) == []
    assert [r.id for r in sched.waiting] == [0, 1]


def test_scheduler_reserve_policy_never_grows():
    pool = PagePool(num_pages=16, page_size=2)
    sched = FCFSScheduler(1, pool, policy="reserve")
    req = _req(0, plen=3, max_new=5)
    sched.submit(req)
    sched.admit(now=0.0)
    before = len(pool.table(0))
    for _ in range(5):
        sched.record_token(req.slot, 1, now=0.0)
        pool.ensure(req.id, req.context_len)
    assert len(pool.table(0)) == before


def test_scheduler_preempt_youngest_to_queue_head():
    pool = PagePool(num_pages=64, page_size=4)
    sched = FCFSScheduler(3, pool, policy="on_demand")
    for i in range(3):
        sched.submit(_req(i, plen=4))
    sched.admit(now=0.0)
    sched.submit(_req(3, plen=4))
    for slot, r in sched.running.items():
        sched.record_token(slot, 7, now=1.0)
        r.prefill_pos = r.prompt_len
    victim = sched.preempt_youngest()
    assert victim.id == 2
    assert victim.slot is None and victim.prefill_pos == 0
    assert victim.num_preemptions == 1 and sched.preemptions == 1
    assert [r.id for r in sched.waiting] == [2, 3]
    pool.check_invariants()
    assert victim.id not in pool._tables
    assert list(victim.kv_tokens) == list(victim.prompt)
    sched.record_token(sched.admit(now=2.0)[0].slot, 8, now=2.0)
    assert sched.preempt_youngest() is not None
    assert sched.preempt_youngest() is not None
    assert sched.preempt_youngest() is None         # sole survivor protected


def test_request_kv_tokens_carries_generated_prefix():
    req = _req(0, plen=3, max_new=8)
    req.out_tokens = [11, 12, 13]
    assert req.num_kv_tokens == 5
    assert list(req.kv_tokens) == [0, 0, 0, 11, 12]
    assert req.in_prefill
    req.prefill_pos = 5
    assert not req.in_prefill
