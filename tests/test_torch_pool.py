"""Pool-level tests of the port's ref-counted copy-on-write ``PagePool``
(``repro_torch/serving/kv_cache.py``), on which speculative decoding's
rollback (``truncate_seq``) and the draft pool rest.

A port of the pool-level tests of ``tests/test_prefix_cache.py`` (chain
hashes, double free, fork / COW, publish / match / LRU evict, the capped
match, the deferred promise, peek, the blocked head, the negative cache)
and of ``tests/test_pool_property.py`` (hypothesis: random interleavings
against ``check_invariants``, COW never touching shared pages, fork then a
partial rollback, the int8 round trip, scales travelling with copied
pages through the port's ``make_page_copy_step``, fork / truncate keeping
page ids), run against the port's modules.  The prefix hit rate of None
is the engine's: the last test holds the port's engine to it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.steps import make_page_copy_step
from repro_torch.optim.compression import dequantize_int8, quantize_int8
from repro_torch.serving import PagePool, PagePoolOOM, chain_hashes

P = 4  # pool-test page size

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


# ---------------------------------------------------------------------------
# content hashing, pool lifecycle, refcounts, fork, COW, publish / match /
# evict, lookups
# ---------------------------------------------------------------------------
def test_chain_hashes_pin_the_whole_prefix():
    a = chain_hashes(b"dense", np.arange(12), P)
    b = chain_hashes(b"dense", np.arange(12), P)
    assert a == b and len(a) == 3                # deterministic, full pages
    # a change in block 0 changes EVERY downstream hash (the chain)
    toks = np.arange(12)
    toks[0] += 1
    c = chain_hashes(b"dense", toks, P)
    assert all(x != y for x, y in zip(a, c))
    # same tokens under another namespace never collide
    d = chain_hashes(b"sub:1", np.arange(12), P)
    assert all(x != y for x, y in zip(a, d))
    # partial trailing block contributes no hash
    assert chain_hashes(b"dense", np.arange(11), P) == a[:2]


def test_double_free_raises_descriptive_error():
    pool = PagePool(num_pages=8, page_size=P)
    pool.alloc(7, 6)
    assert pool.free_seq(7) == 2
    with pytest.raises(ValueError, match="double free"):
        pool.free_seq(7)                         # not a bare KeyError
    with pytest.raises(ValueError, match="not allocated"):
        pool.free_seq(99)
    with pytest.raises(ValueError, match="not allocated"):
        pool.table(99)
    with pytest.raises(ValueError, match="not allocated"):
        pool.ensure(99, 4)
    pool.check_invariants()


def test_fork_shares_and_cow_isolates():
    pool = PagePool(num_pages=12, page_size=P, prefix_cache=True)
    t0 = list(pool.alloc(0, 8))
    pool.fork(0, 1)
    assert pool.table(1) == t0
    assert all(pool.refcount(p) == 2 for p in t0)
    pool.check_invariants()
    # writer 1 touches page 1 -> private copy; page 0 stays shared
    pairs = pool.prepare_write(1, P, 2 * P)
    assert len(pairs) == 1 and pairs[0][0] == t0[1]
    assert pool.table(0) == t0                   # victim table untouched
    assert pool.table(1)[0] == t0[0] and pool.table(1)[1] != t0[1]
    assert pool.refcount(t0[0]) == 2 and pool.refcount(t0[1]) == 1
    # the last holder writes in place: no copy
    assert pool.prepare_write(0, P, 2 * P) == []
    pool.check_invariants()
    pool.free_seq(0)
    pool.free_seq(1)
    assert pool.used_pages == 0
    pool.check_invariants()


def test_publish_match_lru_evict_roundtrip():
    pool = PagePool(num_pages=8, page_size=P, prefix_cache=True)
    toks = np.arange(3 * P, dtype=np.int32)
    hs = chain_hashes(b"dense", toks, P)
    t = list(pool.alloc(0, 3 * P))
    assert pool.publish_prefix(0, hs, 3) == 3
    # indexed while live: a concurrent request adopts at refcount 2
    hit = pool.match_pages(hs)
    assert hit == t
    pool.alloc_pages(1, 0, cached=hit)
    assert all(pool.refcount(p) == 2 for p in t)
    pool.check_invariants()
    pool.free_seq(0)
    pool.free_seq(1)
    # refcount 0 + published -> held by the cache, not freed
    assert pool.used_pages == 0 and pool.cached_pages == 3
    assert pool.match_pages(hs) == t             # still matchable
    # allocation pressure evicts LRU-first — deepest blocks retired first,
    # so the surviving entry is the shallow prefix page, still matchable
    # through the chain walk
    pool.alloc_pages(2, pool.free_pages + 2)
    assert pool.cached_pages == 1
    assert pool.match_pages(hs) == [t[0]]
    pool.check_invariants()


def test_match_is_capped_and_chained():
    pool = PagePool(num_pages=10, page_size=P, prefix_cache=True)
    toks = np.arange(3 * P, dtype=np.int32)
    hs = chain_hashes(b"dense", toks, P)
    pool.alloc(0, 3 * P)
    pool.publish_prefix(0, hs, 3)
    pages, n = pool.match_prefix(b"dense", toks)
    assert n == 3 * P and len(pages) == 3
    # a fresh prompt must keep its last token: cap excludes the final page
    pages, n = pool.match_prefix(b"dense", toks, max_tokens=3 * P - 1)
    assert n == 2 * P
    # divergence after page 0 matches exactly one page
    toks2 = toks.copy()
    toks2[P] += 1
    pages, n = pool.match_prefix(b"dense", toks2)
    assert n == P
    assert pool.match_prefix(b"sub:0", toks) == ([], 0)
    pool.free_seq(0)
    pool.check_invariants()


def test_deferred_promise_blocks_interlopers():
    pool = PagePool(num_pages=8, page_size=P)   # 7 allocatable
    pool.alloc_pages(0, 2, deferred=3)          # owns 2, promises 3 more
    assert pool.deferred_pages == 3
    with pytest.raises(PagePoolOOM):
        pool.alloc_pages(1, 3)                  # only 7-2-3=2 unpromised
    pool.alloc_pages(1, 2)
    pool.ensure(0, 5 * P)                       # redeems the promise
    assert pool.deferred_pages == 0
    pool.check_invariants()
    pool.free_seq(0)
    pool.free_seq(1)
    pool.check_invariants()


def test_peek_match_counts_nothing():
    pool = PagePool(num_pages=8, page_size=P, prefix_cache=True)
    toks = np.arange(2 * P, dtype=np.int32)
    hs = chain_hashes(b"dense", toks, P)
    t = list(pool.alloc(0, 2 * P))
    pool.publish_prefix(0, hs, 2)
    for _ in range(4):
        assert pool.match_pages(hs, peek=True) == t
    assert pool.cache.hits == 0 and pool.cache.misses == 0
    assert pool.match_pages(hs) == t             # committed lookup counts
    assert pool.cache.hits == 2 and pool.cache.misses == 0
    pool.free_seq(0)
    pool.check_invariants()


def test_blocked_head_replans_without_stat_or_lru_distortion():
    """The regression: a blocked FCFS head replans (and so re-probes the
    prefix cache) every tick; those feasibility peeks must not inflate the
    hit/miss counters or touch LRU recency — only the tick that actually
    adopts the pages commits one lookup."""
    from repro_torch.serving import FCFSScheduler, Request

    pool = PagePool(num_pages=10, page_size=P, prefix_cache=True)
    toks = np.arange(3 * P, dtype=np.int32)
    hs = chain_hashes(b"dense", toks, P)
    pool.alloc(100, 3 * P)
    pool.publish_prefix(100, hs, 3)
    pool.free_seq(100)                           # 3 cached, evictable pages
    lru_before = list(pool.cache.lru)
    pool.alloc_pages(101, pool.free_pages)       # a hog drains the free list
    sched = FCFSScheduler(2, pool, policy="on_demand")
    prompt = np.concatenate([toks, np.asarray([7, 8, 9], np.int32)])
    sched.submit(Request(id=0, prompt=prompt, max_new_tokens=4))
    for _ in range(5):                           # blocked head, 5 replans
        assert sched.admit(0.0) == []
    assert pool.cache.hits == 0 and pool.cache.misses == 0, \
        "feasibility peeks counted as cache traffic"
    assert list(pool.cache.lru) == lru_before, \
        "a blocked head refreshed LRU recency"
    pool.free_seq(101)
    admitted = sched.admit(1.0)                  # now it fits: adopt + count
    assert len(admitted) == 1 and admitted[0].num_cached_tokens == 3 * P
    assert pool.cache.hits == 3 and pool.cache.misses == 0
    pool.check_invariants()


def test_negative_cache_remembers_cold_chain_heads():
    pool = PagePool(num_pages=8, page_size=P, prefix_cache=True)
    toks = np.arange(2 * P, dtype=np.int32)
    hs = chain_hashes(b"dense", toks, P)
    assert pool.match_pages(hs, peek=True) == []
    assert hs[0] in pool.cache.neg               # cold head remembered
    base = pool.cache.neg_hits
    pool.match_pages(hs, peek=True)
    pool.match_pages(hs)
    assert pool.cache.neg_hits == base + 2       # walks short-circuited
    # publish invalidates the negative set: the same lookup now hits
    t = list(pool.alloc(0, 2 * P))
    pool.publish_prefix(0, hs, 2)
    assert not pool.cache.neg
    assert pool.match_pages(hs) == t
    pool.check_invariants()
    # a partial hit (miss past page 0) is NOT a cold head: no neg entry
    toks2 = toks.copy()
    toks2[P] += 1
    hs2 = chain_hashes(b"dense", toks2, P)
    assert pool.match_pages(hs2, peek=True) == [t[0]]
    assert hs2[0] not in pool.cache.neg
    pool.free_seq(0)


def test_prefix_hit_rate_is_none_when_nothing_eligible():
    from repro_torch.configs.base import get_model_config, reduced
    from repro_torch.models.params import init_params
    from repro_torch.serving import Engine, EngineConfig

    cfg = reduced(get_model_config("qwen3-1.7b"), dtype="float32")
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    for prefix_cache in (False, True):
        eng = Engine(cfg, params,
                     EngineConfig(num_slots=2, num_pages=16, page_size=8,
                                  max_prompt_len=16, max_new_tokens=2,
                                  kv_dtype="float32",
                                  compute_dtype="float32",
                                  prefix_cache=prefix_cache), device="cpu")
        assert eng.stats.prefix_hit_rate is None   # no eligible lookup
    eng.submit(np.arange(1, 10, dtype=np.int32), 2)
    eng.run()
    assert eng.stats.prefix_hit_rate == 0.0        # eligible but cold


# ---------------------------------------------------------------------------
# hypothesis properties: random interleavings against the invariants
# ---------------------------------------------------------------------------
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_pool_random_interleavings_keep_invariants(data):
    """alloc / ensure / fork / prepare_write / publish / free / pressure-
    evict in random order: after every op the pool invariants hold —
    refcounts equal table references, cache-held pages are unreferenced,
    no page is both free and mapped, and a COW-prepared range is always
    exclusively owned (refcount 1) by the writer."""
    pool = PagePool(num_pages=data.draw(st.integers(6, 20), label="pages"),
                    page_size=P, prefix_cache=True)
    streams = {}                     # seq -> (tokens, hashes)
    next_seq = 0
    for _ in range(data.draw(st.integers(5, 30), label="ops")):
        live = sorted(streams)
        op = data.draw(st.sampled_from(
            ["alloc", "ensure", "fork", "write", "publish", "free",
             "truncate"]))
        try:
            if op == "alloc":
                n = data.draw(st.integers(1, 3 * P))
                toks = np.asarray(data.draw(st.lists(
                    st.integers(0, 2), min_size=n, max_size=n)), np.int32)
                hashes = chain_hashes(b"ns", toks, P)
                cached = pool.match_pages(hashes[:max(0, (n - 1) // P)])
                fresh = pool.pages_for(n) - len(cached)
                pool.alloc_pages(next_seq, fresh, owner=next_seq % 2,
                                 cached=cached)
                streams[next_seq] = (toks, hashes)
                next_seq += 1
            elif op == "ensure" and live:
                seq = data.draw(st.sampled_from(live))
                toks, _ = streams[seq]
                extra = data.draw(st.integers(1, P + 1))
                grown = np.concatenate(
                    [toks, np.zeros((extra,), np.int32)])
                pool.ensure(seq, len(grown))
                streams[seq] = (grown, chain_hashes(b"ns", grown, P))
            elif op == "fork" and live:
                src = data.draw(st.sampled_from(live))
                pool.fork(src, next_seq, owner=next_seq % 2)
                streams[next_seq] = streams[src]
                next_seq += 1
            elif op == "write" and live:
                seq = data.draw(st.sampled_from(live))
                table = pool.table(seq)
                if table:
                    hi = len(table) * P
                    a = data.draw(st.integers(0, hi - 1))
                    b = data.draw(st.integers(a + 1, hi))
                    pool.prepare_write(seq, a, b)
                    for i in range(a // P, pool.pages_for(b)):
                        page = pool.table(seq)[i]
                        assert pool.refcount(page) == 1, \
                            "COW left a written page shared"
            elif op == "publish" and live:
                seq = data.draw(st.sampled_from(live))
                toks, hashes = streams[seq]
                pool.publish_prefix(seq, hashes, len(hashes))
            elif op == "free" and live:
                seq = data.draw(st.sampled_from(live))
                pool.free_seq(seq)
                del streams[seq]
            elif op == "truncate" and live:
                # speculative partial-accept rollback: drop the tail
                seq = data.draw(st.sampled_from(live))
                toks, _ = streams[seq]
                keep = data.draw(st.integers(0, max(0, len(toks))))
                pool.truncate_seq(seq, keep,
                                  recredit=data.draw(st.booleans()))
                kept = toks[:pool.pages_for(keep) * P] if keep else toks[:0]
                streams[seq] = (kept, chain_hashes(b"ns", kept, P))
        except PagePoolOOM:
            pass                      # legal outcome under pressure
        pool.check_invariants()
    for seq in sorted(streams):
        pool.free_seq(seq)
    pool.check_invariants()
    assert pool.used_pages == 0


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_pool_cow_never_touches_shared_pages(data):
    """The issue's refcount invariant, stated directly: after
    ``prepare_write`` the written range is exclusively owned, and every
    page another sequence still maps kept its refcount and its bytes
    (same page id in the other table)."""
    pool = PagePool(num_pages=16, page_size=P, prefix_cache=True)
    n = data.draw(st.integers(1, 4)) * P
    pool.alloc(0, n)
    forks = data.draw(st.integers(1, 3))
    for f in range(1, forks + 1):
        pool.fork(0, f)
    before = {s: pool.table(s) for s in range(forks + 1)}
    writer = data.draw(st.integers(0, forks))
    a = data.draw(st.integers(0, n - 1))
    pool.prepare_write(writer, a, n)
    for s in range(forks + 1):
        if s == writer:
            continue
        assert pool.table(s) == before[s], "COW mutated a reader's table"
    for i in range(a // P, n // P):
        assert pool.refcount(pool.table(writer)[i]) == 1
    pool.check_invariants()


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_fork_then_partial_rollback_releases_only_the_tail(data):
    """The speculative-decode lifecycle: fork a published prefix, COW the
    tail for draft writes, then roll a rejected tail back with
    ``truncate_seq`` — the reader's table is untouched, only tail pages
    are released, and under ``recredit`` the freed pages stay promised to
    the writer (its later re-grow can never lose them to a bystander)."""
    pool = PagePool(num_pages=16, page_size=P, prefix_cache=True)
    n_pages = data.draw(st.integers(2, 4), label="pages")
    n = n_pages * P
    toks = np.asarray(data.draw(st.lists(st.integers(0, 2),
                                         min_size=n, max_size=n)), np.int32)
    hashes = chain_hashes(b"ns", toks, P)
    pool.alloc(0, n)
    pool.publish_prefix(0, hashes, n_pages)
    pool.fork(0, 1)                       # the speculating sequence
    spec_end = n + data.draw(st.integers(1, 2 * P), label="drafted")
    pool.ensure(1, spec_end)              # draft tail pages
    pool.prepare_write(1, n - 1, spec_end)
    reader_before = pool.table(0)
    used_before = pool.used_pages
    keep = data.draw(st.integers(n, spec_end), label="accepted")
    recredit = data.draw(st.booleans(), label="recredit")
    released = pool.truncate_seq(1, keep, recredit=recredit)
    pool.check_invariants()
    assert pool.table(0) == reader_before, "rollback mutated the reader"
    assert released == pool.pages_for(spec_end) - pool.pages_for(keep)
    assert pool.used_pages == used_before - released
    if recredit:
        assert pool.deferred_pages == released
        # the promise is redeemable even after a bystander drains the
        # free list: the writer re-grows to where it was, OOM-free
        grabber = 2
        free_now = pool.free_pages - pool.deferred_pages
        if free_now:
            pool.alloc_pages(grabber, free_now)
        pool.ensure(1, spec_end)
        assert pool.deferred_pages == 0
        pool.check_invariants()


# ---------------------------------------------------------------------------
# int8 paged-KV properties: the quantization round trip, and scale rows
# travelling with their pages through COW / fork / truncate page copies
# ---------------------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(st.data())
def test_int8_roundtrip_error_within_quantization_step(data):
    """``quantize_int8(axis=(1, 3))`` then ``dequantize_int8``: every
    element of a [P, psize, KH, D] pool comes back within its (page,
    head)'s quantization step, amax / 127 (half a step plus float slop;
    one step is a safe outer bound)."""
    P_, psize, KH, D = (data.draw(st.integers(1, 4), label="P"),
                        data.draw(st.sampled_from([2, 4]), label="psize"),
                        data.draw(st.integers(1, 3), label="KH"),
                        data.draw(st.sampled_from([4, 8]), label="D"))
    scale_mag = data.draw(st.sampled_from([1e-3, 1.0, 100.0]), label="mag")
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31), label="s"))
    x = np.asarray(rng.normal(size=(P_, psize, KH, D)) * scale_mag,
                   np.float32)
    q, sc = quantize_int8(torch.from_numpy(x), axis=(1, 3))
    back = dequantize_int8(q, sc).numpy()
    step = np.abs(x).max(axis=(1, 3), keepdims=True) / 127.0
    assert (np.abs(back - x) <= step + 1e-9).all()
    assert q.dtype == torch.int8
    assert tuple(sc.shape) == (P_, 1, KH, 1)


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_page_copy_moves_scales_with_pages(data):
    """The port's COW page copy (``core/steps.py::make_page_copy_step``) on
    an int8 layer (k, v, k_scale, v_scale): after copying src[i] -> dst[i]
    the dequantized dst page equals the dequantized src page, so the
    [P, KH] scale rows travel with their pages, and every other page is
    untouched.  The port's leaves are all [P, ...] (the JAX package also
    has a scanned [R, P, ...] layout, which the port does not use)."""
    psize, KH, D, NP = 4, 2, 4, 8
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31), label="s"))
    layer = []
    for _ in range(2):
        x = torch.from_numpy(np.asarray(rng.normal(size=(NP, psize, KH, D)),
                                        np.float32))
        q, sc = quantize_int8(x, axis=(1, 3))
        layer.append((q, sc[:, 0, :, 0].contiguous()))
    cache = [(layer[0][0], layer[1][0], layer[0][1], layer[1][1])]
    n = data.draw(st.integers(1, 4), label="copies")
    src = data.draw(st.lists(st.integers(1, NP - 1), min_size=n, max_size=n),
                    label="src")
    # distinct dst pages (a page is only ever COW-copied onto a free page)
    dst = data.draw(st.permutations(list(range(1, NP))), label="dst")[:n]

    def deq(c):
        kq, vq, ks, vs = c[0]
        return [(pool.to(torch.float32) * s[:, None, :, None]).numpy()
                for pool, s in ((kq, ks), (vq, vs))]

    before = deq(cache)
    copy = make_page_copy_step()
    after = deq(copy(cache, torch.tensor(src), torch.tensor(dst)))
    for b, a in zip(before, after):
        want = b.copy()
        for s_, d_ in zip(src, dst):
            want[d_] = b[s_]
        for p in range(NP):
            assert np.array_equal(a[p], want[p]), \
                "scale row did not travel with its page"


def test_pool_fork_and_truncate_preserve_scale_correspondence():
    """Host-side lifecycle: PagePool fork shares page *ids* (scales are
    indexed by page id, so correspondence is automatic), COW prepare_write
    gives the writer fresh ids — and the engine copies pool+scale rows to
    the new ids together (test above) — and truncate_seq only drops tail
    ids, never remapping survivors."""
    pool = PagePool(num_pages=16, page_size=P, prefix_cache=True)
    pool.alloc(0, 3 * P)
    t0 = pool.table(0)
    pool.fork(0, 1)
    assert pool.table(1) == t0              # shared ids -> shared scales
    pool.prepare_write(1, P, 3 * P)         # COW the tail
    t1 = pool.table(1)
    assert t1[0] == t0[0]                   # untouched head still shared
    assert t1[1] != t0[1] and t1[2] != t0[2]
    pool.truncate_seq(1, 2 * P)
    assert pool.table(1) == t1[:2]          # survivors keep their ids
    pool.check_invariants()
