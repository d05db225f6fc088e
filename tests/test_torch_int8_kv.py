"""The port's int8 paged KV pools against the JAX package's.

``quantize_int8``, the quantize-on-append ``paged_pool_append_quant``, the
plain chunk attention over int8 pools, ``kv_page_bytes``, ``paged_step``
and the engine with ``kv_dtype="int8"`` get the same numpy inputs (and, for
the models, the same weights through ``load_jax_flat``) as their JAX
counterparts, which run on the JAX package's ``ref`` path.  The ``cuda``
test holds the chunk kernel's int8 mode against its plain version on the
card and skips elsewhere.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_int8_kv.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_model_config, reduced
from repro_torch.core.steps import make_page_copy_step
from repro_torch.kernels.paged_attention import kernel, ops, ref
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.models.params import load_jax_cache, to_jax_cache
from repro_torch.optim.compression import dequantize_int8, quantize_int8
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.kv_cache import kv_page_bytes

PSIZE = 8


def jax_modules():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    return jax, jnp


# ---------------------------------------------------------------------------
# quantize_int8
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", [None, (1, 3)])
def test_quantize_int8_matches_jax_bitwise(axis):
    """Same q and scale bits as ``repro.optim.compression.quantize_int8``,
    on values that include exact rounding ties (x.5 steps) and a slice of
    zeros (the 1e-12 floor)."""
    _, jnp = jax_modules()
    from repro.optim.compression import quantize_int8 as jax_quantize

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 4, 3, 8)) * 3).astype(np.float32)
    x[0, :, 0] = 0.0
    x[1, 0, 1, :] = np.arange(8) + 0.5        # ties once amax / 127 is 1
    x[1, 1, 1, :] = 127.0
    q, s = quantize_int8(torch.tensor(x), axis=axis)
    jq, js = jax_quantize(jnp.asarray(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    back = dequantize_int8(q, s).numpy()
    assert np.all(np.abs(back - x) <= s.numpy() / 2 + 1e-6)


# ---------------------------------------------------------------------------
# plain chunk attention over int8 pools
# ---------------------------------------------------------------------------
def int8_chunk_case(B, H, KH, D, maxp, C, seed):
    """The fixture of ``tests/test_serving_engine.py::_chunk_case`` with
    int8=True: disjoint pages, chunks straddling pages, pools quantized per
    (page, kv head)."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, PSIZE, KH, D)).astype(np.float32)
    vp = rng.normal(size=(P, PSIZE, KH, D)).astype(np.float32)
    bt = np.zeros((B, maxp), np.int32)
    starts = np.zeros((B,), np.int32)
    clens = np.zeros((B,), np.int32)
    for b in range(B):
        starts[b] = int(rng.integers(0, maxp * PSIZE - C + 1))
        clens[b] = C if b == 0 else int(rng.integers(0, C + 1))
        npg = max(1, -(-(int(starts[b]) + int(clens[b])) // PSIZE))
        bt[b, :npg] = 1 + b * maxp + np.arange(npg)
    kq, ks = quantize_int8(torch.tensor(kp), axis=(1, 3))
    vq, vs = quantize_int8(torch.tensor(vp), axis=(1, 3))
    return (q, kq.numpy(), vq.numpy(), bt, starts, clens,
            ks[:, 0, :, 0].numpy(), vs[:, 0, :, 0].numpy())


@pytest.mark.parametrize("variant", ["plain", "window", "softcap", "gqa"])
@pytest.mark.parametrize("C", [1, 4])
def test_int8_chunk_plain_matches_jax_ref(variant, C):
    """The int8 rows of ``test_paged_chunk_pages_per_step_sweep``: the
    port's plain version against JAX's ``paged_chunk_attention_ref`` with
    the same int8 pools and scales, atol 2e-5, rtol 1e-5."""
    _, jnp = jax_modules()
    from repro.kernels.paged_attention.ref import \
        paged_chunk_attention_ref as jax_ref

    vid = {"plain": 1, "window": 2, "softcap": 3, "gqa": 4}[variant]
    H, KH = (4, 2) if variant == "gqa" else (4, 4)
    D = 16
    q, kq, vq, bt, st, cl, ks, vs = int8_chunk_case(2, H, KH, D, 4, C,
                                                    (vid, C))
    kw = {"window": PSIZE + 3} if variant == "window" else \
        {"softcap": 30.0} if variant == "softcap" else {}
    want = np.asarray(jax_ref(
        *(jnp.asarray(a) for a in (q, kq, vq, bt, st, cl)),
        scale=D ** -0.5, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        **kw))
    got = ops.paged_chunk_attention(
        *(torch.tensor(a) for a in (q, kq, vq, bt, st, cl)),
        scale=D ** -0.5, k_scale=torch.tensor(ks), v_scale=torch.tensor(vs),
        **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    for b in range(2):
        assert np.all(got[b, cl[b]:] == 0)


# ---------------------------------------------------------------------------
# quantize on append
# ---------------------------------------------------------------------------
def written_pages(bt, starts, clens, psize):
    return {int(bt[b, (int(starts[b]) + j) // psize])
            for b in range(len(starts)) for j in range(int(clens[b]))}


def both_appends(qp, sc, new, bt, starts, clens):
    """(port pool, port scale, JAX pool, JAX scale) after one append."""
    _, jnp = jax_modules()
    from repro.kernels.paged_attention.ops import \
        paged_pool_append_quant as jax_append

    tp, ts = torch.tensor(qp), torch.tensor(sc)
    out = ops.paged_pool_append_quant(
        tp, ts, torch.tensor(new), torch.tensor(bt), torch.tensor(starts),
        torch.tensor(clens))
    assert out[0] is tp and out[1] is ts                  # in place
    jp, js = jax_append(*(jnp.asarray(a) for a in
                          (qp, sc, new, bt, starts, clens)))
    return tp.numpy(), ts.numpy(), np.asarray(jp), np.asarray(js)


def test_append_quant_matches_jax_on_the_jax_case():
    """``test_paged_pool_append_quant_matches_f32_within_scale``'s case:
    every page a token lands in (1, 2, 4) is bit-for-bit JAX's, pools and
    scales; pages 3 and 5, in JAX's window but with no token, keep their
    bytes in the port, and JAX's re-quantization gives the same bytes;
    6 and 7 keep theirs in both; and the dequantized pool tracks the f32
    append within each page's step (amax / 127), the JAX test's own check,
    run on the port."""
    psize, KH, D = 4, 2, 8
    rng = np.random.default_rng(5)
    fpool = rng.normal(size=(8, psize, KH, D)).astype(np.float32)
    qp, sc = quantize_int8(torch.tensor(fpool), axis=(1, 3))
    qp, sc = qp.numpy(), sc[:, 0, :, 0].numpy()
    new = rng.normal(size=(2, 5, KH, D)).astype(np.float32)
    bt = np.asarray([[1, 2, 3], [4, 5, 0]], np.int32)
    starts = np.asarray([2, 0], np.int32)
    clens = np.asarray([5, 3], np.int32)
    tp, ts, jp, js = both_appends(qp, sc, new, bt, starts, clens)
    assert written_pages(bt, starts, clens, psize) == {1, 2, 4}
    for page in range(1, 8):
        assert np.array_equal(tp[page], jp[page]), page
        assert np.array_equal(ts[page], js[page]), page
    for page in (3, 5, 6, 7):
        assert np.array_equal(tp[page], qp[page])
        assert np.array_equal(ts[page], sc[page])
    fref = ops.paged_pool_append(
        torch.tensor(fpool), torch.tensor(new), torch.tensor(bt),
        torch.tensor(starts), torch.tensor(clens)).numpy()
    deq = tp.astype(np.float32) * ts[:, None, :, None]
    for page in (1, 2, 3, 4, 5):
        step = np.abs(fref[page]).max(axis=(0, 2)) / 127.0 + 1e-6
        assert (np.abs(deq[page] - fref[page]).max(axis=(0, 2))
                <= step).all(), page


@pytest.mark.parametrize("seed", range(8))
def test_append_quant_matches_jax_on_random_chunks(seed):
    """Random chunk widths, page sizes, starts and lengths (one row idle at
    start 0, as the engine's idle slots are) over a pool quantized from
    random values.  Pages a token lands in: bit-for-bit JAX's.  Pages none
    lands in: the port leaves them as they were; JAX re-quantizes the ones
    in its window, which on a page quantized before gives back the same
    bytes, so the whole pool and every scale equal JAX's."""
    rng = np.random.default_rng(seed)
    psize, KH, D = int(rng.choice([2, 4, 8])), 2, 8
    B, C, maxp = 3, int(rng.integers(1, 9)), 5
    P = B * maxp + 2
    mag = float(rng.uniform(0.5, 3.0))
    fpool = (rng.normal(size=(P, psize, KH, D)) * mag).astype(np.float32)
    qp, sc = quantize_int8(torch.tensor(fpool), axis=(1, 3))
    qp, sc = qp.numpy(), sc[:, 0, :, 0].numpy()
    new = (rng.normal(size=(B, C, KH, D)) * mag).astype(np.float32)
    bt = (1 + np.arange(B)[:, None] * maxp
          + np.arange(maxp)[None, :]).astype(np.int32)
    starts = rng.integers(0, maxp * psize - C + 1, size=B).astype(np.int32)
    clens = rng.integers(0, C + 1, size=B).astype(np.int32)
    clens[0], clens[2], starts[2] = C, 0, 0
    tp, ts, jp, js = both_appends(qp, sc, new, bt, starts, clens)
    written = written_pages(bt, starts, clens, psize)
    for page in range(1, P):                     # page 0: the null page
        assert np.array_equal(tp[page], jp[page]), page
        assert np.array_equal(ts[page], js[page]), page
        if page not in written:
            assert np.array_equal(tp[page], qp[page])
            assert np.array_equal(ts[page], sc[page])


def test_append_quant_leaves_a_fresh_page_scale_where_jax_moves_it():
    """The one place the port's pools differ from JAX's: JAX re-quantizes
    every page of its window, so a page no token lands in that was never
    quantized (scale 0, as ``init_paged_cache`` zero-fills it) gets the
    floor scale 1e-12; the port leaves it at 0.  Its int8 values are 0
    either way and dequantize to 0 (ROADMAP section 3)."""
    psize, KH, D = 4, 2, 8
    qp = np.zeros((6, psize, KH, D), np.int8)
    sc = np.zeros((6, KH), np.float32)
    new = np.random.default_rng(1).normal(size=(1, 2, KH, D)).astype(
        np.float32)
    bt = np.asarray([[1, 2, 3]], np.int32)       # page 2: allocated, empty
    tp, ts, jp, js = both_appends(qp, sc, new, bt, np.asarray([0], np.int32),
                                  np.asarray([2], np.int32))
    assert np.array_equal(tp[1], jp[1]) and np.array_equal(ts[1], js[1])
    assert np.array_equal(tp[2], jp[2]) and not tp[2].any()
    assert np.all(ts[2] == 0) and np.all(js[2] == np.float32(1e-12))
    assert np.array_equal(ts[3], js[3])          # past JAX's window


@pytest.mark.parametrize("psize,KH,D", [(16, 8, 128), (16, 2, 64),
                                        (8, 4, 32), (4, 2, 64)])
def test_kv_page_bytes_int8_capacity_ratio(psize, KH, D):
    """The four geometries of ``test_kv_page_bytes_int8_capacity_ratio``:
    int8 pages and their scale sidecar fit >= 1.9x the pages of bf16 in
    the same bytes, priced exactly as the JAX package prices them."""
    pytest.importorskip("jax")
    from repro.serving.kv_cache import kv_page_bytes as jax_bytes

    bf16 = kv_page_bytes(psize, KH, D, "bfloat16")
    i8 = kv_page_bytes(psize, KH, D, "int8")
    assert bf16 == 2 * psize * KH * D * 2 == jax_bytes(psize, KH, D,
                                                       "bfloat16")
    assert i8 == 2 * (psize * KH * D + KH * 4) == jax_bytes(psize, KH, D,
                                                            "int8")
    assert bf16 / i8 >= 1.9


# ---------------------------------------------------------------------------
# the cache, the page copy and the bridge
# ---------------------------------------------------------------------------
def test_init_paged_cache_int8_builds_the_4_tuple():
    cfg = reduced(get_model_config("qwen3-1.7b"))
    cache = T.init_paged_cache(cfg, 7, 4, dtype=torch.int8, device="cpu")
    assert len(cache) == cfg.num_layers
    for kp, vp, ks, vs in cache:
        assert kp.dtype == vp.dtype == torch.int8
        assert kp.shape == (7, 4, cfg.num_kv_heads, cfg.head_dim)
        assert ks.dtype == vs.dtype == torch.float32
        assert ks.shape == vs.shape == (7, cfg.num_kv_heads)
        assert not ks.any() and not kp.any()


def test_page_copy_carries_the_scale_rows():
    """``make_page_copy_step`` on int8 4-tuples: page ``src`` lands in
    ``dst`` in both pools and both scale sidecars, every layer; nothing
    else moves."""
    gen = torch.Generator().manual_seed(0)
    cache = [(torch.randint(-127, 128, (5, 4, 2, 8), dtype=torch.int8,
                            generator=gen),
              torch.randint(-127, 128, (5, 4, 2, 8), dtype=torch.int8,
                            generator=gen),
              torch.rand(5, 2, generator=gen),
              torch.rand(5, 2, generator=gen)) for _ in range(2)]
    before = [tuple(t.clone() for t in layer) for layer in cache]
    make_page_copy_step()(cache, torch.tensor([3, 1]), torch.tensor([2, 4]))
    for layer, old in zip(cache, before):
        for t, t0 in zip(layer, old):
            assert torch.equal(t[2], t0[3]) and torch.equal(t[4], t0[1])
            assert torch.equal(t[[0, 1, 3]], t0[[0, 1, 3]])


def test_int8_paged_cache_bridge_roundtrip():
    """A JAX int8 paged cache (``init_paged_cache(dtype=jnp.int8)`` filled
    with values) crosses into the port and back bit for bit: int8 pools,
    f32 scales, superblock stacking undone and redone."""
    jax, jnp = jax_modules()
    from repro.configs.base import get_model_config as jax_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import transformer as JT

    jcfg = jax_reduced(jax_config("gemma2-27b"))
    cfg = reduced(get_model_config("gemma2-27b"))
    tree = JT.init_paged_cache(jcfg, 6, 4, dtype=jnp.int8)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda x: np.asarray(
        rng.integers(-127, 128, x.shape) if x.dtype == jnp.int8
        else rng.random(x.shape), x.dtype), tree)
    cache = load_jax_cache(tree, cfg, device="cpu")
    assert all(len(layer) == 4 and layer[0].dtype == torch.int8
               and layer[2].dtype == torch.float32 for layer in cache)
    back = to_jax_cache(cache, cfg)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for path, leaf in flat:
        assert got[path].dtype == leaf.dtype
        assert np.array_equal(got[path], leaf), path


# ---------------------------------------------------------------------------
# the model's paged step and the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-27b"])
def test_paged_step_int8_matches_jax(arch):
    """The three ticks of ``test_torch_model.py::test_paged_step_logits_match``
    (a prompt chunk, a second chunk, a decode token; slot 1 idle in tick
    2) over int8 pools, reduced config in f32.  Logits atol 1e-4; each
    page's dequantized pools within one quantization step (amax / 127) of
    JAX's, as K/V projections that differ in the last bit may round to
    neighbouring int8 values; scales rtol 1e-6, except on the (page, kv
    head) pairs no token has reached, where JAX's window leaves 1e-12 and
    the port 0 over int8 zeros (see the test above)."""
    jax, jnp = jax_modules()
    from repro.configs.base import get_model_config as jax_config
    from repro.configs.base import reduced as jax_reduced
    from repro.core.steps import make_ctx
    from repro.models import api as jax_api
    from repro.models import transformer as JT
    from repro_torch.models.params import load_jax_flat

    jcfg = jax_reduced(jax_config(arch), dtype="float32")
    tcfg = reduced(get_model_config(arch), dtype="float32")
    params = jax_api.model_init(jax.random.key(1), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
            in jax.tree_util.tree_leaves_with_path(params)}
    model = load_jax_flat(flat, tcfg, device="cpu")
    ctx = make_ctx(jcfg, None)
    P, psize, B = 12, 4, 2
    jcache = JT.init_paged_cache(jcfg, P, psize, dtype=jnp.int8)
    tcache = T.init_paged_cache(tcfg, P, psize, dtype=torch.int8,
                                device="cpu")
    bt = np.asarray([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    rng = np.random.default_rng(9)
    for C, st, cl in [(8, [0, 0], [7, 3]), (4, [7, 3], [4, 0]),
                      (1, [11, 3], [1, 1])]:
        tok = rng.integers(1, jcfg.vocab_size, size=(B, C)).astype(np.int32)
        st, cl = np.asarray(st, np.int32), np.asarray(cl, np.int32)
        want, jcache = jax_api.paged_step(
            params, jcache, jnp.asarray(tok), jnp.asarray(st),
            jnp.asarray(cl), jnp.asarray(bt), jcfg, ctx)
        got, tcache = api.paged_step(
            model, tcache, torch.tensor(tok), torch.tensor(st),
            torch.tensor(cl), torch.tensor(bt), tcfg)
        live = cl > 0
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   atol=1e-4, rtol=1e-4)
    jtree = to_jax_cache(tcache, tcfg)
    for key in jcache:
        for name in jcache[key]:
            jk, jv, jks, jvs = (np.asarray(a) for a in jcache[key][name])
            tk, tv, tks, tvs = jtree[key][name]
            for jq, js, tq, ts in ((jk, jks, tk, tks), (jv, jvs, tv, tvs)):
                ts, js = ts[..., 1:, :], js[..., 1:, :]   # not the null page
                fresh = ts == 0
                moved = js[fresh] == np.float32(1e-12)
                assert moved.any() and np.all(moved | (js[fresh] == 0))
                np.testing.assert_allclose(ts[~fresh], js[~fresh], rtol=1e-6,
                                           atol=0)
                ts, js = (np.pad(a, [(0, 0)] * (a.ndim - 2) + [(1, 0), (0, 0)])
                          for a in (ts, js))
                jd = jq.astype(np.float32) * js[..., :, None, :, None]
                td = tq.astype(np.float32) * ts[..., :, None, :, None]
                step = js[..., :, None, :, None]
                assert np.all(np.abs(td - jd)[..., 1:, :, :, :]
                              <= step[..., 1:, :, :, :] * 1.0001)


def test_engine_int8_streams_match_jax():
    """The setup of ``test_engine_int8_and_pages_per_step`` (reduced qwen3,
    2 slots, 32 pages of 4 tokens, budget 16, f32 compute, int8 pools)
    without ``pages_per_step``: the port's greedy streams equal the JAX int8
    engine's, the cache holds int8 pools and f32 [P, KH] scales, and every
    page is back in the pool at the end."""
    jax, _ = jax_modules()
    from repro.configs.base import get_model_config as jax_config
    from repro.configs.base import reduced as jax_reduced
    from repro.models import api as jax_api
    from repro.serving import Engine as JaxEngine
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro_torch.models.params import load_jax_flat

    jcfg = jax_reduced(jax_config("qwen3-1.7b"))
    cfg = reduced(get_model_config("qwen3-1.7b"))
    params = jax_api.model_init(jax.random.key(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
            in jax.tree_util.tree_leaves_with_path(params)}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 3)]
    kw = dict(num_slots=2, num_pages=32, page_size=4, max_prompt_len=12,
              max_new_tokens=6, token_budget=16, policy="on_demand",
              kv_dtype="int8", compute_dtype="float32")

    def serve(eng):
        for p in prompts:
            eng.submit(p, 6)
        return [list(r.out_tokens)
                for r in sorted(eng.run(), key=lambda r: r.id)]

    want = serve(JaxEngine(jcfg, params, JaxEngineConfig(**kw)))
    eng = Engine(cfg, load_jax_flat(flat, cfg, device="cpu"),
                 EngineConfig(**kw), device="cpu")
    got = serve(eng)
    assert got == want
    assert eng.pool.used_pages == 0
    eng.pool.check_invariants()
    for kp, vp, ks, vs in eng.cache:
        assert kp.dtype == vp.dtype == torch.int8
        assert ks.dtype == vs.dtype == torch.float32
        assert ks.shape == (32, cfg.num_kv_heads)
    assert eng.stats.decode_ticks > 0 and eng.stats.attn_launches == 0


def test_serve_cli_int8_on_the_cpu(capsys):
    """``launch/serve.py --kv-dtype int8`` end to end at the reduced size,
    on the plain versions: every request finishes, and the report names
    both kernels' launches (none on the CPU) beside the tick counts."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--kv-dtype", "int8", "--requests", "6",
                "--gen", "8", "--stream", "batch"])
    out = capsys.readouterr().out
    assert out.count(" done: ") == 6
    assert "paged_chunk_attention launches: 0" in out
    assert "paged_attention launches: 0" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", [
    # B, H, KH, D, maxp, C, kw
    (2, 4, 4, 32, 4, 1, {}),
    (2, 4, 2, 32, 4, 4, {"window": PSIZE + 3}),
    (3, 8, 2, 96, 5, 7, {"softcap": 30.0}),
    (4, 16, 8, 128, 20, 64, {}),
    (3, 32, 16, 128, 10, 7, {"window": 20, "softcap": 50.0}),
])
def test_int8_chunk_kernel_matches_plain(cuda, dtype, geom):
    """The chunk kernel on int8 pools (q in ``dtype``: f32 on the CUDA-core
    kernel, bf16 on the tensor-core one) against its plain version on the
    same card and inputs: f32 q atol/rtol 2e-5 (summation order), bf16 q
    and output 2e-2 (one bf16 ulp at |x| ~ 1 is 7.8e-3)."""
    B, H, KH, D, maxp, C, kw = geom
    q, kq, vq, bt, st, cl, ks, vs = int8_chunk_case(B, H, KH, D, maxp, C,
                                                    (B, C, D))
    dt = getattr(torch, dtype)
    args = [torch.tensor(q, device=cuda).to(dt)] + [
        torch.tensor(a, device=cuda) for a in (kq, vq, bt, st, cl)]
    kw = dict(kw, scale=D ** -0.5, k_scale=torch.tensor(ks, device=cuda),
              v_scale=torch.tensor(vs, device=cuda))
    got = kernel.paged_chunk_attention(*args, **kw)
    want = ref.paged_chunk_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for b in range(B):
        assert torch.all(got[b, int(cl[b]):] == 0)
