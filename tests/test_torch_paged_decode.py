"""The port's paged decode attention against the JAX package's.

The plain ``paged_attention`` gets the same numpy inputs as the JAX
``ref.paged_attention_ref`` oracle; its relation to the chunk version at
C == 1 (bit for bit on the CPU) and the decode route of ``attn_apply`` are
checked within the port.  The ``cuda`` tests hold the hand-written decode
kernel against its plain version and the chunk kernel, and count a
decode-only engine tick's launches, on the card; they skip elsewhere.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_paged_decode.py
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_model_config, reduced
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import kernel, ops, ref
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from repro_torch.optim.compression import quantize_int8
from repro_torch.serving import Engine, EngineConfig

VARIANTS = ["plain", "window", "softcap"]


def variant_kw(variant, psize):
    return {"window": {"window": psize + 3},
            "softcap": {"softcap": 30.0}}.get(variant, {})


def decode_case(B, H, KH, D, psize, maxp, seed, *, int8=False):
    """The fixture of ``test_paged_attention_kernel_vs_ref``: each slot owns
    a disjoint page range and a length that straddles pages.  int8 pools
    are quantized per (page, kv head).  Returns numpy (q, k_pages,
    v_pages, block_tables, lengths, k_scale, v_scale) and a copy of the
    block table with every dead entry poisoned far outside the pool."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, psize, KH, D)).astype(np.float32)
    vp = rng.normal(size=(P, psize, KH, D)).astype(np.float32)
    bt = np.zeros((B, maxp), np.int32)
    lengths = np.zeros((B,), np.int32)
    for b in range(B):
        lengths[b] = int(rng.integers(1, maxp * psize + 1))
        npg = -(-int(lengths[b]) // psize)
        bt[b, :npg] = 1 + b * maxp + np.arange(npg)
    ks = vs = None
    if int8:
        kq, ks = quantize_int8(torch.tensor(kp), axis=(1, 3))
        vq, vs = quantize_int8(torch.tensor(vp), axis=(1, 3))
        kp, vp = kq.numpy(), vq.numpy()
        ks, vs = ks[:, 0, :, 0].numpy(), vs[:, 0, :, 0].numpy()
    poisoned = bt.copy()
    for b in range(B):
        poisoned[b, -(-int(lengths[b]) // psize):] = 999_999
    return (q, kp, vp, bt, lengths, ks, vs), poisoned


def torch_args(case, device="cpu", dtype=torch.float32, bt=None):
    q, kp, vp, bt0, lengths, ks, vs = case
    fl = (lambda a: torch.tensor(a, device=device).to(dtype)
          if a.dtype == np.float32 else torch.tensor(a, device=device))
    args = (fl(q), fl(kp), fl(vp),
            torch.tensor(bt0 if bt is None else bt, device=device),
            torch.tensor(lengths, device=device))
    scales = {} if ks is None else {
        "k_scale": torch.tensor(ks, device=device),
        "v_scale": torch.tensor(vs, device=device)}
    return args, scales


@pytest.mark.parametrize("B,H,KH,D,psize,maxp", [
    (2, 4, 4, 16, 8, 3),     # MHA
    (3, 4, 2, 32, 16, 4),    # GQA
    (1, 8, 1, 16, 8, 5),     # MQA
])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pools", ["float32", "int8"])
def test_decode_plain_matches_jax_ref(B, H, KH, D, psize, maxp, variant,
                                      pools):
    """``test_paged_attention_kernel_vs_ref``'s geometries and variants,
    with f32 and int8 pools: the port's plain decode (given the poisoned
    block table) against JAX's ``paged_attention_ref`` (given the clean
    one), atol 2e-5, rtol 1e-5 for the summation order."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ref import \
        paged_attention_ref as jax_ref

    vid = VARIANTS.index(variant) + 1
    case, poisoned = decode_case(B, H, KH, D, psize, maxp,
                                 (B, H, KH, psize, vid),
                                 int8=pools == "int8")
    kw = dict(variant_kw(variant, psize), scale=D ** -0.5)
    q, kp, vp, bt, lengths, ks, vs = case
    jscales = {} if ks is None else {"k_scale": jnp.asarray(ks),
                                     "v_scale": jnp.asarray(vs)}
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in
                                (q, kp, vp, bt, lengths)), **kw, **jscales))
    args, scales = torch_args(case, bt=poisoned)
    got = ops.paged_attention(*args, **kw, **scales).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_decode_empty_slot_emits_zeros():
    """``test_paged_attention_empty_slot_emits_zeros`` on the port: a slot
    of length 0 writes exact zeros, and every output is finite."""
    B, H, KH, D, psize = 2, 2, 2, 16, 8
    rng = np.random.default_rng(0)
    kp = torch.tensor(rng.normal(size=(5, psize, KH, D)), dtype=torch.float32)
    q = torch.tensor(rng.normal(size=(B, H, D)), dtype=torch.float32)
    bt = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    ln = torch.tensor([11, 0], dtype=torch.int32)
    out = ops.paged_attention(q, kp, kp, bt, ln, scale=0.25)
    assert torch.all(out[1] == 0)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("pools", ["float32", "int8"])
def test_decode_dead_block_table_entries_never_gathered(pools):
    """``test_dead_block_table_entries_never_gathered``'s decode check:
    poisoning every dead entry with 999_999 leaves the output bit for bit
    unchanged."""
    case, poisoned = decode_case(3, 4, 2, 16, 8, 4, 23, int8=pools == "int8")
    clean, scales = torch_args(case)
    dirty, _ = torch_args(case, bt=poisoned)
    a = ops.paged_attention(*clean, scale=0.25, **scales)
    b = ops.paged_attention(*dirty, scale=0.25, **scales)
    assert torch.equal(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("pools", ["float32", "int8"])
def test_plain_decode_is_plain_chunk_at_c1_bitwise(variant, pools):
    """``test_paged_chunk_attention_c1_bitwise_matches_decode`` on the
    port's plain versions: the decode at ``lengths`` is the chunk at
    C == 1 with ``starts = lengths - 1`` and ``chunk_lens = 1``, bit for
    bit, and a slot of length 0 matches an idle chunk row (start 0,
    chunk_len 0)."""
    case, _ = decode_case(3, 4, 2, 16, 8, 4, 7, int8=pools == "int8")
    (q, kp, vp, bt, lengths), scales = torch_args(case)
    lengths[1] = 0
    kw = dict(variant_kw(variant, 8), scale=0.25, **scales)
    dec = ops.paged_attention(q, kp, vp, bt, lengths, **kw)
    live = (lengths > 0).to(torch.int32)
    chk = ops.paged_chunk_attention(q[:, None], kp, vp, bt,
                                    (lengths - 1) * live, live, **kw)
    assert torch.equal(dec, chk[:, 0])
    assert torch.all(dec[1] == 0)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-27b"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_attn_apply_decode_route_is_the_chunk_route(monkeypatch, arch, kv):
    """A C == 1 tick of ``attn_apply``'s paged branch (two decode slots and
    an idle one; gemma2's layer 0 is a local, windowed layer with a
    softcap) goes through ``paged_attention``; sending the same tick
    through ``paged_chunk_attention`` instead gives the same output and the
    same pools, bit for bit on the CPU."""
    cfg = reduced(get_model_config(arch), dtype="float32")
    model = init_params(cfg, 3, device="cpu", dtype=torch.float32)
    bp, kind = model.layers[0], cfg.layer_kinds()[0]
    P, psize = 10, 4
    dtype = getattr(torch, kv)
    cache = T.init_paged_cache(cfg, P, psize, dtype=dtype, device="cpu")[0]
    gen = torch.Generator().manual_seed(0)
    if kv == "int8":
        pools = [torch.randn(P, psize, cfg.num_kv_heads, cfg.head_dim,
                             generator=gen) for _ in range(2)]
        for i, pool in enumerate(pools):
            qp, sc = quantize_int8(pool, axis=(1, 3))
            cache[i].copy_(qp)
            cache[2 + i].copy_(sc[:, 0, :, 0])
    else:
        for pool in cache:
            pool.copy_(torch.randn(pool.shape, generator=gen))
    bt = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    starts = torch.tensor([9, 2, 0], dtype=torch.int32)
    clens = torch.tensor([1, 1, 0], dtype=torch.int32)
    x = torch.randn(3, 1, cfg.d_model, generator=gen)
    kw = dict(kind=kind, positions=starts.long()[:, None],
              cache_index=starts, block_tables=bt, chunk_lens=clens)

    routes = []
    real = attention.paged_attention

    def decode_route(*a, **k):
        routes.append("decode")
        return real(*a, **k)

    def chunk_route(q, kp, vp, bt_, lengths, **k):
        routes.append("chunk")
        return ops.paged_chunk_attention(q[:, None], kp, vp, bt_, starts,
                                         clens, **k)[:, 0]

    outs, caches = [], []
    for route in (decode_route, chunk_route):
        monkeypatch.setattr(attention, "paged_attention", route)
        c = copy.deepcopy(cache)
        out, new = attention.attn_apply(bp.attn, x, cfg, cache=c, **kw)
        assert new is c
        outs.append(out)
        caches.append(c)
    assert routes == ["decode", "chunk"]
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*caches):
        assert torch.equal(a, b)


def test_idle_slot_with_cached_tokens_matches_jax_paged_step(monkeypatch):
    """A C == 1 ``api.paged_step`` on reduced qwen3 in f32, after a prompt
    tick filled both slots' pages: slot 0 decodes one token, slot 1 is idle
    (``chunk_lens`` 0) with ``starts`` 6 > 0.  JAX runs the chunk kernel
    for every paged step, which gives an idle slot zeros; the port's
    decode route must do the same, so the logits of every slot, the idle
    one included, match JAX's ``paged_step``, and layer 0's attention
    output matches JAX's ``paged_chunk_attention_ref`` on the same q and
    pools.  f32 throughout: logits atol/rtol 1e-4 (summation order of the
    matmuls, as ``test_paged_step_logits_match``), attention 1e-5 (one
    softmax over at most 6 keys)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.base import get_model_config as jax_config
    from repro.configs.base import reduced as jax_reduced
    from repro.core.steps import make_ctx
    from repro.kernels.paged_attention.ref import paged_chunk_attention_ref
    from repro.models import api as jax_api
    from repro.models import transformer as JT
    from repro_torch.models import api
    from repro_torch.models.params import load_jax_flat

    jcfg = jax_reduced(jax_config("qwen3-1.7b"), dtype="float32")
    cfg = reduced(get_model_config("qwen3-1.7b"), dtype="float32")
    params = jax_api.model_init(jax.random.key(2), jcfg)
    model = load_jax_flat(
        {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
         jax.tree_util.tree_leaves_with_path(params)}, cfg, device="cpu")
    ctx = make_ctx(jcfg, None)
    P, psize = 8, 4
    jcache = JT.init_paged_cache(jcfg, P, psize, dtype=jnp.float32)
    tcache = T.init_paged_cache(cfg, P, psize, dtype=torch.float32,
                                device="cpu")
    bt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    rng = np.random.default_rng(5)

    seen = []
    real = attention.paged_attention

    def record(q, kp, vp, bt_, lengths, **kw):
        out = real(q, kp, vp, bt_, lengths, **kw)
        seen.append((q.clone(), kp.clone(), vp.clone(), kw, out))
        return out

    monkeypatch.setattr(attention, "paged_attention", record)
    for C, st, cl in ((8, [0, 0], [5, 6]), (1, [5, 6], [1, 0])):
        tok = rng.integers(1, jcfg.vocab_size, size=(2, C)).astype(np.int32)
        st, cl = np.asarray(st, np.int32), np.asarray(cl, np.int32)
        want, jcache = jax_api.paged_step(
            params, jcache, jnp.asarray(tok), jnp.asarray(st),
            jnp.asarray(cl), jnp.asarray(bt), jcfg, ctx)
        got, tcache = api.paged_step(
            model, tcache, torch.tensor(tok), torch.tensor(st),
            torch.tensor(cl), torch.tensor(bt), cfg)
        live = cl > 0 if C > 1 else np.ones(2, bool)
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], atol=1e-4,
                                   rtol=1e-4)
    assert len(seen) == cfg.num_layers          # the C == 1 tick only
    q, kp, vp, kw, out = seen[0]
    ref_out = paged_chunk_attention_ref(
        jnp.asarray(q.numpy()[:, None]), jnp.asarray(kp.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(bt), jnp.asarray(st),
        jnp.asarray(cl), scale=kw["scale"], window=kw["window"],
        softcap=kw["softcap"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out)[:, 0],
                               atol=1e-5, rtol=1e-5)
    assert torch.all(out[1] == 0)


def test_cpu_tensors_never_reach_the_decode_kernel():
    """The CPU path is the plain version; the CUDA wrapper refuses CPU
    tensors instead of computing anything."""
    case, _ = decode_case(2, 4, 2, 32, 8, 3, 0)
    args, _ = torch_args(case)
    before = build.LAUNCHES[kernel.NAME_DECODE]
    ops.paged_attention(*args, scale=0.1)
    assert build.LAUNCHES[kernel.NAME_DECODE] == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.paged_attention(*args, scale=0.1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


GEOMS = [
    # B, H, KH, D, psize, maxp, kw
    (2, 4, 4, 32, 8, 3, {}),
    (3, 4, 2, 64, 16, 4, {"window": 19}),
    (2, 8, 1, 32, 8, 5, {"softcap": 30.0}),
    (2, 16, 1, 96, 4, 9, {}),                      # G 16: two row groups
    (8, 16, 8, 128, 16, 20, {}),                   # qwen3-1.7b
    (4, 32, 16, 128, 16, 38, {"window": 64, "softcap": 50.0}),  # gemma2
    (2, 8, 2, 256, 16, 6, {"window": 20}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pools", ["native", "int8"])
@pytest.mark.parametrize("geom", GEOMS)
def test_decode_kernel_matches_plain(cuda, dtype, pools, geom):
    """The decode kernel against its plain version on the same card and
    inputs, with the dead block-table entries poisoned and slot 0 empty.
    f32 q: atol/rtol 2e-5 (summation order only); bf16 q, compared in
    f32: 2e-2 (one bf16 ulp at |x| ~ 1 is 7.8e-3)."""
    B, H, KH, D, psize, maxp, kw = geom
    case, poisoned = decode_case(B, H, KH, D, psize, maxp, (B, H, D),
                                 int8=pools == "int8")
    args, scales = torch_args(case, cuda, getattr(torch, dtype), poisoned)
    args[4][0] = 0
    kw = dict(kw, scale=D ** -0.5, **scales)
    got = kernel.paged_attention(*args, **kw)
    want = ref.paged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("pools", ["native", "int8"])
@pytest.mark.parametrize("geom", GEOMS)
def test_decode_kernel_matches_chunk_kernel_at_c1(cuda, pools, geom):
    """The two kernels on the same decode tick in f32: the chunk kernel at
    C == 1, starts = lengths - 1, chunk_lens = 1.  They sum in different
    orders (keys split over warps against one warp a row), so atol/rtol
    2e-5."""
    B, H, KH, D, psize, maxp, kw = geom
    case, poisoned = decode_case(B, H, KH, D, psize, maxp, (B, D),
                                 int8=pools == "int8")
    (q, kp, vp, bt, lengths), scales = torch_args(case, cuda, bt=poisoned)
    kw = dict(kw, scale=D ** -0.5, **scales)
    dec = kernel.paged_attention(q, kp, vp, bt, lengths, **kw)
    chk = kernel.paged_chunk_attention(q[:, None].contiguous(), kp, vp, bt,
                                       lengths - 1, torch.ones_like(lengths),
                                       **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(dec, chk[:, 0], atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_decode_only_tick_launches_the_decode_kernel(cuda, kv):
    """An engine on the card (reduced qwen3 with head_dim 32, which the
    kernels take): the prompt ticks launch the chunk kernel, and every
    tick whose chunk bucket is 1 launches ``paged_attention`` once per
    layer and the chunk kernel not at all."""
    cfg = dataclasses.replace(reduced(get_model_config("qwen3-1.7b")),
                              head_dim=32)
    eng = Engine(cfg, init_params(cfg, 0, device=cuda), EngineConfig(
        num_slots=2, num_pages=16, page_size=8, max_prompt_len=16,
        max_new_tokens=4, token_budget=16, kv_dtype=kv), device=cuda)
    for n in (5, 9):
        eng.submit(np.arange(1, n + 1, dtype=np.int32), 4)
    while eng.sched.waiting or any(r.in_prefill
                                   for r in eng.sched.running.values()):
        eng.step()
    assert eng.stats.attn_launches == cfg.num_layers * eng.stats.steps
    build.reset_launches()
    ticks = eng.stats.steps
    eng.step()                                     # both slots decode
    assert eng.stats.steps == ticks + 1 and eng.stats.decode_ticks >= 1
    assert build.LAUNCHES[kernel.NAME_DECODE] == cfg.num_layers
    assert build.LAUNCHES[kernel.NAME] == 0
    eng.run()
    assert eng.stats.decode_launches == cfg.num_layers * \
        eng.stats.decode_ticks
