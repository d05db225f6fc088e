"""The port's paged attention against the JAX package's.

The plain PyTorch ``paged_chunk_attention`` and ``paged_pool_append`` get
the same numpy inputs as the JAX ``ref`` oracle and ``ops.paged_pool_append``
(the JAX side runs on its ``ref`` path, as the JAX package's own CPU tests
do).  The ``cuda`` tests hold the hand-written kernel against the plain
version on the card and skip elsewhere; they need no JAX, so JAX is imported
inside the parity tests only.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_paged_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import kernel, ops, ref

PSIZE = 8
VARIANTS = {"plain": {}, "window": {"window": PSIZE + 3},
            "softcap": {"softcap": 30.0}}


def chunk_case(B, H, KH, D, maxp, C, seed, *, psize=PSIZE):
    """Disjoint-page chunk-attention inputs: chunks start mid-page, straddle
    pages, slot 0 is a full chunk, the others partial, slot 2 (when B > 2)
    idle: the fixture of tests/test_serving_engine.py with the idle slot
    made certain.  Returns numpy arrays plus a copy of the block table with
    every dead entry poisoned."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, psize, KH, D)).astype(np.float32)
    vp = rng.normal(size=(P, psize, KH, D)).astype(np.float32)
    bt = np.zeros((B, maxp), np.int32)
    starts = np.zeros((B,), np.int32)
    clens = np.zeros((B,), np.int32)
    for b in range(B):
        starts[b] = int(rng.integers(0, maxp * psize - C + 1))
        clens[b] = C if b == 0 else int(rng.integers(0, C + 1))
        if b == 2:
            clens[b] = 0                         # an idle slot
        npg = max(1, -(-(int(starts[b]) + int(clens[b])) // psize))
        bt[b, :npg] = 1 + b * maxp + np.arange(npg)
    poisoned = bt.copy()
    live = -(-(starts + clens) // psize)
    for b in range(B):
        poisoned[b, live[b]:] = 999_999          # far outside the pool
    return (q, kp, vp, bt, starts, clens), poisoned


def torch_args(args, device="cpu", dtype=torch.float32):
    q, kp, vp, bt, st, cl = args
    fl = [torch.tensor(a, dtype=dtype, device=device) for a in (q, kp, vp)]
    it = [torch.tensor(a, dtype=torch.int32, device=device)
          for a in (bt, st, cl)]
    return (*fl, *it)


@pytest.mark.parametrize("B,H,KH,D,maxp", [
    (2, 4, 4, 16, 4),        # MHA
    (3, 4, 2, 32, 5),        # GQA
])
@pytest.mark.parametrize("C", [1, PSIZE, 3 * PSIZE - 1])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_matches_jax_ref(B, H, KH, D, maxp, C, variant):
    """f32 on both sides; atol/rtol 1e-5 covers the different summation
    order of the two einsum/softmax implementations.  The port gets the
    poisoned block table, the JAX oracle the clean one: dead entries must
    not matter."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ref import paged_chunk_attention_ref

    vid = list(VARIANTS).index(variant)
    args, poisoned = chunk_case(B, H, KH, D, maxp, C, (B, H, KH, C, vid))
    kw = dict(VARIANTS[variant], scale=D ** -0.5)
    want = np.asarray(paged_chunk_attention_ref(
        *(jnp.asarray(a) for a in args), **kw))
    got = ops.paged_chunk_attention(
        *torch_args(args[:3] + (poisoned,) + args[4:]), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for b in range(B):                # padding rows and idle slots: exact 0
        assert np.all(got[b, args[5][b]:] == 0)


def test_pool_append_matches_jax_bitwise():
    """Same scatter as the JAX ``ops.paged_pool_append``: chunks straddle
    pages, one is partial, one slot is idle.  Every page but the null page
    must be bit-identical (the null page takes the padding writes, whose
    order neither side fixes)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ops import paged_pool_append

    rng = np.random.default_rng(5)
    P, psize, KH, D, B, C = 9, 4, 2, 8, 3, 6
    pool = rng.normal(size=(P, psize, KH, D)).astype(np.float32)
    new = rng.normal(size=(B, C, KH, D)).astype(np.float32)
    bt = np.asarray([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    starts = np.asarray([2, 0, 0], np.int32)
    clens = np.asarray([6, 3, 0], np.int32)
    want = np.asarray(paged_pool_append(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(bt),
        jnp.asarray(starts), jnp.asarray(clens)))
    tp = torch.tensor(pool)
    out = ops.paged_pool_append(tp, torch.tensor(new), torch.tensor(bt),
                                torch.tensor(starts), torch.tensor(clens))
    assert out is tp                              # in place
    assert np.array_equal(tp.numpy()[1:], want[1:])


def test_cpu_tensors_never_reach_the_kernel():
    """The CPU path is the plain version; the CUDA wrapper refuses CPU
    tensors instead of computing anything."""
    args, _ = chunk_case(2, 4, 2, 32, 3, 4, 0)
    t = torch_args(args)
    before = build.LAUNCHES[kernel.NAME]
    ops.paged_chunk_attention(*t, scale=0.1)
    assert build.LAUNCHES[kernel.NAME] == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.paged_chunk_attention(*t, scale=0.1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", [
    # B, H, KH, D, maxp, C, psize, kw
    (3, 4, 2, 32, 5, 23, 8, {}),
    (3, 4, 2, 32, 5, 8, 8, {"window": 11}),
    (2, 4, 4, 64, 4, 1, 8, {"softcap": 30.0}),
    (8, 16, 8, 128, 20, 64, 16, {}),
    (4, 32, 16, 128, 38, 7, 16, {"window": 64, "softcap": 50.0}),
    (2, 8, 2, 256, 6, 40, 16, {"window": 20}),
])
def test_kernel_matches_plain(cuda, dtype, geom):
    """Kernel against the plain version on the same card and inputs.  f32:
    atol/rtol 2e-5 (summation order only).  bf16 inputs, compared in f32:
    atol/rtol 2e-2, one bf16 ulp at |x| ~ 1 being 7.8e-3."""
    B, H, KH, D, maxp, C, psize, kw = geom
    args, poisoned = chunk_case(B, H, KH, D, maxp, C, (B, C, D),
                                psize=psize)
    dt = getattr(torch, dtype)
    t = torch_args(args[:3] + (poisoned,) + args[4:], cuda, dt)
    kw = dict(kw, scale=D ** -0.5)
    got = kernel.paged_chunk_attention(*t, **kw)
    want = ref.paged_chunk_attention_ref(*t, **kw)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    clens = args[5]
    for b in range(B):
        assert torch.all(got[b, int(clens[b]):] == 0)


# ---------------------------------------------------------------------------
# the logit_index window (the TPU kernel's fused verify window)
# ---------------------------------------------------------------------------
WINDOW_VARIANTS = {"plain": (4, 4, {}), "window": (4, 4, {"window": 11}),
                   "softcap": (4, 4, {"softcap": 30.0}),
                   "gqa": (8, 2, {"window": 13, "softcap": 20.0})}


def window_case(B, H, KH, D, maxp, C, seed, *, psize=PSIZE, S_w=3,
                int8=False):
    """``chunk_case`` plus a logit_index [B, S_w] of chunk positions in
    [0, C) (valid and padding rows alike), and for ``int8`` the pools as
    int8 with positive [P, KH] f32 scales.  Returns (args, poisoned,
    scales, logit_index) as numpy arrays."""
    args, poisoned = chunk_case(B, H, KH, D, maxp, C, seed, psize=psize)
    rng = np.random.default_rng((seed, 7))
    widx = rng.integers(0, C, size=(B, S_w)).astype(np.int32)
    scales = {}
    if int8:
        q, kp, vp = args[:3]
        P = kp.shape[0]
        kq, vq = (rng.integers(-127, 128, size=kp.shape).astype(np.int8)
                  for _ in range(2))
        scales = {name: rng.uniform(0.005, 0.02, size=(P, KH)).astype(
            np.float32) for name in ("k_scale", "v_scale")}
        args = (q, kq, vq) + args[3:]
    return args, poisoned, scales, widx


@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("C", [1, PSIZE, 3 * PSIZE - 1])
@pytest.mark.parametrize("variant", list(WINDOW_VARIANTS))
def test_logit_index_matches_jax_ref(variant, C, int8):
    """``logit_index`` against JAX's ``ref.paged_chunk_attention_ref``
    with the same argument: both halves of (out, out_win), f32 q, pools of
    q's dtype or int8 with scales.  atol/rtol 1e-5, the summation order of
    the two einsum/softmax implementations; padding rows that a window
    names are exact zeros on both sides."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ref import paged_chunk_attention_ref

    H, KH, kw = WINDOW_VARIANTS[variant]
    D, B, maxp = 16, 3, 5
    seed = (C, list(WINDOW_VARIANTS).index(variant), int(int8))
    args, poisoned, scales, widx = window_case(B, H, KH, D, maxp, C, seed,
                                               int8=int8)
    kw = dict(kw, scale=D ** -0.5)
    want_out, want_win = paged_chunk_attention_ref(
        *(jnp.asarray(a) for a in args), **kw,
        **{k: jnp.asarray(v) for k, v in scales.items()},
        logit_index=jnp.asarray(widx))
    q, kp, vp, bt, st, cl = args[:3] + (poisoned,) + args[4:]
    pools = [torch.tensor(a) for a in (kp, vp)]
    t = (torch.tensor(q), *pools,
         *(torch.tensor(a, dtype=torch.int32) for a in (bt, st, cl)))
    got_out, got_win = ops.paged_chunk_attention(
        *t, **kw, **{k: torch.tensor(v) for k, v in scales.items()},
        logit_index=torch.tensor(widx))
    assert got_win.shape == (B, widx.shape[1], H, D)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_win.numpy(), np.asarray(want_win),
                               atol=1e-5, rtol=1e-5)
    for b in range(B):
        for s, j in enumerate(widx[b]):
            if j >= args[5][b]:
                assert np.all(got_win[b, s].numpy() == 0)


def test_logit_index_outside_the_chunk_raises():
    """The plain version holds positions to [0, C); the kernel, which
    cannot raise, leaves such rows zero."""
    args, _ = chunk_case(2, 4, 2, 16, 3, 4, 0)
    with pytest.raises(ValueError, match="logit_index"):
        ops.paged_chunk_attention(*torch_args(args), scale=0.25,
                                  logit_index=torch.tensor([[0, 4],
                                                            [1, 2]]))


# ---------------------------------------------------------------------------
# the tensor-core kernel: routing rule (CPU) and card tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,quant,D,psize,G,want", [
    (torch.bfloat16, False, 128, 16, 2, "wgmma"),
    (torch.bfloat16, False, 64, 8, 8, "wgmma"),
    (torch.bfloat16, False, 32, 32, 64, "wgmma"),
    (torch.bfloat16, False, 96, 64, 1, "wgmma"),
    (torch.float32, False, 128, 16, 2, "cuda_core"),
    (torch.bfloat16, True, 128, 16, 2, "wgmma_int8"),
    (torch.bfloat16, True, 32, 8, 64, "wgmma_int8"),
    (torch.float32, True, 128, 16, 2, "cuda_core"),
    (torch.bfloat16, True, 256, 16, 2, "cuda_core"),
    (torch.bfloat16, False, 256, 16, 2, "cuda_core"),
    (torch.bfloat16, False, 160, 16, 2, "cuda_core"),
    (torch.bfloat16, False, 128, 4, 2, "cuda_core"),
    (torch.bfloat16, False, 128, 128, 2, "cuda_core"),
    (torch.bfloat16, False, 128, 16, 3, "cuda_core"),
    (torch.bfloat16, False, 128, 16, 128, "cuda_core"),
])
def test_chunk_route_rule(dtype, quant, D, psize, G, want):
    """bf16 q goes to the tensor cores for head dims 32-128, pages of 8-64
    tokens and G dividing the 64-row q tile: ``wgmma`` on bf16 pools,
    ``wgmma_int8`` on int8 pools; f32 q and every other shape keep the
    CUDA-core kernel."""
    assert kernel.chunk_route(dtype, quant, D, psize, G) == want
    assert want in kernel.CHUNK_ROUTES


def tc_case(B, G, KH, D, C, psize, seed):
    """Chunk inputs for the tensor-core tests: slot 0 a full C-token chunk
    after a context that straddles pages, slot 1 a partial chunk, slot 2
    idle at a start > 0, the others partial; pages shuffled across the
    pool; every dead block-table entry garbage (far outside the pool)."""
    rng = np.random.default_rng(seed)
    H = G * KH
    maxp = -(-(3 * psize + 150 + C) // psize)
    P = B * maxp + 1
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, psize, KH, D)).astype(np.float32)
    vp = rng.normal(size=(P, psize, KH, D)).astype(np.float32)
    order = 1 + rng.permutation(B * maxp)
    bt = np.full((B, maxp), 987_654, np.int32)
    starts = rng.integers(1, 3 * psize + 150, size=B).astype(np.int32)
    clens = rng.integers(1, C + 1, size=B).astype(np.int32)
    clens[0] = C
    clens[2 % B] = 0 if B > 2 else clens[2 % B]
    for b in range(B):
        live = -(-(int(starts[b]) + int(clens[b])) // psize)
        bt[b, :live] = order[b * maxp:b * maxp + live]
    return q, kp, vp, bt, starts, clens


TC_VARIANTS = [{}, {"window": 37}, {"softcap": 30.0},
               {"window": 70, "softcap": 50.0}]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("psize", [8, 16, 32])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [1, 16, 64, 256])
def test_tc_kernel_matches_plain(cuda, C, G, psize, D):
    """The tensor-core kernel against the plain version on bf16 q and
    pools, compared in f32 at atol/rtol 2e-2 (one bf16 ulp at |x| ~ 1 is
    7.8e-3; both round P to bf16 at different places).  Windows and
    softcaps cycle over the cases; padding rows and the idle slot are
    exact zeros; every launch takes the wgmma route."""
    kw = dict(TC_VARIANTS[(C + G + psize + D) % len(TC_VARIANTS)],
              scale=D ** -0.5)
    q, kp, vp, bt, st, cl = tc_case(4, G, 2, D, C, psize,
                                    seed=(C, G, psize, D))
    t = [torch.tensor(a, device=cuda).to(torch.bfloat16) for a in (q, kp, vp)]
    t += [torch.tensor(a, device=cuda) for a in (bt, st, cl)]
    assert kernel.chunk_route(torch.bfloat16, False, D, psize, G) == "wgmma"
    build.reset_launches()
    got = kernel.paged_chunk_attention(*t, **kw)
    torch.cuda.synchronize()
    assert build.ROUTE_LAUNCHES[f"{kernel.NAME}:wgmma"] == 1
    want = ref.paged_chunk_attention_ref(*t, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    for b in range(4):
        assert torch.all(got[b, int(cl[b]):] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("psize", [8, 16, 32])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [1, 16, 64, 256])
def test_tc_int8_kernel_matches_plain(cuda, C, G, psize, D):
    """The tensor-core kernel on int8 pools (bf16 q) over
    ``test_tc_kernel_matches_plain``'s grid, against the plain version
    (which dequantizes the pages in f32) and against the plain version of
    its own arithmetic (scales on the columns of S and P), compared in f32
    at atol/rtol 2e-2 (one bf16 ulp at |x| ~ 1 is 7.8e-3; the kernel
    rounds q and the scaled P to bf16).  Windows and softcaps cycle over
    the cases; padding rows and the idle slot are exact zeros; every launch
    takes the wgmma_int8 route."""
    kw = dict(TC_VARIANTS[(C + G + psize + D) % len(TC_VARIANTS)],
              scale=D ** -0.5)
    q, kp, vp, bt, st, cl = tc_case(4, G, 2, D, C, psize,
                                    seed=(C, G, psize, D, 8))
    from repro_torch.optim.compression import quantize_int8
    (kq, ks), (vq, vs) = (quantize_int8(torch.tensor(x, device=cuda),
                                        axis=(1, 3)) for x in (kp, vp))
    kw.update(k_scale=ks[:, 0, :, 0].contiguous(),
              v_scale=vs[:, 0, :, 0].contiguous())
    t = [torch.tensor(q, device=cuda).to(torch.bfloat16), kq, vq]
    t += [torch.tensor(a, device=cuda) for a in (bt, st, cl)]
    assert kernel.chunk_route(torch.bfloat16, True, D, psize, G) == \
        "wgmma_int8"
    build.reset_launches()
    got = kernel.paged_chunk_attention(*t, **kw)
    torch.cuda.synchronize()
    assert build.ROUTE_LAUNCHES[f"{kernel.NAME}:wgmma_int8"] == 1
    for plain in (ref.paged_chunk_attention_ref,
                  ref.paged_chunk_attention_int8_ref):
        want = plain(*t, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    for b in range(4):
        assert torch.all(got[b, int(cl[b]):] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("pools", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("C", [1, 23, 64])
def test_logit_index_kernel_matches_plain(cuda, C, pools):
    """Both kernels' window epilogue (the tensor-core one on bf16 and on
    int8 pools): out_win against the plain version's (which gathers its
    own out), and out_win[b, s] equal to the kernel's own out[b,
    logit_index[b, s]] bit for bit."""
    G, KH, D, psize = 2, 2, 64, 16
    q, kp, vp, bt, st, cl = tc_case(3, G, KH, D, C, psize, seed=(C, 9))
    rng = np.random.default_rng(C)
    widx = torch.tensor(rng.integers(0, C, size=(3, 4)), dtype=torch.int32,
                        device=cuda)
    dt = torch.float32 if pools == "f32" else torch.bfloat16
    t = [torch.tensor(a, device=cuda).to(dt) for a in (q, kp, vp)]
    kw = {"scale": D ** -0.5, "window": 40}
    if pools == "int8":
        from repro_torch.optim.compression import quantize_int8
        (kq, ks), (vq, vs) = (quantize_int8(x.float(), axis=(1, 3))
                              for x in t[1:])
        t[1:] = [kq, vq]
        kw.update(k_scale=ks[:, 0, :, 0].contiguous(),
                  v_scale=vs[:, 0, :, 0].contiguous())
    ints = [torch.tensor(a, device=cuda) for a in (bt, st, cl)]
    build.reset_launches()
    got, got_win = kernel.paged_chunk_attention(*t, *ints, **kw,
                                                logit_index=widx)
    route = kernel.chunk_route(dt, pools == "int8", D, psize, G)
    assert route == {"bf16": "wgmma", "f32": "cuda_core",
                     "int8": "wgmma_int8"}[pools]
    assert build.ROUTE_LAUNCHES[f"{kernel.NAME}:{route}"] == 1
    want, want_win = ref.paged_chunk_attention_ref(*t, *ints, **kw,
                                                   logit_index=widx)
    torch.cuda.synchronize()
    tol = 2e-5 if pools == "f32" else 2e-2
    torch.testing.assert_close(got_win.float(), want_win.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for b in range(3):
        for s in range(4):
            assert torch.equal(got_win[b, s], got[b, int(widx[b, s])])
