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
