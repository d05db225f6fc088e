"""The port's block-sparse dropout matmul against the JAX package's.

The plain PyTorch ``dropout_matmul_ref`` gets the same numpy inputs as the
JAX oracle ``repro.kernels.dropout_matmul.ref.dropout_matmul_ref`` over the
sweep of ``tests/test_kernels.py``.  The ``cuda`` tests hold the
hand-written kernel against the plain version on the card and skip
elsewhere; they need no JAX, so JAX is imported inside the parity tests
only.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_dropout_matmul.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.dropout_matmul import kernel, ops, ref

# (G, M, K, N, block_n): the sweep of tests/test_kernels.py
SWEEP = [(1, 128, 128, 128, 128), (2, 256, 128, 512, 128),
         (4, 128, 256, 256, 64), (3, 128, 384, 640, 128)]
DTYPES = ["float32", "bfloat16"]


def case(G, M, K, N, bn, seed):
    """x, w and a {0, 2} mask from numpy, every group with a live block."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mask = rng.choice([0.0, 2.0], size=(G, N // bn)).astype(np.float32)
    mask[np.arange(G), np.arange(G) % (N // bn)] = 2.0
    return x, w, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", SWEEP, ids=lambda g: "x".join(map(str, g)))
def test_plain_matches_jax_ref(geom, dtype):
    """Both sides cast to f32 and take one f32 product (bf16 inputs round
    the same numpy values the same way); atol 1e-4 / rtol 1e-5 covers the
    two einsums' summation orders over K <= 384 terms of |y| ~ 20."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.dropout_matmul.ref import dropout_matmul_ref

    G, M, K, N, bn = geom
    x, w, mask = case(*geom, seed=SWEEP.index(geom))
    jdt = getattr(jnp, dtype)
    want = np.asarray(dropout_matmul_ref(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(mask),
        block_n=bn))
    dt = getattr(torch, dtype)
    got = ops.dropout_matmul(torch.tensor(x).to(dt), torch.tensor(w).to(dt),
                             torch.tensor(mask), block_n=bn)
    assert got.dtype == torch.float32 and got.shape == (G, M, N)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_all_dropped_block_is_zero():
    """The case of ``tests/test_kernels.py``: a dropped block is exactly 0,
    a kept one carries the 1/keep scale."""
    x = torch.ones(1, 128, 128)
    w = torch.ones(128, 256)
    out = ops.dropout_matmul(x, w, torch.tensor([[0.0, 2.0]]), block_n=128)
    assert (out[:, :, :128] == 0).all()
    assert (out[:, :, 128:] == 2 * 128).all()


@pytest.mark.parametrize("which", ["x", "w"])
def test_gradient_is_refused(which):
    """Forward-only on the CPU as on the card: a gradient request raises
    and names ROADMAP; without grad mode the same call runs."""
    x, w, mask = (torch.tensor(a) for a in case(2, 8, 16, 128, 64, seed=1))
    {"x": x, "w": w}[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="ROADMAP"):
        ops.dropout_matmul(x, w, mask, block_n=64)
    with torch.no_grad():
        assert ops.dropout_matmul(x, w, mask, block_n=64).shape == (2, 8, 128)


def test_cpu_tensors_never_reach_the_kernel():
    """The CPU path is the plain version; the CUDA wrapper refuses CPU
    tensors and a wrong mask shape raises on both paths."""
    x, w, mask = (torch.tensor(a) for a in case(2, 8, 16, 128, 64, seed=2))
    before = build.LAUNCHES[kernel.NAME]
    ops.dropout_matmul(x, w, mask, block_n=64)
    assert build.LAUNCHES[kernel.NAME] == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.dropout_matmul(x, w, mask, block_n=64)
    with pytest.raises(ValueError, match="mask"):
        ref.dropout_matmul_ref(x, w, mask[:, :1], block_n=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# the sweep, plus ragged M and K (odd K: x rows not 16-byte aligned), a
# block_n of 192, and an empty K
CUDA_CASES = SWEEP + [(2, 7, 13, 128, 64), (1, 130, 40, 192, 64),
                      (3, 129, 33, 384, 192), (2, 3, 0, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", CUDA_CASES,
                         ids=lambda g: "x".join(map(str, g)))
def test_kernel_matches_plain(cuda, geom, dtype):
    """The kernel against the plain version on the same card and inputs,
    with the JAX sweep's tolerances: atol tol * sqrt(K), rtol tol, tol 1e-4
    in f32 and 0.15 in bf16 (both sides sum exact products in f32, so the
    measured error is far below)."""
    G, M, K, N, bn = geom
    x, w, mask = (torch.tensor(a, device=cuda)
                  for a in case(*geom, seed=CUDA_CASES.index(geom)))
    dt = getattr(torch, dtype)
    x, w = x.to(dt), w.to(dt)
    got = kernel.dropout_matmul(x, w, mask, block_n=bn)
    want = ref.dropout_matmul_ref(x, w, mask, block_n=bn)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 0.15
    assert got.dtype == torch.float32 and got.shape == (G, M, N)
    torch.testing.assert_close(got, want, atol=tol * max(K, 1) ** 0.5,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_dropped_tiles_never_read_their_weights(cuda, dtype):
    """Columns of w in blocks that every group drops are NaN: the plain
    version's 0 * NaN is NaN there, the kernel's output is exactly 0,
    because those tiles never enter their K loop; the live columns match."""
    G, M, K, N, bn = 2, 256, 128, 512, 128
    x, w, _ = case(G, M, K, N, bn, seed=5)
    mask = torch.tensor([[2.0, 0.0, 2.0, 0.0], [0.0, 0.0, 2.0, 2.0]],
                        device=cuda)
    dt = getattr(torch, dtype)
    w = torch.tensor(w, device=cuda)
    w[:, bn:2 * bn] = float("nan")
    x, w = torch.tensor(x, device=cuda).to(dt), w.to(dt)
    got = kernel.dropout_matmul(x, w, mask, block_n=bn)
    torch.cuda.synchronize()
    assert (got[:, :, bn:2 * bn] == 0).all()
    keep = torch.cat([torch.arange(bn), torch.arange(2 * bn, N)]).to(cuda)
    want = ref.dropout_matmul_ref(x, w.index_select(1, keep),
                                  torch.stack([mask[:, 0], mask[:, 2],
                                               mask[:, 3]], 1), block_n=bn)
    torch.testing.assert_close(got.index_select(2, keep), want,
                               atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, w, mask = (torch.tensor(a, device=cuda)
                  for a in case(2, 8, 64, 128, 64, seed=3))
    with pytest.raises(ValueError, match="contiguous"):
        kernel.dropout_matmul(x.transpose(1, 2).contiguous().transpose(1, 2),
                              w, mask, block_n=64)
    shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        kernel.dropout_matmul(shifted, w, mask, block_n=64)
    with pytest.raises(ValueError, match="block_n"):
        kernel.dropout_matmul(x, w, mask, block_n=32)
    with pytest.raises(ValueError, match="mask_blocks"):
        kernel.dropout_matmul(x, w, mask[:, :1], block_n=64)
    with pytest.raises(TypeError, match="one type"):
        kernel.dropout_matmul(x, w.to(torch.bfloat16), mask, block_n=64)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="ROADMAP"):
        kernel.dropout_matmul(x, w, mask, block_n=64)


@pytest.mark.cuda
def test_ops_launches_the_kernel_once(cuda):
    x, w, mask = (torch.tensor(a, device=cuda)
                  for a in case(2, 64, 64, 256, 128, seed=4))
    build.reset_launches()
    ops.dropout_matmul(x, w, mask, block_n=128)
    assert build.LAUNCHES[kernel.NAME] == 1


@pytest.mark.parametrize("dtype,K,want", [
    (torch.bfloat16, 2048, "wgmma"), (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 40, "wgmma"), (torch.bfloat16, 13, "mma_sync"),
    (torch.bfloat16, 33, "mma_sync"), (torch.bfloat16, 0, "mma_sync"),
    (torch.float32, 2048, "f32"), (torch.float32, 13, "f32"),
])
def test_route_rule(dtype, K, want):
    """bf16 goes to the wgmma kernel where TMA can describe x (rows of a
    multiple of 16 bytes, K > 0), else to the mma.sync kernel; f32 to the
    CUDA-core kernel.  Other dtypes have no kernel."""
    assert kernel.route(dtype, K) == want
    assert want in kernel.ROUTES


def test_route_rule_refuses_other_dtypes():
    with pytest.raises(TypeError, match="no kernel"):
        kernel.route(torch.float16, 64)


# (G, M, K, N, block_n) on the wgmma route: ragged M (past one 128-row
# tile, and below one 64-row half), K not a multiple of the 64-deep stage,
# block_n 64 (64-column tiles) and 128 (128-column tiles), G 1 to 4, and
# more tiles than a card has SMs (the persistent grid walks several)
WGMMA_CASES = [(1, 1, 8, 64, 64), (2, 130, 40, 256, 128),
               (3, 257, 136, 384, 64), (4, 64, 2048, 512, 128),
               (1, 300, 520, 640, 128), (2, 7, 72, 192, 64),
               (4, 1024, 256, 2048, 128), (3, 200, 1000, 1536, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("geom", WGMMA_CASES,
                         ids=lambda g: "x".join(map(str, g)))
def test_wgmma_route_matches_plain(cuda, geom):
    """The wgmma kernel against the plain version, bf16 inputs, the JAX
    sweep's bf16 tolerance (atol 0.15 * sqrt(K), rtol 0.15); dropped
    tiles exactly 0; every launch counted on the wgmma route."""
    G, M, K, N, bn = geom
    x, w, mask = (torch.tensor(a, device=cuda)
                  for a in case(*geom, seed=WGMMA_CASES.index(geom) + 50))
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    assert kernel.route(x.dtype, K) == "wgmma"
    build.reset_launches()
    got = kernel.dropout_matmul(x, w, mask, block_n=bn)
    want = ref.dropout_matmul_ref(x, w, mask, block_n=bn)
    torch.cuda.synchronize()
    assert build.ROUTE_LAUNCHES["dropout_matmul:wgmma"] == 1
    assert build.LAUNCHES[kernel.NAME] == 1
    assert got.dtype == torch.float32 and got.shape == (G, M, N)
    torch.testing.assert_close(got, want, atol=0.15 * K ** 0.5, rtol=0.15)
    dropped = torch.repeat_interleave(mask == 0, bn, dim=1)[:, None, :]
    assert torch.all(got.masked_select(dropped.expand_as(got)) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [64, 128])
def test_wgmma_route_all_dropped_and_one_live(cuda, bn):
    """An all-dropped mask gives exact zeros (no tile runs its K loop);
    with one live block in one group, that block matches the plain
    version and everything else is exactly 0."""
    G, M, K, N = 3, 200, 264, 768
    x, w, _ = case(G, M, K, N, bn, seed=bn)
    x = torch.tensor(x, device=cuda).to(torch.bfloat16)
    w = torch.tensor(w, device=cuda).to(torch.bfloat16)
    nb = N // bn
    none = torch.zeros(G, nb, device=cuda)
    got = kernel.dropout_matmul(x, w, none, block_n=bn)
    torch.cuda.synchronize()
    assert torch.all(got == 0)
    one = none.clone()
    one[1, nb // 2] = 2.0
    got = kernel.dropout_matmul(x, w, one, block_n=bn)
    want = ref.dropout_matmul_ref(x, w, one, block_n=bn)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0.15 * K ** 0.5, rtol=0.15)
    live = torch.zeros_like(got, dtype=torch.bool)
    live[1, :, (nb // 2) * bn:(nb // 2 + 1) * bn] = True
    assert torch.all(got[~live] == 0)
    assert torch.all(got[live] != 0)


@pytest.mark.cuda
def test_each_route_counts_its_own_launches(cuda):
    """One launch on each of the three kernels: the total and each
    route's count move by one."""
    build.reset_launches()
    for dtype, K in ((torch.bfloat16, 64), (torch.bfloat16, 13),
                     (torch.float32, 64)):
        x, w, mask = (torch.tensor(a, device=cuda)
                      for a in case(2, 64, K, 256, 128, seed=K))
        kernel.dropout_matmul(x.to(dtype), w.to(dtype), mask, block_n=128)
    torch.cuda.synchronize()
    assert build.LAUNCHES[kernel.NAME] == 3
    for how in kernel.ROUTES:
        assert build.ROUTE_LAUNCHES[f"{kernel.NAME}:{how}"] == 1
