"""The port's SSD chunk scan against the JAX package's.

The plain PyTorch versions (``ssd_ref``, the token-by-token oracle, and
``ssd_chunk_scan_ref``, the chunked form of ``ssm.ssd_chunked``) get the
same numpy inputs as the JAX oracle ``repro.kernels.ssd.ref.ssd_ref`` and
``repro.models.ssm.ssd_chunked``, over the sweep of ``tests/test_kernels.py``
and two more shapes.  The ``cuda`` tests hold the hand-written kernel
against the plain version on the card and skip elsewhere; they need no
JAX, so JAX is imported inside the parity tests only.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_ssd.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import kernel, ops, ref

# (B, S, H, P, N, chunk): the sweep of tests/test_kernels.py, S 96 at chunk
# 32 (test_model_ssd_chunked_matches_sequential_ref), and S 36 at chunk 16,
# whose chunk halves 16 -> 8 -> 4 (S 33 halves down to Q = 1)
GEOMS = [(1, 64, 2, 16, 16, 16), (2, 128, 3, 16, 32, 32),
         (1, 256, 1, 32, 64, 64), (2, 96, 2, 8, 16, 32),
         (1, 36, 2, 8, 16, 16), (2, 33, 2, 8, 16, 16)]
# the tolerance of the JAX package's own SSD tests
ATOL, RTOL = 2e-4, 1e-3


def gid(g):
    return "x".join(map(str, g))


def case(B, S, H, P, N, seed):
    """x, dt, A, Bm, Cm as the JAX sweep draws them (f32 numpy)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, S, H, P)) * 0.5).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, H))) + 0.1).astype(np.float32)
    A = (-(np.abs(rng.normal(size=(H,))) + 0.5)).astype(np.float32)
    Bm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def torch_case(geom, seed, device="cpu", dtype=torch.float32):
    x, dt, A, Bm, Cm = (torch.tensor(a, device=device)
                        for a in case(*geom[:5], seed=seed))
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


@pytest.mark.parametrize("chunk,S,Q", [(256, 2048, 256), (256, 96, 96),
                                       (32, 96, 32), (16, 36, 4),
                                       (256, 257, 1), (8, 5, 5), (64, 1, 1)])
def test_chunk_len_follows_the_jax_rule(chunk, S, Q):
    """min(chunk, S), halved until it divides S (``ssd_chunked``)."""
    assert ref.chunk_len(chunk, S) == Q


@pytest.mark.parametrize("geom", GEOMS, ids=gid)
def test_plain_matches_jax_ssd_ref(geom):
    """The chunked plain version's y and final state against the JAX
    token-by-token oracle, f32, atol 2e-4 / rtol 1e-3."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd.ref import ssd_ref

    inputs = case(*geom[:5], seed=GEOMS.index(geom))
    y_want, s_want = (np.asarray(a) for a in
                      ssd_ref(*(jnp.asarray(a) for a in inputs)))
    y, state = ops.ssd_chunk_scan(*(torch.tensor(a) for a in inputs),
                                  chunk=geom[5])
    assert y.dtype == state.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(state.numpy(), s_want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("geom", GEOMS, ids=gid)
def test_plain_matches_jax_ssd_chunked(geom):
    """The chunked plain version against ``ssm.ssd_chunked``, same chunk
    rule, f32, atol 2e-4 / rtol 1e-3, on every output ``ssd_chunked``
    gives finite.  ``ssd_chunked`` masks ``exp(cum_i - cum_j)`` by a
    multiply, and above the diagonal that exponent overflows once chunks
    are long (here at Q = 64): inf * 0 puts NaN into its y.  The port
    selects instead, and is finite there."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked

    inputs = case(*geom[:5], seed=GEOMS.index(geom))
    y_want, s_want = (np.asarray(a) for a in ssd_chunked(
        *(jnp.asarray(a) for a in inputs), chunk=geom[5]))
    y, state = ops.ssd_chunk_scan(*(torch.tensor(a) for a in inputs),
                                  chunk=geom[5])
    y = y.numpy()
    assert np.isfinite(y).all()
    finite = np.isfinite(y_want)
    if geom[5] < 64:
        assert finite.all()
    np.testing.assert_allclose(y[finite], y_want[finite], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(state.numpy(), s_want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("geom", GEOMS[:4], ids=gid)
def test_port_ssd_ref_matches_jax(geom):
    """The port's token-by-token oracle against JAX's: the same recurrence
    in the same order, f32; atol/rtol 1e-5 covers the two einsums'
    summation order over N."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd.ref import ssd_ref

    inputs = case(*geom[:5], seed=GEOMS.index(geom))
    y_want, s_want = (np.asarray(a) for a in
                      ssd_ref(*(jnp.asarray(a) for a in inputs)))
    y, state = ref.ssd_ref(*(torch.tensor(a) for a in inputs))
    np.testing.assert_allclose(y.numpy(), y_want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state.numpy(), s_want, atol=1e-5, rtol=1e-5)


def test_bf16_inputs_run_in_f32():
    """bf16 x, Bm and Cm are widened to f32 before any arithmetic: the
    result equals the f32 call on the same rounded values, bit for bit."""
    x, dt, A, Bm, Cm = torch_case(GEOMS[1], seed=7, dtype=torch.bfloat16)
    got = ops.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=32)
    want = ops.ssd_chunk_scan(x.float(), dt, A, Bm.float(), Cm.float(),
                              chunk=32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_cpu_tensors_never_reach_the_kernel():
    """The CPU path is the plain version; the CUDA wrapper refuses CPU
    tensors."""
    x, dt, A, Bm, Cm = torch_case(GEOMS[0], seed=2)
    before = build.LAUNCHES[kernel.NAME]
    ops.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=16)
    assert build.LAUNCHES[kernel.NAME] == before
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# the sweep plus S 257 at the published chunk of 256 (Q halves to 1), a
# ragged P and N, and a chunk that is not a multiple of the 64-row tile
CUDA_GEOMS = GEOMS + [(1, 257, 2, 16, 32, 256), (2, 48, 2, 20, 100, 48),
                      (1, 96, 3, 64, 128, 256)]
FULL = (2, 2048, 80, 64, 128, 256)     # mamba2-2.7b's SSD at seq 2048


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", CUDA_GEOMS + [FULL], ids=gid)
def test_kernel_matches_plain(cuda, geom, dtype):
    """y and the final state from the kernel against the plain version on
    the same card and inputs.  Both compute in f32 from the same (bf16-
    rounded) values and differ only in summation order: atol 2e-4 / rtol
    1e-3, the JAX tests' tolerance."""
    x, dt, A, Bm, Cm = torch_case(geom, seed=CUDA_GEOMS.index(geom)
                                  if geom in CUDA_GEOMS else 99,
                                  device=cuda, dtype=getattr(torch, dtype))
    y, state = kernel.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=geom[5])
    y_want, s_want = ref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk=geom[5])
    torch.cuda.synchronize()
    assert y.dtype == state.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    torch.testing.assert_close(y, y_want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(state, s_want, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, Bm, Cm = torch_case(GEOMS[0], seed=3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.ssd_chunk_scan(x.transpose(2, 3).contiguous().transpose(2, 3),
                              dt, A, Bm, Cm, chunk=16)
    with pytest.raises(TypeError, match="one type"):
        kernel.ssd_chunk_scan(x, dt, A, Bm.to(torch.bfloat16), Cm, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        kernel.ssd_chunk_scan(x, dt.double(), A, Bm, Cm, chunk=16)
    wide = torch.zeros(*x.shape[:3], 65, device=cuda)
    with pytest.raises(ValueError, match="P <= 64"):
        kernel.ssd_chunk_scan(wide, dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match=r"\[B, S, N\]"):
        kernel.ssd_chunk_scan(x, dt, A, Bm[:, :-1].contiguous(), Cm,
                              chunk=16)


@pytest.mark.cuda
def test_ops_launches_the_kernel_once(cuda):
    x, dt, A, Bm, Cm = torch_case(GEOMS[0], seed=4, device=cuda)
    build.reset_launches()
    ops.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=16)
    assert build.LAUNCHES[kernel.NAME] == 1
