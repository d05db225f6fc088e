"""The SSD chunk scan's wgmma route: its routing rule and its rounding.

The wgmma kernel (``csrc/ssd_chunk_scan.cu``, ``ssd_chunk_scan_wgmma_kernel``)
walks the sequence in 64-token blocks and feeds each f32 operand (T, the
carried state, w x) to the tensor cores as two bf16 terms.  Its arithmetic
is written plainly in ``ref.ssd_split_ref``; here that emulation is held on
the CPU against the JAX oracle ``ssd_ref``, against JAX's ``ssd_chunked``
and against the port's ``ssd_chunk_scan_ref`` at the caller's chunk, at
the tolerance of the JAX package's SSD tests (atol 2e-4, rtol 1e-3).  The
``cuda`` tests hold the kernel against both plain versions on the card and
assert the route each launch took; they skip elsewhere.

    PYTHONPATH=src python -m pytest tests/test_torch_ssd_split.py
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_ssd_split.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import kernel, ref
from test_torch_ssd import ATOL, CUDA_GEOMS, FULL, RTOL, case, gid

# (B, S, H, P, N, chunk) on the wgmma route: P 16/32/48/64, N 16/32/96/128
# (N <= 64 runs the kernel's 64-column tiles), chunks of 64-256 tokens, up
# to (1, 512, 4, 64, 128, 256): mamba2-2.7b's P, N and chunk
SPLIT_GEOMS = [(1, 256, 1, 32, 64, 64), (2, 128, 3, 16, 32, 64),
               (1, 192, 3, 16, 16, 64), (2, 256, 2, 48, 96, 128),
               (1, 512, 4, 64, 128, 256)]

# the route every geometry of the CUDA grid must take, by dtype: only bf16
# with chunks of a multiple of 64 tokens, P and N multiples of 16 goes to
# the tensor cores
EXPECTED_ROUTE = {
    (1, 64, 2, 16, 16, 16): "cuda_core",      # Q 16
    (2, 128, 3, 16, 32, 32): "cuda_core",     # Q 32
    (1, 256, 1, 32, 64, 64): "wgmma",
    (2, 96, 2, 8, 16, 32): "cuda_core",       # Q 32, P 8
    (1, 36, 2, 8, 16, 16): "cuda_core",       # Q 4
    (2, 33, 2, 8, 16, 16): "cuda_core",       # Q 1
    (1, 257, 2, 16, 32, 256): "cuda_core",    # Q 1
    (2, 48, 2, 20, 100, 48): "cuda_core",     # Q 48, P 20, N 100
    (1, 96, 3, 64, 128, 256): "cuda_core",    # Q 96
    FULL: "wgmma",
}


def edge_dt(dt):
    """dt with some tokens at 0, some tiny (1e-30) and some negative
    (-0.05): the contract takes any finite dt, and the wgmma kernel
    multiplies by dt after the exponent, never taking a log of it."""
    dt = dt.clone()
    dt[:, 0::5] = 0.0
    dt[:, 3::7] = 1e-30
    dt[:, 1::11] = -0.05
    return dt


def bf16_case(geom, seed):
    """The sweep's inputs with x, Bm and Cm rounded to bf16: (torch
    tensors, the same values in f32 numpy for JAX)."""
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in case(*geom[:5], seed=seed))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    exact = [t.float().numpy() for t in (x, dt, A, Bm, Cm)]
    return (x, dt, A, Bm, Cm), exact


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", CUDA_GEOMS + [FULL], ids=gid)
def test_route_rule(geom, dtype):
    """Every geometry of the card grid, in both dtypes, takes the route
    the rule gives: f32 always the CUDA-core kernel."""
    B, S, H, P, N, chunk = geom
    want = EXPECTED_ROUTE[geom] if dtype == "bfloat16" else "cuda_core"
    assert kernel.route(getattr(torch, dtype), P, N,
                        ref.chunk_len(chunk, S)) == want


@pytest.mark.parametrize("geom", SPLIT_GEOMS, ids=gid)
def test_split_geoms_take_the_wgmma_route(geom):
    B, S, H, P, N, chunk = geom
    assert kernel.route(torch.bfloat16, P, N,
                        ref.chunk_len(chunk, S)) == "wgmma"


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="no kernel"):
        kernel.route(torch.float16, 64, 128, 256)


def test_bf16_split_holds_a_value_to_2_to_the_minus_16():
    """hi + lo of ``bf16_split`` is within 2^-16 relative of the f32
    value; hi alone (one bf16 term) only within 2^-9."""
    v = torch.tensor(np.random.default_rng(0).normal(size=4096) * 10.0,
                     dtype=torch.float32)
    hi, lo = ref.bf16_split(v)
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    assert ((hi + lo - v).abs() <= v.abs() * 2.0 ** -16).all()
    assert ((hi - v).abs() > v.abs() * 2.0 ** -16).any()


def test_split_ref_refuses_a_ragged_sequence():
    (x, dt, A, Bm, Cm), _ = bf16_case((1, 96, 1, 16, 16, 64), seed=0)
    with pytest.raises(ValueError, match="multiple of the block"):
        ref.ssd_split_ref(x, dt, A, Bm, Cm)


@pytest.mark.parametrize("geom", SPLIT_GEOMS, ids=gid)
def test_split_matches_jax_ssd_ref(geom):
    """The emulated wgmma arithmetic against JAX's token-by-token oracle on
    the same (bf16-exact) values: y and the final state, atol 2e-4 / rtol
    1e-3."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd.ref import ssd_ref

    inputs, exact = bf16_case(geom, seed=SPLIT_GEOMS.index(geom))
    y_want, s_want = (np.asarray(a) for a in
                      ssd_ref(*(jnp.asarray(a) for a in exact)))
    y, state = ref.ssd_split_ref(*inputs)
    assert y.dtype == state.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(state.numpy(), s_want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("geom", SPLIT_GEOMS, ids=gid)
def test_split_matches_jax_ssd_chunked(geom):
    """Against ``ssm.ssd_chunked`` at the caller's chunk, atol 2e-4 / rtol
    1e-3, on every y that ``ssd_chunked`` gives finite (its masked multiply
    of an overflowing exponent puts NaN in y once chunks are long;
    ``test_torch_ssd.py::test_plain_matches_jax_ssd_chunked``); its final
    state is finite throughout."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked

    inputs, exact = bf16_case(geom, seed=SPLIT_GEOMS.index(geom))
    y_want, s_want = (np.asarray(a) for a in ssd_chunked(
        *(jnp.asarray(a) for a in exact), chunk=geom[5]))
    y, state = ref.ssd_split_ref(*inputs)
    y = y.numpy()
    assert np.isfinite(y).all()
    finite = np.isfinite(y_want)
    assert finite.any()
    np.testing.assert_allclose(y[finite], y_want[finite], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(state.numpy(), s_want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("geom", SPLIT_GEOMS, ids=gid)
def test_split_matches_plain_chunk_scan(geom):
    """Against the port's chunked plain version at the caller's chunk (what
    ``chip_smoke.py`` and the ``cuda`` tests hold the kernel against),
    atol 2e-4 / rtol 1e-3."""
    inputs, _ = bf16_case(geom, seed=SPLIT_GEOMS.index(geom))
    y, state = ref.ssd_split_ref(*inputs)
    y_want, s_want = ref.ssd_chunk_scan_ref(*inputs, chunk=geom[5])
    torch.testing.assert_close(y, y_want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(state, s_want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("geom", SPLIT_GEOMS[:3], ids=gid)
def test_split_matches_plain_and_jax_at_zero_tiny_and_negative_dt(geom):
    """dt at 0, 1e-30 and -0.05 on some tokens: the emulated wgmma
    arithmetic stays finite and matches ``ssd_chunk_scan_ref`` and JAX's
    ``ssd_ref`` on the same values, atol 2e-4 / rtol 1e-3."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ssd.ref import ssd_ref

    (x, dt, A, Bm, Cm), exact = bf16_case(geom, seed=11)
    dt = edge_dt(dt)
    exact[1] = dt.numpy()
    y, state = ref.ssd_split_ref(x, dt, A, Bm, Cm)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    y_want, s_want = ref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk=geom[5])
    torch.testing.assert_close(y, y_want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(state, s_want, atol=ATOL, rtol=RTOL)
    y_jax, s_jax = (np.asarray(a) for a in
                    ssd_ref(*(jnp.asarray(a) for a in exact)))
    np.testing.assert_allclose(y.numpy(), y_jax, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(state.numpy(), s_jax, atol=ATOL, rtol=RTOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def route_launches(how):
    return build.ROUTE_LAUNCHES.get(f"{kernel.NAME}:{how}", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", CUDA_GEOMS + [FULL] + SPLIT_GEOMS[1:],
                         ids=gid)
def test_kernel_route_matches_both_plain_versions(cuda, geom, dtype):
    """Each launch takes the route of the rule (asserted by its count),
    and y and the final state match ``ssd_chunk_scan_ref`` and, on the
    wgmma route, ``ssd_split_ref`` on the same card and inputs, atol 2e-4
    / rtol 1e-3."""
    B, S, H, P, N, chunk = geom
    dt_ = getattr(torch, dtype)
    how = kernel.route(dt_, P, N, ref.chunk_len(chunk, S))
    if geom in EXPECTED_ROUTE:
        assert how == (EXPECTED_ROUTE[geom] if dtype == "bfloat16"
                       else "cuda_core")
    x, dt, A, Bm, Cm = (torch.tensor(a, device=cuda) for a in
                        case(*geom[:5], seed=7))
    x, Bm, Cm = x.to(dt_), Bm.to(dt_), Cm.to(dt_)
    build.reset_launches()
    y, state = kernel.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert build.LAUNCHES[kernel.NAME] == route_launches(how) == 1
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    wants = [ref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)]
    if how == "wgmma":
        wants.append(ref.ssd_split_ref(x, dt, A, Bm, Cm))
    for y_want, s_want in wants:
        torch.testing.assert_close(y, y_want, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(state, s_want, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [SPLIT_GEOMS[0], SPLIT_GEOMS[-1], FULL],
                         ids=gid)
def test_wgmma_kernel_takes_zero_tiny_and_negative_dt(cuda, geom):
    """dt at 0, 1e-30 and -0.05 on some tokens, on the wgmma route: y and
    the final state are finite and match both plain versions, atol 2e-4 /
    rtol 1e-3."""
    B, S, H, P, N, chunk = geom
    x, dt, A, Bm, Cm = (torch.tensor(a, device=cuda) for a in
                        case(B, S, H, P, N, seed=13))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    dt = edge_dt(dt)
    build.reset_launches()
    y, state = kernel.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert route_launches("wgmma") == 1
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    for y_want, s_want in (ref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm,
                                                  chunk=chunk),
                           ref.ssd_split_ref(x, dt, A, Bm, Cm)):
        torch.testing.assert_close(y, y_want, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(state, s_want, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_wgmma_kernel_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits (no atomics)."""
    x, dt, A, Bm, Cm = (torch.tensor(a, device=cuda) for a in
                        case(*SPLIT_GEOMS[-1][:5], seed=3))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    first = kernel.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=256)
    again = kernel.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=256)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wgmma_route_refuses_unaligned_tiles(cuda):
    """The wgmma kernel copies x, Bm and Cm by TMA: a tensor that does not
    start on a 16-byte boundary raises, and nothing falls back."""
    B, S, H, P, N, chunk = SPLIT_GEOMS[0]
    x, dt, A, Bm, Cm = (torch.tensor(a, device=cuda) for a in
                        case(B, S, H, P, N, seed=5))
    x, Cm = x.to(torch.bfloat16), Cm.to(torch.bfloat16)
    flat = torch.zeros(B * S * N + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(B, S, N)
    shifted.copy_(Bm)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    build.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        kernel.ssd_chunk_scan(x, dt, A, shifted, Cm, chunk=chunk)
    assert build.LAUNCHES[kernel.NAME] == 0
