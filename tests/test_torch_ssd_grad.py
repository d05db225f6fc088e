"""The gradient of the port's SSD chunk scan.

* Autograd through ``ops.ssd_chunk_scan`` on the CPU (the plain version)
  against ``jax.vjp`` of the JAX package's ``ssd_chunked``, over both
  outputs with nonzero cotangents of y and of the final state, at the
  ``test_torch_ssd.py`` geometries whose chunk is under 64 tokens (there
  ``ssd_chunked``'s 0/1-multiplied mask stays finite; ROADMAP section 3).
* ``ref.ssd_chunk_scan_bwd_ref`` (the backward kernel's arithmetic and
  schedule, written plainly) against that autograd, at chunks of 1 to 256
  tokens and S not a multiple of the 64-token block.
* ``torch.autograd.gradcheck`` in f64 on a tiny case, of the plain version
  and of ``ssd_chunk_scan_bwd_ref`` as the backward of an
  ``autograd.Function``.
* ``route_bwd``, the cluster rule and the wgmma route's scratch.
* ``cuda`` cases (each backward route against autograd through the plain
  version on the card, every wgmma-routed case also forced through the
  CUDA-core kernel; bit-equality of two calls) that skip without a card;
  they need no JAX, which the parity tests import inside.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_ssd_grad.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import kernel, ops, ref
from test_torch_ssd import GEOMS, case, gid

# the gradient parity of two f32 implementations of one chunked algorithm,
# summed in different orders
ATOL, RTOL = 1e-5, 1e-4
# the plain backward against autograd: the forward tests' tolerance (its
# sums of up to 64 x 128 f32 products run in another order and blocking)
BWD_ATOL, BWD_RTOL = 2e-4, 1e-3
NAMES = ("x", "dt", "A", "Bm", "Cm")


def cotangents(B, S, H, P, N, seed):
    """dy [B, S, H, P] and dstate [B, H, P, N], f32 numpy."""
    rng = np.random.default_rng(1000 + seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.normal(size=(B, H, P, N)).astype(np.float32))


def autograd_grads(fn, inputs, dy, dstate):
    """d/d inputs of <y, dy> + <state, dstate> through ``fn``."""
    ins = [t.clone().requires_grad_(True) for t in inputs]
    y, state = fn(*ins)
    loss = (y * dy).sum() + (0 if dstate is None else (state * dstate).sum())
    return torch.autograd.grad(loss, ins)


@pytest.mark.parametrize("geom", [g for g in GEOMS if g[5] < 64], ids=gid)
def test_port_grads_match_jax_vjp_of_ssd_chunked(geom):
    """Autograd through the port's CPU path against ``jax.vjp`` of
    ``ssd_chunked`` with the same cotangents, every input, f32: atol 1e-5 /
    rtol 1e-4."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked

    B, S, H, P, N, chunk = geom
    inputs = case(B, S, H, P, N, seed=GEOMS.index(geom))
    dy, ds = cotangents(B, S, H, P, N, GEOMS.index(geom))
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk=chunk),
                     *(jnp.asarray(a) for a in inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = autograd_grads(
        lambda *a: ops.ssd_chunk_scan(*a, chunk=chunk),
        [torch.tensor(a) for a in inputs], torch.tensor(dy), torch.tensor(ds))
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all(), name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL,
                                   err_msg=name)


# (B, S, H, P, N, chunk): the sweep, chunks of 1, 7 and 256 tokens, S not
# a multiple of 64 (one block, a short last block, S 257 -> Q 1), a ragged
# P and N
BWD_GEOMS = GEOMS + [(2, 130, 3, 8, 12, 32), (1, 257, 2, 16, 32, 256),
                     (1, 200, 2, 5, 7, 256), (2, 49, 2, 20, 100, 7),
                     (1, 64, 2, 16, 16, 1), (2, 1, 2, 8, 8, 64)]


@pytest.mark.parametrize("with_dstate", [True, False], ids=["dstate",
                                                             "no-dstate"])
@pytest.mark.parametrize("geom", BWD_GEOMS, ids=gid)
def test_bwd_ref_matches_autograd(geom, with_dstate):
    """``ssd_chunk_scan_bwd_ref`` in 64-token blocks against autograd
    through ``ssd_chunk_scan_ref`` at the geometry's own chunk, f32: atol
    2e-4 / rtol 1e-3."""
    B, S, H, P, N, chunk = geom
    seed = BWD_GEOMS.index(geom)
    inputs = [torch.tensor(a) for a in case(B, S, H, P, N, seed=seed)]
    dy, ds = (torch.tensor(a) for a in cotangents(B, S, H, P, N, seed))
    ds = ds if with_dstate else None
    want = autograd_grads(
        lambda *a: ref.ssd_chunk_scan_ref(*a, chunk=chunk), inputs, dy, ds)
    got = ref.ssd_chunk_scan_bwd_ref(*inputs, dy, ds)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        torch.testing.assert_close(g, w, atol=BWD_ATOL, rtol=BWD_RTOL,
                                   msg=lambda m: f"{name}: {m}")


def test_bwd_ref_takes_any_block():
    """The gradient does not depend on the block: 16-token blocks give
    what 64-token blocks give, at the same tolerance."""
    B, S, H, P, N, chunk = 2, 130, 3, 8, 12, 32
    inputs = [torch.tensor(a) for a in case(B, S, H, P, N, seed=5)]
    dy, ds = (torch.tensor(a) for a in cotangents(B, S, H, P, N, 5))
    for g16, g64 in zip(ref.ssd_chunk_scan_bwd_ref(*inputs, dy, ds,
                                                   block=16),
                        ref.ssd_chunk_scan_bwd_ref(*inputs, dy, ds)):
        torch.testing.assert_close(g16, g64, atol=BWD_ATOL, rtol=BWD_RTOL)


class PlainBwd(torch.autograd.Function):
    """``ssd_chunk_scan_ref`` forward, ``ssd_chunk_scan_bwd_ref``
    backward (the kernels' pairing, in plain PyTorch)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return ref.ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk=4)

    @staticmethod
    def backward(ctx, dy, dstate):
        return ref.ssd_chunk_scan_bwd_ref(*ctx.saved_tensors, dy, dstate,
                                          block=3)


@pytest.mark.parametrize("fn", ["autograd", "bwd_ref"])
def test_gradcheck_f64(fn):
    """Both gradients against finite differences, f64 (the plain versions
    compute in f64 for f64 inputs), S 8 in chunks of 4 and blocks of 3 (a
    short last block), dt of both signs."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 2, 3, generator=g, dtype=torch.float64)
    dt = torch.randn(1, 8, 2, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(2, generator=g, dtype=torch.float64) - 0.2
    Bm, Cm = (torch.randn(1, 8, 4, generator=g, dtype=torch.float64)
              for _ in range(2))
    inputs = [t.requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    f = (PlainBwd.apply if fn == "bwd_ref" else
         lambda *a: ref.ssd_chunk_scan_ref(*a, chunk=4))
    assert torch.autograd.gradcheck(f, inputs)


def test_split_ref_stays_forward_only():
    """``ssd_split_ref`` restates the forward kernel's rounding and is not
    a function to train through: a gradient request raises and names what
    to differentiate; without grad mode it runs."""
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in case(1, 64, 2, 16, 16, 1))
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="ssd_chunk_scan_ref"):
        ref.ssd_split_ref(x, dt, A, Bm, Cm)
    with torch.no_grad():
        y, state = ref.ssd_split_ref(x, dt, A, Bm, Cm)
    assert y.shape == x.shape and state.shape == (1, 2, 16, 16)


def test_cpu_gradient_launches_no_kernel():
    """A CPU backward goes through the plain version: neither kernel's
    count moves, and the wrapper refuses CPU tensors."""
    inputs = [torch.tensor(a) for a in case(1, 64, 2, 16, 16, 2)]
    dy, ds = (torch.tensor(a) for a in cotangents(1, 64, 2, 16, 16, 2))
    before = dict(build.LAUNCHES)
    grads = autograd_grads(lambda *a: ops.ssd_chunk_scan(*a, chunk=16),
                           inputs, dy, ds)
    assert all(torch.isfinite(g).all() for g in grads)
    assert build.LAUNCHES[kernel.NAME] == before[kernel.NAME]
    assert build.LAUNCHES[kernel.NAME_BWD] == before[kernel.NAME_BWD]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_chunk_scan_bwd(*inputs, dy, ds)


def test_boundary_bytes_in_training_by_hand():
    """Forward and backward of one call under the cost counter: the
    forward reads x, dt, A, Bm, Cm and writes y and the final state (f32);
    the backward reads the five and both cotangents and writes the five
    gradients, each once, whatever the plain version's autograd moves."""
    from repro_torch import scope
    from repro_torch.launch import analysis as A

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 2, 4, generator=g).requires_grad_(True)
    dt = (torch.rand(1, 8, 2, generator=g) + 0.1).requires_grad_(True)
    A_ = (-torch.rand(2, generator=g)).requires_grad_(True)
    Bm, Cm = (torch.randn(1, 8, 3, generator=g).requires_grad_(True)
              for _ in range(2))
    ins = (64 + 16 + 2 + 24 + 24) * 4
    outs = (64 + 2 * 4 * 3) * 4
    with A.CostCounter(hold=(x, dt, A_, Bm, Cm)) as counter:
        with scope.Scope("ssd_chunk"):
            y, state = ops.ssd_chunk_scan(x, dt, A_, Bm, Cm, chunk=4)
        (y.sum() + state.sum()).backward()
    got = counter.by_tag()["ssd_chunk"]
    assert got["bytes"] == (ins + outs) + (2 * ins + outs)
    assert x.grad is not None and A_.grad is not None


@pytest.mark.parametrize("dtype,P,N,want", [
    ("bfloat16", 64, 128, "wgmma"), ("bfloat16", 64, 16, "wgmma"),
    ("bfloat16", 16, 16, "wgmma"), ("bfloat16", 48, 96, "wgmma"),
    ("bfloat16", 20, 100, "cuda_core"), ("bfloat16", 64, 120, "cuda_core"),
    ("bfloat16", 8, 16, "cuda_core"), ("float32", 64, 128, "cuda_core"),
    ("float32", 16, 16, "cuda_core")])
def test_route_bwd_rule(dtype, P, N, want):
    """bf16 with P and N multiples of 16 goes to the wgmma kernels, any S;
    f32 and ragged P or N to the CUDA-core kernel."""
    assert kernel.route_bwd(getattr(torch, dtype), P, N) == want


def test_route_bwd_refuses_other_dtypes():
    with pytest.raises(TypeError, match="no kernel"):
        kernel.route_bwd(torch.float16, 64, 128)


@pytest.mark.parametrize("H,cl", [(80, 8), (256, 8), (24, 8), (12, 4),
                                  (4, 4), (6, 2), (2, 2), (3, 1), (1, 1)])
def test_cluster_bwd_is_the_largest_of_8_4_2_1_dividing_H(H, cl):
    assert kernel.cluster_bwd(H) == cl
    assert H % cl == 0


def test_bwd_scratch_at_the_train_shape():
    """The wgmma route's scratch at mamba2-2.7b's train shape: the state
    entering blocks 4, 8, ..., 28 (7 of 32), carrE and delta, and the head
    partials of 10 clusters of 8; a tenth of the CUDA-core route's."""
    tc = kernel.bwd_scratch(4, 2048, 80, 64, 128, "wgmma")
    cc = kernel.bwd_scratch(4, 2048, 80, 64, 128, "cuda_core")
    assert tc == {"states": (4, 80, 7, 64 * 128), "dBp": (4, 10, 2048, 128),
                  "dCp": (4, 10, 2048, 128), "dAp": (4, 80),
                  "carrE": (4, 80, 2048), "delta": (4, 80)}
    nbytes = {k: 4 * sum(int(np.prod(v)) for v in d.values())
              for k, d in (("tc", tc), ("cc", cc))}
    assert nbytes == {"tc": 159_910_400, "cc": 1_006_634_240}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def torch_inputs(geom, seed, device, dtype):
    B, S, H, P, N = geom[:5]
    x, dt, A, Bm, Cm = (torch.tensor(a, device=device)
                        for a in case(B, S, H, P, N, seed=seed))
    dy, ds = (torch.tensor(a, device=device)
              for a in cotangents(B, S, H, P, N, seed))
    return [x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)], dy, ds


def close_to_plain(got, want, dtype):
    """Each gradient's max |kernel - plain| within 1e-4 of its max |plain|
    where it is f32 (sums in another order), 1e-2 where it is bf16 (dx,
    dBm, dCm are rounded to x's type once: 2^-8 relative, twice that when
    the two round to neighbours)."""
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        tol = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * max(w.float().abs().max().item(), 1e-6), \
            (name, dtype, err)


# (geom, dtype, route): every card case on the route ``route_bwd`` gives
# it ("routed"), and each that goes to the wgmma kernels also forced
# through the CUDA-core kernel; decided by the shape alone
KERNEL_CASES = [
    (geom, dtype, how)
    for geom in BWD_GEOMS + [(1, 512, 4, 64, 128, 256)]
    for dtype in ("float32", "bfloat16")
    for how in ("routed", "cuda_core")
    if how == "routed" or kernel.route_bwd(getattr(torch, dtype), geom[3],
                                           geom[4]) == "wgmma"]


@pytest.mark.cuda
@pytest.mark.parametrize("geom,dtype,how", KERNEL_CASES,
                         ids=[f"{gid(g)}-{d}-{h}" for g, d, h in KERNEL_CASES])
def test_kernel_bwd_matches_autograd_through_plain(cuda, geom, dtype, how):
    dtype = getattr(torch, dtype)
    inputs, dy, ds = torch_inputs(geom, 3, cuda, dtype)
    want = autograd_grads(
        lambda *a: ref.ssd_chunk_scan_ref(*a, chunk=geom[5]), inputs, dy, ds)
    route = (kernel.route_bwd(dtype, geom[3], geom[4]) if how == "routed"
             else how)
    key = f"{kernel.NAME_BWD}:{route}"
    before = build.ROUTE_LAUNCHES.get(key, 0)
    got = (kernel.ssd_chunk_scan_bwd(*inputs, dy, ds) if how == "routed"
           else kernel._launch_bwd(*inputs, dy, ds, how))
    torch.cuda.synchronize()
    assert build.ROUTE_LAUNCHES[key] == before + 1
    close_to_plain(got, want, dtype)


@pytest.mark.cuda
def test_kernel_bwd_is_deterministic(cuda):
    """Two calls on the same inputs give the same bits (the head sums run
    in a fixed order, in the clusters' shared memory and then over the
    cluster partials), on the wgmma route this shape takes."""
    inputs, dy, ds = torch_inputs((2, 1000, 16, 64, 128, 256), 4, cuda,
                                  torch.bfloat16)
    key = f"{kernel.NAME_BWD}:wgmma"
    before = build.ROUTE_LAUNCHES.get(key, 0)
    a = kernel.ssd_chunk_scan_bwd(*inputs, dy, ds)
    b = kernel.ssd_chunk_scan_bwd(*inputs, dy, ds)
    torch.cuda.synchronize()
    assert build.ROUTE_LAUNCHES[key] == before + 2
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
def test_ops_backward_launches_each_kernel_once(cuda):
    inputs, dy, ds = torch_inputs(GEOMS[0], 5, cuda, torch.float32)
    build.reset_launches()
    grads = autograd_grads(lambda *a: ops.ssd_chunk_scan(*a, chunk=16),
                           inputs, dy, ds)
    torch.cuda.synchronize()
    assert build.LAUNCHES[kernel.NAME] == 1
    assert build.LAUNCHES[kernel.NAME_BWD] == 1
    assert all(torch.isfinite(g).all() for g in grads)
