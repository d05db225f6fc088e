"""The port's flash attention against the JAX package's.

The plain PyTorch ``attention_ref`` gets the same numpy inputs as the JAX
oracle ``repro.kernels.flash_attention.ref.attention_ref`` (forward), and
torch autograd through it gets the same cotangent as ``jax.vjp`` of that
oracle (backward).  The ``cuda`` tests hold the hand-written forward and
backward kernels against the plain version on the card and skip elsewhere;
they need no JAX, so JAX is imported inside the parity tests only.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel, ops, ref

VARIANTS = {"causal": dict(causal=True),
            "window": dict(causal=True, window=64),
            "softcap": dict(causal=True, softcap=50.0),
            "full": dict(causal=False)}
# the sweep of tests/test_kernels.py, plus a ragged S = 7 and gemma3-4b's
# head dim 256 (its 8/4 heads at a ragged S 130, and MQA)
GEOMS = [(1, 2, 2, 128, 64), (2, 4, 2, 256, 64), (1, 8, 1, 128, 128),
         (2, 4, 2, 7, 32), (1, 8, 4, 130, 256), (1, 2, 1, 64, 256)]


def case(B, H, KH, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((B, H, S, D), (B, KH, S, D), (B, KH, S, D), (B, H, S, D))]


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_forward_matches_jax_ref(geom, variant):
    """f32 on both sides; atol/rtol 1e-5 covers the different summation
    order of the two einsum/softmax implementations."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref

    q, k, v, _ = case(*geom, seed=(*geom, list(VARIANTS).index(variant)))
    kw = dict(VARIANTS[variant], scale=geom[-1] ** -0.5)
    want = np.asarray(attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw))
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: "x".join(map(str, g)))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_backward_matches_jax_vjp(geom, variant):
    """dq, dk, dv from torch autograd through the plain version against
    ``jax.vjp`` of the JAX oracle, same cotangent, f32.  atol/rtol 1e-4:
    each gradient entry sums up to S products of O(1) terms, so summation
    order alone moves it by ~S * 2^-24 relative."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import attention_ref

    q, k, v, do = case(*geom, seed=(*geom, 9, list(VARIANTS).index(variant)))
    kw = dict(VARIANTS[variant], scale=geom[-1] ** -0.5)
    _, vjp = jax.vjp(lambda a, b, c: attention_ref(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_cpu_tensors_never_reach_the_kernels():
    """The CPU path is the plain version with its own autograd; the CUDA
    wrappers refuse CPU tensors instead of computing anything."""
    q, k, v, do = (torch.tensor(a) for a in case(1, 2, 1, 9, 32, 0))
    before = dict(build.LAUNCHES)
    q.requires_grad_(True)
    out = ops.flash_attention(q, k, v, scale=0.2)
    out.backward(do)
    assert q.grad is not None
    assert build.LAUNCHES[kernel.FWD] == before[kernel.FWD]
    assert build.LAUNCHES[kernel.BWD] == before[kernel.BWD]
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_fwd(q.detach(), k, v, scale=0.2)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_bwd(q.detach(), k, v, q.detach(),
                                   torch.zeros(1, 2, 9), do, scale=0.2)


def test_route_names_the_kernels_and_head_dim():
    """The launch counter's route: bf16 on the tensor cores, f32 on the
    CUDA cores, and the head dim (gemma3-4b's 256 among them)."""
    assert kernel.route(torch.bfloat16, 256) == "wgmma_d256"
    assert kernel.route(torch.float32, 128) == "cuda_core_d128"
    assert 256 in kernel.HEAD_DIMS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


CUDA_GEOMS = [
    # B, H, KH, S, D, kw
    (2, 4, 2, 7, 32, dict(causal=True)),
    (1, 4, 4, 130, 64, dict(causal=True, window=20)),
    (2, 16, 8, 256, 128, dict(causal=True)),
    (1, 32, 16, 200, 128, dict(causal=True, window=64, softcap=50.0)),
    (1, 8, 2, 100, 96, dict(causal=False, softcap=30.0)),
    (1, 2, 1, 1, 128, dict(causal=True)),
    (1, 8, 4, 130, 256, dict(causal=True, window=64, softcap=50.0)),
    (1, 2, 1, 64, 256, dict(causal=False)),
    (2, 8, 4, 300, 256, dict(causal=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geom", CUDA_GEOMS, ids=lambda g: str(g[:5]))
def test_kernels_match_plain(cuda, dtype, geom):
    """Forward and dq/dk/dv of the kernels against the plain version and
    its autograd on the same card and inputs.  f32: atol/rtol 1e-4
    (summation order over up to S terms).  bf16 inputs and outputs,
    compared in f32: atol/rtol 2e-2, one bf16 ulp at |x| ~ 1 being 7.8e-3
    (both sides compute in f32 and round once)."""
    B, H, KH, S, D, kw = geom
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.tensor(a, device=cuda).to(dt)
                   for a in case(B, H, KH, S, D, seed=(B, H, S, D)))
    kw = dict(kw, scale=D ** -0.5)
    o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ref.attention_ref(*leaves, **kw)
    grads = torch.autograd.grad(want, leaves, do)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                            (want, *grads)):
        assert got.dtype == dt, name
        torch.testing.assert_close(got.float(), w.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
def test_autograd_function_launches_each_kernel_once(cuda):
    """``ops.flash_attention`` on CUDA tensors runs the forward kernel once
    and, on backward, the backward kernel once; its grads equal those of
    the plain version on the CPU (f32, atol/rtol 1e-4)."""
    arrays = case(2, 8, 4, 96, 64, seed=3)
    cpu = [torch.tensor(a, requires_grad=True) for a in arrays[:3]]
    dev = [torch.tensor(a, device=cuda, requires_grad=True)
           for a in arrays[:3]]
    kw = dict(scale=0.125, causal=True, window=40)
    build.reset_launches()
    out = ops.flash_attention(*dev, **kw)
    out.backward(torch.tensor(arrays[3], device=cuda))
    assert build.LAUNCHES[kernel.FWD] == 1
    assert build.LAUNCHES[kernel.BWD] == 1
    for name in (kernel.FWD, kernel.BWD):
        assert build.ROUTE_LAUNCHES[f"{name}:cuda_core_d64"] == 1
    ops.flash_attention(*cpu, **kw).backward(torch.tensor(arrays[3]))
    for a, b in zip(dev, cpu):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-4,
                                   rtol=1e-4)


# the bf16 tensor-core kernels: every head dim, ragged and tile-sized
# lengths, MHA and GQA, every mask variant
TC_VARIANTS = {"causal": dict(causal=True),
               "non-causal": dict(causal=False),
               "window": dict(causal=True, window=48),
               "softcap": dict(causal=True, softcap=30.0),
               "window-softcap": dict(causal=True, window=48, softcap=30.0)}
BF16_TOL = 2e-2


def tc_check(cuda, B, KH, G, Sq, Skv, D, kw, seed):
    """bf16 forward and dq/dk/dv of the kernels against the plain version
    and its autograd on the same card and inputs, compared in f32 at
    atol/rtol 2e-2: both sides take bf16 inputs and round the outputs to
    bf16 (one ulp at |x| ~ 1 is 7.8e-3); the kernels also round P and dS
    to bf16 before their second products, as any bf16 tensor-core
    attention does."""
    gen = torch.Generator(cuda).manual_seed(seed)
    H = KH * G
    q, do = (torch.randn(B, H, Sq, D, generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, KH, Skv, D, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(kw, scale=D ** -0.5)
    o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ref.attention_ref(*leaves, **kw)
    grads = torch.autograd.grad(want, leaves, do)
    torch.cuda.synchronize()
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv),
                            (want, *grads)):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape, name
        torch.testing.assert_close(got.float(), w.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL,
                                   msg=lambda m: f"{name}: {m}")
    assert torch.isfinite(lse).all()


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(TC_VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("S", [1, 7, 65, 1000, 1024])
@pytest.mark.parametrize("D", [32, 64, 96, 128, 256])
def test_bf16_tensor_core_kernels_match_plain(cuda, D, S, G, variant):
    """Sq == Skv == S, two kv heads of G query heads each."""
    tc_check(cuda, 1, 2, G, S, S, D, TC_VARIANTS[variant],
             seed=D * 10_000 + S * 10 + G)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(TC_VARIANTS))
@pytest.mark.parametrize("Sq,Skv", [(7, 1000), (1000, 65), (130, 257),
                                    (1, 64), (257, 130)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_bf16_tensor_core_kernels_sq_ne_skv(cuda, D, Sq, Skv, variant):
    """Sq != Skv: positions count from 0 in both sequences, so with Sq <
    Skv under the causal mask the keys past Sq - 1 get zero dk and dv, and
    with Sq > Skv the late rows see every key (the window is refused where
    it would leave a row none)."""
    kw = TC_VARIANTS[variant]
    if kw.get("window") and Sq >= Skv + kw["window"]:
        with pytest.raises(ValueError, match="see no key"):
            tc_check(cuda, 2, 2, 2, Sq, Skv, D, kw, seed=Sq + Skv)
        return
    tc_check(cuda, 2, 2, 2, Sq, Skv, D, kw, seed=Sq + Skv)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=100, softcap=30.0)],
                         ids=["causal", "window-softcap"])
def test_bf16_backward_is_bitwise_repeatable(cuda, kw, D):
    """No atomics: two backward runs on the same inputs give the same bits
    (GQA, S 1000; at D 256 the two warpgroups' exchange through shared
    memory too)."""
    gen = torch.Generator(cuda).manual_seed(7)
    B, H, KH, S = 2, 8, 2, 1000
    q, do = (torch.randn(B, H, S, D, generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, KH, S, D, generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(kw, scale=D ** -0.5)
    o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
    first = kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    second = kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
