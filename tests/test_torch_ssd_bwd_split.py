"""The SSD backward's wgmma route, its rounding written plainly.

``ref.ssd_chunk_scan_bwd_split_ref`` restates the route's two sweeps: the
carried state in a forward sweep, G in a reverse one, delta's recurrence
restarted from the state kept every ``ref.BWD_CKPT`` blocks, and each f32
operand fed to the tensor cores as the number of bf16 terms
``ref.BWD_TERMS`` gives it.  Here it is held on the CPU against the plain
backward ``ssd_chunk_scan_bwd_ref`` (and once against ``jax.vjp`` of the
JAX package's ``ssd_chunked``) at the card's tolerance: each gradient's
max |split - plain| within 1e-4 of its max |plain| where it is f32 (ddt,
dA) and 1e-2 where the kernel stores it in bf16 (dx, dBm, dCm), as
``SSD_BWD_TOL`` in ``chip_smoke.py``.  Cases with one term fewer where the
design takes two or three show that the design's terms are needed.

    PYTHONPATH=src python -m pytest tests/test_torch_ssd_bwd_split.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import ref
from test_torch_ssd import case, gid
from test_torch_ssd_grad import cotangents

# chip_smoke.py's SSD_BWD_TOL, by the dtype of the gradient the kernel
# returns
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
NAMES = ("dx", "ddt", "dA", "dBm", "dCm")

# (B, S, H, P, N): one block, a short last block (S 257, 130), N 16 (the
# 64-column state tiles) and 128, P 16 to 64, several blocks with kept
# states (S 640: blocks 4 and 8 kept)
GEOMS = [(1, 64, 2, 16, 16), (2, 130, 3, 32, 48), (1, 257, 2, 64, 128),
         (1, 640, 2, 64, 16), (2, 200, 4, 48, 64)]


def bf16_inputs(B, S, H, P, N, seed, dstate=True):
    """The sweep's inputs with x, Bm and Cm in bf16, dy and dstate f32."""
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in case(B, S, H, P, N, seed))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    dy, ds = (torch.tensor(a) for a in cotangents(B, S, H, P, N, seed))
    return (x, dt, A, Bm, Cm, dy, ds if dstate else None)


def ratios(got, want):
    """Each gradient's max |got - want| / max |want| over its tolerance;
    ``want`` (f32) is rounded to ``got``'s type first, as the kernel's
    caller sees it."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        w = w.to(g.dtype).float()
        out[name] = ((g.float() - w).abs().max()
                     / w.abs().max()).item() / TOL[g.dtype]
    return out


def split(args, **kw):
    with torch.no_grad():
        return ref.ssd_chunk_scan_bwd_split_ref(*args, **kw)


@pytest.mark.parametrize("with_dstate", [True, False],
                         ids=["dstate", "no-dstate"])
@pytest.mark.parametrize("geom", GEOMS, ids=gid)
def test_split_matches_plain_backward(geom, with_dstate):
    args = bf16_inputs(*geom, seed=GEOMS.index(geom), dstate=with_dstate)
    got = split(args)
    want = ref.ssd_chunk_scan_bwd_ref(*args)
    for name, g, a in zip(NAMES, got, args[:5]):
        assert g.dtype == (a.dtype if name in ("dx", "dBm", "dCm")
                           else torch.float32), name
        assert g.shape == a.shape and torch.isfinite(g).all(), name
    r = ratios(got, want)
    assert all(v <= 1 for v in r.values()), r


def test_split_matches_jax_vjp_of_ssd_chunked():
    """At a chunk under 64 tokens (where ``ssd_chunked``'s 0/1 mask stays
    finite) the split backward against ``jax.vjp`` on the same bf16-exact
    inputs and cotangents, at the card's tolerance."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked

    B, S, H, P, N, chunk = 2, 96, 2, 16, 32, 32
    args = bf16_inputs(B, S, H, P, N, seed=7)
    ins = [jnp.asarray(t.float().numpy()) for t in args[:5]]
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk=chunk), *ins)
    want = [torch.tensor(np.asarray(w))
            for w in vjp((jnp.asarray(args[5].numpy()),
                          jnp.asarray(args[6].numpy())))]
    r = ratios(split(args), want)
    assert all(v <= 1 for v in r.values()), r


# (operand, terms, the gradient that then misses): fewer terms than the
# design's, each missing the card's tolerance against the plain backward
FEWER = [("dy_e", 1, "ddt"), ("E_G", 1, "dA"), ("G_gb", 2, "dA"),
         ("wx_s", 2, "dA")]


@pytest.mark.parametrize("operand,terms,misses", FEWER,
                         ids=[f"{o}-{t}" for o, t, _ in FEWER])
def test_fewer_terms_miss_the_tolerance(operand, terms, misses):
    assert terms < ref.BWD_TERMS[operand]
    args = bf16_inputs(1, 256, 1, 32, 64, seed=3)
    want = ref.ssd_chunk_scan_bwd_ref(*args)
    assert all(v <= 1 for v in ratios(split(args), want).values())
    r = ratios(split(args, terms={operand: terms}), want)
    assert r[misses] > 1, r


def test_one_term_of_M_and_dy_costs_dx_a_bf16_step():
    """dx's operands in one bf16 term each move dx by about one bf16 step
    at its largest values: over half the tolerance where the design's two
    terms keep it under a tenth."""
    args = bf16_inputs(1, 512, 4, 64, 128, seed=3)
    want = ref.ssd_chunk_scan_bwd_ref(*args)
    assert ratios(split(args), want)["dx"] < 0.1
    assert ratios(split(args, terms={"M": 1, "dy_dx": 1}),
                  want)["dx"] > 0.5


def test_kept_states_and_three_terms_of_E_hold_dA_to_f64():
    """dA against the f64 backward at S 2048 with a dstate: the design
    keeps it under a quarter of the tolerance; delta's recurrence over the
    whole row of 32 blocks (no kept states) or E in two terms in G's
    update each take it past half, and both together past the
    tolerance."""
    args = bf16_inputs(1, 2048, 4, 32, 32, seed=5)
    exact = ref.ssd_chunk_scan_bwd_ref(
        *(t.double() for t in args))[2].float()

    def dA_ratio(**kw):
        got = split(args, **kw)[2]
        return ((got - exact).abs().max() / exact.abs().max()).item() / 1e-4

    assert dA_ratio() < 0.25
    assert dA_ratio(ckpt=10 ** 6) > 0.5
    assert dA_ratio(terms={"E_G": 2}) > 0.5
    assert dA_ratio(ckpt=10 ** 6, terms={"E_G": 2}) > 1


def test_bf16_terms_hold_a_value_to_their_precision():
    g = torch.Generator().manual_seed(0)
    v = torch.randn(4096, generator=g) * torch.exp(
        torch.randn(4096, generator=g) * 4)
    for n, bound in ((1, 2.0 ** -8), (2, 2.0 ** -16), (3, 2.0 ** -23)):
        t = ref.bf16_terms(v, n)
        assert len(t) == n and all(
            torch.equal(u, u.to(torch.bfloat16).float()) for u in t)
        assert ((sum(t) - v).abs() <= bound * v.abs()).all(), n


def test_split_ref_refuses_gradients_and_unknown_terms():
    args = list(bf16_inputs(1, 64, 2, 16, 16, seed=1))
    args[0] = args[0].float().requires_grad_(True)
    with pytest.raises(RuntimeError, match="ssd_chunk_scan_ref"):
        ref.ssd_chunk_scan_bwd_split_ref(*args)
    args[0] = args[0].detach().to(torch.bfloat16)
    with pytest.raises(ValueError, match="terms"):
        split(args, terms={"nope": 2})
    with pytest.raises(ValueError, match="terms"):
        split(args, terms={"G_gb": 4})
