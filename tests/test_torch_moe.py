"""The port's sort-based, static-capacity MoE layer against the JAX
package's ``repro.models.layers.moe_apply``, on the same weights and inputs.

Reduced phi3.5-moe-42b (d 64, 4 experts, top 2, expert hidden 128) in f32,
weights and inputs from numpy.  The routing bookkeeping (positions within
an expert, counts, the stable sort order) must be equal outright; the
outputs, the three aux values and the gradients of x and of every MoE
weight agree within atol 1e-5 / rtol 1e-4 (the two sides sum the products
in different orders).

    PYTHONPATH=src python -m pytest tests/test_torch_moe.py
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_model_config as jax_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.core.steps import make_ctx  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs.base import get_model_config, reduced  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
ROWS = 2
AUX_COEF = {"load_balance_loss": 0.01, "router_z_loss": 1e-3}


def configs(**over):
    over = {"dtype": "float32", **over}
    return (jax_reduced(jax_config("phi3.5-moe-42b"), **over),
            reduced(get_model_config("phi3.5-moe-42b"), **over))


@pytest.mark.parametrize("n,E,seed", [(1, 4, 0), (14, 4, 1), (128, 4, 2),
                                      (128, 16, 3), (64, 2, 4), (37, 3, 5)])
def test_route_row_matches_jax_exactly(n, E, seed):
    """Positions within an expert, counts per expert and the stable sort
    order of ids with many repeats: equal to JAX's ``_route_row``, one row
    at a time and batched over rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E, (3, n)).astype(np.int32)
    got = L._route_row(torch.tensor(ids, dtype=torch.long), E)
    for r in range(3):
        want = JL._route_row(jnp.asarray(ids[r]), E)
        one = L._route_row(torch.tensor(ids[r], dtype=torch.long), E)
        for g, o, w in zip(got, one, want):
            assert np.array_equal(g[r].numpy(), np.asarray(w))
            assert np.array_equal(o.numpy(), np.asarray(w))


@pytest.mark.parametrize("S", [1, 2, 7, 64, 257])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_capacity_matches_the_reference_rule(S, cf):
    """C = max(4, min(ceil(S K cf / E), S K)), computed in floats, so at
    decode (S K = 2) C is 4: larger than S K."""
    _, cfg = configs(capacity_factor=cf)
    E, K = cfg.num_experts, cfg.experts_per_tok
    want = max(4, min(int(-(-S * K * cf // E)), S * K))
    assert L.moe_capacity(cfg, S) == want
    if S == 1:
        assert want == 4 > S * K


def weights(cfg, seed):
    """MoE leaves from numpy, normal with std 1/sqrt of the dimension each
    product contracts (d for the router, ``wi`` and ``wg``, ff for
    ``wo``), so outputs and gradients are of order 1.  The models' init
    (std 1/sqrt(E) for the expert leaves, as the JAX init takes the first
    dimension for fan-in) makes this layer's outputs ~45 and the router's
    gradients ~300, where f32 rounding of the two sides' different
    summation orders alone passes an absolute 1e-5; the archs' tests run
    that init through whole models."""
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.moe_ff, cfg.num_experts
    shapes = {"router": ((d, E), d), "wi": ((E, d, ff), d),
              "wo": ((E, ff, d), ff)}
    if cfg.mlp_gated:
        shapes["wg"] = ((E, d, ff), d)
    return {k: (rng.standard_normal(s) / np.sqrt(n)).astype(np.float32)
            for k, (s, n) in shapes.items()}


def hidden_mask(kind, cfg, seed):
    """[ROWS, 1, 1, ff] mask of the experts' hidden units: None, a Horn
    train mask (16-unit blocks at keep 0.5, scaled by 1 / keep) or a
    binary serve mask."""
    if kind == "none":
        return None
    rng = np.random.default_rng(seed)
    blocks = rng.random((ROWS, cfg.moe_ff // 16)) < 0.5
    blocks[:, 0] = True
    m = np.repeat(blocks, 16, axis=-1).astype(np.float32)
    if kind == "horn":
        m = m / 0.5
    return m[:, None, None, :]


@pytest.mark.parametrize("mask", ["none", "horn", "serve"])
@pytest.mark.parametrize("act", ["silu_gated", "gelu"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("S", [1, 7, 64])
def test_moe_apply_matches_jax(S, cf, act, mask):
    """Output, aux and the gradients of x and of the router and expert
    weights against JAX's ``moe_apply`` (through ``jax.value_and_grad``)
    of the same objective: the output against a fixed cotangent plus the
    aux terms the loss adds.  At capacity factor 0.5 and S 64 tokens are
    dropped (``dropped_frac`` > 0)."""
    gated = act == "silu_gated"
    over = dict(capacity_factor=cf, mlp_gated=gated,
                act="silu" if gated else "gelu")
    jcfg, tcfg = configs(**over)
    rng = np.random.default_rng(S * 10 + int(cf * 4))
    x = rng.standard_normal((ROWS, S, tcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    w = weights(tcfg, seed=S)
    hm = hidden_mask(mask, tcfg, seed=S + 1)
    ctx = make_ctx(jcfg, None)

    def jobjective(args):
        xx, ww = args
        out, aux = JL.moe_apply(ww, xx, jcfg, ctx, hidden_mask=None if hm
                                is None else jnp.asarray(hm))
        obj = jnp.sum(out * cot) + sum(c * aux[k]
                                       for k, c in AUX_COEF.items())
        return obj, (out, aux)

    (jobj, (jout, jaux)), (jgx, jgw) = jax.value_and_grad(
        jobjective, has_aux=True)((jnp.asarray(x),
                                   {k: jnp.asarray(v) for k, v in w.items()}))

    params = L.MoE(tcfg, lambda shape, init="normal", scale=1.0:
                   torch.nn.Parameter(torch.zeros(shape)))
    with torch.no_grad():
        for k, v in w.items():
            getattr(params, k).copy_(torch.tensor(v))
    tx = torch.tensor(x, requires_grad=True)
    out, aux = L.moe_apply(params, tx, tcfg, hidden_mask=None if hm is None
                           else torch.tensor(hm))
    obj = (out * torch.tensor(cot)).sum() + sum(
        c * aux[k] for k, c in AUX_COEF.items())
    names = list(w)
    grads = torch.autograd.grad(obj, [tx] + [getattr(params, k)
                                             for k in names])

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=RTOL)
    assert set(aux) == set(jaux) == set(L.MOE_AUX)
    for k in L.MOE_AUX:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    choices = ROWS * S * tcfg.experts_per_tok       # dropped: the same ones
    assert round(aux["dropped_frac"].item() * choices) == \
        round(float(jaux["dropped_frac"]) * choices)
    if cf == 0.5 and S == 64:
        assert aux["dropped_frac"].item() > 0
    if S == 1:
        assert aux["dropped_frac"].item() == 0.0
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=ATOL,
                               rtol=RTOL, err_msg="x")
    for k, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgw[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def test_padding_sorts_after_valid_tokens():
    """A right-padded row: the padding's choices come after the valid
    tokens' in every expert's slots (the sort is stable), so padding never
    takes a valid token's slot; the valid tokens' outputs are those of the
    row without its padding when nothing of theirs drops."""
    _, cfg = configs(capacity_factor=4.0)
    rng = np.random.default_rng(11)
    w = weights(cfg, seed=3)
    params = L.MoE(cfg, lambda shape, init="normal", scale=1.0:
                   torch.nn.Parameter(torch.zeros(shape),
                                      requires_grad=False))
    with torch.no_grad():
        for k, v in w.items():
            getattr(params, k).copy_(torch.tensor(v))
    x = torch.tensor(rng.standard_normal((1, 12, cfg.d_model)),
                     dtype=torch.float32)
    padded = torch.cat([x[:, :5], torch.zeros_like(x[:, 5:])], dim=1)
    ids = torch.tensor(rng.integers(0, cfg.num_experts, (1, 24)))
    pos, _, order = L._route_row(ids, cfg.num_experts)
    for e in range(cfg.num_experts):
        mine = order[0][ids[0][order[0]] == e]
        assert torch.all(mine[1:] > mine[:-1])       # flat order kept
        assert torch.equal(pos[0][mine], torch.arange(len(mine)))
    full, _ = L.moe_apply(params, padded, cfg)
    alone, _ = L.moe_apply(params, x[:, :5], cfg)
    torch.testing.assert_close(full[:, :5], alone, atol=ATOL, rtol=RTOL)


def test_moe_weights_follow_the_reference_init():
    """``init_params`` draws expert weights with the JAX package's rule:
    std 1/sqrt of the leaf's first dimension, which is E for [E, d, ff]
    (0.5 at 4 experts, 0.25 at phi3.5's 16)."""
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(configs()[1], moe_d_ff=256, d_model=128)
    model = init_params(cfg, 0, device="cpu")
    moe = model.layers[0].moe
    E = cfg.num_experts
    for name in ("wi", "wg", "wo"):
        std = getattr(moe, name).std().item()
        assert abs(std - 1 / np.sqrt(E)) < 0.02, (name, std)
    assert abs(moe.router.std().item() - 1 / np.sqrt(cfg.d_model)) < 0.01
    assert not hasattr(model.layers[0], "mlp")


@pytest.mark.parametrize("S", [1, 64])
def test_serving_forward_skips_the_aux(S):
    """Without ``with_aux`` the layer's output is bitwise the same and no
    aux is built; a serving forward (prefill, decode) returns (hidden,
    cache), a train forward (hidden, aux)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    _, cfg = configs()
    model = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    moe = model.layers[0].moe
    x = torch.tensor(np.random.default_rng(S).standard_normal(
        (ROWS, S, cfg.d_model)), dtype=torch.float32)
    with torch.no_grad():
        want, aux = L.moe_apply(moe, x, cfg)
        got, none = L.moe_apply(moe, x, cfg, with_aux=False)
        assert torch.equal(got, want) and set(aux) == set(L.MOE_AUX)
        assert none == {}
        tokens = torch.randint(0, cfg.vocab_size, (ROWS, S))
        hidden, cache = T.lm_forward(model, tokens, cfg, mode="prefill")
        assert isinstance(cache, list) and len(cache) == cfg.num_layers
        h_train, aux = T.lm_forward(model, tokens, cfg, mode="train",
                                    remat=False)
        assert set(aux) == set(L.MOE_AUX)
        torch.testing.assert_close(hidden, h_train, atol=ATOL, rtol=RTOL)
