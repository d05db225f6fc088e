"""The port's sub-model planner and block-sparse MLP against the JAX
package's.

The planner tests port ``tests/test_submodel.py``.  The MLP tests run the
port's ``mlp_apply(mask_blocks=...)`` (its plain ``dropout_matmul`` on the
CPU) against JAX's own block branch of ``repro.models.layers.mlp_apply``.
That branch runs only off the ``ref`` backend and reaches the Pallas
kernel, whose interpret mode does not run on this jax; so the tests set the
backend to ``interpret`` and route the kernel through JAX's plain
``dropout_matmul_ref`` (``mlp_apply`` imports the kernel at call time).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (MAMBA, HornConfig, get_model_config,
                                      reduced)
from repro_torch.core import parallel_dropout as pd
from repro_torch.core import submodel as SM
from repro_torch.models import layers as L


def test_plan_covers_families():
    horn = HornConfig()
    dense = SM.plan(get_model_config("qwen3-1.7b"), horn)
    assert any(a.name == "ffn_hidden" for a in dense)
    qwen = get_model_config("qwen3-1.7b")
    ssm = dataclasses.replace(qwen, family="ssm", d_ff=0,
                              layer_pattern=(MAMBA,), ssm_state=128)
    names = {a.name for a in SM.plan(ssm, horn)}
    assert "ssm_channels" in names and "ffn_hidden" not in names
    hybrid = dataclasses.replace(qwen, family="hybrid", ssm_state=16,
                                 num_experts=16, moe_d_ff=512,
                                 layer_pattern=(MAMBA, "attn"))
    names = {a.name for a in SM.plan(hybrid, horn)}
    assert {"ssm_channels", "moe_hidden", "ffn_hidden"} <= names


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-27b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b", "phi3.5-moe-42b"])
@pytest.mark.parametrize("heads", [False, True])
def test_plan_matches_jax(arch, heads):
    """The same axes, in order, for the JAX package's configs (carried over
    field for field) with and without head masking."""
    pytest.importorskip("jax")
    from repro.configs import base as jbase
    from repro.core import submodel as JSM
    from repro_torch.configs.base import ModelConfig

    jcfg = jbase.get_model_config(arch)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    horn = HornConfig(mask_attention_heads=heads)
    want = JSM.plan(jcfg, jbase.HornConfig(**dataclasses.asdict(horn)))
    assert [dataclasses.astuple(a) for a in SM.plan(cfg, horn)] == \
        [dataclasses.astuple(a) for a in want]


def test_draw_matches_jax_given_its_uniforms():
    """``draw`` from JAX's own uniforms equals JAX's ``draw`` exactly."""
    jax = pytest.importorskip("jax")
    from repro.core import submodel as JSM

    axis = SM.SubmodelAxis("ffn_hidden", 6144, 0.5, 128)
    for seed in range(3):
        key = jax.random.key(seed)
        u = np.asarray(jax.random.uniform(key, (4, axis.n_blocks)))
        want = np.asarray(JSM.draw(key, JSM.SubmodelAxis(*dataclasses.astuple(
            axis)), 4))
        assert np.array_equal(SM.draw(torch.tensor(u), axis).numpy(), want)
    with pytest.raises(ValueError, match="blocks"):
        SM.draw(torch.rand(4, 3), axis)


def test_materialized_submodel_is_exact():
    """Running the kept-columns-only weights == running masked full weights:
    the sub-model is a genuinely smaller network, not an approximation."""
    rng = np.random.default_rng(0)
    d, ff, bs = 16, 64, 8
    wi = torch.tensor(rng.normal(size=(d, ff)), dtype=torch.float32)
    wo = torch.tensor(rng.normal(size=(ff, d)), dtype=torch.float32)
    mask_blocks = torch.tensor([2.0, 0.0, 2.0, 0.0, 0.0, 2.0, 2.0, 0.0])
    x = torch.tensor(rng.normal(size=(4, d)), dtype=torch.float32)

    full_mask = torch.repeat_interleave(mask_blocks, bs)
    y_masked = (torch.relu(x @ wi) * full_mask) @ wo

    wi_k, wo_k = SM.materialize(wi, wo, mask_blocks, bs)
    assert wi_k.shape == (d, 32) and wo_k.shape == (32, d)   # half the units
    y_small = (torch.relu(x @ wi_k) * 2.0) @ wo_k           # 1/keep scale
    torch.testing.assert_close(y_small, y_masked, atol=1e-5, rtol=1e-5)


def test_materialize_units_matches_jax():
    """Kept units gathered and zero-padded exactly as JAX does it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import submodel as JSM

    rng = np.random.default_rng(1)
    mlp = {"wi": rng.normal(size=(8, 32)), "wg": rng.normal(size=(8, 32)),
           "wo": rng.normal(size=(32, 8))}
    units = (rng.random(32) < 0.5).astype(np.float32)
    want = JSM.materialize_units({k: jnp.asarray(v, jnp.float32)
                                  for k, v in mlp.items()}, units, pad_to=24)
    got = SM.materialize_units({k: torch.tensor(v, dtype=torch.float32)
                                for k, v in mlp.items()}, units, pad_to=24)
    for name in mlp:
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name


def test_stats_tracks_keep_rate():
    horn = HornConfig(keep_hidden=0.5, keep_input=0.8, block_size=128)
    s = SM.stats(get_model_config("qwen3-1.7b"), horn, num_groups=32)
    assert abs(s["ffn_hidden_dropped_frac"] - 0.5) < 0.15
    assert abs(s["input_embed_dropped_frac"] - 0.2) < 0.15
    assert s == SM.stats(get_model_config("qwen3-1.7b"), horn, num_groups=32)


# ---------------------------------------------------------------------------
# mlp_apply(mask_blocks=...)
# ---------------------------------------------------------------------------
G, B, S = 2, 4, 8


def mlp_case(gated: bool, seed: int, nb: int = 4):
    """(port cfg, numpy weights, x, mask_blocks [G, nb] in {0, 2} with a
    live block in every group); d_model 64, d_ff 256 as in
    ``tests/test_kernels.py``."""
    kw = {} if gated else dict(mlp_gated=False, act="relu")
    cfg = dataclasses.replace(
        reduced(get_model_config("qwen3-1.7b"), d_ff=256, d_model=64), **kw)
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.d_ff
    names = ("wi", "wo", "wg") if gated else ("wi", "wo")
    weights = {n: (rng.normal(size=(ff, d) if n == "wo" else (d, ff))
                   / np.sqrt(ff if n == "wo" else d)).astype(np.float32)
               for n in names}
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    mask = rng.choice([0.0, 2.0], size=(G, nb)).astype(np.float32)
    mask[np.arange(G), np.arange(G)] = 2.0
    return cfg, weights, x, mask


def port_params(weights):
    return types.SimpleNamespace(**{n: torch.tensor(w)
                                    for n, w in weights.items()})


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "relu"])
def test_block_mlp_matches_jax(gated, x_dtype, monkeypatch):
    """f32 weights, x in f32 or bf16: same output dtype as JAX's block path
    (f32 in both cases: the down projection promotes), within 1e-5 with f32
    x and 2e-2 with bf16 x (h rounds to bf16 on both sides; an f32 sum that
    lands near a rounding boundary may round the other way)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.core.steps import make_ctx
    from repro.kernels import backend as KB
    from repro.kernels.dropout_matmul import kernel as jkernel
    from repro.kernels.dropout_matmul.ref import dropout_matmul_ref
    from repro.models import layers as JL

    def through_ref(x, w, mask_blocks, *, block_n, interpret=False, **kw):
        return dropout_matmul_ref(x, w, mask_blocks, block_n=block_n)

    monkeypatch.setattr(jkernel, "dropout_matmul", through_ref)
    monkeypatch.setattr(KB, "_BACKEND", "interpret")
    cfg, weights, x, mask = mlp_case(gated, seed=int(gated))
    jcfg = jbase.ModelConfig(**dataclasses.asdict(cfg))
    want = JL.mlp_apply({n: jnp.asarray(w) for n, w in weights.items()},
                        jnp.asarray(x, getattr(jnp, x_dtype)), jcfg,
                        make_ctx(jcfg, None), mask_blocks=jnp.asarray(mask))
    got = L.mlp_apply(port_params(weights),
                      torch.tensor(x).to(getattr(torch, x_dtype)), cfg,
                      mask_blocks=torch.tensor(mask))
    assert str(got.dtype) == f"torch.{want.dtype}" == "torch.float32"
    tol = 1e-5 if x_dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "relu"])
def test_block_mlp_matches_dense_masked_path(gated, nb):
    """The block path equals the dense path under the expanded mask
    (``expand_mask``: sample b in group b // (B // G)), f32, within 1e-5;
    ``mask_blocks`` wins when both masks are given."""
    cfg, weights, x, mask = mlp_case(gated, seed=7 + nb, nb=nb)
    params, xt, mt = port_params(weights), torch.tensor(x), torch.tensor(mask)
    dense = L.mlp_apply(params, xt, cfg,
                        hidden_mask=pd.expand_mask(mt, cfg.d_ff, B))
    blocks = L.mlp_apply(params, xt, cfg, mask_blocks=mt)
    torch.testing.assert_close(blocks, dense, atol=1e-5, rtol=1e-5)
    both = L.mlp_apply(params, xt, cfg, mask_blocks=mt,
                       hidden_mask=torch.zeros(B, 1, cfg.d_ff))
    assert torch.equal(both, blocks)


def test_block_mlp_refuses_what_jax_cannot_run():
    """A batch that does not split into the mask's groups raises; so does
    a gradient request through the forward-only kernel."""
    cfg, weights, x, mask = mlp_case(True, seed=3)
    params = port_params(weights)
    with pytest.raises(ValueError, match="groups"):
        L.mlp_apply(params, torch.tensor(x[:3]), cfg,
                    mask_blocks=torch.tensor(mask))
    params.wi.requires_grad_(True)
    with pytest.raises(RuntimeError, match="ROADMAP"):
        L.mlp_apply(params, torch.tensor(x), cfg,
                    mask_blocks=torch.tensor(mask))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "relu"])
def test_block_mlp_on_the_card_matches_the_cpu(gated, x_dtype):
    """The block path through the CUDA kernel (2 launches gated, 1 not)
    against the plain version on the CPU, same inputs: f32 weights, so
    both sides sum f32 products; atol/rtol 1e-4 covers the summation order
    over d_model 64 and d_ff 256 terms, and one bf16 rounding of h either
    way with bf16 x (2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels import build

    cfg, weights, x, mask = mlp_case(gated, seed=11)
    dt = getattr(torch, x_dtype)
    want = L.mlp_apply(port_params(weights), torch.tensor(x).to(dt), cfg,
                       mask_blocks=torch.tensor(mask))
    params = types.SimpleNamespace(**{n: torch.tensor(w, device="cuda")
                                      for n, w in weights.items()})
    build.reset_launches()
    got = L.mlp_apply(params, torch.tensor(x, device="cuda").to(dt), cfg,
                      mask_blocks=torch.tensor(mask, device="cuda"))
    assert build.LAUNCHES["dropout_matmul"] == (2 if gated else 1)
    assert got.dtype == want.dtype
    tol = 1e-4 if x_dtype == "float32" else 2e-2
    torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol)
