"""The port's model against the JAX package's, on the same weights.

Weights come from ``repro.models.api.model_init`` and cross over through
``load_jax_flat`` (the ``shard_0.npz`` keystr layout); inputs come from
numpy.  The JAX side runs its ``ref`` kernels on the CPU, the port its
plain versions.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_model_config as jax_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.core.steps import make_ctx  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs.base import get_model_config, reduced  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import load_jax_flat  # noqa: E402

ARCHS = ["qwen3-1.7b", "gemma2-27b", "qwen1.5-4b", "gemma3-4b"]


def flatten(params):
    """The checkpointer's flat layout: {keystr(path): numpy leaf}."""
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(params)}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX cfg, JAX params, port cfg, port model) for one arch."""
    arch = request.param
    jcfg = jax_reduced(jax_config(arch))
    tcfg = reduced(get_model_config(arch))
    params = jax_api.model_init(jax.random.key(0), jcfg)
    return arch, jcfg, params, tcfg, load_jax_flat(flatten(params), tcfg,
                                                   device="cpu")


def test_bridge_roundtrip_through_npz(tmp_path):
    """Every JAX leaf lands unchanged in the port (stacked superblock
    leaves unstacked by layer), through the file the checkpointer
    writes; missing and extra keys raise."""
    jcfg = jax_reduced(jax_config("qwen3-1.7b"))
    cfg = reduced(get_model_config("qwen3-1.7b"))
    flat = flatten(jax_api.model_init(jax.random.key(0), jcfg))
    np.savez(tmp_path / "shard_0.npz", **flat)
    model = load_jax_flat(tmp_path / "shard_0.npz", cfg, device="cpu")
    named = dict(model.named_parameters())
    R = cfg.pattern_repeats
    for key, arr in flat.items():
        path = key[2:-2].split("']['")
        if path[0] == "blocks":
            got = np.stack([named[f"layers.{r}.{'.'.join(path[2:])}"]
                            .numpy() for r in range(R)])
        else:
            got = named[".".join(path)].numpy()
        assert np.array_equal(got, arr), key
    n_leaves = sum(arr.size for arr in flat.values())
    assert n_leaves == sum(p.numel() for p in model.parameters())
    some = next(iter(flat))
    with pytest.raises(KeyError, match="no value"):
        load_jax_flat({k: v for k, v in flat.items() if k != some}, cfg,
                      device="cpu")
    with pytest.raises(KeyError, match="no parameter"):
        load_jax_flat({**flat, "['embed']['extra']": flat[some]}, cfg,
                      device="cpu")


# each layer's tolerance: f32 math agrees to rounding; bf16 outputs may
# differ by one bf16 ulp (2^-8 relative) where an f32 intermediate rounds
# the other way
LAYERS = ["norm", "rope", "mlp", "embed", "unembed"]


@pytest.mark.parametrize("layer", LAYERS)
def test_layers_match(pair, layer):
    arch, jcfg, params, tcfg, model = pair
    ctx = make_ctx(jcfg, None)
    rng = np.random.default_rng(LAYERS.index(layer))
    B, S, d = 2, 5, jcfg.d_model
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if layer == "norm":
        # the residual stream is bf16 (cfg.dtype) with f32 statistics
        xb = jnp.asarray(x, jnp.bfloat16)
        norm = jax.tree.map(lambda a: a[0],
                            params["blocks"]["l0"]["pre_norm"])
        want = JL.norm_apply(norm, xb, jcfg)
        got = L.norm_apply(model.layers[0].pre_norm,
                           torch.tensor(x).to(torch.bfloat16), tcfg)
        tol = 2 ** -8
    elif layer == "rope":
        h = rng.normal(size=(B, S, 4, jcfg.head_dim)).astype(np.float32)
        pos = rng.integers(0, 4000, size=(B, S)).astype(np.int32)
        want = JL.apply_rope(jnp.asarray(h), jnp.asarray(pos),
                             jcfg.rope_theta)
        got = L.apply_rope(torch.tensor(h), torch.tensor(pos),
                           tcfg.rope_theta)
        tol = 1e-5          # angles up to 4000 rad: sin/cos rounding
    elif layer == "mlp":
        mp = jax.tree.map(lambda a: a[0], params["blocks"]["l0"]["mlp"])
        xb = jnp.asarray(x, jnp.bfloat16)
        want = JL.mlp_apply(mp, xb, jcfg, ctx)
        got = L.mlp_apply(model.layers[0].mlp,
                          torch.tensor(x).to(torch.bfloat16), tcfg)
        tol = 2 ** -8
    elif layer == "embed":
        tok = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
        want = JL.embed_apply(params["embed"], jnp.asarray(tok), jcfg, ctx)
        got = L.embed_apply(model.embed, torch.tensor(tok), tcfg)
        tol = 0.0           # a gather, a cast and one bf16 multiply
    else:
        xb = jnp.asarray(x, jnp.bfloat16)
        want = JL.unembed_apply(params["embed"], xb, jcfg, ctx)
        got = L.unembed_apply(model.embed,
                              torch.tensor(x).to(torch.bfloat16), tcfg)
        tol = 2 ** -7       # bf16 logits: rounding of the f32 sums
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def f32_pair(request):
    """Like ``pair`` but with dtype="float32" end to end."""
    arch = request.param
    jcfg = jax_reduced(jax_config(arch), dtype="float32")
    tcfg = reduced(get_model_config(arch), dtype="float32")
    params = jax_api.model_init(jax.random.key(1), jcfg)
    return jcfg, params, tcfg, load_jax_flat(flatten(params), tcfg,
                                             device="cpu")


def test_paged_step_logits_match(f32_pair):
    """Three successive ticks on the same pools (a prompt chunk, a second
    chunk, a decode token), slot 1 at its own depth and idle in tick 2.
    f32 throughout; atol 1e-4 for the summation order of the matmuls."""
    jcfg, params, tcfg, model = f32_pair
    ctx = make_ctx(jcfg, None)
    P, psize, maxp, B = 12, 4, 5, 2
    jcache = JT.init_paged_cache(jcfg, P, psize, dtype=jnp.float32)
    tcache = T.init_paged_cache(tcfg, P, psize, dtype=torch.float32,
                                device="cpu")
    bt = np.asarray([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    rng = np.random.default_rng(9)
    ticks = [  # (chunk width, starts, chunk_lens)
        (8, [0, 0], [7, 3]),
        (4, [7, 3], [4, 0]),
        (1, [11, 3], [1, 1]),
    ]
    for C, st, cl in ticks:
        tok = rng.integers(1, jcfg.vocab_size, size=(B, C)).astype(np.int32)
        st, cl = np.asarray(st, np.int32), np.asarray(cl, np.int32)
        want, jcache = jax_api.paged_step(
            params, jcache, jnp.asarray(tok), jnp.asarray(st),
            jnp.asarray(cl), jnp.asarray(bt), jcfg, ctx)
        got, tcache = api.paged_step(
            model, tcache, torch.tensor(tok), torch.tensor(st),
            torch.tensor(cl), torch.tensor(bt), tcfg)
        live = cl > 0                       # idle slots: logits are garbage
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   atol=1e-4, rtol=1e-4)
    # the pools themselves (every page but the null page) agree too
    for li, (kp, vp) in enumerate(tcache):
        r, i = divmod(li, len(jcfg.layer_pattern))
        jk, jv = jcache["blocks"][f"l{i}"]
        np.testing.assert_allclose(kp.numpy()[1:], np.asarray(jk[r])[1:],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(vp.numpy()[1:], np.asarray(jv[r])[1:],
                                   atol=1e-5, rtol=1e-5)
