"""The MoE, multimodal-prefix and hybrid families in the port against the
JAX package: the counterpart of ``tests/test_smoke_archs.py`` for
phi3.5-moe-42b, llama4-maverick-400b, llava-next-34b and
jamba-1.5-large-398b.

Reduced configs in f32, weights from ``repro.models.api.model_init``
carried over with ``load_jax_flat``, tokens and patch embeddings from
numpy.  The JAX side runs its ``ref`` kernels on the CPU, the port its
plain versions.  Loss within rtol 1e-5, gradients and logits within atol
1e-5 / rtol 1e-4 (logits 1e-4 absolute, as ``test_torch_ssm.py``), the
parameter layout equal outright.

    PYTHONPATH=src python -m pytest tests/test_torch_archs.py
"""
import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import steps as JS  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models.params import ParamSpec  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import steps as TS  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import (_maker, load_jax_flat,  # noqa: E402
                                       to_jax_flat)
from test_torch_parallel_dropout import jax_uniform_horn  # noqa: E402

ARCHS = ["phi3.5-moe-42b", "llama4-maverick-400b", "llava-next-34b",
         "jamba-1.5-large-398b"]
TRAINED = ARCHS[:3]      # jamba: tests/test_torch_train_jamba*.py
B, S_TEXT = 2, 20
HORN = dict(num_groups=2, block_size=32, mask_attention_heads=True)
LOGIT_TOL = 1e-4


def configs(arch, **over):
    over = {"dtype": "float32", **over}
    return (jbase.reduced(jbase.get_model_config(arch), **over),
            tbase.reduced(tbase.get_model_config(arch), **over))


def flatten(params):
    """The checkpointer's flat layout: {keystr(path): numpy leaf}."""
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(params)}


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX cfg, JAX params, port cfg, port model), f32."""
    arch = request.param
    jcfg, tcfg = configs(arch)
    params = jax_api.model_init(jax.random.key(0), jcfg)
    return (arch, jcfg, params, tcfg,
            load_jax_flat(flatten(params), tcfg, device="cpu"))


def make_batch(cfg, seed, text=S_TEXT, labels=True):
    """Seeded tokens (and labels), and normal patch embeddings in front of
    them for a multimodal config."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size,
                                    (B, text)).astype(np.int32)}
    if labels:
        batch["labels"] = rng.integers(1, cfg.vocab_size,
                                       (B, text)).astype(np.int32)
    if cfg.num_patches:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("horn", ["off", "on"])
@pytest.mark.parametrize("arch", TRAINED)
def test_model_loss_and_grads_match_jax(arch, horn):
    """Loss (cross-entropy plus the MoE router terms) within rtol 1e-5,
    each aux value within 1e-5, and every gradient leaf within atol 1e-5
    / rtol 1e-4 of ``jax.value_and_grad`` of JAX's ``model_loss``; with
    Horn on the port draws JAX's uniforms (the expert hidden masks of salt
    5 and width moe_ff too)."""
    jcfg, tcfg = configs(arch)
    params = jax_api.model_init(jax.random.key(0), jcfg)
    model = load_jax_flat(flatten(params), tcfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    nb = make_batch(tcfg, seed=1)
    js = ts = None
    if horn == "on":
        js, ts = jax_uniform_horn(0, tbase.HornConfig(**HORN), step=2)
    ctx = JS.make_ctx(jcfg, None)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_api.model_loss(p, {k: jnp.asarray(v) for k, v in
                                         nb.items()}, jcfg, ctx, horn=js),
        has_aux=True)(params)
    loss, metrics = api.model_loss(
        model, {k: torch.tensor(v) for k, v in nb.items()}, tcfg, horn=ts)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jm)
    for k in ("xent",) + L.MOE_AUX:
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    if tcfg.num_experts and T.layer_moe_flags(tcfg).count(True):
        assert metrics["load_balance_loss"].item() > 0
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, gi in zip(g.parameters(), grads):
            p.copy_(gi)
    got, want = to_jax_flat(g, tcfg), flatten(jgrads)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                   rtol=1e-4, err_msg=key)


def pad_jax_cache(jcfg, cache, max_len):
    """JAX's prefill cache laid into ``init_cache`` buffers of ``max_len``
    tokens (attention (k, v) at the front; mamba leaves as they are)."""
    buf = jax_api.T.init_cache(jcfg, B, max_len, dtype=jnp.float32)

    def put(b, c):
        if b.shape == c.shape:
            return c
        S = c.shape[-3]
        return b.at[..., :S, :, :].set(c)

    return jax.tree.map(put, buf, cache)


def test_prefill_and_decode_match_jax(pair):
    """``make_prefill_step`` then 4 greedy ``make_decode_step`` steps
    against the JAX package, llama4 and llava behind random patch
    embeddings (the logits are the last text token's; decode continues at
    patches + text).  Attention-only archs: against the JAX steps on JAX's
    own prefill cache, step by step, at the configs' capacity factor, so
    both sides drop the same expert choices.  jamba: the JAX package's
    decode chain hands its mamba layers the post-conv tail (ROADMAP
    section 3), so the port's chain is held against JAX's prefill of the
    longer sequence instead, at capacity factor 2 = E / K, where no expert
    choice drops and a token's MoE output does not depend on the others'
    (capacity depends on the row's length)."""
    arch, jcfg, params, tcfg, model = pair
    K = 4
    hybrid = tbase.MAMBA in tcfg.layer_pattern
    if hybrid:
        jcfg, tcfg = configs(arch, capacity_factor=2.0)
    npatch = tcfg.num_patches
    nb = make_batch(tcfg, seed=2, labels=False)
    total = npatch + S_TEXT + K
    trun = tbase.RunConfig(model=tcfg, shape=tbase.ShapeConfig(
        "p", "prefill", total, B), compute_dtype="float32")
    jrun = jbase.RunConfig(model=jcfg, shape=jbase.ShapeConfig(
        "p", "prefill", total, B), compute_dtype="float32")
    mesh = make_test_mesh(1, 1)
    ctx = JS.make_ctx(jcfg, None)
    prefill = TS.make_prefill_step(trun, "cpu")
    decode = TS.make_decode_step(trun, "cpu")
    logits, cache = prefill(model, nb)
    jpre, _ = JS.make_prefill_step(jrun, mesh)
    jlogits, jcache, _ = jpre(params, {k: jnp.asarray(v)
                                       for k, v in nb.items()})
    assert max_diff(logits, jlogits) < LOGIT_TOL
    if not hybrid:
        jdec, _ = JS.make_decode_step(jrun, mesh)
        jcache = pad_jax_cache(jcfg, jcache, total)
    seq = nb["tokens"]
    for k in range(K):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        assert torch.equal(tok, torch.tensor(
            np.asarray(jnp.argmax(jlogits, -1))[:, None]))
        seq = np.concatenate([seq, tok.numpy()], axis=1)
        pos = npatch + S_TEXT + k
        logits, cache = decode(model, cache, tok, pos)
        if hybrid:
            jlogits, _, _ = jax_api.prefill(params, {
                "tokens": jnp.asarray(seq)}, jcfg, ctx)
        else:
            jlogits, jcache = jdec(params, jcache, jnp.asarray(tok.numpy()),
                                   jnp.asarray(pos, jnp.int32))
        assert max_diff(logits, jlogits) < LOGIT_TOL, (arch, k)
        assert torch.isfinite(logits).all()


def test_eval_forward_is_deterministic(pair):
    """Eval mode (no Horn) gives the same hidden states twice, and JAX's
    within 1e-5."""
    arch, jcfg, params, tcfg, model = pair
    nb = make_batch(tcfg, seed=3, labels=False)
    tb = {k: torch.tensor(v) for k, v in nb.items()}
    h1, aux1 = api.forward_hidden(model, tb, tcfg, remat=False)
    h2, aux2 = api.forward_hidden(model, tb, tcfg, remat=False)
    assert torch.equal(h1, h2)
    assert all(torch.equal(aux1[k], aux2[k]) for k in L.MOE_AUX)
    jh, _, jaux, _ = jax_api.forward_hidden(
        params, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg,
        JS.make_ctx(jcfg, None), horn=None, mode="train", remat=False)
    assert h1.shape[1] == tcfg.num_patches + S_TEXT
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-4)
    for k in L.MOE_AUX:
        np.testing.assert_allclose(aux1[k].item(), float(jaux[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def spec_shapes(jcfg):
    """{keystr: shape} of the JAX package's parameter spec tree."""
    leaves = jax.tree_util.tree_leaves_with_path(
        jax_api.model_specs(jcfg),
        is_leaf=lambda x: isinstance(x, ParamSpec))
    return {jax.tree_util.keystr(p): tuple(s.shape) for p, s in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_layout_equals_the_jax_spec_tree(arch):
    """At the published depth (reduced widths): ``to_jax_flat``'s keys and
    shapes equal the JAX spec tree's; llama4-maverick has no MoE layer
    there (its scanned pattern ``(ATTN,)`` asks ``layer_is_moe(0)``), so
    no router; llava has no experts at all.  At the published widths (the port's LM built on the meta
    device): the same parameter count as the spec tree."""
    jcfg, tcfg = jbase.get_model_config(arch), tbase.get_model_config(arch)
    jred = jbase.reduced(jcfg, num_layers=jcfg.num_layers)
    tred = tbase.reduced(tcfg, num_layers=tcfg.num_layers)
    model = T.LM(tred, _maker(lambda shape, init, scale, device, dtype:
                              torch.zeros(shape), "cpu", torch.float32))
    flat = to_jax_flat(model, tred)
    want = spec_shapes(jred)
    assert {k: v.shape for k, v in flat.items()} == want
    routers = [k for k in want if "['moe']['router']" in k]
    flags = T.layer_moe_flags(tred)
    if arch == "llama4-maverick-400b":
        assert tred.num_layers == 48 and tcfg.num_experts == 128
    assert bool(routers) == any(flags) == (arch in ("phi3.5-moe-42b",
                                                    "jamba-1.5-large-398b"))
    meta = T.LM(tcfg, _maker(lambda shape, init, scale, device, dtype:
                             torch.empty(shape, device="meta"), "meta",
                             torch.float32))
    n = sum(p.numel() for p in meta.parameters())
    assert n == sum(int(np.prod(s)) for s in spec_shapes(jcfg).values())
    assert sum(isinstance(m, L.MoE) for m in meta.modules()) == \
        sum(T.layer_moe_flags(tcfg))


def test_patches_reach_the_logits():
    """llava's logits depend on its patch embeddings, and a loss batch
    without patches is the text alone (positions from 0)."""
    jcfg, tcfg = configs("llava-next-34b")
    params = jax_api.model_init(jax.random.key(0), jcfg)
    model = load_jax_flat(flatten(params), tcfg, device="cpu")
    nb = {k: torch.tensor(v) for k, v in make_batch(
        tcfg, seed=4, labels=False).items()}
    a, _ = api.prefill(model, nb, tcfg)
    b, _ = api.prefill(model, dict(nb, patch_embeds=nb["patch_embeds"] * 2),
                       tcfg)
    assert not torch.allclose(a, b)
    c, cache = api.prefill(model, {"tokens": nb["tokens"]}, tcfg)
    assert cache[0][0].shape[1] == S_TEXT
    jc, _, _ = jax_api.prefill(params, {"tokens": jnp.asarray(
        nb["tokens"].numpy())}, jcfg, JS.make_ctx(jcfg, None))
    assert max_diff(c, jc) < LOGIT_TOL


@pytest.mark.parametrize("arch", TRAINED)
def test_train_cli_runs_the_new_archs_on_the_cpu(arch, capsys):
    """``launch.train`` at the reduced size: finite losses, grad norms
    above 0; a multimodal arch feeds zero patch embeddings in front of
    ``--seq`` minus its patches of text."""
    from repro_torch.launch import train

    out = train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "24", "--log-every", "1"])
    assert len(out["steps"]) == 2
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in out["steps"])
    sess = train.setup(["--arch", arch, "--device", "cpu", "--seq", "24",
                        "--batch", "2"])
    batch = sess.batch_at(0)
    cfg = sess.run.model
    assert batch["tokens"].shape == (2, 24 - cfg.num_patches)
    if cfg.num_patches:
        assert batch["patch_embeds"].shape == (2, cfg.num_patches,
                                               cfg.d_model)
        assert not batch["patch_embeds"].any()
    assert "loss: first=" in capsys.readouterr().out


def test_hybrid_layout_matches_jax():
    """jamba's reduced config: the JAX package's layer kinds and MoE layers
    (1, 3, 5 and 7 of each 8-layer superblock), and each layer's dense
    decode cache (attention (k, v), mamba (conv tail, state)) of the JAX
    shapes."""
    jcfg, tcfg = configs("jamba-1.5-large-398b")
    assert tcfg.layer_kinds() == jcfg.layer_kinds()
    flags = T.layer_moe_flags(tcfg)
    assert [i for i, f in enumerate(flags) if f] == \
        [i for i in range(tcfg.num_layers) if i % 2 == 1]
    cache = T.init_cache(tcfg, B, 8, device="cpu")
    jcache = jax_api.T.init_cache(jcfg, B, 8)["blocks"]
    P = len(tcfg.layer_pattern)
    for li, entry in enumerate(cache):
        want = jcache[f"l{li % P}"]
        assert [tuple(t.shape) for t in entry] == \
            [tuple(a.shape[1:]) for a in want]
