"""The encoder-decoder family (whisper-base) in the port against the JAX
package: ``models/encdec.py``, cross-attention, learned positions, the
``frames`` / ``encoder_out`` branches of ``models/api.py`` and
``core/steps.py``, the weight and train-state bridges, and the train CLI.

Reduced configs in f32, weights from ``repro.models.api.model_init``
carried over with ``load_jax_flat``, tokens and frames from numpy.  The
JAX side runs its ``ref`` kernels on the CPU, the port its plain versions.
``reduced()`` drops the decoder's learned positions and gives G 2 in both
packages, so every case runs twice: as ``reduced()`` gives it
("reduced"), and with ``learned_pos=True, max_pos=64, num_kv_heads=4``
("pos-g1": the decoder's learned positions and one query head a KV head,
whisper-base's own geometry).  Loss within rtol 1e-5, gradients within
atol 1e-5 / rtol 1e-4, logits and the encoder output within 1e-4
absolute, layouts equal outright.  The card's cases are in
``tests/test_torch_encdec_cuda.py``, which imports no JAX.

    PYTHONPATH=src python -m pytest tests/test_torch_encdec.py
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
from repro_torch.kernels.flash_attention import kernel  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models.params import (_maker, init_params,  # noqa: E402
                                       load_jax_flat, to_jax_flat)
from test_torch_parallel_dropout import jax_uniform_horn  # noqa: E402

ARCH = "whisper-base"
VARIANTS = {"reduced": {},
            "pos-g1": dict(learned_pos=True, max_pos=64, num_kv_heads=4)}
B, S_TEXT, K = 2, 12, 4
HORN = dict(num_groups=2, block_size=32, mask_attention_heads=True)
LOGIT_TOL = 1e-4


def configs(variant, **over):
    over = {"dtype": "float32", **VARIANTS[variant], **over}
    return (jbase.reduced(jbase.get_model_config(ARCH), **over),
            tbase.reduced(tbase.get_model_config(ARCH), **over))


def flatten(tree):
    """The checkpointer's flat layout: {keystr(path): numpy leaf}."""
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def make_batch(cfg, seed, labels=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size,
                                    (B, S_TEXT)).astype(np.int32),
             "frames": rng.standard_normal(
                 (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    if labels:
        batch["labels"] = rng.integers(1, cfg.vocab_size,
                                       (B, S_TEXT)).astype(np.int32)
    return batch


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    """(variant, JAX cfg, JAX params, port cfg, port model), f32."""
    jcfg, tcfg = configs(request.param)
    params = jax_api.model_init(jax.random.key(0), jcfg)
    return (request.param, jcfg, params, tcfg,
            load_jax_flat(flatten(params), tcfg, device="cpu"))


def spec_shapes(jcfg):
    """{keystr: shape} of the JAX package's parameter spec tree."""
    leaves = jax.tree_util.tree_leaves_with_path(
        jax_api.model_specs(jcfg),
        is_leaf=lambda x: isinstance(x, ParamSpec))
    return {jax.tree_util.keystr(p): tuple(s.shape) for p, s in leaves}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_param_layout_equals_the_jax_spec_tree(variant):
    """At the published depth (6 + 6 layers, reduced widths):
    ``to_jax_flat``'s keys and shapes equal the JAX spec tree's (the
    encoder's blocks stacked over its 6 layers, the decoder's with
    ``cross_norm`` / ``cross_attn``, positions where the config has
    them); at the published widths the meta-device model holds as many
    parameters as the spec tree, and ``load_jax_flat`` of JAX's weights
    round-trips bit for bit."""
    depth = dict(num_layers=6, num_encoder_layers=6)
    jcfg, tcfg = configs(variant, **depth)
    model = init_params(tcfg, 0, device="cpu")
    assert isinstance(model, ED.EncDec)
    flat = to_jax_flat(model, tcfg)
    want = spec_shapes(jcfg)
    assert {k: v.shape for k, v in flat.items()} == want
    assert want["['encoder']['blocks']['l0']['attn']['wq']"][0] == 6
    assert "['decoder']['blocks']['l0']['cross_attn']['wk']" in want
    assert ("['decoder']['pos_embed']" in want) == tcfg.learned_pos
    assert want["['encoder']['pos_embed']"] == (tcfg.encoder_seq,
                                                tcfg.d_model)
    params = jax_api.model_init(jax.random.key(1), jcfg)
    back = to_jax_flat(load_jax_flat(flatten(params), tcfg, device="cpu"),
                       tcfg)
    assert all(np.array_equal(back[k], v) for k, v in flatten(params).items())
    full_j, full_t = jbase.get_model_config(ARCH), tbase.get_model_config(ARCH)
    meta = ED.EncDec(full_t, _maker(lambda shape, init, scale, device, dtype:
                                    torch.empty(shape, device="meta"),
                                    "meta", torch.float32))
    assert sum(p.numel() for p in meta.parameters()) == \
        sum(int(np.prod(s)) for s in spec_shapes(full_j).values())


def test_whisper_config_is_the_reference_copy():
    """The registered config equals the JAX package's field for field."""
    import dataclasses

    assert dataclasses.asdict(tbase.get_model_config(ARCH)) == \
        dataclasses.asdict(jbase.get_model_config(ARCH))


@pytest.mark.parametrize("arch", tbase.list_archs())
def test_param_count_matches_jax(arch):
    """``ModelConfig.param_count`` (total and active) equals JAX's for
    every registered arch, whisper's encoder and cross-attention
    included."""
    jcfg, tcfg = jbase.get_model_config(arch), tbase.get_model_config(arch)
    for active in (False, True):
        assert tcfg.param_count(active) == jcfg.param_count(active)


@pytest.mark.parametrize("horn", ["off", "on"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_loss_and_grads_match_jax(variant, horn):
    """Loss within rtol 1e-5 and every gradient leaf (encoder, decoder,
    cross-attention, positions) within atol 1e-5 / rtol 1e-4 of
    ``jax.value_and_grad`` of JAX's ``model_loss``, with remat on; with
    Horn on the port draws JAX's uniforms (decoder masks only)."""
    jcfg, tcfg = configs(variant)
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
    np.testing.assert_allclose(metrics["xent"].item(), float(jm["xent"]),
                               rtol=1e-5)
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, gi in zip(g.parameters(), grads):
            p.copy_(gi)
    got, want = to_jax_flat(g, tcfg), flatten(jgrads)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                   rtol=1e-4, err_msg=key)
    enc = "['encoder']['blocks']['l0']['attn']['wq']"
    assert np.abs(got[enc]).max() > 0


def pad_jax_cache(jcfg, cache, max_len):
    """JAX's prefill cache laid into ``init_cache`` buffers of ``max_len``
    tokens."""
    buf = jax_api.T.init_cache(jcfg, B, max_len, dtype=jnp.float32)
    return jax.tree.map(lambda b, c: b.at[..., :c.shape[-3], :, :].set(c),
                        buf, cache)


def test_prefill_and_decode_match_jax(pair):
    """``make_prefill_step`` (logits, and the encoder output as a third
    value) then 4 greedy ``make_decode_step`` steps fed that output,
    against JAX's steps on JAX's own padded prefill cache: logits and the
    encoder output within 1e-4, the same greedy tokens."""
    variant, jcfg, params, tcfg, model = pair
    nb = make_batch(tcfg, seed=2, labels=False)
    total = S_TEXT + K
    trun = tbase.RunConfig(model=tcfg, shape=tbase.ShapeConfig(
        "p", "prefill", total, B), compute_dtype="float32")
    jrun = jbase.RunConfig(model=jcfg, shape=jbase.ShapeConfig(
        "p", "prefill", total, B), compute_dtype="float32")
    mesh = make_test_mesh(1, 1)
    logits, cache, enc = TS.make_prefill_step(trun, "cpu")(model, nb)
    jpre, _ = JS.make_prefill_step(jrun, mesh)
    jlogits, jcache, jenc = jpre(params, {k: jnp.asarray(v)
                                          for k, v in nb.items()})
    assert enc.shape == (B, tcfg.encoder_seq, tcfg.d_model)
    assert max_diff(enc, jenc) < LOGIT_TOL
    assert max_diff(logits, jlogits) < LOGIT_TOL
    decode = TS.make_decode_step(trun, "cpu")
    jdec, _ = JS.make_decode_step(jrun, mesh)
    jcache = pad_jax_cache(jcfg, jcache, total)
    for k in range(K):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        assert torch.equal(tok, torch.tensor(
            np.asarray(jnp.argmax(jlogits, -1))[:, None]))
        logits, cache = decode(model, cache, tok, S_TEXT + k, enc)
        jlogits, jcache = jdec(params, jcache, jnp.asarray(tok.numpy()),
                               jnp.asarray(S_TEXT + k, jnp.int32), jenc)
        assert max_diff(logits, jlogits) < LOGIT_TOL, (variant, k)


def test_encoder_reaches_the_logits_and_decode_needs_it(pair):
    """The prefill logits depend on the frames, decode refuses to run
    without ``encoder_out``, and the paged step and serve masks refuse an
    encoder-decoder, as in the JAX package."""
    _, _, _, tcfg, model = pair
    nb = {k: torch.tensor(v) for k, v in make_batch(
        tcfg, seed=3, labels=False).items()}
    a, cache, enc = api.prefill(model, nb, tcfg)
    b, _, _ = api.prefill(model, dict(nb, frames=nb["frames"] * 2), tcfg)
    assert not torch.allclose(a, b)
    with pytest.raises(ValueError, match="encoder_out"):
        api.decode_step(model, cache, nb["tokens"][:, :1], S_TEXT, tcfg)
    with pytest.raises(ValueError, match="decoder-LM-only"):
        api.paged_step(model, cache, nb["tokens"], None, None, None, tcfg)
    with pytest.raises(ValueError, match="decoder-LM-only"):
        api.prefill(model, nb, tcfg, serve_masks={})


def test_encoder_stream_keeps_the_frames_dtype():
    """With bf16 parameters and f32 frames the encoder's stream (and its
    output) stays f32, as JAX's ``frames + pos_embed.astype(frames
    .dtype)``; with bf16 frames it is bf16."""
    _, tcfg = configs("pos-g1")
    model = init_params(tcfg, 0, device="cpu", dtype=torch.bfloat16)
    frames = torch.randn(B, tcfg.encoder_seq, tcfg.d_model)
    assert ED.encode(model.encoder, frames, tcfg).dtype == torch.float32
    assert ED.encode(model.encoder, frames.to(torch.bfloat16),
                     tcfg).dtype == torch.bfloat16


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_state_round_trips_through_the_jax_layout(optimizer):
    """JAX's ``init_state`` of whisper, flattened, loads into the port's
    state and comes back out of ``state_to_jax_flat`` key for key and bit
    for bit; the port's own state has the same keys, shapes and dtypes."""
    from repro.checkpoint.checkpointer import _flatten

    jcfg, tcfg = configs("pos-g1")
    shape = dict(name="t", kind="train", seq_len=S_TEXT, global_batch=B)
    jrun = jbase.RunConfig(model=jcfg, shape=jbase.ShapeConfig(**shape),
                           optimizer=optimizer)
    trun = tbase.RunConfig(model=tcfg, shape=tbase.ShapeConfig(**shape),
                           optimizer=optimizer)
    want = {k: np.asarray(v) for k, v in _flatten(
        JS.init_state(jax.random.key(trun.seed), jrun)).items()}
    state = TS.state_from_jax_flat(want, trun, "cpu")
    got = TS.state_to_jax_flat(state, trun)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    own = TS.state_to_jax_flat(TS.init_state(trun, "cpu"), trun)
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}


def test_train_step_matches_jax():
    """Two steps of ``make_train_step`` (AdamW, f32 compute, Horn off)
    against JAX's on the same weights and batches: losses within rtol
    1e-5, the parameters after them within atol 1e-4 / rtol 1e-4, the
    AdamW tolerance of ``tests/test_torch_train.py`` (the first steps'
    m / sqrt(v) turn a gradient's last bits into lr-sized moves)."""
    jcfg, tcfg = configs("pos-g1")
    shape = dict(name="t", kind="train", seq_len=S_TEXT, global_batch=B)
    kw = dict(optimizer="adamw", learning_rate=1e-3,
              compute_dtype="float32")
    jrun = jbase.RunConfig(model=jcfg, shape=jbase.ShapeConfig(**shape),
                           horn=jbase.HornConfig(enabled=False), **kw)
    trun = tbase.RunConfig(model=tcfg, shape=tbase.ShapeConfig(**shape),
                           horn=tbase.HornConfig(enabled=False), **kw)
    from repro.checkpoint.checkpointer import _flatten

    jstate = JS.init_state(jax.random.key(0), jrun)
    state = TS.state_from_jax_flat(
        {k: np.asarray(v) for k, v in _flatten(jstate).items()}, trun, "cpu")
    jstep, _ = JS.make_train_step(jrun, make_test_mesh(1, 1))
    step = TS.make_train_step(trun, "cpu")
    for i in range(2):
        nb = make_batch(tcfg, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in nb.items()})
        state, m = step(state, nb)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
    got = to_jax_flat(state["params"], tcfg)
    for k, v in flatten(jstate["params"]).items():
        np.testing.assert_allclose(got[k], v, atol=1e-4, rtol=1e-4,
                                   err_msg=k)


def test_train_cli_runs_whisper_on_the_cpu(capsys):
    """``launch.train --arch whisper-base`` at the reduced size: finite
    losses, grad norms above 0, zero f32 frames [batch, encoder_seq,
    d_model] beside ``--seq`` decoder tokens, no flash launch on the
    CPU."""
    from repro_torch.launch import train

    argv = ["--arch", ARCH, "--device", "cpu", "--seq", "16", "--batch", "2"]
    out = train.main(argv + ["--steps", "2", "--log-every", "1"])
    assert len(out["steps"]) == 2
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in out["steps"])
    assert out["launches"][kernel.FWD] == 0
    sess = train.setup(argv)
    batch = sess.batch_at(0)
    cfg = sess.run.model
    assert batch["tokens"].shape == (2, 16)
    assert batch["frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    assert batch["frames"].dtype == np.float32 and not batch["frames"].any()
    assert "loss: first=" in capsys.readouterr().out


def test_serve_cli_refuses_whisper():
    """Neither engine serves an encoder-decoder: the port's serve CLI
    exits with the engine's message (status 1)."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "1",
                    "--gen", "2"])
    assert "decoder-only" in str(e.value.code)
