"""The port's training path against the JAX package's, on the same weights:
the shared configs, helpers and checks of the per-arch
``tests/test_torch_train_<arch>.py`` files.

Reduced qwen3-1.7b, gemma2-27b, qwen1.5-4b (QKV bias, untied unembedding)
and gemma3-4b (5:1 local:global, qk-norm, gelu) configs in f32 (residual
stream and compute), weights from ``repro.models.api.model_init`` carried over with
``load_jax_flat``, batches from both packages' synthetic pipelines.  The
JAX side runs its ``ref`` kernels on the CPU, the port its plain versions.
With Horn on, the port draws JAX's own uniforms (``jax_uniform_horn``), so
both apply the same masks.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.core import steps as JS
from repro.data import pipeline as jpipe
from repro.launch.mesh import make_test_mesh
from repro.models import api as jax_api
from repro_torch.configs import base as tbase
from repro_torch.core import steps as TS
from repro_torch.models import api
from repro_torch.models.params import load_jax_flat, to_jax_flat
from repro_torch.optim.sgd import make_optimizer
from test_torch_parallel_dropout import jax_uniform_horn

B, S = 4, 32
HORN = dict(num_groups=2, block_size=32, mask_attention_heads=True)


def configs(arch):
    return (dataclasses.replace(jbase.reduced(jbase.get_model_config(arch)),
                                dtype="float32"),
            dataclasses.replace(tbase.reduced(tbase.get_model_config(arch)),
                                dtype="float32"))


def flatten(params):
    """The checkpointer's flat layout: {keystr(path): numpy leaf}."""
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(params)}


def batch_at(vocab, step, seed=0):
    return jpipe.SyntheticTokenPipeline(jpipe.TokenPipelineConfig(
        vocab_size=vocab, seq_len=S, global_batch=B, seed=seed)).batch_at(step)


def grads_as_jax_flat(model, grads, cfg):
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, gi in zip(g.parameters(), grads):
            p.copy_(gi)
    return to_jax_flat(g, cfg)


def check_model_loss_and_grads(arch, horn):
    """Loss within rtol 1e-5 and every gradient leaf within atol 1e-5 /
    rtol 1e-4 of ``jax.value_and_grad`` of JAX's ``model_loss``: both are
    f32, and the two sides sum attention, matmuls and the chunked
    cross-entropy in different orders."""
    jcfg, tcfg = configs(arch)
    params = jax_api.model_init(jax.random.key(0), jcfg)
    model = load_jax_flat(flatten(params), tcfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    nb = batch_at(jcfg.vocab_size, 0)
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
    assert metrics["xent"].item() == loss.item()
    want = flatten(jgrads)
    got = grads_as_jax_flat(model, grads, tcfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                   rtol=1e-4, err_msg=key)


OPT_MICRO = [("sgdm", 1), ("sgdm", 2), ("adamw", 1), ("adamw", 2)]


def check_three_train_steps(arch, optimizer, micro, monkeypatch):
    """Three steps of ``make_train_step`` with Horn on (JAX's uniforms on
    both sides), f32 compute: loss, grad norm and the MoE aux metrics
    (load balance, router z, dropped fraction; zeros for a dense arch) of
    every step within rtol 1e-5 (atol 1e-6 for the aux), and every
    parameter after the third step within rtol 1e-4 of the JAX step's.  atol: 2e-5 for sgdm (the update is lr-scaled and clipped
    at norm 1, so a gradient difference at f32 rounding stays at rounding);
    1e-4, a tenth of one step of lr 1e-3, for AdamW, which divides each
    element's step by its own gradient scale, so an element whose gradient
    is near the rounding noise moves by a visible fraction of lr."""
    jcfg, tcfg = configs(arch)
    lr = 0.05 if optimizer == "sgdm" else 1e-3
    common = dict(optimizer=optimizer, learning_rate=lr, microbatches=micro,
                  compute_dtype="float32", seed=0)
    jrun = jbase.RunConfig(model=jcfg,
                           shape=jbase.ShapeConfig("t", "train", S, B),
                           horn=jbase.HornConfig(**HORN), **common)
    trun = tbase.RunConfig(model=tcfg,
                           shape=tbase.ShapeConfig("t", "train", S, B),
                           horn=tbase.HornConfig(**HORN), **common)
    step_fn, _ = JS.make_train_step(jrun, make_test_mesh(1, 1))
    jstate = JS.init_state(jax.random.key(0), jrun)
    opt_init, _ = make_optimizer(optimizer)
    model = load_jax_flat(flatten(jstate["params"]), tcfg, device="cpu")
    tstate = {"params": model, "opt": opt_init(list(model.parameters())),
              "step": 0, "rng": 0}
    monkeypatch.setattr(
        TS, "make_horn_state",
        lambda seed, hcfg, step, device: jax_uniform_horn(
            seed, hcfg, step)[1])
    tstep = TS.make_train_step(trun, "cpu")
    for i in range(3):
        nb = batch_at(jcfg.vocab_size, i)
        jstate, jm = step_fn(jstate, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
        tstate, tm = tstep(tstate, nb)
        assert set(tm) == set(jm)
        for k in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        for k in ("load_balance_loss", "router_z_loss", "dropped_frac"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=1e-6,
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    assert tstate["step"] == int(jstate["step"]) == 3
    want = flatten(jstate["params"])
    got = to_jax_flat(tstate["params"], tcfg)
    for key in want:
        np.testing.assert_allclose(
            got[key], want[key], atol=2e-5 if optimizer == "sgdm" else 1e-4,
            rtol=1e-4, err_msg=key)
