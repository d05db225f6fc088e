"""The port's Horn masks against the JAX package's.

The two packages draw their uniforms differently (threefry in JAX, a
``torch.Generator`` seeded from the counters in the port), so the parity
tests hand the port JAX's own uniforms: ``jax_uniform_horn`` is a
``HornState`` whose ``uniform`` returns ``jax.random.uniform`` of the key
JAX derives for the same (step, layer, salt).  Everything downstream of the
uniforms must then agree exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import HornConfig, get_model_config, reduced
from repro_torch.core import parallel_dropout as pd
from repro_torch.models import api
from repro_torch.models.params import init_params


def jax_uniform_horn(seed, hcfg, step):
    """(JAX HornState, port HornState drawing JAX's uniforms) for one
    step."""
    jax = pytest.importorskip("jax")
    from repro.configs.base import HornConfig as JHornConfig
    from repro.core import parallel_dropout as jpd

    @dataclasses.dataclass(frozen=True)
    class JaxUniformHorn(pd.HornState):
        jkey: object = None

        def uniform(self, layer_idx, salt, shape):
            key = jax.random.fold_in(jax.random.fold_in(self.jkey, layer_idx),
                                     salt)
            return torch.tensor(np.asarray(jax.random.uniform(key, shape)),
                                device=self.device)

    jstate = jpd.make_horn_state(jax.random.key(seed),
                                 JHornConfig(**dataclasses.asdict(hcfg)), 1,
                                 step)
    return jstate, JaxUniformHorn(seed, step, hcfg, jstate.num_groups,
                                  torch.device("cpu"), jkey=jstate.key)


@pytest.mark.parametrize("G,units,keep,bs", [
    (4, 512, 0.5, 128),      # the paper's hidden keep rate
    (3, 300, 0.8, 128),      # remainder tail, input keep rate
    (8, 64, 0.05, 32),       # most groups draw all-dead: the fallback
    (2, 6, 0.5, 1),          # per-unit (head) masks
])
def test_group_block_mask_matches_jax_exactly(G, units, keep, bs):
    jax = pytest.importorskip("jax")
    from repro.core import parallel_dropout as jpd

    key = jax.random.key(units * 7 + G)
    nb = max(1, units // bs)
    u = jax.random.uniform(key, (G, nb))
    want = np.asarray(jpd.group_block_mask(key, G, units, keep, bs))
    got = pd.group_block_mask(torch.tensor(np.asarray(u)), keep).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    dead = (np.asarray(u) >= keep).all(axis=-1)
    if keep < 0.1:
        assert dead.any(), "the fallback case must draw an all-dead group"
    assert ((got > 0).sum(axis=-1) >= 1).all()


@pytest.mark.parametrize("G,nb,units,batch", [
    (4, 3, 300, 8),          # units % nb == 0
    (3, 4, 306, 7),          # remainder tail of 2 units, ragged batch
    (2, 5, 17, 2),
])
def test_expand_units_and_mask_match_jax(G, nb, units, batch):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import parallel_dropout as jpd

    mb = np.random.default_rng(units).integers(0, 2, (G, nb)) / 0.5
    mb = mb.astype(np.float32)
    assert np.array_equal(
        pd.expand_units(torch.tensor(mb), units).numpy(),
        np.asarray(jpd.expand_units(jnp.asarray(mb), units)))
    assert np.array_equal(
        pd.expand_mask(torch.tensor(mb), units, batch).numpy(),
        np.asarray(jpd.expand_mask(jnp.asarray(mb), units, batch)))


def test_no_state_means_no_mask():
    assert pd.unit_mask(None, 0, 4, 64) is None
    assert pd.input_mask(None, 4, 64) is None
    assert pd.head_mask(None, 0, 4, 8) is None
    assert pd.make_horn_state(0, HornConfig(enabled=False), 0,
                              "cpu") is None
    st = pd.make_horn_state(0, HornConfig(), 0, "cpu")
    assert st.num_groups == 1
    assert pd.unit_mask(st, 0, 4, 64, keep=1.0) is None
    assert pd.head_mask(st, 0, 4, 8) is None       # heads are not masked


@pytest.mark.parametrize("step", [0, 5])
def test_unit_input_head_masks_match_jax_given_its_uniforms(step):
    pytest.importorskip("jax")
    from repro.core import parallel_dropout as jpd

    hcfg = HornConfig(num_groups=3, block_size=16, mask_attention_heads=True)
    js, ts = jax_uniform_horn(11, hcfg, step)
    for layer in (0, 3):
        assert np.array_equal(
            pd.unit_mask(ts, layer, 7, 100, salt=5).numpy(),
            np.asarray(jpd.unit_mask(js, layer, 7, 100, salt=5)))
        assert np.array_equal(
            pd.head_mask(ts, layer, 7, 8).numpy(),
            np.asarray(jpd.head_mask(js, layer, 7, 8)))
    assert np.array_equal(pd.input_mask(ts, 7, 64).numpy(),
                          np.asarray(jpd.input_mask(js, 7, 64)))


def test_uniforms_are_a_function_of_the_counters():
    """Same (seed, step, layer, salt): the same numbers, however often
    they are drawn (a recomputed block sees its forward's masks); any
    counter changed: other numbers."""
    st = pd.make_horn_state(3, HornConfig(), 7, "cpu")
    a = st.uniform(2, 5, (4, 16))
    assert torch.equal(a, st.uniform(2, 5, (4, 16)))
    for other in (st.uniform(2, 7, (4, 16)), st.uniform(3, 5, (4, 16)),
                  pd.make_horn_state(3, HornConfig(), 8,
                                     "cpu").uniform(2, 5, (4, 16))):
        assert not torch.equal(a, other)
    assert ((a >= 0) & (a < 1)).all()


def test_checkpointed_blocks_give_the_unchecked_loss_and_grads():
    """Horn on (FFN and head masks): rematerialising every block in the
    backward recomputes the same masks, so the loss is bitwise the same and
    the gradients agree to f32 rounding (atol/rtol 1e-6)."""
    cfg = dataclasses.replace(reduced(get_model_config("qwen3-1.7b")),
                              dtype="float32")
    model = init_params(cfg, 0, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    horn = pd.make_horn_state(
        0, HornConfig(num_groups=2, block_size=16, mask_attention_heads=True),
        3, "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 24)))
             for k in ("tokens", "labels")}
    out = {}
    for remat in (False, True):
        loss, _ = api.model_loss(model, batch, cfg, horn=horn, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss,
                                                list(model.parameters())))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    loss_off, _ = api.model_loss(model, batch, cfg, horn=None)
    assert not torch.equal(loss_off, out[True][0])     # the masks bite
