"""mamba2-2.7b's training path against the JAX package's on the same
weights (``tests/torch_train_common.py`` says how).  One file an arch, so that
``pytest --dist loadfile`` spreads the archs over its workers."""
import pytest

pytest.importorskip("jax")

from torch_train_common import (OPT_MICRO, check_model_loss_and_grads,  # noqa: E402,E501
                                check_three_train_steps)


@pytest.mark.parametrize("horn", ["off", "on"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b"])
def test_model_loss_and_grads_match_jax(arch, horn):
    check_model_loss_and_grads(arch, horn)


@pytest.mark.parametrize("optimizer,micro", OPT_MICRO)
@pytest.mark.parametrize("arch", ["mamba2-2.7b"])
def test_three_train_steps_match_jax(arch, optimizer, micro, monkeypatch):
    check_three_train_steps(arch, optimizer, micro, monkeypatch)


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_state_round_trips_through_the_jax_layout(arch, optimizer):
    """A Mamba train state's checkpoint: JAX's ``init_state``, flattened,
    loads into the port's state and comes back out of
    ``state_to_jax_flat`` key for key and bit for bit (the mamba leaves and
    their moments included); the port's own state has the same keys,
    shapes and dtypes."""
    import jax
    import numpy as np

    from repro.checkpoint.checkpointer import _flatten
    from repro.configs import base as jbase
    from repro.core import steps as JS
    from repro_torch.configs import base as tbase
    from repro_torch.core import steps as TS
    from torch_train_common import B, S, configs

    jcfg, tcfg = configs(arch, num_layers=8)
    shape = dict(name="t", kind="train", seq_len=S, global_batch=B)
    jrun = jbase.RunConfig(model=jcfg, shape=jbase.ShapeConfig(**shape),
                           optimizer=optimizer)
    trun = tbase.RunConfig(model=tcfg, shape=tbase.ShapeConfig(**shape),
                           optimizer=optimizer)
    want = {k: np.asarray(v) for k, v in _flatten(
        JS.init_state(jax.random.key(trun.seed), jrun)).items()}
    assert any("['mamba']" in k for k in want)
    state = TS.state_from_jax_flat(want, trun, "cpu")
    got = TS.state_to_jax_flat(state, trun)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    own = TS.state_to_jax_flat(TS.init_state(trun, "cpu"), trun)
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
