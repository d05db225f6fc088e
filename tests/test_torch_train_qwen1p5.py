"""qwen1.5-4b's training path against the JAX package's on the same
weights (``tests/torch_train_common.py`` says how).  One file an arch, so that
``pytest --dist loadfile`` spreads the archs over its workers."""
import pytest

pytest.importorskip("jax")

from torch_train_common import (OPT_MICRO, check_model_loss_and_grads,  # noqa: E402,E501
                                check_three_train_steps)


@pytest.mark.parametrize("horn", ["off", "on"])
@pytest.mark.parametrize("arch", ["qwen1.5-4b"])
def test_model_loss_and_grads_match_jax(arch, horn):
    check_model_loss_and_grads(arch, horn)


@pytest.mark.parametrize("optimizer,micro", OPT_MICRO)
@pytest.mark.parametrize("arch", ["qwen1.5-4b"])
def test_three_train_steps_match_jax(arch, optimizer, micro, monkeypatch):
    check_three_train_steps(arch, optimizer, micro, monkeypatch)
