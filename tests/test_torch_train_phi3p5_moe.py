"""phi3.5-moe-42b's training path against the JAX package's on the same
weights (``tests/torch_train_common.py`` says how).  One file an arch, so that
``pytest --dist loadfile`` spreads the archs over its workers."""
import pytest

pytest.importorskip("jax")

from torch_train_common import OPT_MICRO, check_three_train_steps  # noqa: E402


@pytest.mark.parametrize("optimizer,micro", OPT_MICRO)
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b"])
def test_three_train_steps_match_jax(arch, optimizer, micro, monkeypatch):
    check_three_train_steps(arch, optimizer, micro, monkeypatch)
