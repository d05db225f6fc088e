"""jamba-1.5-large-398b's three train steps with momentum SGD against the
JAX package's (``tests/test_torch_train_jamba.py`` says which config;
one file an optimizer, so that ``--dist loadfile`` spreads them)."""
import pytest

pytest.importorskip("jax")

from test_torch_train_jamba import ARCH, LAYERS  # noqa: E402
from torch_train_common import OPT_MICRO, check_three_train_steps  # noqa: E402


@pytest.mark.parametrize("optimizer,micro",
                         [c for c in OPT_MICRO if c[0] == "sgdm"])
@pytest.mark.parametrize("arch", [ARCH])
def test_three_train_steps_match_jax(arch, optimizer, micro, monkeypatch):
    check_three_train_steps(arch, optimizer, micro, monkeypatch,
                            num_layers=LAYERS)
