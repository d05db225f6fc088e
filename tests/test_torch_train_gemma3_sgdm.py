"""gemma3-4b's three momentum-SGD train steps against the JAX package's on
the same weights (``tests/torch_train_common.py`` says how); the rest of
its cases are in ``tests/test_torch_train_gemma3.py``."""
import pytest

pytest.importorskip("jax")

from torch_train_common import OPT_MICRO, check_three_train_steps  # noqa: E402


@pytest.mark.parametrize("optimizer,micro",
                         [om for om in OPT_MICRO if om[0] == "sgdm"])
@pytest.mark.parametrize("arch", ["gemma3-4b"])
def test_three_train_steps_match_jax(arch, optimizer, micro, monkeypatch):
    check_three_train_steps(arch, optimizer, micro, monkeypatch)
