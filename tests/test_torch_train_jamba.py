"""jamba-1.5-large-398b's training path against the JAX package's on the
same weights (``tests/torch_train_common.py`` says how), at 5 layers of
its 8-layer pattern (four mamba layers, then the attention layer; MoE
FFNs on layers 1 and 3): the hybrid training path through the SSD,
attention and the router.  One file an arch, so that ``pytest --dist
loadfile`` spreads the archs over its workers; jamba's three train steps
are in ``test_torch_train_jamba_{sgdm,adamw}.py``."""
import pytest

pytest.importorskip("jax")

from torch_train_common import check_model_loss_and_grads  # noqa: E402

ARCH = "jamba-1.5-large-398b"
LAYERS = 5


@pytest.mark.parametrize("horn", ["off", "on"])
@pytest.mark.parametrize("arch", [ARCH])
def test_model_loss_and_grads_match_jax(arch, horn):
    check_model_loss_and_grads(arch, horn, num_layers=LAYERS)
