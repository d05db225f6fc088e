"""The encoder-decoder family's flash geometry on the card: the flash
kernels at whisper-base's 8 / 8 heads x 64 (D 64, G 1), non-causal as its
encoder runs them and causal as its decoder does, and the whole encoder
on the card against the CPU plain path.  Every case needs a CUDA card and
skips elsewhere; the file imports no JAX, so the card, which has none,
runs it (the CPU parity of the family is ``tests/test_torch_encdec.py``).

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_encdec_cuda.py
"""
import copy

import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel, ref
from repro_torch.models import encdec as ED
from repro_torch.models.params import init_params

B = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["encoder", "decoder"])
@pytest.mark.parametrize("S", [1, 7, 448, 1536])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_at_whisper_geometry_matches_plain(cuda, dtype, S, causal):
    """Flash forward and backward at whisper-base's 8 / 8 heads x 64 (G 1,
    scale 64 ** -0.5), non-causal as the encoder runs it and causal as
    the decoder does, against the plain version and its autograd: f32 at
    atol / rtol 1e-4, bf16 at 2e-2 (compared in f32), each launch on the
    route of its dtype at D 64."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(cuda).manual_seed(S)
    q, k, v, do = (torch.randn(2, 8, S, 64, generator=gen, device=cuda)
                   .to(dt) for _ in range(4))
    kw = dict(scale=64 ** -0.5, causal=causal)
    build.reset_launches()
    o, lse = kernel.flash_attention_fwd(q, k, v, **kw)
    grads = kernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    route = kernel.route(dt, 64)
    assert build.ROUTE_LAUNCHES[f"{kernel.FWD}:{route}"] == 1
    assert build.ROUTE_LAUNCHES[f"{kernel.BWD}:{route}"] == 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = ref.attention_ref(*leaves, **kw)
    wgrads = torch.autograd.grad(want, leaves, do)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o, *grads),
                            (want, *wgrads)):
        torch.testing.assert_close(got.float(), w.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
def test_encoder_on_the_card_matches_the_cpu(cuda):
    """The whole encoder (2 non-causal layers, f32, through the flash
    kernels with remat in training) and its frames' gradient on the card
    against the CPU plain path: output and gradients within 1e-4; the
    forward kernel launched twice a layer (remat) and the backward once,
    on ``cuda_core_d64``."""
    tcfg = tbase.reduced(tbase.get_model_config("whisper-base"),
                         dtype="float32", d_model=512, num_heads=8,
                         num_kv_heads=8, head_dim=64, encoder_seq=256)
    cpu_model = init_params(tcfg, 0, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda)
    frames = torch.randn(B, tcfg.encoder_seq, tcfg.d_model,
                         generator=torch.Generator().manual_seed(0))
    outs = []
    build.reset_launches()
    for model, dev in ((card_model, cuda), (cpu_model, "cpu")):
        f = frames.to(dev).requires_grad_(True)
        out = ED.encode(model.encoder, f, tcfg, train=True)
        (g,) = torch.autograd.grad(out.square().sum(), f)
        outs.append((out.detach().cpu(), g.cpu()))
    L = tcfg.num_encoder_layers
    for name, n in ((kernel.FWD, 2 * L), (kernel.BWD, L)):
        assert build.ROUTE_LAUNCHES[f"{name}:cuda_core_d64"] == n, name
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
