"""Shared layers: norms, RoPE, the gated MLP (dense and block-sparse),
embeddings.

Parameters live in ``nn.Module`` containers whose attributes keep the JAX
package's names and shapes (``scale``, ``wi``/``wg``/``wo``,
``embedding``); the math is plain functions ``<name>_apply(params, x, cfg)``
as in ``repro.models.layers``.  Each container is built from a ``make``
callable, ``make(shape, init) -> nn.Parameter``, so one declaration serves
both random init and the weight bridge (``models/params.py``).

Dtypes follow the JAX package: where jnp promotes a bf16 activation times
an f32 weight to f32, ``mm`` casts both to the promoted type explicitly
(``torch.matmul`` refuses mixed dtypes).
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dropout_matmul.ops import dropout_matmul

f32 = torch.float32

ACTS = {
    "silu": F.silu,
    "gelu": partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def mm(eq: str, a, b, out_dtype=None):
    """``einsum`` in the promoted dtype of ``a`` and ``b`` (jnp's rule),
    cast to ``out_dtype`` when given (jnp's ``preferred_element_type``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    y = torch.einsum(eq, a.to(dt), b.to(dt))
    return y if out_dtype is None else y.to(out_dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    """RMSNorm weight ``scale`` (applied as ``1 + scale``, zeros at init) or
    LayerNorm ``scale``/``bias``."""

    def __init__(self, cfg: ModelConfig, dim: int, make):
        super().__init__()
        self.scale = make((dim,), "zeros" if cfg.norm == "rmsnorm" else "ones")
        if cfg.norm == "layernorm":
            self.bias = make((dim,), "zeros")


def norm_apply(params, x, cfg: ModelConfig):
    """RMSNorm/LayerNorm: statistics in f32, elementwise math in x.dtype."""
    if cfg.norm == "rmsnorm":
        var = x.to(f32).square().mean(-1, keepdim=True)
        mult = torch.rsqrt(var + cfg.norm_eps).to(x.dtype)
        y = x * mult * (1.0 + params.scale).to(x.dtype)
    else:
        xf = x.to(f32)
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        mult = torch.rsqrt(var + cfg.norm_eps)
        y = ((x - mu.to(x.dtype)) * mult.to(x.dtype)
             * params.scale.to(x.dtype) + params.bias.to(x.dtype))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=f32, device=device)
                     / head_dim)


def apply_rope(x, positions, theta: float):
    """Rotate-half RoPE in f32.  x: [..., S, H, D]; positions: [..., S]."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                # [D/2]
    ang = positions[..., :, None].to(f32) * inv         # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU): dense path and Horn's block-sparse path
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.wi = make((d, ff))
        self.wo = make((ff, d))
        if cfg.mlp_gated:
            self.wg = make((d, ff))


def mlp_apply(params, x, cfg: ModelConfig, *, hidden_mask=None,
              mask_blocks=None):
    """x: [B, S, d] -> [B, S, d], in x.dtype on the dense path (the down
    projection keeps the activation dtype, as
    ``preferred_element_type=x.dtype`` does).

    ``hidden_mask`` ([B, 1, ff]-broadcastable, or None) is Horn's per-group
    structured neuron mask, already scaled by 1/keep; it multiplies the
    hidden units before the down projection.

    ``mask_blocks`` ([G, ff / block] in {0, 1/keep}) takes the block-sparse
    path instead (and wins over ``hidden_mask``): the up and gate products
    run through ``dropout_matmul``, whose dropped blocks skip their work.
    Same semantics as the masked dense path, forward-only."""
    act = ACTS[cfg.act]
    if mask_blocks is not None:
        return _mlp_blocks(params, x, cfg, act, mask_blocks)
    up = mm("...d,df->...f", x, params.wi)
    if cfg.mlp_gated:
        h = act(mm("...d,df->...f", x, params.wg)) * up
    else:
        h = act(up)
    if hidden_mask is not None:
        h = h * hidden_mask.to(h.dtype)
    return mm("...f,fd->...d", h, params.wo, x.dtype)


def _mlp_blocks(params, x, cfg: ModelConfig, act, mask_blocks):
    """The block branch of the JAX ``mlp_apply``, rule for rule.  Sample b
    belongs to group ``b // (B // G)`` (``expand_mask``'s rule).  The
    activation runs on the kernel's f32 output; ``h`` is then cast to
    x.dtype and the down projection keeps the promoted dtype (f32 weights
    give f32 out, unlike the dense path)."""
    B, S, d = x.shape
    G, nb = mask_blocks.shape
    if B % G:
        raise ValueError(f"mlp_apply: batch {B} does not split into {G} "
                         f"groups of mask_blocks")
    block_n = cfg.d_ff // nb
    xg = x.reshape(G, (B // G) * S, d)
    mask_blocks = mask_blocks.to(f32).contiguous()
    # gate uses a {0, 1} mask (masking inside the activation is wrong);
    # the 1/keep scale rides on the up projection
    blocks01 = (mask_blocks > 0).to(f32)

    def product(w, mask):
        dt = torch.promote_types(x.dtype, w.dtype)
        return dropout_matmul(xg.to(dt).contiguous(), w.to(dt).contiguous(),
                              mask, block_n=block_n)

    if cfg.mlp_gated:
        h = act(product(params.wg, blocks01)) * product(params.wi,
                                                        mask_blocks)
    else:
        # act(up * s) != act(up) * s, so mask {0, 1} first, scale after
        mask = torch.repeat_interleave(mask_blocks, block_n, dim=-1)
        h = act(product(params.wi, blocks01)) * mask[:, None, :]
    h = h.to(x.dtype).reshape(B, S, cfg.d_ff)
    return mm("...f,fd->...d", h, params.wo)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        self.embedding = make((cfg.vocab_size, cfg.d_model))
        if not cfg.tie_embeddings:
            self.unembed = make((cfg.d_model, cfg.vocab_size))


def embed_apply(params, tokens, cfg: ModelConfig):
    """Rows of the embedding in ``cfg.dtype`` (bf16 unless the config says
    otherwise, whatever the compute dtype); gemma scales by sqrt(d)."""
    x = params.embedding[tokens].to(dtype_of(cfg.dtype))
    if cfg.post_sublayer_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=f32).to(x.dtype)
    return x


def unembed_apply(params, x, cfg: ModelConfig):
    w = params.unembed if hasattr(params, "unembed") else params.embedding.T
    logits = mm("...d,dv->...v", x, w.to(x.dtype))
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
