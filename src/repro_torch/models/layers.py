"""Shared layers: norms, RoPE, the dense gated MLP, embeddings.

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
# Gated MLP (SwiGLU / GeGLU), dense path
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.wi = make((d, ff))
        self.wo = make((ff, d))
        if cfg.mlp_gated:
            self.wg = make((d, ff))


def mlp_apply(params, x, cfg: ModelConfig, *, hidden_mask=None):
    """x: [B, S, d] -> [B, S, d] in x.dtype (the down projection keeps the
    activation dtype, as ``preferred_element_type=x.dtype`` does).

    ``hidden_mask`` ([B, 1, ff]-broadcastable, or None) is Horn's per-group
    structured neuron mask, already scaled by 1/keep; it multiplies the
    hidden units before the down projection."""
    act = ACTS[cfg.act]
    up = mm("...d,df->...f", x, params.wi)
    if cfg.mlp_gated:
        h = act(mm("...d,df->...f", x, params.wg)) * up
    else:
        h = act(up)
    if hidden_mask is not None:
        h = h * hidden_mask.to(h.dtype)
    return mm("...f,fd->...d", h, params.wo, x.dtype)


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
