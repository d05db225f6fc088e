"""Mamba2 (SSD: state-space duality) mixer, the port of
``repro/models/ssm.py``.

Training and prefill run the chunked SSD through
``kernels/ssd/ops.ssd_chunk_scan``: the CUDA kernel on a card, the plain
version on the CPU, each returning y and the state after the last chunk
in one pass.  Both are differentiable: on a card the gradient is the
backward kernel's (``kernel.SSDChunkScan``), on the CPU autograd through
the plain version; Horn's ``channel_mask`` and the train step's remat
(``models/transformer.py``) wrap them as they wrap attention.  Decode
steps one token with plain tensor code (``conv_decode_step``,
``ssd_decode_step``), as the JAX package does.  ngroups = 1 (the public mamba2 configs), so B and C are
shared across heads.

The conv tail that prefill leaves in the cache holds the last W - 1 rows
of the *raw* projections ``[xs, Bs, Cs]``, zero-padded on the left when
the prompt is shorter, because ``conv_decode_step`` convolves the tail
with the next raw projection.  The JAX package stores those rows after
``causal_conv``, ``silu`` and the channel mask, so its decode that
continues a prefill diverges from a prefill of the longer sequence
(ROADMAP section 3); with the raw tail the two agree.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd.ops import ssd_chunk_scan
from repro_torch.models.layers import mm
from repro_torch.scope import Scope

f32 = torch.float32


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim P, state N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state


class Mamba(nn.Module):
    """The leaves of ``mamba_specs``: projections ``wz``/``wx`` [d, d_in],
    ``wB``/``wC`` [d, N], ``wdt`` [d, H]; ``dt_bias``, ``A_log`` (A =
    -exp(A_log)), ``D`` [H]; depthwise convs ``conv_x`` [W, d_in] (with
    ``conv_x_bias``), ``conv_B``/``conv_C`` [W, N]; ``gnorm`` [d_in]; the
    out-projection ``wo`` [d_in, d]."""

    AXES = {"wz": ("embed", "ssm_inner"), "wx": ("embed", "ssm_inner"),
            "wB": ("embed", "ssm_state"), "wC": ("embed", "ssm_state"),
            "wdt": ("embed", "ssm_heads"), "dt_bias": ("ssm_heads",),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",),
            "conv_x": ("conv", "ssm_inner"), "conv_x_bias": ("ssm_inner",),
            "conv_B": ("conv", "ssm_state"), "conv_C": ("conv", "ssm_state"),
            "gnorm": ("ssm_inner",), "wo": ("ssm_inner", "embed")}

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        d = cfg.d_model
        d_in, H, _, N = ssm_dims(cfg)
        W = cfg.ssm_conv_width
        self.wz = make((d, d_in))
        self.wx = make((d, d_in))
        self.wB = make((d, N))
        self.wC = make((d, N))
        self.wdt = make((d, H))
        self.dt_bias = make((H,), "zeros")
        self.A_log = make((H,), "ones", 0.5)
        self.D = make((H,), "ones")
        self.conv_x = make((W, d_in), "normal", 0.5)
        self.conv_x_bias = make((d_in,), "zeros")
        self.conv_B = make((W, N), "normal", 0.5)
        self.conv_C = make((W, N), "normal", 0.5)
        self.gnorm = make((d_in,), "zeros")
        self.wo = make((d_in, d))


# ---------------------------------------------------------------------------
# Causal depthwise conv (width W): shift and add
# ---------------------------------------------------------------------------
def causal_conv(x, weight, bias=None):
    """x: [B, S, C]; weight: [W, C] depthwise."""
    W, S = weight.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = sum(pad[:, w:w + S] * weight[w] for w in range(W))
    if bias is not None:
        out = out + bias
    return out


def conv_decode_step(conv_state, x_new, weight, bias=None):
    """conv_state: [B, W-1, C] raw inputs; x_new: [B, C] ->
    (y [B, C], new_state)."""
    dt = torch.promote_types(conv_state.dtype, x_new.dtype)
    full = torch.cat([conv_state.to(dt), x_new[:, None].to(dt)], dim=1)
    y = mm("bwc,wc->bc", full, weight)
    if bias is not None:
        y = y + bias
    return y, full[:, 1:]


# ---------------------------------------------------------------------------
# SSD: the chunked prefill and the one-token step
# ---------------------------------------------------------------------------
def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int):
    """Chunked state-space duality from a zero state.

    x: [B, S, H, P]; dt: [B, S, H] f32 (post-softplus, > 0); A: [H] f32
    (negative); Bm, Cm: [B, S, N] in x's dtype.  Returns (y [B, S, H, P]
    in x.dtype, final_state [B, H, P, N] f32), both from one
    ``ssd_chunk_scan`` call, differentiable in every input.  The JAX
    function also takes an initial state; no caller passes one, and the
    kernel starts from zero."""
    with Scope("ssd_chunk"):
        y, final = ssd_chunk_scan(x.contiguous(), dt.contiguous(),
                                  A.contiguous(), Bm.contiguous(),
                                  Cm.contiguous(), chunk=chunk)
    return y.to(x.dtype), final


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token recurrence.  x: [B, H, P], dt: [B, H], Bm/Cm: [B, N].

    Returns (y [B, H, P] in x.dtype, new_state [B, H, P, N] f32)."""
    xf, dtf = x.to(f32), dt.to(f32)
    dA = torch.exp(dtf * A.to(f32))[..., None, None]             # [B,H,1,1]
    upd = (dtf[..., None, None] * xf[..., None]
           * Bm[:, None, None, :].to(f32))
    new_state = state * dA + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.to(f32))
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# The Mamba2 sublayer
# ---------------------------------------------------------------------------
def _gated_norm(params, y, z, cfg: ModelConfig):
    """RMSNormGated: RMSNorm(y * silu(z)) * (1 + w)."""
    g = (y * F.silu(z)).to(f32)
    var = g.square().mean(-1, keepdim=True)
    out = g * torch.rsqrt(var + cfg.norm_eps) * (1.0 + params.gnorm.to(f32))
    return out.to(y.dtype)


def mamba_apply(params, x, cfg: ModelConfig, *, cache=None,
                channel_mask=None):
    """Mamba2 mixer.

    Prefill: ``cache`` None, x [B, S, d] -> (out, (conv_tail, ssm_state)):
    the raw-projection conv tail [B, W-1, d_in + 2N] in the activation
    dtype and the f32 state after the last token.  Decode: ``cache`` =
    (conv_state [B, W-1, d_in + 2N], ssm_state [B, H, P, N]), x [B, 1, d]
    -> (out, the advanced cache).  ``channel_mask`` ([B, 1, d_in] or None)
    is Horn's per-group mask over d_inner."""
    B, S, _ = x.shape
    d_in, H, P, N = ssm_dims(cfg)

    z = mm("bsd,de->bse", x, params.wz)
    xs = mm("bsd,de->bse", x, params.wx)
    Bs = mm("bsd,dn->bsn", x, params.wB)
    Cs = mm("bsd,dn->bsn", x, params.wC)
    dt = mm("bsd,dh->bsh", x, params.wdt)
    dt = F.softplus(dt.to(f32) + params.dt_bias.to(f32))
    A = -torch.exp(params.A_log.to(f32))

    if cache is None:
        # the raw projections' last W - 1 rows for a later decode, copied
        # out (a view would keep whole [B, S, *] projections alive)
        W1 = cfg.ssm_conv_width - 1
        k = min(S, W1)
        tail = F.pad(torch.cat([t[:, S - k:] for t in (xs, Bs, Cs)], dim=-1),
                     (0, 0, W1 - k, 0))
        xs = F.silu(causal_conv(xs, params.conv_x, params.conv_x_bias))
        Bs = F.silu(causal_conv(Bs, params.conv_B))
        Cs = F.silu(causal_conv(Cs, params.conv_C))
        if channel_mask is not None:
            xs = xs * channel_mask.to(xs.dtype)
        xh = xs.reshape(B, S, H, P)
        y, final = ssd_chunked(xh, dt, A, Bs, Cs, chunk=cfg.ssm_chunk)
        y = y + xh * params.D.to(y.dtype)[:, None]
        new_cache = (tail, final)
    else:
        conv_state, ssm_state = cache
        cx, cB, cC = torch.split(conv_state, [d_in, N, N], dim=-1)
        xs1, cx = conv_decode_step(cx, xs[:, 0], params.conv_x,
                                   params.conv_x_bias)
        Bs1, cB = conv_decode_step(cB, Bs[:, 0], params.conv_B)
        Cs1, cC = conv_decode_step(cC, Cs[:, 0], params.conv_C)
        xs1, Bs1, Cs1 = map(F.silu, (xs1, Bs1, Cs1))
        if channel_mask is not None:
            xs1 = xs1 * channel_mask[:, 0].to(xs1.dtype)
        xh = xs1.reshape(B, H, P)
        y, ssm_state = ssd_decode_step(ssm_state, xh, dt[:, 0], A, Bs1, Cs1)
        y = (y + xh * params.D.to(y.dtype)[:, None])[:, None]
        new_cache = (torch.cat([cx, cB, cC], dim=-1), ssm_state)

    y = _gated_norm(params, y.reshape(B, S, d_in), z, cfg)
    return mm("bse,ed->bsd", y, params.wo), new_cache
