"""Device-dispatched flash attention ([B, H, S, D] layout).

CPU tensors take the plain version, and autograd goes through it; CUDA
tensors go through ``kernel.FlashAttention``, whose forward and backward are
the CUDA kernels, and launch them or raise.  While a cost counter listens,
the plain version runs inside the kernels' boundary (``boundary``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import scope
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "boundary"]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def boundary(q, k, v) -> scope.Boundary:
    """What the card's kernels read and write for one call: the forward q,
    k, v in, the output (q's shape and dtype) out, and the f32 row
    log-sum-exp [B, H, Sq] out when a backward will run; the backward q,
    k, v, the output, its cotangent and the log-sum-exp in, dq, dk and dv
    out."""
    qkv = _nbytes(q) + _nbytes(k) + _nbytes(v)
    out, lse = _nbytes(q), q.shape[0] * q.shape[1] * q.shape[2] * 4
    training = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return scope.Boundary(
        fwd_bytes=qkv + out + (lse if training else 0),
        bwd_bytes=2 * qkv + 2 * out + lse if training else 0)


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """q: [B, H, Sq, D]; k, v: [B, KH, Skv, D] -> [B, H, Sq, D] in q's
    dtype.  Differentiable on both devices."""
    if q.device.type == "cpu":
        with scope.Scope(None, boundary(q, k, v)) if scope.listening() \
                else contextlib.nullcontext():
            return attention_ref(q, k, v, scale=scale, causal=causal,
                                 window=window, softcap=softcap)
    if q.device.type == "cuda":
        return kernel.FlashAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), scale, causal,
            window, softcap)
    raise ValueError(f"flash_attention: no version for {q.device}")
