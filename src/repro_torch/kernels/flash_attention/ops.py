"""Device-dispatched flash attention ([B, H, S, D] layout).

CPU tensors take the plain version, and autograd goes through it; CUDA
tensors go through ``kernel.FlashAttention``, whose forward and backward are
the CUDA kernels, and launch them or raise.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """q: [B, H, Sq, D]; k, v: [B, KH, Skv, D] -> [B, H, Sq, D] in q's
    dtype.  Differentiable on both devices."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap)
    if q.device.type == "cuda":
        return kernel.FlashAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), scale, causal,
            window, softcap)
    raise ValueError(f"flash_attention: no version for {q.device}")
