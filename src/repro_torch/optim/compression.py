"""Symmetric int8 quantization: the port of ``repro/optim/compression.py``'s
``quantize_int8``/``dequantize_int8``.

The paged KV pools use the per-axis variant: int8 pages [P, psize, KH, D]
with one f32 scale per (page, kv head).  The gradient-compression helpers
of the JAX module (``compress_tree``, error feedback) are not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

f32 = torch.float32


def quantize_int8(x, axis: Optional[Sequence[int]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization, JAX's arithmetic step for step.

    ``axis=None``: one scale for the whole tensor, returned as a 0-dim f32
    tensor.  ``axis`` a tuple of axes to reduce over: one scale per
    remaining slice, kept with size-1 dims so ``q * scale`` broadcasts back
    (pools [P, psize, KH, D] with ``axis=(1, 3)`` give [P, 1, KH, 1]).
    The scale is ``amax / 127`` floored at 1e-12; values round half to
    even (``torch.round``, as ``jnp.round``) and clip to +-127.
    Returns (q int8, scale f32)."""
    xf = x.to(f32)
    if axis is None:
        scale = xf.abs().amax()
    else:
        scale = xf.abs().amax(dim=tuple(axis), keepdim=True)
    scale = torch.maximum(scale / 127.0, scale.new_tensor(1e-12))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    """Inverse of ``quantize_int8``: ``scale`` broadcasts against ``q``."""
    return q.to(f32) * scale
