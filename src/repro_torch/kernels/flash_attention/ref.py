"""Plain PyTorch version of the flash attention kernel.

Naive full-score attention with the masking and softcap of the JAX
package's oracle (``repro/kernels/flash_attention/ref.py::attention_ref``):
f32 math, an additive -1e30 mask, output in ``q.dtype``.  It is
differentiable, so torch autograd through it is the backward's reference.
The wrappers in ``ops.py`` run it for CPU tensors; tests and
``chip_smoke.py`` hold the CUDA kernels against it.
"""
from __future__ import annotations

from typing import Optional

import torch

f32 = torch.float32
NEG_INF = -1e30


def attention_ref(q, k, v, *, scale: float, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """q: [B, H, Sq, D]; k, v: [B, KH, Skv, D] (H = KH * G) -> [B, H, Sq, D].

    Key j is visible to query row i when j <= i (causal) and j > i - window
    (window); both count positions from 0 in their own sequence."""
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, Sq, D).to(f32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(f32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    masked = torch.zeros((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        masked = masked | (ki > qi)
    if window is not None:
        masked = masked | (ki <= qi - window)
    s = s + torch.where(masked, NEG_INF, 0.0).to(f32)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(f32))
    return o.reshape(B, H, Sq, D).to(q.dtype)
