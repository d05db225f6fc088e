"""Optimizers: momentum SGD (the paper's optimizer) and AdamW.

Ports of ``repro/optim/sgd.py``, over lists of tensors instead of pytrees.
Unlike the JAX functions, the updates work in place: the parameters (f32
masters) and the moments are overwritten, and the returned ones are the same
tensors.  At full width that saves a second copy of the masters and moments
(about 20 GB for qwen3-1.7b under AdamW, 47 GB for gemma3-4b).  The
arithmetic is the JAX package's, in f32 whatever the gradients' dtype.

``apply``, a 0-dim bool tensor, makes an update conditional on the device:
where it is False every parameter and moment keeps its bits (a select, not
a multiply by 0, which would turn a non-finite update into NaN), with no
host sync.  The train step passes "loss and grad norm are finite", so a
step that the fault-tolerant loop skips leaves the tensors as they were;
where it is True the bits are those of an unconditional update.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

f32 = torch.float32


# ---------------------------------------------------------------------------
# Momentum SGD: paper §3, eta = 0.3, alpha (momentum) = 0.98
# ---------------------------------------------------------------------------
def sgdm_init(params: Sequence[torch.Tensor]) -> Dict:
    return {"mom": [torch.zeros_like(p, dtype=f32) for p in params]}


def _commit(dst: torch.Tensor, new: torch.Tensor, apply) -> None:
    """dst = where(apply, new, dst), in place."""
    torch.where(apply, new.to(dst.dtype), dst, out=dst)


@torch.no_grad()
def sgdm_update(grads, state, params, *, lr, apply, momentum=0.98,
                weight_decay=0.0):
    for g, m, p in zip(grads, state["mom"], params):
        g = g.to(f32)
        if weight_decay:
            g = g + weight_decay * p.to(f32)
        m_new = m.mul(momentum).add_(g)
        p_new = p.to(f32) - lr * m_new
        _commit(m, m_new, apply)
        del m_new
        _commit(p, p_new, apply)
    return params, state


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params: Sequence[torch.Tensor]) -> Dict:
    return {"m": [torch.zeros_like(p, dtype=f32) for p in params],
            "v": [torch.zeros_like(p, dtype=f32) for p in params],
            "t": 0}


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, apply, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.0):
    t = state["t"] + 1
    # the bias corrections in f32, as the JAX package computes them
    one, tf = np.float32(1.0), np.float32(t)
    bc1 = float(one - np.float32(b1) ** tf)
    bc2 = float(one - np.float32(b2) ** tf)
    for g, m, v, p in zip(grads, state["m"], state["v"], params):
        g = g.to(f32)
        m_new = m.mul(b1).add_(g, alpha=1 - b1)
        v_new = v.mul(b2).addcmul_(g, g, value=1 - b2)
        del g
        step = (m_new / bc1) / ((v_new / bc2).sqrt_().add_(eps))
        _commit(m, m_new, apply)
        _commit(v, v_new, apply)
        del m_new, v_new
        if weight_decay:
            step.add_(p.to(f32), alpha=weight_decay)
        _commit(p, p.to(f32) - lr * step, apply)
    state["t"] = t
    return params, state


OPTIMIZERS = {
    "sgdm": (sgdm_init, sgdm_update),
    "adamw": (adamw_init, adamw_update),
}


def make_optimizer(name: str):
    return OPTIMIZERS[name]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (a 0-dim tensor
    on the tensors' device; no host sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(f32)))
                          for x in tensors))


@torch.no_grad()
def clip_by_global_norm(tensors: List[torch.Tensor], max_norm: float):
    """Scale ``tensors`` in place so their global norm is at most
    ``max_norm``; returns (tensors, norm before clipping).  Each is scaled
    in f32 and cast back to its dtype, as the JAX package does."""
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for x in tensors:
        x.copy_(x.to(f32) * scale)
    return tensors, norm
