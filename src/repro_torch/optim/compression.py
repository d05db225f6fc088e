"""Symmetric int8 quantization and gradient compression with error
feedback: the port of ``repro/optim/compression.py``'s ``quantize_int8``,
``dequantize_int8``, ``compress_tree``, ``ef_compress`` and
``ef_compress_tree``.

The paged KV pools use the per-axis variant: int8 pages [P, psize, KH, D]
with one f32 scale per (page, kv head).  The collective trainer's int8
merge compresses each group's gradients with one scale per group and leaf
(``ef_compress_tree(..., groups=True)``, the port of JAX's
``jax.vmap(ef_compress_tree)``).  ``psum_mean_compressed`` is the merge
of such gradients across processes (``core/group_sync.py::merge_grads``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

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


def compress_tree(tree: Dict[str, torch.Tensor]
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """``quantize_int8`` of every leaf of a dict: {name: (q, scale)}."""
    return {k: quantize_int8(v) for k, v in tree.items()}


def ef_compress(grad, residual, axis=None):
    """Error-feedback compress one tensor.

    Returns (q, scale, new_residual): the residual accumulates what int8
    could not represent and is re-added next step (None counts as zeros).
    ``axis`` as in ``quantize_int8``."""
    corrected = grad.to(f32) + (residual if residual is not None else 0.0)
    q, scale = quantize_int8(corrected, axis)
    return q, scale, corrected - dequantize_int8(q, scale)


def ef_compress_tree(grads: Dict[str, torch.Tensor],
                     residuals: Optional[Dict[str, torch.Tensor]], *,
                     groups: bool = False):
    """``ef_compress`` of every leaf: (q, scales, residuals), three dicts
    with the keys of ``grads``.  ``residuals`` None starts from zeros.
    ``groups``: every leaf has a leading group dim [G, ...] and gets one
    scale per group, [G, 1, ...] (JAX's ``jax.vmap(ef_compress_tree)``);
    else one scale per leaf."""
    if residuals is None:
        residuals = {k: torch.zeros(g.shape, dtype=f32, device=g.device)
                     for k, g in grads.items()}
    out = {k: ef_compress(g, residuals[k],
                          tuple(range(1, g.ndim)) if groups else None)
           for k, g in grads.items()}
    return tuple({k: t[i] for k, t in out.items()} for i in range(3))


def psum_mean_compressed(q_tree: Dict[str, torch.Tensor],
                         scale_tree: Dict[str, torch.Tensor], group
                         ) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of ``group`` (a process group, a tuple of
    them or None, as ``group_sync.psum_mean`` takes it) of each rank's
    dequantized gradients: ``q.to(f32) * scale`` all-reduced and divided
    by the rank count, JAX's arithmetic.  Scales differ from rank to rank,
    so the sum runs over the widened f32 values, as the JAX function's
    does: the wire carries f32, and no claim is made about int8 bytes on
    it."""
    from repro_torch.core.group_sync import all_reduce_sum, group_size

    n = float(group_size(group))
    return {k: all_reduce_sum(q.to(f32) * scale_tree[k], group) / n
            for k, q in q_tree.items()}
