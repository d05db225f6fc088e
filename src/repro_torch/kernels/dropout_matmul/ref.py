"""Plain PyTorch version of the block-sparse dropout matmul.

A copy of the JAX package's oracle
(``repro/kernels/dropout_matmul/ref.py::dropout_matmul_ref``):
``y[g] = (x[g] @ w) * expand(mask[g])`` where ``mask[g]`` holds one value
in {0, 1/keep} per contiguous block of ``block_n`` output units, all in
f32.  The wrapper in ``ops.py`` runs it for CPU tensors; tests and
``chip_smoke.py`` hold the CUDA kernel against it.

Like the TPU kernel, the function is forward-only: ``refuse_grad`` raises
when autograd would need its gradient, on either device.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and any input requires a gradient: the
    kernel has no backward (the TPU kernel has none either)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only, like the TPU kernel it ports: no "
            f"backward exists (ROADMAP section 2 item 4).  Call it under "
            f"torch.no_grad(), or train through mlp_apply(hidden_mask=...)")


def dropout_matmul_ref(x, w, mask_blocks, *, block_n: int):
    """x: [G, M, K]; w: [K, N]; mask_blocks: [G, N // block_n] in
    {0, 1/keep}.  Returns [G, M, N] float32."""
    refuse_grad("dropout_matmul", x, w, mask_blocks)
    G, N = x.shape[0], w.shape[1]
    if mask_blocks.shape != (G, N // block_n) or N % block_n:
        raise ValueError(f"dropout_matmul: mask {tuple(mask_blocks.shape)} "
                         f"does not give one value per {block_n} of N {N} "
                         f"for {G} groups")
    y = torch.einsum("gmk,kn->gmn", x.to(f32), w.to(f32))
    mask = torch.repeat_interleave(mask_blocks.to(f32), block_n, dim=-1)
    return y * mask[:, None, :]
