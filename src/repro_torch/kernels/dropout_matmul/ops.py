"""Device-dispatched block-sparse dropout matmul.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Both refuse a gradient request: the kernel is forward-only.
"""
from __future__ import annotations

from repro_torch.kernels.dropout_matmul import kernel
from repro_torch.kernels.dropout_matmul.ref import dropout_matmul_ref

__all__ = ["dropout_matmul"]


def dropout_matmul(x, w, mask_blocks, *, block_n: int = 128):
    """y[g] = (x[g] @ w) * expand(mask[g]) in f32; x: [G, M, K]; w: [K, N];
    mask_blocks: [G, N / block_n] in {0, 1/keep}."""
    if x.device.type == "cpu":
        return dropout_matmul_ref(x, w, mask_blocks, block_n=block_n)
    if x.device.type == "cuda":
        return kernel.dropout_matmul(x, w, mask_blocks, block_n=block_n)
    raise ValueError(f"dropout_matmul: no version for {x.device}")
