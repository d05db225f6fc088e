"""The CUDA block-sparse dropout matmul: ctypes binding and wrapper.

The kernels are ``csrc/dropout_matmul.cu`` (they replace the TPU kernel
``src/repro/kernels/dropout_matmul/kernel.py:48``).  ``dropout_matmul``
takes CUDA tensors only: it checks them, picks a kernel by ``route``,
allocates the f32 output, launches on the current stream and raises when a
launch is refused.  Like the TPU kernel it is forward-only.  CPU tensors go
to the plain version through ``ops.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dropout_matmul.ref import refuse_grad

NAME = "dropout_matmul"
SOURCE = Path(__file__).resolve().parent / "csrc" / "dropout_matmul.cu"
DTYPES = (torch.float32, torch.bfloat16)
TILE_N = 64                     # output columns of a tile; divides block_n
# the kernels of the source, by the number the C entry point takes
ROUTES = ("f32", "mma_sync", "wgmma")

build.LAUNCHES.setdefault(NAME, 0)

_fn = None


def _entry():
    """The bound C entry point (built from ``SOURCE`` at first use)."""
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).dropout_matmul
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, w, mask_blocks, block_n):
    refuse_grad(NAME, x, w, mask_blocks)
    for tname, t in dict(x=x, w=w, mask_blocks=mask_blocks).items():
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"{NAME}: {tname} is on {t.device}, expected "
                             f"the CUDA device of x ({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {tname} must start on a 16-byte "
                             f"boundary (tiles are copied in 16-byte pieces)")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{NAME}: x is {x.dtype} and w {w.dtype}; the "
                        f"kernel takes float32 or bfloat16, both of one type")
    if mask_blocks.dtype != torch.float32:
        raise TypeError(f"{NAME}: mask_blocks must be float32, got "
                        f"{mask_blocks.dtype}")
    if x.dim() != 3 or w.dim() != 2 or x.shape[2] != w.shape[0]:
        raise ValueError(f"{NAME}: x must be [G, M, K] and w [K, N]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    G, N = x.shape[0], w.shape[1]
    if block_n <= 0 or block_n % TILE_N or N % block_n:
        raise ValueError(f"{NAME}: block_n {block_n} must be a multiple of "
                         f"{TILE_N} that divides N {N}")
    if mask_blocks.shape != (G, N // block_n):
        raise ValueError(f"{NAME}: mask_blocks is "
                         f"{tuple(mask_blocks.shape)}, expected "
                         f"{(G, N // block_n)} (one value per group and "
                         f"block of {block_n} columns)")


def route(dtype: torch.dtype, K: int) -> str:
    """Which kernel takes a product of depth ``K`` in ``dtype``: bf16 goes
    to the wgmma kernel, whose TMA copies need 16-byte row strides in x (K
    a multiple of 8, and K > 0); other bf16 depths to the mma.sync kernel,
    which copies such rows element by element; f32 to the CUDA-core
    kernel.  A pure function of the shape: nothing is tried and retried."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"{NAME}: no kernel for {dtype}")
    return "wgmma" if K > 0 and K % 8 == 0 else "mma_sync"


def dropout_matmul(x, w, mask_blocks, *, block_n: int = 128):
    """Launch the kernel: x [G, M, K], w [K, N] (f32 or bf16, one type),
    mask_blocks [G, N / block_n] f32 -> y [G, M, N] f32.  Same contract as
    ``ref.dropout_matmul_ref``; tiles of dropped blocks never run their K
    loop."""
    _check(x, w, mask_blocks, block_n)
    G, M, K = x.shape
    N = w.shape[1]
    how = route(x.dtype, K)
    y = torch.empty((G, M, N), dtype=torch.float32, device=x.device)
    err = _entry()(x.data_ptr(), w.data_ptr(), mask_blocks.data_ptr(),
                   y.data_ptr(), G, M, K, N, block_n, ROUTES.index(how),
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: kernel launch ({how}) failed with CUDA "
                           f"error {err}")
    build.count_launch(NAME, how)
    return y
