"""The CUDA ``paged_chunk_attention`` kernel: build, ctypes binding, wrapper.

The kernel itself is ``csrc/paged_chunk_attention.cu`` (it replaces the TPU
kernel ``src/repro/kernels/paged_attention/kernel.py:264``).  This wrapper
takes CUDA tensors only: it checks them, allocates the output, launches the
kernel on the current stream and raises when the launch is refused.  CPU
tensors go to the plain version through ``ops.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "paged_chunk_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / f"{NAME}.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

build.LAUNCHES.setdefault(NAME, 0)

_fn = None


def _entry():
    """The bound C entry point (built from ``SOURCE`` at first use)."""
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).paged_chunk_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k_pages, v_pages, block_tables, starts, chunk_lens):
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("starts", starts),
                    ("chunk_lens", chunk_lens)):
        if t.device != q.device or not t.is_cuda:
            raise ValueError(f"{NAME}: {name} is on {t.device}, expected "
                             f"the CUDA device of q ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"{NAME}: q is {q.dtype}; the kernel takes "
                        f"float32 or bfloat16")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"{NAME}: pools are {k_pages.dtype}/{v_pages.dtype}"
                        f", q is {q.dtype}; they must match")
    for name, t in (("block_tables", block_tables), ("starts", starts),
                    ("chunk_lens", chunk_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{NAME}: {name} is {t.dtype}, expected int32")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{NAME}: q must be [B, C, H, D] and both pools "
                         f"[P, psize, KH, D]; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, C, H, D = q.shape
    KH = k_pages.shape[2]
    if k_pages.shape[3] != D or H % KH:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)} (head dim, H % KH)")
    if D % 32 or not 32 <= D <= 256:
        raise ValueError(f"{NAME}: head dim {D} must be a multiple of 32 "
                         f"up to 256")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{NAME}: pools must start on a 16-byte boundary "
                         f"(the kernel copies them in 16-byte pieces)")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or starts.shape != (B,) or chunk_lens.shape != (B,)):
        raise ValueError(f"{NAME}: block_tables must be [B, maxp] and "
                         f"starts/chunk_lens [B] with B = {B}")


def paged_chunk_attention(q, k_pages, v_pages, block_tables, starts,
                          chunk_lens, *, scale: float,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None):
    """Launch the CUDA kernel; same contract as
    ``ref.paged_chunk_attention_ref``.  Every block-table entry of a live
    page (index < ceil((start + chunk_len) / psize)) must be a valid page
    id; entries past it are never read."""
    _check(q, k_pages, v_pages, block_tables, starts, chunk_lens)
    B, C, H, D = q.shape
    psize, KH = k_pages.shape[1], k_pages.shape[2]
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(), chunk_lens.data_ptr(),
        out.data_ptr(), B, C, H, KH, D, psize, block_tables.shape[1],
        float(scale), int(window or 0), float(softcap or 0.0),
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: kernel launch failed with CUDA error "
                           f"{err}")
    build.LAUNCHES[NAME] += 1
    return out
