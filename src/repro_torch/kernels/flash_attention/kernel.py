"""The CUDA flash attention kernels: ctypes binding, wrappers, autograd.

The kernels are ``csrc/flash_attention.cu`` (they replace the TPU kernel
``src/repro/kernels/flash_attention/kernel.py:85`` and add the backward it
lacks): bf16 on the tensor cores (wgmma fed by TMA), f32 on the CUDA
cores, at head dims ``HEAD_DIMS``.  ``flash_attention_fwd`` and ``flash_attention_bwd`` take CUDA
tensors only: they check them, allocate outputs and scratch, launch on the
current stream and raise when a launch is refused.  ``FlashAttention`` is
the ``torch.autograd.Function`` whose forward and backward are the two.
CPU tensors go to the plain version through ``ops.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build

FWD, BWD = "flash_attention_fwd", "flash_attention_bwd"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 96, 128, 256)

build.LAUNCHES.setdefault(FWD, 0)
build.LAUNCHES.setdefault(BWD, 0)

_fns = {}


def _entry(name: str):
    """The bound C entry point ``name`` (built from ``SOURCE`` at first
    use)."""
    if name not in _fns:
        fn = getattr(build.load(SOURCE), name)
        n_ptrs = 5 if name == FWD else 10
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(name, q, k, v, window, **more):
    tensors = dict(q=q, k=k, v=v, **more)
    for tname, t in tensors.items():
        if t.device != q.device or not t.is_cuda:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"the CUDA device of q ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must start on a 16-byte "
                             f"boundary (tiles are copied in 16-byte pieces)")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: q is {q.dtype}; the kernel takes float32 "
                        f"or bfloat16")
    for tname, t in tensors.items():
        if t.dtype != q.dtype and tname != "lse":
            raise TypeError(f"{name}: {tname} is {t.dtype}, q is {q.dtype}; "
                            f"they must match")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q must be [B, H, Sq, D] and k, v "
                         f"[B, KH, Skv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KH:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (batch, head dim, H % KH)")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} must be one of {HEAD_DIMS} "
                         f"(the head dims the kernels are built for)")
    if Sq < 1 or Skv < 1:
        raise ValueError(f"{name}: empty sequence (Sq {Sq}, Skv {Skv})")
    if window is not None and Sq >= Skv + window:
        raise ValueError(f"{name}: with window {window}, query rows past "
                         f"{Skv + window - 1} see no key (Skv {Skv})")


def route(dtype: torch.dtype, D: int) -> str:
    """The kernels a launch runs, for ``build.ROUTE_LAUNCHES``: bf16 on
    the tensor cores (``wgmma``; at D 256 the backward splits D over two
    warpgroups), f32 on the CUDA cores, and the head dim:
    ``"wgmma_d256"``, ``"cuda_core_d128"``..."""
    return f"{'wgmma' if dtype == torch.bfloat16 else 'cuda_core'}_d{D}"


def _common(q, k, scale, causal, window, softcap):
    B, H, Sq, D = q.shape
    return (B, H, k.shape[1], Sq, k.shape[2], D, float(scale), int(causal),
            int(window or 0), float(softcap or 0.0), DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q, k, v, *, scale: float, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """Launch the forward kernel: returns (o [B, H, Sq, D] in q's dtype,
    lse [B, H, Sq] f32).  Same contract as ``ref.attention_ref``."""
    _check(FWD, q, k, v, window)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = _entry(FWD)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), lse.data_ptr(),
                      *_common(q, k, scale, causal, window, softcap))
    if err:
        raise RuntimeError(f"{FWD}: kernel launch failed with CUDA error "
                           f"{err}")
    build.count_launch(FWD, route(q.dtype, q.shape[-1]))
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, dout, *, scale: float,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """Launch the backward kernels: returns (dq, dk, dv) in q's dtype from
    the forward's inputs, its outputs ``o``/``lse`` and the cotangent
    ``dout`` of ``o``."""
    _check(BWD, q, k, v, window, o=o, lse=lse, dout=dout)
    if o.shape != q.shape or dout.shape != q.shape \
            or lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"{BWD}: o and dout must be {tuple(q.shape)} and "
                         f"lse f32 {tuple(q.shape[:3])}")
    di = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = _entry(BWD)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                      di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(),
                      *_common(q, k, scale, causal, window, softcap))
    if err:
        raise RuntimeError(f"{BWD}: kernel launch failed with CUDA error "
                           f"{err}")
    build.count_launch(BWD, route(q.dtype, q.shape[-1]))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the CUDA kernels; saves
    q, k, v, o and the row log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                     window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(scale=scale, causal=causal, window=window,
                        softcap=softcap)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse,
                                         dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None
