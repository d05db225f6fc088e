"""Device-dispatched SSD chunk scan.

CPU tensors take the plain version, and autograd goes through it; CUDA
tensors go through ``kernel.SSDChunkScan``, whose forward and backward are
the CUDA kernels, and launch them or raise.  While a cost counter listens,
the plain version runs inside the kernels' boundary (``boundary``).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import scope
from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import ssd_chunk_scan_ref

__all__ = ["ssd_chunk_scan", "boundary"]


def boundary(x, dt, A, Bm, Cm) -> scope.Boundary:
    """What the card's kernels read and write for one call: the forward x,
    dt, A, Bm and Cm in, y [B, S, H, P] and the final state [B, H, P, N],
    both f32, out; when a backward will run, the backward the same five
    inputs and the cotangents of y and of the final state (f32) in, dx,
    ddt, dA, dBm and dCm (each its input's shape and type) out."""
    B, S, H, P = x.shape
    ins = sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm))
    outs = 4 * (B * S * H * P + B * H * P * Bm.shape[-1])
    training = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, A, Bm, Cm))
    return scope.Boundary(fwd_bytes=ins + outs,
                          bwd_bytes=2 * ins + outs if training else 0)


def ssd_chunk_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """Mamba2's chunked SSD from a zero state.  x: [B, S, H, P]; dt:
    [B, S, H] f32; A: [H] f32; Bm, Cm: [B, S, N] -> (y [B, S, H, P] f32,
    the [B, H, P, N] f32 final state).  Differentiable on both devices."""
    if x.device.type == "cpu":
        with scope.Scope(None, boundary(x, dt, A, Bm, Cm)) \
                if scope.listening() else contextlib.nullcontext():
            return ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type == "cuda":
        return kernel.SSDChunkScan.apply(x, dt, A, Bm, Cm, chunk)
    raise ValueError(f"ssd_chunk_scan: no version for {x.device}")
