"""Device-dispatched SSD chunk scan.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Both refuse a gradient request: the kernel is forward-only.  While
a cost counter listens, the plain version runs inside the kernel's
boundary (``boundary``).
"""
from __future__ import annotations

import contextlib

from repro_torch import scope
from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import ssd_chunk_scan_ref

__all__ = ["ssd_chunk_scan", "boundary"]


def boundary(x, dt, A, Bm, Cm) -> scope.Boundary:
    """What the card's kernel reads and writes for one call: x, dt, A, Bm
    and Cm in; y [B, S, H, P] and the final state [B, H, P, N], both f32,
    out."""
    B, S, H, P = x.shape
    ins = sum(t.numel() * t.element_size() for t in (x, dt, A, Bm, Cm))
    return scope.Boundary(fwd_bytes=ins + 4 * (B * S * H * P
                                               + B * H * P * Bm.shape[-1]))


def ssd_chunk_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """Mamba2's chunked SSD from a zero state.  x: [B, S, H, P]; dt:
    [B, S, H] f32; A: [H] f32; Bm, Cm: [B, S, N] -> (y [B, S, H, P] f32,
    the [B, H, P, N] f32 final state)."""
    if x.device.type == "cpu":
        with scope.Scope(None, boundary(x, dt, A, Bm, Cm)) \
                if scope.listening() else contextlib.nullcontext():
            return ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type == "cuda":
        return kernel.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
    raise ValueError(f"ssd_chunk_scan: no version for {x.device}")
