"""Device-dispatched SSD chunk scan.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  Both refuse a gradient request: the kernel is forward-only.
"""
from __future__ import annotations

from repro_torch.kernels.ssd import kernel
from repro_torch.kernels.ssd.ref import ssd_chunk_scan_ref

__all__ = ["ssd_chunk_scan"]


def ssd_chunk_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """Mamba2's chunked SSD from a zero state.  x: [B, S, H, P]; dt:
    [B, S, H] f32; A: [H] f32; Bm, Cm: [B, S, N] -> (y [B, S, H, P] f32,
    the [B, H, P, N] f32 final state)."""
    if x.device.type == "cpu":
        return ssd_chunk_scan_ref(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type == "cuda":
        return kernel.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
    raise ValueError(f"ssd_chunk_scan: no version for {x.device}")
