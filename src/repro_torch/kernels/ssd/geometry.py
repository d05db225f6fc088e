"""Pure-shape model of the SSD chunk-scan launches, for ``hornshape``.

``geometry`` restates the one launch ``kernel.ssd_chunk_scan`` makes, on
the route ``kernel.route`` picks, as a ``LaunchGeometry``: one block a
(head, batch row), grid (H, B), scanning every chunk of its row and
writing its y columns and its final state.  The launch lines mirrored:
``ssd_chunk_scan.cu:353`` (the CUDA-core kernel, whose launcher always
sets the dynamic shared memory attribute) and ``:834`` (the wgmma kernel).

``bwd_geometries`` restates the two launches of
``kernel.ssd_chunk_scan_bwd`` (``ssd_chunk_scan_bwd.cu:614`` and ``:624``):
the walk, one block a (head, batch row), writing its rows of dx and ddt,
its block-start states and its per-head partials of dBm, dCm and dA; then
the reduction, a grid-stride loop over the elements of dBm and dCm, whose
block 0 also writes dA.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.analysis.launch_geometry import (
    DEFAULT_DYNAMIC_SMEM, LaunchGeometry, Operand, box, cu_constants)
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd.ref import chunk_len

SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd_chunk_scan.cu"
# read from the source: the CUDA-core kernel's tiles and threads
# (:104-109); the wgmma kernel's (:371-376): 64-token blocks, P padded to
# 64 columns, two warpgroups and a producer warp, a 3-stage ring, 2
# buffers of T/w x
TQ, PMAX, NMAX, THREADS, LDN, LDT = cu_constants(
    K.SOURCE, "TQ", "PMAX", "NMAX", "THREADS", "LDN", "LDT")
L, PW, NTHREADS, NS, NQ = cu_constants(
    K.SOURCE, "L", "PW", "NTHREADS", "NS", "NQ")
# the backward's (ssd_chunk_scan_bwd.cu:72-86): 64-token blocks, 256
# threads, its shared tiles and vectors, the reduction's threads
BWD_L, BWD_THREADS, RTHREADS, SMEM_FLOATS = cu_constants(
    K.SOURCE_BWD, "L", "THREADS", "RTHREADS", "SMEM_FLOATS")
SOURCE_BWD = "src/repro_torch/kernels/ssd/csrc/ssd_chunk_scan_bwd.cu"
# the wgmma kernel's static __shared__ bytes (:491-494): full/empty[3] and
# tready/tfree[2] mbarriers (80 B) and colv[3][64] float2 (1536 B); a
# model constant, held against the card's trace by chip_smoke.py phase
# 18(a)
WGMMA_STATIC_SMEM = 1616


def geometry(*, B: int, S: int, H: int, P: int, N: int, dtype: torch.dtype,
             chunk: int) -> LaunchGeometry:
    """The launch for x [B, S, H, P], Bm/Cm [B, S, N] at ``chunk``."""
    call = dict(model="ssd", B=B, S=S, H=H, P=P, N=N, dtype=dtype,
                chunk=chunk)
    Q = chunk_len(chunk, S)
    route = K.route(dtype, P, N, Q)
    ops = [Operand("x", (B, S, H, P)), Operand("dt", (B, S, H)),
           Operand("A", (H,)), Operand("Bm", (B, S, N)),
           Operand("Cm", (B, S, N)), Operand("y", (B, S, H, P), True),
           Operand("state", (B, H, P, N), True)]

    def touches(blk):
        h, b, _ = blk
        yield box("x", b, (0, S), h, (0, P))
        yield box("dt", b, (0, S), h)
        yield box("A", h)
        for t in ("Bm", "Cm"):
            yield box(t, b, (0, S), (0, N))
        yield box("y", b, (0, S), h, (0, P), write=True)
        yield box("state", b, h, (0, P), (0, N), write=True)

    if route == "wgmma":
        np_ = 64 if N <= 64 else 128
        stage = 2 * (L * np_ * 2) + L * PW * 2
        smem = 1024 + NS * stage + NQ * 2 * (L * L * 2) + NQ * 2 * (
            L * PW * 2) + 2 * (L * PW * 4)
        return LaunchGeometry(
            name=f"{K.NAME}:wgmma", kernel="ssd_chunk_scan_wgmma_kernel",
            source=f"{SOURCE}:834", grid=(H, B, 1), block=(NTHREADS, 1, 1),
            dynamic_smem=smem,
            smem_allowed=smem if smem > DEFAULT_DYNAMIC_SMEM else None,
            operands=ops, touches=touches, static_smem=WGMMA_STATIC_SMEM,
            call=call)
    smem = 4 * (PMAX * LDN + 2 * TQ * LDN + TQ * PMAX + TQ * LDT + 3 * Q)
    return LaunchGeometry(
        name=f"{K.NAME}:cuda_core", kernel="ssd_chunk_scan_kernel",
        source=f"{SOURCE}:353", grid=(H, B, 1), block=(THREADS, 1, 1),
        dynamic_smem=smem, smem_allowed=smem, operands=ops, touches=touches,
        call=call)


def bwd_geometries(*, B: int, S: int, H: int, P: int, N: int,
                   dtype: torch.dtype) -> List[LaunchGeometry]:
    """The two launches of ``kernel.ssd_chunk_scan_bwd`` for x
    [B, S, H, P], Bm/Cm [B, S, N], in order (none of them depends on the
    forward's chunk)."""
    call = dict(model="ssd.bwd", B=B, S=S, H=H, P=P, N=N, dtype=dtype)
    nblk = -(-S // BWD_L)
    states_written = np.ones((B, H, nblk, P, N), bool)
    states_written[:, :, :1] = False            # block 0 starts from zero
    walk_ops = [
        Operand("x", (B, S, H, P)), Operand("dt", (B, S, H)),
        Operand("A", (H,)), Operand("Bm", (B, S, N)),
        Operand("Cm", (B, S, N)), Operand("dy", (B, S, H, P)),
        Operand("dstate", (B, H, P, N)), Operand("dx", (B, S, H, P), True),
        Operand("ddt", (B, S, H), True),
        Operand("states", (B, H, nblk, P, N), True, states_written),
        Operand("dBp", (B, H, S, N), True), Operand("dCp", (B, H, S, N), True),
        Operand("dAp", (B, H), True)]

    def walk(blk):
        h, b, _ = blk
        for t in ("x", "dy"):
            yield box(t, b, (0, S), h, (0, P))
        yield box("dt", b, (0, S), h)
        yield box("A", h)
        for t in ("Bm", "Cm"):
            yield box(t, b, (0, S), (0, N))
        yield box("dstate", b, h, (0, P), (0, N))
        yield box("states", b, h, (1, nblk), (0, P), (0, N), write=True)
        yield box("states", b, h, (1, nblk), (0, P), (0, N))
        yield box("dx", b, (0, S), h, (0, P), write=True)
        yield box("ddt", b, (0, S), h, write=True)
        for t in ("dBp", "dCp"):
            yield box(t, b, h, (0, S), (0, N), write=True)
        yield box("dAp", b, h, write=True)

    smem = 4 * SMEM_FLOATS
    grid = K.reduce_blocks(B, S, N)
    SN, total = S * N, B * S * N

    def reduce(blk):
        for e0 in range(blk[0] * RTHREADS, total, grid * RTHREADS):
            e1 = min(total, e0 + RTHREADS)
            for b in range(e0 // SN, (e1 - 1) // SN + 1):
                lo, hi = max(e0, b * SN) - b * SN, min(e1, b * SN + SN) - b * SN
                for t in ("dBp", "dCp"):
                    yield box(t, b, (0, H), (lo, hi))
            for t in ("dB", "dC"):
                yield box(t, (e0, e1), write=True)
        if blk[0] == 0:
            yield box("dAp", (0, B), (0, H))
            yield box("dA", (0, H), write=True)

    return [
        LaunchGeometry(
            name=f"{K.NAME_BWD}:{K.ROUTE_BWD}", kernel="ssd_bwd_kernel",
            source=f"{SOURCE_BWD}:614", grid=(H, B, 1),
            block=(BWD_THREADS, 1, 1), dynamic_smem=smem, smem_allowed=smem,
            operands=walk_ops, touches=walk, call=call),
        LaunchGeometry(
            name=f"{K.NAME_BWD}:{K.ROUTE_BWD}:reduce",
            kernel="ssd_bwd_reduce_kernel", source=f"{SOURCE_BWD}:624",
            grid=(grid, 1, 1), block=(RTHREADS, 1, 1), dynamic_smem=0,
            operands=[Operand("dBp", (B, H, SN)), Operand("dCp", (B, H, SN)),
                      Operand("dAp", (B, H)), Operand("dB", (total,), True),
                      Operand("dC", (total,), True),
                      Operand("dA", (H,), True)],
            touches=reduce, call=call)]
