"""Pure-shape model of the SSD chunk-scan launches, for ``hornshape``.

``geometry`` restates the one launch ``kernel.ssd_chunk_scan`` makes, on
the route ``kernel.route`` picks, as a ``LaunchGeometry``: one block a
(head, batch row), grid (H, B), scanning every chunk of its row and
writing its y columns and its final state.  The launch lines mirrored:
``ssd_chunk_scan.cu:353`` (the CUDA-core kernel, whose launcher always
sets the dynamic shared memory attribute) and ``:834`` (the wgmma kernel).

``bwd_geometries`` restates the launches of ``kernel.ssd_chunk_scan_bwd``
on the route ``kernel.route_bwd`` picks.  cuda_core (two launches): the
walk, one block a (head, batch row), writing its rows of dx and ddt, its
block-start states and its per-head partials of dBm, dCm and dA; then the
reduction, a grid-stride loop over the elements of dBm and dCm, whose
block 0 also writes dA.  wgmma (three launches): sweep F and sweep R, one
block a (head, batch row) in clusters of ``kernel.cluster_bwd(H)`` heads,
256 threads; their TMA boxes (64 tokens of C, B and x a block, clipped to
the tensors: TMA fills the rest with zeros) and what they write: F the
kept states, carrE, delta and its rank's rows of each block's dCm partial,
R dx (a TMA store of 64 tokens, clipped), ddt, dA's partial and its rank's
rows of dBm's partial; then the reduction over H / cluster partials.  The
launch lines are found in the source by their text.
"""
from __future__ import annotations

from pathlib import Path
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
# the backward's CUDA-core kernel: 64-token blocks, 256 threads, its shared
# tiles and vectors, the reduction's threads; the wgmma route's threads,
# ring stages, kept-state stride and [64][64] bf16 tile bytes
BWD_L, BWD_THREADS, RTHREADS, SMEM_FLOATS = cu_constants(
    K.SOURCE_BWD, "L", "THREADS", "RTHREADS", "SMEM_FLOATS")
TC_THREADS, TC_NS, TC_TILE = cu_constants(
    K.SOURCE_BWD, "NTHREADS", "NS", "TILE")
SOURCE_BWD = "src/repro_torch/kernels/ssd/csrc/ssd_chunk_scan_bwd.cu"
# the wgmma route's static __shared__ bytes (its ``Shared`` struct: 10
# mbarriers, the per-token (cum, dt, exp(cum), exp(cum_L - cum)) of NS
# stages and the warps' partial sums); a model constant, held against the
# card's trace by phase 18(a)
TC_STATIC_SMEM = 7280


def _launch_line(text: str) -> str:
    """``SOURCE_BWD:line`` of the first line of the backward's source that
    holds ``text``."""
    for i, line in enumerate(Path(K.SOURCE_BWD).read_text().splitlines(),
                             1):
        if text in line:
            return f"{SOURCE_BWD}:{i}"
    raise KeyError(f"{SOURCE_BWD} has no line with {text!r}")


def tc_smem(N: int) -> dict:
    """Dynamic shared memory of the wgmma route's sweeps (``Geo<NP>``): a
    1024-byte alignment slack, NS stages of C, B [64][NP] and x [64][64]
    bf16, and per sweep F: s_hi twice, w x in three terms, the exchange
    tile [64][NP + 8] f32; R: dy in two terms, E in three, M in two, G_hi
    twice, the exchange tile and the dx staging tile."""
    NP = 64 if N <= 64 else 128
    st, xch = 64 * NP * 2, 64 * (NP + 8) * 4
    stage = 2 * 64 * NP * 2 + TC_TILE
    ring = 1024 + TC_NS * stage
    return {"fwd": ring + 2 * st + 3 * TC_TILE + xch,
            "rev": ring + 7 * TC_TILE + 2 * st + xch + TC_TILE}
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
    """The launches of ``kernel.ssd_chunk_scan_bwd`` for x [B, S, H, P],
    Bm/Cm [B, S, N], in order (none of them depends on the forward's
    chunk)."""
    call = dict(model="ssd.bwd", B=B, S=S, H=H, P=P, N=N, dtype=dtype)
    how = K.route_bwd(dtype, P, N)
    if how == "wgmma":
        return _tc_geometries(B, S, H, P, N, call)
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
    return [
        LaunchGeometry(
            name=f"{K.NAME_BWD}:cuda_core", kernel="ssd_bwd_kernel",
            source=_launch_line("ssd_bwd_kernel<T><<<"), grid=(H, B, 1),
            block=(BWD_THREADS, 1, 1), dynamic_smem=smem, smem_allowed=smem,
            operands=walk_ops, touches=walk, call=call),
        _reduce_geometry(B, S, H, H, N, "cuda_core", call)]


def _reduce_geometry(B, S, HP, H, N, how, call) -> LaunchGeometry:
    """The head reduction: HP partials of each batch row summed into dBm
    and dCm by a grid-stride loop, dA's B partials by block 0."""
    grid = K.reduce_blocks(B, S, N)
    SN, total = S * N, B * S * N

    def reduce(blk):
        for e0 in range(blk[0] * RTHREADS, total, grid * RTHREADS):
            e1 = min(total, e0 + RTHREADS)
            for b in range(e0 // SN, (e1 - 1) // SN + 1):
                lo, hi = max(e0, b * SN) - b * SN, min(e1, b * SN + SN) - b * SN
                for t in ("dBp", "dCp"):
                    yield box(t, b, (0, HP), (lo, hi))
            for t in ("dB", "dC"):
                yield box(t, (e0, e1), write=True)
        if blk[0] == 0:
            yield box("dAp", (0, B), (0, H))
            yield box("dA", (0, H), write=True)

    return LaunchGeometry(
        name=f"{K.NAME_BWD}:{how}:reduce", kernel="ssd_bwd_reduce_kernel",
        source=_launch_line(
            "ssd_bwd_reduce_kernel<T><<<" if how == "cuda_core"
            else "ssd_bwd_reduce_kernel<__nv_bfloat16><<<"),
        grid=(grid, 1, 1), block=(RTHREADS, 1, 1), dynamic_smem=0,
        operands=[Operand("dBp", (B, HP, SN)), Operand("dCp", (B, HP, SN)),
                  Operand("dAp", (B, H)), Operand("dB", (total,), True),
                  Operand("dC", (total,), True), Operand("dA", (H,), True)],
        touches=reduce, call=call)


def _tc_geometries(B, S, H, P, N, call) -> List[LaunchGeometry]:
    """The wgmma route's sweeps F and R and its reduction."""
    CL = K.cluster_bwd(H)
    HC, R = H // CL, BWD_L // CL
    nblk = -(-S // BWD_L)
    NP = 64 if N <= 64 else 128
    sc = K.bwd_scratch(B, S, H, P, N, "wgmma")
    nck = sc["states"][2]
    smem = tc_smem(N)
    ins = [Operand("x", (B, S, H, P)), Operand("dt", (B, S, H)),
           Operand("A", (H,)), Operand("Bm", (B, S, N)),
           Operand("Cm", (B, S, N)), Operand("dy", (B, S, H, P)),
           Operand("dstate", (B, H, P, N))]

    def blocks(b, h):
        """Per 64-token block: the TMA boxes read, clipped to the tensors,
        and the rows of the head sum's partial this rank writes."""
        for k in range(nblk):
            t0, t1 = k * BWD_L, min(S, k * BWD_L + BWD_L)
            yield box("x", b, (t0, t1), h, (0, P))
            yield box("dy", b, (t0, t1), h, (0, P))
            yield box("dt", b, (t0, t1), h)
            for c0 in range(0, NP, 64):
                for t in ("Bm", "Cm"):
                    yield box(t, b, (t0, t1), (c0, min(N, c0 + 64)))
            r0 = t0 + (h % CL) * R
            yield (b, h // CL, r0, min(t1, r0 + R))

    def fwd(blk):
        h, b, _ = blk
        yield box("A", h)
        yield box("dstate", b, h, (0, P), (0, N))
        for bx in blocks(b, h):
            if isinstance(bx, tuple):
                if bx[2] < bx[3]:
                    yield box("dCp", bx[0], bx[1], (bx[2], bx[3]), (0, N),
                              write=True)
            else:
                yield bx
        if nck:
            yield box("states", b, h, (0, nck), (0, 64 * NP), write=True)
        yield box("carrE", b, h, (0, S), write=True)
        yield box("delta", b, h, write=True)

    def rev(blk):
        h, b, _ = blk
        yield box("A", h)
        yield box("dstate", b, h, (0, P), (0, N))
        if nck:
            yield box("states", b, h, (0, nck), (0, 64 * NP))
        yield box("carrE", b, h, (0, S))
        yield box("delta", b, h)
        for bx in blocks(b, h):
            if isinstance(bx, tuple):
                if bx[2] < bx[3]:
                    yield box("dBp", bx[0], bx[1], (bx[2], bx[3]), (0, N),
                              write=True)
            else:
                yield bx
        yield box("dx", b, (0, S), h, (0, P), write=True)
        yield box("ddt", b, (0, S), h, write=True)
        yield box("dAp", b, h, write=True)

    states = Operand("states", sc["states"])
    common = dict(grid=(H, B, 1), block=(TC_THREADS, 1, 1),
                  cluster=(CL, 1, 1), static_smem=TC_STATIC_SMEM, call=call)
    return [
        LaunchGeometry(
            name=f"{K.NAME_BWD}:wgmma:fwd", kernel="ssd_bwd_fwd_kernel",
            source=_launch_line("ssd_bwd_fwd_kernel<NP>, Geo<NP>::F_BYTES"),
            dynamic_smem=smem["fwd"], smem_allowed=smem["fwd"],
            operands=ins + [
                Operand("states", sc["states"], True),
                Operand("carrE", sc["carrE"], True),
                Operand("delta", sc["delta"], True),
                Operand("dCp", sc["dCp"], True)],
            touches=fwd, **common),
        LaunchGeometry(
            name=f"{K.NAME_BWD}:wgmma", kernel="ssd_bwd_rev_kernel",
            source=_launch_line("ssd_bwd_rev_kernel<NP>, Geo<NP>::R_BYTES"),
            dynamic_smem=smem["rev"], smem_allowed=smem["rev"],
            operands=ins + [
                states, Operand("carrE", sc["carrE"]),
                Operand("delta", sc["delta"]),
                Operand("dx", (B, S, H, P), True),
                Operand("ddt", (B, S, H), True),
                Operand("dBp", sc["dBp"], True),
                Operand("dAp", sc["dAp"], True)],
            touches=rev, **common),
        _reduce_geometry(B, S, HC, H, N, "wgmma", call)]
