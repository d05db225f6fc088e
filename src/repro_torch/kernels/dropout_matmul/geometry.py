"""Pure-shape model of the dropout-matmul launch, for ``hornshape``.

Restates the one launch ``kernel.dropout_matmul`` makes, on each of the
routes ``kernel.route`` picks, as a ``LaunchGeometry``.  The f32 and
mma.sync kernels take one output tile a block (``dropout_matmul.cu:605``,
``:610``).  The wgmma kernel is persistent (``:584``): min(tiles, SMs)
blocks, block k taking the kept tiles k, k + gridDim.x, ... of the mask
walk (``:445``, ``:481``) for its products and the dropped tiles of the
same walk over dropped entries (``:397``) for its zero stores, so the model
needs the mask's values.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.launch_geometry import (
    DEFAULT_DYNAMIC_SMEM, LaunchGeometry, Operand, box, cu_constants)
from repro_torch.kernels.dropout_matmul import kernel as K

SOURCE = "src/repro_torch/kernels/dropout_matmul/csrc/dropout_matmul.cu"
H100_SMS = 132
# the tiles and threads of each route, read from the source: the columns
# of an f32 / mma.sync tile (:60), the f32 kernel (:242), the mma.sync
# kernel (:118), the wgmma kernel (:301-305)
(BN, F_BM, F_THREADS, TC_BM, TC_THREADS, WG_BM, WG_BK, WG_ST,
 WG_THREADS) = cu_constants(K.SOURCE, "BN", "F_BM", "F_THREADS", "TC_BM",
                            "TC_THREADS", "WG_BM", "WG_BK", "WG_ST",
                            "WG_THREADS")
# static __shared__ bytes: the f32 kernel's At[16][65] and Bt[16][64] f32
# (:249), the mma.sync kernel's As[2][128 * 40] and Bs[2][32 * 72] bf16
# (:161), the wgmma kernel's full/empty[6] mbarriers (:413); model
# constants, held against the card's trace by chip_smoke.py phase 18(a)
STATIC_SMEM = {"f32": 8256, "mma_sync": 29696, "wgmma": 96}


def geometry(*, G: int, M: int, K_: int, N: int, dtype: torch.dtype,
             mask_blocks: np.ndarray, block_n: int = 128,
             sm_count: int = H100_SMS) -> LaunchGeometry:
    """The launch for x [G, M, K_], w [K_, N] and mask_blocks [G, N /
    block_n] (its values decide the persistent grid's walk)."""
    call = dict(model="dropout", G=G, M=M, K_=K_, N=N, dtype=dtype,
                mask_blocks=mask_blocks, block_n=block_n, sm_count=sm_count)
    route = K.route(dtype, K_)
    mask = np.asarray(mask_blocks, np.float32)
    nb = N // block_n
    ops = [Operand("x", (G, M, K_)), Operand("w", (K_, N)),
           Operand("mask_blocks", (G, nb)), Operand("y", (G, M, N), True)]

    def tile(g, m0, m1, n0, n1):
        yield box("mask_blocks", g, n0 // block_n)
        if mask[g, n0 // block_n] != 0:      # dropped tiles skip the K loop
            yield box("x", g, (m0, m1), (0, K_))
            yield box("w", (0, K_), (n0, n1))
        yield box("y", g, (m0, m1), (n0, n1), write=True)

    if route != "wgmma":
        bm = F_BM if route == "f32" else TC_BM

        def touches(blk):
            x, y, g = blk
            yield from tile(g, y * bm, min(M, y * bm + bm), x * BN,
                            x * BN + BN)

        return LaunchGeometry(
            name=f"{K.NAME}:{route}",
            kernel=f"dropout_matmul_{'f32' if route == 'f32' else 'bf16'}",
            source=f"{SOURCE}:{605 if route == 'f32' else 610}",
            grid=(N // BN, -(-M // bm), G),
            block=(F_THREADS if route == "f32" else TC_THREADS, 1, 1),
            dynamic_smem=0, operands=ops, touches=touches,
            static_smem=STATIC_SMEM[route], call=call)

    tbn = 128 if block_n % 128 == 0 else 64
    mtiles = -(-M // WG_BM)
    T = mtiles * (block_n // tbn)                 # tiles a mask entry
    flat = mask.reshape(-1)
    kept = [e for e in range(flat.size) if flat[e] != 0]
    dropped = [e for e in range(flat.size) if flat[e] == 0]
    tiles = G * (N // tbn) * mtiles
    grid = max(1, min(tiles, sm_count))

    def tile_at(e, t):                            # :357
        g = e // nb
        n0 = (e % nb) * block_n + (t // mtiles) * tbn
        m0 = (t % mtiles) * WG_BM
        return g, m0, n0

    def touches(blk):
        for entries in (kept, dropped):
            for k in range(blk[0], len(entries) * T, grid):
                g, m0, n0 = tile_at(entries[k // T], k % T)
                yield from tile(g, m0, min(M, m0 + WG_BM), n0, n0 + tbn)

    stage = WG_BM * WG_BK * 2 + WG_BK * tbn * 2
    smem = 1024 + WG_ST * stage + 2 * 64 * tbn * 4 + 64 * 32 * 4
    return LaunchGeometry(
        name=f"{K.NAME}:wgmma", kernel="dropout_matmul_wgmma",
        source=f"{SOURCE}:584", grid=(grid, 1, 1),
        block=(WG_THREADS, 1, 1), dynamic_smem=smem,
        smem_allowed=smem if smem > DEFAULT_DYNAMIC_SMEM else None,
        operands=ops, touches=touches, static_smem=STATIC_SMEM["wgmma"],
        call=call)
