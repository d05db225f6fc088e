"""Pure-shape models of the paged-attention launches, for ``hornshape``.

Each function restates one launch of ``csrc/paged_chunk_attention.cu`` or
``csrc/paged_attention.cu`` as a ``LaunchGeometry``: the grid, block,
cluster and dynamic shared memory its host code computes, and for each
block index the elements its body reads and writes after its masks.  The
route and the split count come from the wrapper's own rules
(``kernel.chunk_route``, ``kernel.decode_rows``, ``kernel.decode_splits``),
never from a copy of them.  Slot contents (``starts``, ``chunk_lens``,
``lengths``, ``block_tables``, ``logit_index``) are host integer arrays.

The launch lines mirrored:
  ``paged_chunk_attention.cu:389`` (the CUDA-core kernel, ``launch``),
  ``paged_chunk_attention.cu:824`` (the tensor-core kernel, ``launch_tc``),
  ``paged_attention.cu:575-583`` (the decode kernel, ``launch_rows``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.launch_geometry import (
    DEFAULT_DYNAMIC_SMEM, LaunchGeometry, Operand, TableContract, box,
    cu_constants)
from repro_torch.kernels.paged_attention import kernel as K

CHUNK_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/" \
               "paged_chunk_attention.cu"
DECODE_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/" \
                "paged_attention.cu"
H100_SMS = 132

# the kernels' tiles, threads and stages, read from their sources: the
# CUDA-core chunk kernel (paged_chunk_attention.cu:102-106)
KT, NWARPS, RPW, ROWS, NT = cu_constants(
    K.SOURCE, "KT", "NWARPS", "RPW", "ROWS", "NT")
# the tensor-core chunk kernel (:415-418): query rows and keys of a tile,
# TMA stages, converted bf16 stages (int8)
TQ, TK, TC_STAGES, TC_BSTAGES = cu_constants(
    K.SOURCE, "TQ", "TK", "TC_STAGES", "TC_BSTAGES")
# the decode kernel (paged_attention.cu:84-87)
D_NW, D_MAXG, RING_BUDGET = cu_constants(
    K.SOURCE_DECODE, "NW", "MAXG", "RING_BUDGET")
# static shared memory of paged_chunk_tc_kernel (:507-511): the mbarriers
# full/empty[4], qbar and bfull/bempty[2] (104 B), and on int8 pools the
# scale arrays sk8/sv8[4][8] and skb/svb[2][8] f32 (384 B), in 16-byte
# units.  The compiler drops the arrays a bf16 launch leaves unused, so
# this is a model constant, held against the card's trace (``shared
# memory``) by chip_smoke.py phase 18(a)
TC_STATIC_SMEM = {False: 112, True: 496}


def _itemsize(dtype: torch.dtype, quant: bool) -> int:
    return 1 if quant else torch.tensor([], dtype=dtype).element_size()


def _allowed(smem: int) -> Optional[int]:
    return smem if smem > DEFAULT_DYNAMIC_SMEM else None


def _pool_ops(P, psize, KH, D, quant):
    ops = [Operand("k_pages", (P, psize, KH, D)),
           Operand("v_pages", (P, psize, KH, D))]
    if quant:
        ops += [Operand("k_scale", (P, KH)), Operand("v_scale", (P, KH))]
    return ops


def _page_reads(b, kh, D, psize, lo, hi, table, quant, whole_pages=False,
                pages=None):
    """Boxes of the keys [lo, hi] of slot ``b`` (inclusive; page by page
    through the table), or of whole pages with ``whole_pages``.  ``pages``
    overrides the table columns read."""
    cols = range(lo // psize, hi // psize + 1) if pages is None else pages
    for c in cols:
        yield box("block_tables", b, c)
        if not 0 <= c < table.shape[1]:
            continue
        page = int(table[b, c])
        r0, r1 = (0, psize) if whole_pages else (
            max(lo, c * psize) - c * psize, min(hi + 1, (c + 1) * psize)
            - c * psize)
        for pool in ("k_pages", "v_pages"):
            yield box(pool, page, (r0, r1), kh, (0, D))
        if quant:
            for sc in ("k_scale", "v_scale"):
                yield box(sc, page, kh)


def chunk_live(starts, chunk_lens, psize, window):
    """Each slot's (first visible page, live page count) for a chunk
    launch: token 0 of the chunk (position ``start``) sees keys past
    ``start - window``; the chunk's keys end at ``start + chunk_len``."""
    out = []
    for s, c in zip(starts, chunk_lens):
        s, c = int(s), int(c)
        if c <= 0:
            out.append((0, 0))
            continue
        k_lo = max(0, s - window + 1) if window else 0
        out.append((k_lo // psize, -(-(s + c) // psize)))
    return out


def chunk_geometry(*, B: int, C: int, H: int, KH: int, D: int, psize: int,
                   maxp: int, P: int, dtype: torch.dtype, quant: bool,
                   starts: Sequence[int], chunk_lens: Sequence[int],
                   block_tables: np.ndarray, window: Optional[int] = None,
                   logit_index: Optional[np.ndarray] = None
                   ) -> LaunchGeometry:
    """The launch ``kernel.paged_chunk_attention`` makes for q [B, C, H, D]
    over pools [P, psize, KH, D] (int8 with ``quant``)."""
    call = dict(model="paged.chunk", B=B, C=C, H=H, KH=KH, D=D, psize=psize,
                maxp=maxp, P=P, dtype=dtype, quant=quant, starts=starts,
                chunk_lens=chunk_lens, block_tables=block_tables,
                window=window, logit_index=logit_index)
    G = H // KH
    CG = C * G
    route = K.chunk_route(dtype, quant, D, psize, G)
    tc = route != "cuda_core"
    window = int(window or 0)
    S_w = 0 if logit_index is None else logit_index.shape[1]
    starts = [int(s) for s in starts]
    clens = [int(c) for c in chunk_lens]
    table = np.asarray(block_tables)
    widx = None if logit_index is None else np.asarray(logit_index)
    ops = [Operand("q", (B, C, H, D)), *_pool_ops(P, psize, KH, D, quant),
           Operand("block_tables", (B, maxp)), Operand("starts", (B,)),
           Operand("chunk_lens", (B,)), Operand("out", (B, C, H, D), True)]
    if S_w:
        # positions outside [0, C) give zero rows: written by nobody (the
        # wrapper zero-fills), so only in-range window rows must be written
        need = np.zeros((B, S_w, H, D), bool)
        need[(widx >= 0) & (widx < C)] = True
        ops += [Operand("logit_index", (B, S_w)),
                Operand("out_win", (B, S_w, H, D), True, need)]
    rows = TQ if tc else ROWS

    def touches(blk):
        x, kh, b = blk
        row0 = x * rows
        r_end = min(row0 + rows, CG)
        start, clen = starts[b], clens[b]
        yield box("starts", b)
        yield box("chunk_lens", b)
        t_first = row0 // G
        if t_first < clen:
            t_last = min((r_end - 1) // G, clen - 1)
            k_hi = start + t_last
            k_lo = max(0, start + t_first - window + 1) if window else 0
            if tc:
                # the q tile by TMA, tokens clipped at C; whole pages of the
                # tiles [kb0, k_hi], pages wholly before k_lo skipped
                yield box("q", b, (t_first, min(C, t_first + TQ // G)),
                          (kh * G, kh * G + G), (0, D))
                kb0 = k_lo // TK * TK
                n = (k_hi - kb0) // TK + 1
                pages = [pg for t in range(n) for j in range(TK // psize)
                         for pg in [(kb0 + t * TK) // psize + j]
                         if pg * psize <= k_hi and (pg + 1) * psize > k_lo]
                yield from _page_reads(b, kh, D, psize, k_lo, k_hi, table,
                                       quant, whole_pages=True, pages=pages)
            else:
                for r in range(row0, r_end):
                    if r // G < clen:
                        yield box("q", b, r // G, kh * G + r % G, (0, D))
                yield from _page_reads(b, kh, D, psize, k_lo, k_hi, table,
                                       quant)
        if S_w and row0 < r_end:
            yield box("logit_index", b, (0, S_w))
        for r in range(row0, r_end):
            tok, head = r // G, kh * G + r % G
            yield box("out", b, tok, head, (0, D), write=True)
            for sw in range(S_w):
                if widx[b, sw] == tok:
                    yield box("out_win", b, sw, head, (0, D), write=True)

    if tc:
        bst = TC_BSTAGES if quant else TC_STAGES
        smem = 1024 + TQ * D * 2 + 2 * bst * TK * D * 2 + (
            2 * TC_STAGES * TK * D if quant else 0)
        threads, kname, line = 288 if quant else 160, \
            "paged_chunk_tc_kernel", 824
    else:
        kv = _itemsize(dtype, quant)
        smem = kv * 2 * 2 * KT * (D + 16 // kv) + 4 * ROWS * D
        threads, kname, line = NT, "paged_chunk_attention_kernel", 389
    return LaunchGeometry(
        name=f"{K.NAME}:{route}", kernel=kname,
        source=f"{CHUNK_SOURCE}:{line}",
        grid=(-(-CG // rows), KH, B), block=(threads, 1, 1),
        dynamic_smem=smem, smem_allowed=_allowed(smem), operands=ops,
        touches=touches,
        table=TableContract("block_tables",
                            chunk_live(starts, clens, psize, window)),
        static_smem=TC_STATIC_SMEM[quant] if tc else 0, call=call)


def _decode_smem(itemsize: int, D: int) -> int:
    """``Geo<KV, D>::SMEM`` (paged_attention.cu:128-149)."""
    vec = 16 // itemsize
    cpr = D // vec
    lpk = 4 if cpr % 4 == 0 else 2 if cpr % 2 == 0 else 1
    ts = D_NW * (32 // lpk)
    row = D * itemsize
    rsb = row + ((16 * lpk - row % 128) % 128 + 128) % 128
    stage = 2 * ts * rsb
    nstage = min(4, max(2, RING_BUDGET // stage))
    ring = nstage * stage
    merge = 4 * D_NW * D_MAXG * (D + 2)
    scales = nstage * 2 * (ts + 1)
    return max(ring, merge) + 4 * D_MAXG * D + 4 * scales


def decode_key_range(length: int, window: int, psize: int, split: int,
                     NS: int):
    """``KeyRange`` (paged_attention.cu:262-275): split ``split``'s pages
    [pa, pb) and keys [kb, ke) of a slot of ``length`` keys."""
    k_lo = max(0, length - window) if window > 0 else 0
    p_lo = k_lo // psize
    npg = -(-length // psize) - p_lo if length > 0 else 0
    pa = p_lo + split * npg // NS
    pb = p_lo + (split + 1) * npg // NS
    return pa, pb, max(k_lo, pa * psize), min(length, pb * psize)


def decode_live(lengths, psize, window):
    """Each slot's (first visible page, live page count) for a decode
    launch: the query at ``length - 1`` sees keys past ``length - 1 -
    window``."""
    out = []
    for n in lengths:
        n = int(n)
        k_lo = max(0, n - window) if window else 0
        out.append((k_lo // psize, -(-n // psize)) if n > 0 else (0, 0))
    return out


def decode_geometry(*, B: int, H: int, KH: int, D: int, psize: int,
                    maxp: int, P: int, dtype: torch.dtype, quant: bool,
                    lengths: Sequence[int], block_tables: np.ndarray,
                    window: Optional[int] = None,
                    sm_count: int = H100_SMS) -> LaunchGeometry:
    """The launch ``kernel.paged_attention`` makes for q [B, H, D] over
    pools [P, psize, KH, D] on a card of ``sm_count`` SMs."""
    call = dict(model="paged.decode", B=B, H=H, KH=KH, D=D, psize=psize,
                maxp=maxp, P=P, dtype=dtype, quant=quant, lengths=lengths,
                block_tables=block_tables, window=window, sm_count=sm_count)
    G = H // KH
    R = K.decode_rows(G)
    NS = K.decode_splits(B, KH, G, maxp, sm_count)
    window = int(window or 0)
    lengths = [int(n) for n in lengths]
    table = np.asarray(block_tables)
    ops = [Operand("q", (B, H, D)), *_pool_ops(P, psize, KH, D, quant),
           Operand("block_tables", (B, maxp)), Operand("lengths", (B,)),
           Operand("out", (B, H, D), True)]

    def touches(blk):
        split, y, b = blk
        h0 = y * R
        kh = h0 // G
        yield box("lengths", b)
        yield box("q", b, (h0, h0 + R), (0, D))
        _, _, kb, ke = decode_key_range(lengths[b], window, psize, split, NS)
        if ke > kb:
            yield from _page_reads(b, kh, D, psize, kb, ke - 1, table, quant)
        if NS == 1 or split == 0:      # block 0 merges the cluster's splits
            yield box("out", b, (h0, h0 + R), (0, D), write=True)

    def splits(b):
        return [((s, 0, b),) + decode_key_range(lengths[b], window, psize,
                                                s, NS)[:2]
                for s in range(NS)]

    smem = _decode_smem(_itemsize(dtype, quant), D) + (
        4 * NS * R * (D + 2) if NS > 1 else 0)
    return LaunchGeometry(
        name=f"{K.NAME_DECODE}:{K.decode_route(NS)}",
        kernel="paged_attention_kernel", source=f"{DECODE_SOURCE}:575",
        grid=(NS, H // R, B), block=(128, 1, 1), cluster=(NS, 1, 1),
        dynamic_smem=smem, smem_allowed=_allowed(smem), operands=ops,
        touches=touches,
        table=TableContract("block_tables",
                            decode_live(lengths, psize, window), splits),
        call=call)
