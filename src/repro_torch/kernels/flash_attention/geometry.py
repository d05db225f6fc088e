"""Pure-shape models of the flash-attention launches, for ``hornshape``.

Each function restates the launches of ``csrc/flash_attention.cu`` for one
call of ``kernel.flash_attention_fwd`` (one launch) or
``kernel.flash_attention_bwd`` (three: the row dot, dK/dV, dQ) as
``LaunchGeometry`` objects: grid, block and dynamic shared memory as the
host code computes them, and each block's rows read and written.  The
route is the wrapper's own ``kernel.route``.  The launch lines mirrored:
``flash_attention.cu:1498`` (f32 forward), ``:1510`` (the backward's row
dot), ``:1530`` and ``:1542`` (f32 dK/dV and dQ), ``:1582`` (bf16
forward), ``:1599`` and ``:1607`` (bf16 dK/dV and dQ).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.analysis.launch_geometry import (
    DEFAULT_DYNAMIC_SMEM, LaunchGeometry, Operand, box, cu_constants)
from repro_torch.kernels.flash_attention import kernel as K

SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
# read from the source: the CUDA-core kernels' 64-row tile on 128 threads
# (:104-108); the tensor-core kernels' (:670, :850, :1152): the forward's
# 128 q rows on 256 threads, the backward's 64-row tiles on 128 (256 at D
# 256)
TILE, NT, PS, FBM, FNT, BB, BNT, SNT = cu_constants(
    K.SOURCE, "TILE", "NT", "PS", "FBM", "FNT", "BB", "BNT", "SNT")
# static __shared__ bytes of the tensor-core kernels, in 16-byte units: a
# Ring (four mbarriers, :648) and qbar (forward, dQ: 40 B); dK/dV adds
# kvbar and lse/Di rows: Ls/Ds[2][64] f32 (1064 B), or [64] in the D 256
# split kernel (552 B); model constants, held against the card's trace by
# chip_smoke.py phase 18(a)
STATIC_SMEM = {"fwd_tc": 48, "dkdv_tc": 1072, "dq_tc": 48,
               "dkdv_split": 560, "dq_split": 48}


def _allowed(smem: int) -> Optional[int]:
    return smem if smem > DEFAULT_DYNAMIC_SMEM else None


def _kv_rows(q0, q1, Skv, causal, window):
    """Key rows some query row of [q0, q1) can see: the range a tile loop
    walks (whole tiles, rows clipped at Skv)."""
    lo = max(0, q0 - window + 1) if window else 0
    hi = min(Skv, q1) if causal else Skv
    return lo, max(lo, hi)


def _geometry(name, kernel, line, grid, threads, smem, ops, touches,
              static=0, call=None):
    return LaunchGeometry(
        name=name, kernel=kernel, source=f"{SOURCE}:{line}", grid=grid,
        block=(threads, 1, 1), dynamic_smem=smem, smem_allowed=_allowed(smem),
        operands=ops, touches=touches, static_smem=static, call=call)


def fwd_geometry(*, B: int, H: int, KH: int, Sq: int, Skv: int, D: int,
                 dtype: torch.dtype, causal: bool = True,
                 window: Optional[int] = None) -> LaunchGeometry:
    """The one launch of ``kernel.flash_attention_fwd``."""
    call = dict(model="flash.fwd", B=B, H=H, KH=KH, Sq=Sq, Skv=Skv, D=D,
                dtype=dtype, causal=causal, window=window)
    G = H // KH
    window = int(window or 0)
    route = K.route(dtype, D)
    tc = dtype == torch.bfloat16
    rows = FBM if tc else TILE
    ops = [Operand("q", (B, H, Sq, D)), Operand("k", (B, KH, Skv, D)),
           Operand("v", (B, KH, Skv, D)), Operand("o", (B, H, Sq, D), True),
           Operand("lse", (B, H, Sq), True)]

    def touches(blk):
        x, h, b = blk
        q0, q1 = x * rows, min(Sq, x * rows + rows)
        lo, hi = _kv_rows(q0, q1, Skv, causal, window)
        yield box("q", b, h, (q0, q1), (0, D))
        for t in ("k", "v"):
            yield box(t, b, h // G, (lo, hi), (0, D))
        yield box("o", b, h, (q0, q1), (0, D), write=True)
        yield box("lse", b, h, (q0, q1), write=True)

    if tc:
        keys = 64 if D > 128 else 128
        smem = 1024 + 2 * FBM * D + 4 * 2 * keys * D
        return _geometry(f"{K.FWD}:{route}", "flash_fwd_tc_kernel", 1582,
                         (-(-Sq // FBM), H, B), FNT, smem, ops, touches,
                         STATIC_SMEM["fwd_tc"], call)
    smem = 4 * 2 * TILE * (D + 4) + 4 * (TILE * (D + 1) + TILE * PS)
    return _geometry(f"{K.FWD}:{route}", "flash_fwd_kernel", 1498,
                     (-(-Sq // TILE), H, B), NT, smem, ops, touches,
                     call=call)


def bwd_geometries(*, B: int, H: int, KH: int, Sq: int, Skv: int, D: int,
                   dtype: torch.dtype, causal: bool = True,
                   window: Optional[int] = None) -> List[LaunchGeometry]:
    """The three launches of ``kernel.flash_attention_bwd``, in order."""
    call = dict(model="flash.bwd", B=B, H=H, KH=KH, Sq=Sq, Skv=Skv, D=D,
                dtype=dtype, causal=causal, window=window)
    G = H // KH
    window = int(window or 0)
    route = K.route(dtype, D)
    tc = dtype == torch.bfloat16
    rows = B * H * Sq

    def dot(blk):
        r0 = blk[0] * (NT // 32)
        r1 = min(rows, r0 + NT // 32)
        for t in ("o", "dout"):
            yield box(t, (r0, r1), (0, D))
        yield box("di", (r0, r1), write=True)

    dot_geom = _geometry(
        f"{K.BWD}:{route}:dot", "flash_bwd_dot_kernel", 1510,
        (-(-rows // (NT // 32)), 1, 1), NT, 0,
        [Operand("o", (rows, D)), Operand("dout", (rows, D)),
         Operand("di", (rows,), True)], dot, call=call)

    if tc:
        tl, threads = BB, (SNT if D > 128 else BNT)
        smem = 1024 + 6 * 2 * BB * D + (32 * 128 * 4 if D > 128 else 0)
        kinds = ("dkdv_split", "dq_split") if D > 128 else ("dkdv_tc",
                                                            "dq_tc")
        names = (f"flash_bwd_{kinds[0]}_kernel", f"flash_bwd_{kinds[1]}"
                 f"_kernel")
        lines, statics = (1599, 1607), tuple(STATIC_SMEM[k] for k in kinds)
        smem_kv = smem_q = smem
    else:
        tl, threads = (32 if D > 128 else TILE), NT
        smem_kv = 4 * 4 * tl * (D + 4) + 4 * (2 * tl * (tl + 1) + 2 * tl)
        smem_q = 4 * 4 * tl * (D + 4) + 4 * tl * (tl + 1)
        names = ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
        lines, statics = (1530, 1542), (0, 0)
    base = [Operand("q", (B, H, Sq, D)), Operand("k", (B, KH, Skv, D)),
            Operand("v", (B, KH, Skv, D)), Operand("dout", (B, H, Sq, D)),
            Operand("lse", (B, H, Sq)), Operand("di", (B, H, Sq))]

    def dkdv(blk):
        x, kh, b = blk
        k0, k1 = x * tl, min(Skv, x * tl + tl)
        for t in ("k", "v"):
            yield box(t, b, kh, (k0, k1), (0, D))
        for h in range(kh * G, kh * G + G):
            for t in ("q", "dout"):
                yield box(t, b, h, (0, Sq), (0, D))
            for t in ("lse", "di"):
                yield box(t, b, h, (0, Sq))
        for t in ("dk", "dv"):
            yield box(t, b, kh, (k0, k1), (0, D), write=True)

    def dq(blk):
        x, h, b = blk
        q0, q1 = x * tl, min(Sq, x * tl + tl)
        lo, hi = _kv_rows(q0, q1, Skv, causal, window)
        for t in ("q", "dout"):
            yield box(t, b, h, (q0, q1), (0, D))
        for t in ("lse", "di"):
            yield box(t, b, h, (q0, q1))
        for t in ("k", "v"):
            yield box(t, b, h // G, (lo, hi), (0, D))
        yield box("dq", b, h, (q0, q1), (0, D), write=True)

    return [
        dot_geom,
        _geometry(f"{K.BWD}:{route}:dkdv", names[0], lines[0],
                  (-(-Skv // tl), KH, B), threads, smem_kv,
                  base + [Operand("dk", (B, KH, Skv, D), True),
                          Operand("dv", (B, KH, Skv, D), True)], dkdv,
                  statics[0], call),
        _geometry(f"{K.BWD}:{route}:dq", names[1], lines[1],
                  (-(-Sq // tl), H, B), threads, smem_q,
                  base + [Operand("dq", (B, H, Sq, D), True)], dq,
                  statics[1], call),
    ]
