"""hornshape for the port: prove the launch geometry of the CUDA kernels.

``python -m repro_torch.analysis.hornshape`` builds, for every route of the
five kernels, the ``LaunchGeometry`` of ``kernels/<name>/geometry.py`` at
the cases the reference's hornshape instantiates (its ``_paged_entries``,
``_flash_entries``, ``_dropout_entries`` and ``_ssd_entries``: ragged
tails, GQA, int8 pools, a verify window with ``logit_index``), taken at
shapes the port's wrappers accept (head dims that are multiples of 32,
pages of 8 to 64 tokens, ``block_n`` a multiple of 64), plus windows,
every decode split count 1-8 and flash at head dim 256.  Paged cases run
over several slot contents each (full, ragged and empty slots, dead
block-table entries that point outside the pool), and
``launch_geometry.verify`` enumerates every block of every launch.  Exit 0
when every obligation is proved, 1 with findings (each with a
counterexample block index), 2 when a model cannot be built; ``--json``
prints the results as JSON.

``crosscheck_paged_geometry`` is the runtime twin ``serve.py --sanitize``
runs once at the engine's serving geometry: both paged kernels proved at
it, and the table columns each reads per slot held against the slot's
visible live pages, in both directions (a page never read is a wrong
answer, one read past the live range a fault).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.analysis.launch_geometry import (LaunchGeometry,
                                                  iter_blocks, verify)
from repro_torch.kernels.dropout_matmul import geometry as dgeo
from repro_torch.kernels.flash_attention import geometry as fgeo
from repro_torch.kernels.paged_attention import geometry as pgeo
from repro_torch.kernels.paged_attention import kernel as pkernel

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# --------------------------------------------------------------------------
# slot contents
# --------------------------------------------------------------------------
def paged_table(B: int, maxp: int, P: int, live: Sequence[int],
                seed: int = 0) -> np.ndarray:
    """A [B, maxp] block table: slot b's first ``live[b]`` entries are
    distinct pages of [1, P), the rest point outside the pool (a read of
    one is an LG001 finding)."""
    rng = np.random.default_rng(seed)
    table = np.full((B, maxp), P + 7, np.int32)
    for b, n in enumerate(live):
        table[b, :n] = rng.choice(np.arange(1, P), size=n,
                                  replace=n > P - 1)
    return table


def decode_patterns(B: int, maxp: int, psize: int) -> List[List[int]]:
    """Slot lengths: every slot full, ragged tails (one past a page, one
    short of the end), an empty slot among live ones."""
    full = maxp * psize
    pats = [[full] * B, [(psize + 1 + b * psize) % full or 1
                         for b in range(B)],
            [full - 1 - b for b in range(B)]]
    pats.append([0] + [full // 2 + b for b in range(1, B)])
    return [[min(full, max(0, n)) for n in p] for p in pats]


def chunk_patterns(B: int, C: int, maxp: int, psize: int
                   ) -> List[Tuple[List[int], List[int]]]:
    """(starts, chunk_lens): a first chunk, chunks that end ragged inside
    a page, full chunks at the end of the table, an idle slot."""
    full = maxp * psize
    pats = [([0] * B, [C] * B),
            ([psize - 1 + b for b in range(B)],
             [max(1, C - b) for b in range(B)]),
            ([full - C] * B, [C] * B),
            ([3] + [full - C - b for b in range(1, B)],
             [0] + [C] * (B - 1))]
    return [([max(0, min(s, full - c)) for s, c in zip(st, cl)], cl)
            for st, cl in pats]


def _live_pages(ends: Sequence[int], psize: int) -> List[int]:
    return [-(-int(e) // psize) for e in ends]


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------
def paged_decode_cases(*, B, H, KH, D, psize, maxp, P, dtype, quant,
                       window=None, sm_count=pgeo.H100_SMS
                       ) -> List[LaunchGeometry]:
    out = []
    for i, lengths in enumerate(decode_patterns(B, maxp, psize)):
        table = paged_table(B, maxp, P, _live_pages(lengths, psize), i)
        out.append(pgeo.decode_geometry(
            B=B, H=H, KH=KH, D=D, psize=psize, maxp=maxp, P=P, dtype=dtype,
            quant=quant, lengths=lengths, block_tables=table, window=window,
            sm_count=sm_count))
    return out


def paged_chunk_cases(*, B, C, H, KH, D, psize, maxp, P, dtype, quant,
                      window=None, S_w=0) -> List[LaunchGeometry]:
    out = []
    for i, (starts, clens) in enumerate(chunk_patterns(B, C, maxp, psize)):
        ends = [s + c for s, c in zip(starts, clens)]
        table = paged_table(B, maxp, P, _live_pages(ends, psize), i)
        widx = None
        if S_w:
            # window positions: the chunk's last rows, one outside [0, C)
            widx = np.array([[max(0, c - S_w + j) for j in range(S_w)]
                             for c in clens], np.int32)
            widx[0, 0] = C + 2
        out.append(pgeo.chunk_geometry(
            B=B, C=C, H=H, KH=KH, D=D, psize=psize, maxp=maxp, P=P,
            dtype=dtype, quant=quant, starts=starts, chunk_lens=clens,
            block_tables=table, window=window, logit_index=widx))
    return out


def _splits_cases() -> List[Tuple[str, Callable]]:
    """Decode at every split count 1-8: the card size varies, the rule
    (``kernel.decode_splits``) picks NS."""
    out = []
    for ns in range(1, 9):
        # B 2 x KH 2 x one row group: 4 units; NS = ceil(2 sms / 4)
        sms = 2 * ns - 1 if ns > 1 else 1
        want = pkernel.decode_splits(2, 2, 2, 8, sms)
        assert want == ns, (ns, sms, want)
        out.append((f"decode/ns{ns}", lambda sms=sms: paged_decode_cases(
            B=2, H=4, KH=2, D=32, psize=8, maxp=8, P=40,
            dtype=torch.bfloat16, quant=False, sm_count=sms)))
    return out


def registry() -> List[Tuple[str, Callable[[], List[LaunchGeometry]]]]:
    """(label, build) of every case: the reference's, at port shapes."""
    bf, f32 = torch.bfloat16, torch.float32
    paged = dict(H=4, KH=2, D=32, psize=8, P=24)
    cases = []
    for dt in (f32, bf):
        n = "f32" if dt is f32 else "bf16"
        cases += [
            # decode/pps2-ragged, decode/pps1, decode/int8 (maxp 5 and 3)
            (f"decode/ragged-{n}", lambda dt=dt: paged_decode_cases(
                B=2, maxp=5, dtype=dt, quant=False, **paged)),
            (f"decode/short-table-{n}", lambda dt=dt: paged_decode_cases(
                B=2, maxp=3, dtype=dt, quant=False, **paged)),
            (f"decode/int8-{n}", lambda dt=dt: paged_decode_cases(
                B=2, maxp=5, dtype=dt, quant=True, **paged)),
            (f"decode/window-{n}", lambda dt=dt: paged_decode_cases(
                B=3, maxp=5, dtype=dt, quant=False, window=11, **paged)),
            (f"decode/mqa-{n}", lambda dt=dt: paged_decode_cases(
                B=2, H=16, KH=1, D=64, psize=16, maxp=4, P=12, dtype=dt,
                quant=False)),
            # chunk/pps2-ragged, chunk/verify-window
            (f"chunk/ragged-{n}", lambda dt=dt: paged_chunk_cases(
                B=2, C=3, maxp=5, dtype=dt, quant=False, **paged)),
            (f"chunk/verify-window-{n}", lambda dt=dt: paged_chunk_cases(
                B=2, C=4, maxp=7, dtype=dt, quant=False, S_w=2,
                **dict(paged, P=30))),
            (f"chunk/int8-{n}", lambda dt=dt: paged_chunk_cases(
                B=2, C=5, maxp=5, dtype=dt, quant=True, S_w=2, **paged)),
            (f"chunk/window-{n}", lambda dt=dt: paged_chunk_cases(
                B=2, C=70, maxp=12, dtype=dt, quant=False, window=9,
                **dict(paged, P=40))),
            (f"chunk/window-int8-{n}", lambda dt=dt: paged_chunk_cases(
                B=2, C=70, maxp=12, dtype=dt, quant=True, window=20,
                **dict(paged, psize=16, P=40))),
            (f"chunk/wide-psize-{n}", lambda dt=dt: paged_chunk_cases(
                B=2, C=40, H=8, KH=2, D=64, psize=64, maxp=3, P=10,
                dtype=dt, quant=False)),
            # flash/causal-gqa, flash/window-ragged-blocks, and D 256
            (f"flash/causal-gqa-{n}", lambda dt=dt: flash_cases(
                B=2, H=4, KH=2, Sq=24, Skv=40, D=32, dtype=dt)),
            (f"flash/window-ragged-{n}", lambda dt=dt: flash_cases(
                B=2, H=2, KH=2, Sq=24, Skv=40, D=32, dtype=dt,
                causal=False, window=8)),
            (f"flash/long-{n}", lambda dt=dt: flash_cases(
                B=1, H=4, KH=1, Sq=200, Skv=200, D=64, dtype=dt)),
            (f"flash/d256-{n}", lambda dt=dt: flash_cases(
                B=1, H=2, KH=1, Sq=80, Skv=80, D=256, dtype=dt)),
        ]
    # dropout/4d-grid at block_n 64 and 128, a ragged K (mma.sync), f32
    rng = np.random.default_rng(0)
    for G, M, K_, N, bn, dt in ((3, 16, 32, 128, 64, bf),
                                (3, 300, 32, 512, 128, bf),
                                (2, 40, 13, 256, 128, bf),
                                (3, 70, 32, 128, 64, f32)):
        mask = (rng.random((G, N // bn)) < 0.5).astype(np.float32) * 2.0
        cases.append((f"dropout/G{G}-M{M}-K{K_}-N{N}-bn{bn}-"
                      f"{'bf16' if dt is bf else 'f32'}",
                      lambda G=G, M=M, K_=K_, N=N, bn=bn, dt=dt, mask=mask: [
                          dgeo.geometry(G=G, M=M, K_=K_, N=N, dtype=dt,
                                        mask_blocks=mask, block_n=bn),
                          dgeo.geometry(G=G, M=M, K_=K_, N=N, dtype=dt,
                                        mask_blocks=mask, block_n=bn,
                                        sm_count=2)]))
    # ssd/chunked, ssd/chunk-shrunk, and the wgmma route
    from repro_torch.kernels.ssd import geometry as sgeo
    for B, S, H, P, N, chunk, dt in ((2, 24, 3, 4, 8, 8, f32),
                                     (2, 24, 3, 4, 8, 7, f32),
                                     (2, 128, 3, 16, 16, 64, bf),
                                     (1, 256, 2, 64, 128, 128, bf)):
        cases.append((f"ssd/S{S}-chunk{chunk}-P{P}-N{N}",
                      lambda B=B, S=S, H=H, P=P, N=N, chunk=chunk, dt=dt: [
                          sgeo.geometry(B=B, S=S, H=H, P=P, N=N, dtype=dt,
                                        chunk=chunk)]))
    return cases + _splits_cases()


def flash_cases(*, B, H, KH, Sq, Skv, D, dtype, causal=True, window=None):
    kw = dict(B=B, H=H, KH=KH, Sq=Sq, Skv=Skv, D=D, dtype=dtype,
              causal=causal, window=window)
    return [fgeo.fwd_geometry(**kw), *fgeo.bwd_geometries(**kw)]


# --------------------------------------------------------------------------
# the runtime twin
# --------------------------------------------------------------------------
def table_columns_read(geom: LaunchGeometry) -> Dict[int, Set[int]]:
    """Slot -> the block-table columns some block of ``geom`` reads."""
    out: Dict[int, Set[int]] = {}
    name = geom.table.table
    for blk in iter_blocks(geom.grid):
        for bx in geom.touches(blk):
            if bx.operand == name:
                out.setdefault(bx.lo[0], set()).update(
                    range(bx.lo[1], bx.hi[1]))
    return out


def crosscheck_paged_geometry(*, batch: int, kv_heads: int, head_dim: int,
                              page_size: int, num_pages: int,
                              max_pages: int, quantized: bool = False,
                              num_heads: Optional[int] = None,
                              dtype: str = "bfloat16",
                              window: Optional[int] = None,
                              sm_count: int = pgeo.H100_SMS) -> List[str]:
    """Prove both paged kernels at a serving geometry (every slot-content
    pattern) and check that the table columns each reads per slot are
    exactly the slot's visible live pages.  Returns alert strings (empty
    == proved and consistent) for ``serve.py --sanitize``."""
    H = num_heads or kv_heads * 2
    dt = DTYPES[dtype]
    kw = dict(B=batch, H=H, KH=kv_heads, D=head_dim, psize=page_size,
              maxp=max_pages, P=num_pages, dtype=dt, quant=quantized,
              window=window)
    alerts = []
    try:
        geoms = paged_decode_cases(sm_count=sm_count, **kw)
        C = min(8, max_pages * page_size)
        geoms += paged_chunk_cases(C=C, **kw)
        geoms += paged_chunk_cases(C=1, **kw)
    except (ValueError, ZeroDivisionError) as e:
        return [f"hornshape: cannot model the serving geometry: {e}"]
    for geom in geoms:
        rep = verify(geom)
        alerts += [f"hornshape: {f.rule} {f.render()}" for f in rep.findings]
        cols = table_columns_read(geom)
        for b, (first, live) in enumerate(geom.table.live):
            want = set(range(first, live))
            got = cols.get(b, set())
            if got != want:
                alerts.append(
                    f"hornshape-divergence: {geom.name} reads table columns "
                    f"{sorted(got)} of slot {b}, its visible live pages are "
                    f"{sorted(want)}")
    return alerts


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hornshape",
        description="launch-geometry proofs for the port's CUDA kernels")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)
    try:
        results = [(label, verify(geom)) for label, build in registry()
                   for geom in build()]
    except Exception as e:          # a model that cannot be built
        print(f"hornshape: error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    n_findings = sum(len(r.findings) for _, r in results)
    if args.as_json:
        print(json.dumps({
            "results": [
                {"case": label, "geometry": r.geometry.name,
                 "grid": list(r.geometry.grid),
                 "block": list(r.geometry.block),
                 "cluster": list(r.geometry.cluster),
                 "dynamic_smem": r.geometry.dynamic_smem,
                 "obligations": r.obligations, "blocks": r.blocks_checked,
                 "findings": [{"rule": f.rule, "source": f.source,
                               "block": f.block, "message": f.message}
                              for f in r.findings]}
                for label, r in results],
            "ok": n_findings == 0}, indent=2))
    else:
        for label, rep in results:
            print(f"[{label}] " + "\n".join(rep.render()))
        total = sum(r.obligations for _, r in results)
        blocks = sum(r.blocks_checked for _, r in results)
        print(f"hornshape: {len(results)} launches, {total} obligations "
              f"over {blocks} blocks, {n_findings} findings")
    return 1 if n_findings else 0


if __name__ == "__main__":
    sys.exit(main())
