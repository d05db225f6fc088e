"""The SSD backward's wgmma rounding, emulated on the CPU at a given shape.

Draws the inputs as ``chip_smoke.py``'s SSD phases do (x, Bm, Cm normal
x 0.5 in bf16, dt = |normal| + 0.1, A = -(|normal| + 0.5), dy normal f32,
dstate normal or none) from a numpy seed, runs
``ref.ssd_chunk_scan_bwd_split_ref`` (the route's rounding) and
``ref.ssd_chunk_scan_bwd_ref`` (the plain f32 backward) and prints, per
gradient, max |split - plain| / max |plain| beside the card's tolerance
(1e-4 for the f32 ddt and dA, 1e-2 for dx, dBm, dCm in bf16).  ``--terms
NAME=n`` overrides ``ref.BWD_TERMS`` (e.g. ``G_gb=2``).

    PYTHONPATH=src python -m repro_torch.benchmarks.ssd_bwd_split_errors \\
        --shape 4 2048 80 64 128
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.kernels.ssd import ref

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
NAMES = ("dx", "ddt", "dA", "dBm", "dCm")


def inputs(B, S, H, P, N, seed, dstate):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))

    bf = torch.bfloat16
    x = (normal(B, S, H, P) * 0.5).to(bf)
    dt = normal(B, S, H).abs() + 0.1
    A = -(normal(H).abs() + 0.5)
    Bm, Cm = ((normal(B, S, N) * 0.5).to(bf) for _ in range(2))
    dy = normal(B, S, H, P)
    ds = normal(B, H, P, N) if dstate else None
    return x, dt, A, Bm, Cm, dy, ds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=5, default=[4, 2048, 80, 64,
                                                           128],
                    metavar=("B", "S", "H", "P", "N"))
    ap.add_argument("--seed", type=int, default=22)
    ap.add_argument("--dstate", action="store_true",
                    help="a normal cotangent of the final state (training "
                         "has none)")
    ap.add_argument("--terms", nargs="*", default=[], metavar="NAME=n")
    a = ap.parse_args(argv)
    terms = {k: int(v) for k, v in (t.split("=") for t in a.terms)}
    args = inputs(*a.shape, a.seed, a.dstate)
    t0 = time.perf_counter()
    want = ref.ssd_chunk_scan_bwd_ref(*args)
    with torch.no_grad():
        got = ref.ssd_chunk_scan_bwd_split_ref(*args, terms=terms)
    print(f"shape (B, S, H, P, N) {tuple(a.shape)}, seed {a.seed}, dstate "
          f"{'normal' if a.dstate else 'none'}, terms "
          f"{dict(ref.BWD_TERMS, **terms)}; {time.perf_counter() - t0:.1f} "
          f"s on the CPU")
    for name, g, w in zip(NAMES, got, want):
        w = w.to(g.dtype).float()
        rel = ((g.float() - w).abs().max() / w.abs().max()).item()
        print(f"  {name:4s} ({str(g.dtype).split('.')[-1]}): max |split - "
              f"plain| / max |plain| = {rel:.3g}  (tolerance "
              f"{TOL[g.dtype]:g}: {rel / TOL[g.dtype]:.2f} of it)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
