"""The kernels' build with and without ``-split-compile``, on one machine.

    PYTHONPATH=src python -m repro_torch.benchmarks.nvcc_build_ab \\
        [--out build_ab.json]

Runs the build of ``chip_smoke.py``'s phase 2 (the five ``csrc/*.cu``
sources, one nvcc each, all started together) four times into fresh
directories, in the order without, with, with, without, and prints each
source's own nvcc wall and library size a run.  Needs nvcc; builds no
library under ``build/``.
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.dropout_matmul import kernel as dkernel
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.paged_attention import kernel as pkernel
from repro_torch.kernels.ssd import kernel as skernel

SPLIT = "-split-compile=0"
ORDER = ("without", "with", "with", "without")


def run():
    sources = [pkernel.SOURCE, pkernel.SOURCE_DECODE, fkernel.SOURCE,
               dkernel.SOURCE, skernel.SOURCE]
    flags, build_dir = build.NVCC_FLAGS, build.BUILD_DIR
    assert SPLIT in flags, flags
    without = tuple(f for f in flags if f != SPLIT)
    rows = []
    try:
        for label in ORDER:
            build.NVCC_FLAGS = without if label == "without" else flags
            build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="nvcc_ab_"))
            build.BUILD_SECONDS.clear()
            try:
                build.build(sources)
                sizes = {p.name: build.library_path(p).stat().st_size
                         for p in sources}
            finally:
                shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
            row = {"split_compile": label, "nvcc_s": dict(build.BUILD_SECONDS),
                   "wall_s": max(build.BUILD_SECONDS.values()),
                   "library_bytes": sizes}
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        build.NVCC_FLAGS, build.BUILD_DIR = flags, build_dir
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows here as JSON")
    args = ap.parse_args(argv)
    rows = run()
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
