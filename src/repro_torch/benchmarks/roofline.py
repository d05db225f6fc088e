"""Roofline table renderer: reads the dry run's JSON and prints the
§Roofline markdown table of each mesh, plus one-line CSV rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline \\
        [dryrun.json ...]           # default: dryrun_*.json here

The port of ``benchmarks/roofline.py``, line for line.  Its
``fmt_kernel_table`` renders ``BENCH_serving.json``'s ``kernel_bench``
phase, the JAX package's serving benchmark, which the port has no
counterpart of yet (ROADMAP §1 item 7): it is left out.  The port adds
``fmt_bytes_table``: each cell's bytes with kernels counted at their
boundary (``hlo_bytes``, what ``t_memory`` divides) beside the eager
count of every op (``unfused_bytes``), printed after the two tables.
"""
from __future__ import annotations

import glob
import json
import sys


def load_rows(paths=None):
    paths = paths or (glob.glob("dryrun_*.json"))
    rows = []
    seen = set()
    for p in sorted(paths):
        try:
            with open(p) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        for r in (data if isinstance(data, list) else [data]):
            key = (r.get("arch"), r.get("shape"), r.get("mesh"))
            if r.get("status") == "ok" and key not in seen:
                seen.add(key)
                rows.append(r)
    return rows


def fmt_table(rows, mesh="16x16"):
    out = ["| arch | shape | t_compute | t_memory | t_coll | dominant | "
           "model/HLO flops | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3f}s "
            f"| {r['t_memory_s']:.3f}s | {r['t_collective_s']:.3f}s "
            f"| {r['dominant']} | {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def fmt_bytes_table(rows, mesh="16x16"):
    out = ["| arch | shape | hlo_bytes | unfused_bytes | t_memory | "
           "t_memory unfused |", "|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh or "unfused_bytes" not in r:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['hlo_bytes']:.3e} "
            f"| {r['unfused_bytes']:.3e} | {r['t_memory_s']:.3f}s "
            f"| {r['t_memory_unfused_s']:.3f}s |")
    return "\n".join(out)


def run(paths=None):
    rows = load_rows(paths)
    csv = []
    for r in rows:
        if r["mesh"] != "16x16":
            continue
        csv.append((f"roofline_{r['arch']}_{r['shape']}",
                    r["bound_time_s"] * 1e6 if "bound_time_s" in r else
                    max(r["t_compute_s"], r["t_memory_s"],
                        r["t_collective_s"]) * 1e6,
                    f"dominant={r['dominant']} "
                    f"frac={r['roofline_fraction']:.3f}"))
    return csv, {"n_cells": len(rows)}


def main(argv=None) -> None:
    rows = load_rows(sys.argv[1:] if argv is None else argv)
    print(fmt_table(rows))
    print()
    print(fmt_table(rows, mesh="2x16x16"))
    for mesh in ("16x16", "2x16x16"):
        print()
        print(fmt_bytes_table(rows, mesh))


if __name__ == "__main__":
    main()
