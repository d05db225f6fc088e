"""Render FINAL_TABLE.md: baseline vs final roofline terms per cell, both
meshes, from the dry run's JSON.

    PYTHONPATH=src python -m repro_torch.benchmarks.final_table \\
        [--base dryrun_single_pod.json ...] [--final dryrun_final.json] \\
        [--out FINAL_TABLE.md]

The port of ``benchmarks/final_table.py``.  Its defaults read the
reference's file names (the baseline ``dryrun_single_pod.json``,
``dryrun_multi_pod.json`` and ``dryrun_long500k_*.json``, the final
``dryrun_final.json``); ``decode_mem_frac`` reads the port's configs and
the H100's ``HBM_BW``.
"""
from __future__ import annotations

import argparse
import glob
import json
import statistics


def load(paths):
    rows = {}
    for p in paths:
        try:
            with open(p) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        for r in (data if isinstance(data, list) else [data]):
            if r.get("status") == "ok":
                rows[(r["arch"], r["shape"], r["mesh"])] = r
    return rows


def decode_mem_frac(r):
    """Decode cells live on the memory roofline: ideal = one cache read per
    token; frac_mem = ideal_mem_time / t_memory."""
    from repro_torch.configs.base import SHAPES, get_model_config
    from repro_torch.launch.analysis import HBM_BW
    try:
        cfg = get_model_config(r["arch"])
        shape = SHAPES[r["shape"]]
    except KeyError:
        return None
    if shape.kind != "decode":
        return None
    B, S = shape.global_batch, shape.seq_len
    cache_bytes = 0.0
    kinds = cfg.layer_kinds()
    for k in kinds:
        if k in ("attn", "local"):
            cache_bytes += 2 * B * S * cfg.num_kv_heads * cfg.head_dim * 2
        else:
            d_in = cfg.ssm_expand * cfg.d_model
            H = d_in // cfg.ssm_head_dim
            cache_bytes += B * H * cfg.ssm_head_dim * cfg.ssm_state * 4
    ideal = cache_bytes / (r["chips"] * HBM_BW)
    return ideal / r["t_memory_s"] if r["t_memory_s"] else None


def render(base, fin) -> str:
    """The table of ``fin``'s cells ({(arch, shape, mesh): row}) against
    ``base``'s."""
    out = ["# Final roofline table — baseline vs optimized",
           "",
           "bound = max(t_compute, t_memory, t_collective); frac = ideal/bound",
           "(compute ideal = MODEL_FLOPS; decode cells additionally report",
           "frac_mem = cache-read-per-token ideal / t_memory — decode's true",
           "roofline is the memory side).  Baseline = paper-faithful system,",
           "instrument v1; see EXPERIMENTS §Roofline.",
           "", ]
    for mesh in ("16x16", "2x16x16"):
        out.append(f"\n## mesh {mesh}\n")
        out.append("| arch | shape | t_cmp | t_mem | t_coll | dominant | "
                   "frac | bound vs baseline |")
        out.append("|---|---|---|---|---|---|---|---|")
        for key in sorted(fin):
            if key[2] != mesh:
                continue
            r = fin[key]
            b = base.get(key)
            bound = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
            if b:
                bbound = max(b["t_compute_s"], b["t_memory_s"],
                             b["t_collective_s"])
                gain = f"{bbound / bound:.1f}x" if bound else "-"
            else:
                gain = "-"
            mf = decode_mem_frac(r)
            frac = (f"{r['roofline_fraction']:.3f}"
                    if mf is None else f"mem:{mf:.3f}")
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.2f} "
                f"| {r['t_memory_s']:.2f} | {r['t_collective_s']:.2f} "
                f"| {r['dominant']} | {frac} | {gain} |")
    # summary stats
    singles = [r for k, r in fin.items() if k[2] == "16x16"]
    if singles:
        fr = []
        for r in singles:
            mf = decode_mem_frac(r)
            fr.append(r["roofline_fraction"] if mf is None else mf)
        out.append(f"\ncells: {len(singles)} | median frac (decode=mem-frac) "
                   f"{statistics.median(fr):.3f} | best {max(fr):.3f}")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", nargs="*", default=None)
    ap.add_argument("--final", default="dryrun_final.json")
    ap.add_argument("--out", default="FINAL_TABLE.md")
    args = ap.parse_args(argv)
    base_paths = (args.base if args.base is not None else
                  ["dryrun_single_pod.json", "dryrun_multi_pod.json"]
                  + glob.glob("dryrun_long500k_*.json"))
    text = render(load(base_paths), load([args.final]))
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
