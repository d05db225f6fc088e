"""Phase 6's train step profiled with and without the host-side trace.

    PYTHONPATH=src python -m repro_torch.benchmarks.profile_trace_ab \\
        [--out profile_trace_ab.json]

Runs ``chip_smoke.phase_train`` (qwen3-1.7b, 28 layers, 8 x 1024) with its
profiled step traced four times on the same session before the step the
phase itself reads: CPU and CUDA activity, CUDA alone, CPU and CUDA, CUDA
alone.  Prints, for each, the device busy time, the flash kernels' device
time, the number of kernel kinds and launches, and the top kernels.  Needs
a card; builds the flash source.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
ORDER = (True, False, True, False)          # host trace on, off, on, off


def summarize(events):
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"busy_ms": sum(e.self_device_time_total for e in events) / 1e3,
            "flash_ms": {n: sum(e.self_device_time_total for e in events
                                if n in e.key) / 1e3
                         for n in ("flash_fwd", "flash_bwd")},
            "kinds": len(events), "launches": sum(e.count for e in events),
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in top]}


def run():
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fkernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    build.build([fkernel.SOURCE])
    real, rows = cs.device_events, []

    def traced(torch_, fn, warmup=False, cpu=True, scopes=None):
        for host in ORDER:
            row = {"cpu": host, **summarize(real(torch_, fn, warmup=warmup,
                                                 cpu=host))}
            rows.append(row)
            print(json.dumps(row), flush=True)
        return real(torch_, fn, warmup=warmup, cpu=cpu, scopes=scopes)

    cs.device_events = traced
    try:
        cs.phase_train(torch, build, fkernel)
    finally:
        cs.device_events = real
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"card": card, "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    out = run()
    print(f"card: {out['card']}")
    for r in out["rows"]:
        print(f"host trace {'on ' if r['cpu'] else 'off'}: busy "
              f"{r['busy_ms']:.3f} ms, flash forward "
              f"{r['flash_ms']['flash_fwd']:.3f} ms, backward "
              f"{r['flash_ms']['flash_bwd']:.3f} ms, {r['kinds']} kernels, "
              f"{r['launches']} launches")
    if a.out:
        Path(a.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
