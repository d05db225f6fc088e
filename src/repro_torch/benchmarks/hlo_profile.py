"""Per-scope profile of one dry-run cell: where its FLOPs, bytes and
collectives go, and on the card where its device time goes.

    PYTHONPATH=src python -m repro_torch.benchmarks.hlo_profile \\
        --arch llava-next-34b --shape prefill_32k [--multi-pod] [--top 15]
    PYTHONPATH=src python -m repro_torch.benchmarks.hlo_profile \\
        --arch qwen3-1.7b --shape prefill_32k --card --batch 2 --seq 4096

The port of ``benchmarks/hlo_profile.py``.  The reference reads the
compiled HLO of the cell; here ``launch/dryrun.py::trace_cell`` traces one
step on the fake world of the production mesh (CPU, fake tensors) under a
recording ``CostCounter``, and the profile prints the summary (FLOPs,
bytes with kernels at their boundary, the unfused eager bytes, collective
bytes by kind, ``by_tag``), the top ops by bytes and the top collectives,
each summed over its repeats ("x n", the counterpart of the reference's
trip-count multiplier).

``--card`` runs the same step, mesh-free, at ``--batch`` x ``--seq`` (the
shape's own by default) on one CUDA card under ``torch.profiler``, and
prints each tag's device time beside its counted FLOPs, bytes and bound,
``max(flops / PEAK_FLOPS, bytes / HBM_BW)``, from a mesh-free fake trace
of the same step.  A kernel's device time goes to the innermost tag its
CPU range runs in: a tagged ``record_function`` range in the forward, and
in the backward the tag whose forward made the autograd node
(``scope.node_scopes`` of the ``evaluate_function`` range's sequence
number); a remat recompute goes to the tags it re-enters.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch import scope
from repro_torch.launch import analysis as A

EVALUATE = "autograd::engine::evaluate_function"
PROFILE_TRIES = 3


def counts(counter) -> dict:
    """A counter's FLOPs, bytes (kernels at their boundary), unfused
    bytes, ``by_tag`` and the untagged rest."""
    return {"flops": counter.flops, "bytes": counter.bytes,
            "unfused_bytes": counter.unfused_bytes,
            "by_tag": counter.by_tag(), "untagged": counter.untagged}


def summarize(counter, top: int = 15) -> dict:
    """A recording counter's summary, top ops by bytes and top
    collectives: (total bytes, name, shape, repeats, tag) each."""
    rows = {"op": [], "coll": []}
    for (what, name, shape, tag), (nbytes, n) in counter.records.items():
        rows[what].append((nbytes, name, shape, n, tag or "-"))
    return {
        "summary": {**counts(counter), "coll": counter.coll.bytes_simple,
                    "coll_by_kind": dict(counter.coll.by_kind)},
        "top_traffic": sorted(rows["op"], reverse=True)[:top],
        "top_collectives": sorted(rows["coll"], reverse=True)[:top],
    }


def profile_cell(arch: str, shape: str, multi_pod: bool = False,
                 top: int = 15) -> dict:
    """The cell traced on the fake world of its production mesh (rank 0's
    counts, as the dry run's)."""
    from repro_torch.launch.dryrun import fake_world, make_run, trace_cell
    from repro_torch.launch.mesh import make_production_mesh

    run = make_run(arch, shape, multi_pod)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        counter = trace_cell(run, mesh, record=True)
    return summarize(counter, top)


def render(prof) -> None:
    s = prof["summary"]
    print(f"per-dev: flops={s['flops']:.3e} bytes={s['bytes']:.3e} "
          f"(unfused {s['unfused_bytes']:.3e}) coll={s['coll']:.3e}")
    print("coll by kind:", {k: f"{v:.2e}" for k, v in
                            s["coll_by_kind"].items()})
    print("by tag:", {k: {kk: f"{vv:.2e}" for kk, vv in v.items()}
                      for k, v in s["by_tag"].items()},
          "untagged:", {k: f"{v:.2e}" for k, v in s["untagged"].items()})
    print("\n-- top collectives (bytes over repeats) --")
    for b, name, shape, n, tag in prof["top_collectives"]:
        print(f"  {b:.3e}  {name:18s} x{n:<6d} {shape:40s} {tag}")
    print("\n-- top traffic ops --")
    for b, name, shape, n, tag in prof["top_traffic"]:
        print(f"  {b:.3e}  {name:28s} x{n:<6d} {shape:40s} {tag}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def card_run(arch: str, shape: str, batch=None, seq=None):
    """The mesh-free run of a dry-run cell at ``batch`` x ``seq`` (the
    cell's own where None)."""
    from repro_torch.launch.dryrun import make_run

    run = make_run(arch, shape, False)
    sh = dataclasses.replace(run.shape, global_batch=batch or
                             run.shape.global_batch,
                             seq_len=seq or run.shape.seq_len)
    return dataclasses.replace(run, shape=sh)


def card_step(run, device):
    """``fn(i)``: one step of ``run`` on ``device`` (a prefill of seeded
    tokens, or a train step on the synthetic pipeline's batch ``i``), and
    what it holds."""
    import torch

    from repro_torch.core import steps as S
    from repro_torch.models.params import init_params

    kind, cfg = run.shape.kind, run.model
    B, L = run.shape.global_batch, run.shape.seq_len
    if kind == "prefill":
        params = init_params(cfg, run.seed, device=device)
        gen = torch.Generator(device="cpu").manual_seed(run.seed)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, L),
                                         generator=gen).to(device)}
        step = S.make_prefill_step(run, device)
        return lambda i: step(params, batch)
    if kind == "train":
        from repro_torch.data.pipeline import (SyntheticTokenPipeline,
                                               TokenPipelineConfig)
        held = {"state": S.init_state(run, device)}
        step = S.make_train_step(run, device)
        batch_at = SyntheticTokenPipeline(TokenPipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=L, global_batch=B,
            seed=run.seed)).batch_at

        def train(i):
            held["state"], _ = step(held["state"], batch_at(i))
        return train
    raise ValueError(f"--card profiles prefill and train cells, not "
                     f"{kind}")


def tag_of(event) -> str:
    """The tag an event's own kernels go to ("" untagged): the innermost
    tagged range around it, or the tag of the autograd node an
    ``evaluate_function`` range runs; a recompute hides the tags outside
    it."""
    e = event
    while e is not None:
        if e.name in scope.TAGS:
            return e.name
        if e.name == scope.RECOMPUTE:
            return ""
        if e.name.startswith(EVALUATE) and e.sequence_nr >= 0:
            return scope.node_scopes(e.sequence_nr)[0] or ""
        e = e.cpu_parent
    return ""


def device_us_by_tag(prof) -> dict:
    """{tag ("" untagged): device us of the kernels launched under it}."""
    import torch

    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        own = e.self_device_time_total
        if own:
            t = tag_of(e)
            out[t] = out.get(t, 0.0) + own
    return out


def card_scopes(run, device, counted=None, iters: int = 1):
    """Each tag's device time on the card for one step of ``run`` (after a
    warm-up step the profiler drops; ``iters`` steps averaged) beside its
    counted FLOPs, bytes and bound from ``counted`` (``counts`` of a
    mesh-free ``trace_cell`` of the same run; traced here when None).
    Returns {tag: row} with "" for the untagged rest and "total"."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    if counted is None:
        from repro_torch.launch.dryrun import trace_cell
        counted = counts(trace_cell(run))
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else \
        (lambda: None)
    fn = card_step(run, device)
    fn(0)                               # builds, allocates, autotunes
    sync()
    us = {}
    for _ in range(PROFILE_TRIES):
        with scope.listen():
            with profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device.type == "cuda"
                    else []),
                         schedule=schedule(wait=0, warmup=1,
                                           active=iters)) as prof:
                for i in range(1 + iters):
                    fn(1 + i)
                    sync()
                    if i < iters:
                        prof.step()     # the warm-up step's events drop
            us = device_us_by_tag(prof)
        if sum(us.values()) > 0:
            break
    tags = counted["by_tag"]
    rows = {}
    for tag in sorted(set(tags) | {t for t in us if t}) + [""]:
        c = tags.get(tag, counted["untagged"] if tag == "" else
                     {"flops": 0.0, "bytes": 0.0})
        rows[tag] = _row(us.get(tag, 0.0) / iters / 1e3, c["flops"],
                         c["bytes"])
    rows["total"] = _row(sum(us.values()) / iters / 1e3, counted["flops"],
                         counted["bytes"])
    return rows


def _row(ms, flops, nbytes) -> dict:
    t_c, t_m = flops / A.PEAK_FLOPS * 1e3, nbytes / A.HBM_BW * 1e3
    return {"device_ms": ms, "flops": flops, "bytes": nbytes,
            "t_compute_ms": t_c, "t_memory_ms": t_m,
            "bound_ms": max(t_c, t_m)}


def render_card(rows) -> None:
    print(f"{'scope':12s} {'device ms':>10s} {'FLOPs':>10s} "
          f"{'bytes':>10s} {'t_compute':>10s} {'t_memory':>10s} "
          f"{'bound ms':>10s}")
    for tag, r in rows.items():
        print(f"{tag or 'untagged':12s} {r['device_ms']:10.3f} "
              f"{r['flops']:10.3e} {r['bytes']:10.3e} "
              f"{r['t_compute_ms']:10.3f} {r['t_memory_ms']:10.3f} "
              f"{r['bound_ms']:10.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--card", action="store_true",
                    help="the mesh-free step on one CUDA card")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    args = ap.parse_args(argv)
    t0 = time.time()
    if not args.card:
        render(profile_cell(args.arch, args.shape, args.multi_pod, args.top))
    else:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("--card: torch sees no CUDA card")
        run = card_run(args.arch, args.shape, args.batch, args.seq)
        print(f"{args.arch} {run.shape.kind} {run.shape.global_batch} x "
              f"{run.shape.seq_len}, {run.model.num_layers} layers, on "
              f"{torch.cuda.get_device_name(0)}")
        render_card(card_scopes(run, torch.device("cuda", 0)))
    print(f"({time.time() - t0:.1f} s)")


if __name__ == "__main__":
    main()
