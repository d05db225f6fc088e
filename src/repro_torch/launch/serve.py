"""Serving launcher of the port: the continuous-batching engine under a
synthetic load, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --full-config --stream poisson --requests 32

Drives ``repro_torch.serving.Engine`` (paged KV cache in f32, bf16 or
int8 pools, FCFS continuous batching, chunked prefill, the CUDA paged
attention kernels: ``paged_attention`` on decode-only ticks,
``paged_chunk_attention`` on the others) from a synthetic request stream:
Poisson arrivals with mixed prompt lengths, or everything at t=0 with
``--stream batch``.  Weights are random, from ``--seed``.  Reports decode
tok/s, time-to-first-token, p50/p99 end-to-end latency, preemptions and
both kernels' launches.  Exits with status 2 on a request the pool can
never serve.

``--temperature T`` samples instead of taking the argmax (threefry keys
per request and step, from ``--seed``).  ``--submodels G`` serves G Horn
parallel circuits (a ModelBank of fixed sub-model masks over one parent,
``--keep`` and ``--mask-block`` shape them) behind the same engine:
requests are routed per ``--router`` and co-batch across circuits in
every tick, and ``--ensemble-frac`` of them instead fan across ALL
circuits and combine logits on the device (``--combine``).  The report
then tags each request with its circuit (``sub N``, or ``ens id/combine
sub N`` for ensemble members) and ends with the co-batch ratio and tok/s
per circuit.

``--speculate K`` turns on speculative decoding: a materialized Horn
circuit (``--draft-circuit`` of the serving bank, or of a draft-only bank
at ``--draft-keep`` when serving the dense parent) proposes K tokens a
decode tick in one draft call, and the parent verifies all K + 1
positions inside its one budgeted call.  Greedy output is the
non-speculative output token for token; a tick lands up to K + 1 tokens a
slot.  The report then adds the accept rate, the accepted tokens a
speculating slot-tick, the drafted tokens, the draft calls and the
draft's own paged-kernel launches.

Observability (``repro_torch.serving.observability``): ``--stats-every N``
prints a periodic stats line off the engine's telemetry snapshot;
``--trace-out trace.json`` records every tick's plan / host-prep /
device-step / commit phases plus one track per slot and writes Chrome
Trace Event JSON (open in https://ui.perfetto.dev); ``--slo-class
name:ttft:latency`` (repeatable) sets per-class SLO targets and reports
attainment at exit.  ``--record-trace trace.jsonl`` writes the request
stream this run served as a versioned JSONL trace, the JAX package's
format; ``--replay trace.jsonl`` serves a recorded stream on the virtual
clock (arrivals at their recorded offsets, each tick advancing
``--tick-dt`` seconds; no ``--arch`` needed, the header carries it) and
prints the SHA-256 digest of the token streams, identical run to run
under greedy sampling.  The exit report ends with the step profiler's
variants (calls and device ms p50 from CUDA events on a card, host ms on
the CPU), a warning on post-warmup compiles, and ``alerts:`` (tick
spikes, SLO burn, pool leaks, accept-rate collapse, late compiles).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import (HornConfig, get_model_config,
                                      list_archs, reduced)
from repro_torch.models.layers import dtype_of
from repro_torch.models.params import init_params
from repro_torch.serving import (DraftModel, Engine, EngineConfig,
                                 EngineOOM, ModelBank, Router, Telemetry)
from repro_torch.serving.observability import (TraceRecorder, load_trace,
                                               parse_slo_class, replay)
from repro_torch.serving.observability.replay import DEFAULT_TICK_DT


def build_draft(cfg, params, bank, *, speculate: int, draft_circuit: int,
                draft_keep: float, mask_block: int,
                seed: int) -> Optional[DraftModel]:
    """The draft circuit of ``--speculate K``: cut from the serving bank
    when there is one (drafts are verified per slot under each request's
    own circuit masks, so any circuit of the bank may propose), else from
    a draft-only bank over the same parent weights at ``draft_keep`` (the
    dense parent verifies).  None without speculation."""
    if speculate <= 0:
        return None
    if bank is not None:
        return bank.draft_model(draft_circuit, params)
    horn = HornConfig(enabled=True, keep_hidden=draft_keep, keep_input=1.0,
                      block_size=mask_block)
    dbank = ModelBank(cfg, horn, draft_circuit + 1, seed=seed)
    return dbank.draft_model(draft_circuit, params)


def make_requests(n: int, vocab_size: int, rng: np.random.Generator, *,
                  stream: str = "poisson", rate: float = 16.0,
                  max_prompt: int = 64, gen: int = 16,
                  long_frac: float = 0.0):
    """(arrival_time, prompt, max_new) triples: Poisson arrivals (or all at
    t=0 for ``stream="batch"``), prompt lengths log-uniform between 4 and
    ``max_prompt``, max_new drawn in [gen/2, gen]; ``long_frac`` of the
    prompts are pinned at ``max_prompt``.  The same draws as
    ``repro.launch.serve.make_requests`` (without a shared prefix) for the
    same ``rng``."""
    out, t = [], 0.0
    for _ in range(n):
        if stream == "poisson":
            t += rng.exponential(1.0 / rate)
        if long_frac > 0 and rng.uniform() < long_frac:
            plen = max_prompt
        else:
            lo, hi = np.log(min(4, max_prompt)), np.log(max_prompt)
            plen = int(np.exp(rng.uniform(lo, hi)))
        prompt = rng.integers(0, vocab_size, (max(1, plen),)).astype(np.int32)
        out.append((t, prompt, int(rng.integers(max(1, gen // 2), gen + 1))))
    return out


def percentile(xs, p: float) -> float:
    xs = np.asarray(list(xs), np.float64)
    return float(np.percentile(xs, p)) if xs.size else float("nan")


def with_ensembles(pending: list, rng: np.random.Generator, frac: float,
                   combine: str) -> list:
    """(arrival, prompt, max_new, ensemble) quadruples: each request fans
    across the bank's circuits with probability ``frac`` (one
    ``rng.uniform()`` a request, in arrival order, as the JAX launcher
    draws them when it submits)."""
    return [(at, p, g, combine if rng.uniform() < frac else None)
            for at, p, g in pending]


def drive(engine: Engine, pending: list,
          on_done: Optional[Callable] = None,
          after_step: Optional[Callable] = None) -> float:
    """Serve ``pending`` (arrival, prompt, max_new) triples, or quadruples
    with an ensemble combine, on the wall clock, submitting each at its
    arrival offset; returns the wall seconds until the last request
    finished.  ``after_step(elapsed_s)`` runs after every tick."""
    pending = list(pending)
    t0 = time.monotonic()
    while pending or engine.sched.has_work():
        now = time.monotonic() - t0
        while pending and pending[0][0] <= now:
            at, prompt, gen, *ens = pending.pop(0)
            engine.submit(prompt, gen, arrival_time=at,
                          ensemble=ens[0] if ens else None)
        if not engine.sched.has_work():
            time.sleep(min(0.005, max(0.0, pending[0][0] - now)))
            continue
        for req in engine.step(time.monotonic() - t0,
                               tick_clock=lambda: time.monotonic() - t0):
            if on_done is not None:
                on_done(req)
        if after_step is not None:
            after_step(time.monotonic() - t0)
    return time.monotonic() - t0


def summarize(engine: Engine, wall: float) -> dict:
    """The end-to-end numbers of one ``drive`` over ``engine``.  An
    ensemble group delivers one stream, so user-facing counts take its
    leader once; ``device_tok_s`` counts every member's tokens."""
    done: List = engine.finished_streams()
    s = engine.stats
    wall_ = max(wall, 1e-9)
    return {
        "requests": len(done),
        "sequences": len(engine.sched.finished),
        "wall_s": wall,
        "generated_tokens": sum(len(r.out_tokens) for r in done),
        "tok_s": sum(len(r.out_tokens) for r in done) / wall_,
        "device_tok_s": sum(len(r.out_tokens)
                            for r in engine.sched.finished) / wall_,
        "cobatch_ratio": s.cobatch_ratio,
        "tok_s_by_submodel": {g: n / wall_ for g, n in
                              sorted(s.tokens_by_submodel.items())},
        "ticks": s.steps,
        "prefill_tokens": s.prefill_tokens,
        "ttft_p50_s": percentile(
            [r.t_first_token - r.arrival_time for r in done], 50),
        "ttft_p99_s": percentile(
            [r.t_first_token - r.arrival_time for r in done], 99),
        "latency_p50_s": percentile(
            [r.t_done - r.arrival_time for r in done], 50),
        "latency_p99_s": percentile(
            [r.t_done - r.arrival_time for r in done], 99),
        "peak_utilization": s.peak_utilization,
        "preemptions": engine.preemptions,
        "attn_launches": s.attn_launches,
        "decode_launches": s.decode_launches,
        "decode_ticks": s.decode_ticks,
        "accept_rate": s.accept_rate,
        "accepted_tok_per_tick": s.accepted_tok_per_tick,
        "spec_drafted": s.spec_drafted,
        "spec_accepted": s.spec_accepted,
        "spec_committed": s.spec_committed,
        "spec_slot_ticks": s.spec_slot_ticks,
        "draft_calls": engine.spec.draft_calls if engine.spec is not None
        else 0,
        "draft_attn_launches": s.draft_attn_launches,
        "draft_decode_launches": s.draft_decode_launches,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list_archs(),
                    help="model architecture (default qwen3-1.7b, or the "
                         "arch a --replay trace's header records)")
    ap.add_argument("--full-config", action="store_true",
                    help="the arch at its published width (default: the "
                         "reduced smoke-test config)")
    ap.add_argument("--stream", choices=["poisson", "batch"], default="poisson")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=16.0,
                    help="poisson arrival rate (requests/s)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--pages", type=int, default=512)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16,
                    help="max new tokens (per-request draw in [gen/2, gen])")
    ap.add_argument("--budget", type=int, default=256,
                    help="tokens per unified tick (decode + prompt chunks)")
    ap.add_argument("--long-frac", type=float, default=0.0,
                    help="fraction of prompts pinned at --max-prompt")
    ap.add_argument("--policy", choices=["reserve", "on_demand"],
                    default="on_demand")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--kv-dtype", choices=["bfloat16", "float32", "int8"],
                    default="bfloat16",
                    help="page pools; int8 quantizes on append, ~2x the "
                         "pages of bfloat16 in the same bytes")
    ap.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                    default="bfloat16")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0: greedy; else sample logits / T")
    ap.add_argument("--submodels", type=int, default=0,
                    help="serve G Horn circuits from one ModelBank "
                         "(0: the dense parent alone)")
    ap.add_argument("--router", choices=["least_loaded", "hash"],
                    default="least_loaded")
    ap.add_argument("--ensemble-frac", type=float, default=0.0,
                    help="fraction of requests fanned across ALL circuits "
                         "with their logits combined on the device")
    ap.add_argument("--combine", choices=["mean_logit", "majority_vote"],
                    default="mean_logit")
    ap.add_argument("--keep", type=float, default=0.5,
                    help="per-circuit FFN hidden keep rate (paper: 0.5)")
    ap.add_argument("--mask-block", type=int, default=16,
                    help="mask block in hidden units (reduced configs need "
                         "<= d_ff/4 for distinct circuits)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding: a materialized draft "
                         "circuit proposes K tokens a decode tick, the "
                         "parent verifies all K+1 positions in its one "
                         "budgeted call (0: off)")
    ap.add_argument("--draft-circuit", type=int, default=0,
                    help="bank circuit the draft is materialized from")
    ap.add_argument("--draft-keep", type=float, default=0.875,
                    help="FFN keep rate of the draft-only bank when "
                         "--submodels 0 (with random weights acceptance "
                         "tracks how much of the FFN the draft keeps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record-trace", metavar="PATH", default=None,
                    help="write the served request stream (arrivals, "
                         "prompt ids, budgets, ensemble decisions) as a "
                         "versioned JSONL traffic trace")
    ap.add_argument("--replay", metavar="PATH", default=None,
                    help="serve a recorded trace on the deterministic "
                         "virtual clock instead of a synthetic stream "
                         "(--requests/--stream/--rate are ignored)")
    ap.add_argument("--tick-dt", type=float, default=DEFAULT_TICK_DT,
                    help="virtual seconds per tick during --replay "
                         f"(default {DEFAULT_TICK_DT})")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="record the per-tick timeline (plan / host-prep / "
                         "device-step / commit phases + one track per slot) "
                         "and write Chrome Trace Event JSON here")
    ap.add_argument("--stats-every", type=int, default=0, metavar="TICKS",
                    help="print a periodic stats line every N engine ticks "
                         "(0: off)")
    ap.add_argument("--slo-class", action="append", default=[],
                    metavar="NAME:TTFT:LAT",
                    help="SLO targets (seconds; '-' leaves a bound unset), "
                         "e.g. 'default:0.5:5'; repeatable.  Synthetic "
                         "traffic is scored under class 'default', a "
                         "replayed trace under its records' classes.")
    args = ap.parse_args(argv)

    if args.arch is None:
        args.arch = "qwen3-1.7b"
        if args.replay:
            args.arch = load_trace(args.replay)[1].get("arch")
            if args.arch is None:
                ap.error(f"--arch: {args.replay} records no arch in its "
                         f"header meta; pass --arch explicitly")
    cfg = get_model_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg)
    if cfg.family == "mlp":
        raise SystemExit("horn-mnist is a classifier; use launch.train")
    device = resolve_device(args.device)
    ecfg = EngineConfig(
        num_slots=args.slots, num_pages=args.pages, page_size=args.page_size,
        max_prompt_len=-(-args.max_prompt // args.page_size) * args.page_size,
        max_new_tokens=args.gen, token_budget=max(args.budget, args.slots),
        temperature=args.temperature, seed=args.seed, policy=args.policy,
        prefix_cache=args.prefix_cache, speculate_k=args.speculate,
        kv_dtype=args.kv_dtype, compute_dtype=args.compute_dtype)
    params = init_params(cfg, args.seed, device=device,
                         dtype=dtype_of(args.compute_dtype))
    bank = router = None
    try:
        telemetry = Telemetry(
            timeline=args.trace_out is not None,
            slo_classes=[parse_slo_class(s) for s in args.slo_class])
        if args.submodels > 0:
            if args.submodels > args.slots and args.ensemble_frac > 0:
                raise SystemExit(
                    "ensemble mode needs --slots >= --submodels")
            horn = HornConfig(enabled=True, keep_hidden=args.keep,
                              keep_input=1.0, block_size=args.mask_block)
            bank = ModelBank(cfg, horn, args.submodels, seed=args.seed)
            router = Router(args.submodels, policy=args.router)
        draft = build_draft(cfg, params, bank, speculate=args.speculate,
                            draft_circuit=args.draft_circuit,
                            draft_keep=args.draft_keep,
                            mask_block=args.mask_block, seed=args.seed)
        engine = Engine(cfg, params, ecfg, bank=bank, router=router,
                        draft=draft, device=device, telemetry=telemetry)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"{args.arch}: {e}")

    if args.replay:
        records, meta = load_trace(args.replay)
        if meta.get("arch") not in (None, args.arch):
            print(f"WARNING: trace was recorded on arch "
                  f"{meta['arch']!r}, replaying on {args.arch!r}",
                  file=sys.stderr)
        print(f"replaying {len(records)} requests from {args.replay} "
              f"({cfg.name} on {device}, virtual clock, "
              f"{args.tick_dt * 1e3:g}ms/tick)")
        try:
            result = replay(engine, records, tick_dt=args.tick_dt)
        except (EngineOOM, ValueError) as e:
            print(f"FATAL: unservable request — {e}", file=sys.stderr)
            sys.exit(2)
        s = result.summary()
        wall = sum(result.tick_wall_s)
        print(f"\n{result.requests} requests in {result.virtual_s:.2f} "
              f"virtual s ({wall:.2f}s host compute, "
              f"{result.ticks} ticks)")
        print(f"throughput: {s['decode_tok_s_p10'] or 0:.1f} tok/s "
              f"(pooled-p10 tick estimate)  "
              f"{result.generated_tokens} tokens  "
              f"digest {result.token_digest}")
        print(f"TTFT    p50 {s['ttft_p50_s']:.3f}s  "
              f"p99 {s['ttft_p99_s']:.3f}s  (virtual clock)")
        print(f"latency p50 {s['latency_p50_s']:.3f}s  "
              f"p99 {s['latency_p99_s']:.3f}s")
        _tail_report(engine, args, bank, cfg, wall)
        return

    rng = np.random.default_rng(args.seed)
    pending = make_requests(args.requests, cfg.vocab_size, rng,
                            stream=args.stream, rate=args.rate,
                            max_prompt=args.max_prompt, gen=args.gen,
                            long_frac=args.long_frac)
    if bank is not None:
        pending = with_ensembles(pending, rng, args.ensemble_frac,
                                 args.combine)
    sub = f", {args.submodels} submodels ({args.router} routing, " \
          f"{args.ensemble_frac:.0%} ensemble)" if bank else ""
    print(f"serving {args.requests} requests ({args.stream} stream, "
          f"{cfg.name} on {device}, {args.slots} slots, "
          f"{args.pages}x{args.page_size}-token pages, budget "
          f"{ecfg.token_budget} tok/tick, policy={args.policy}, "
          f"temperature {args.temperature:g}{sub})")

    def done_line(req) -> None:
        pre = f"  ({req.num_preemptions}x preempted)" \
            if req.num_preemptions else ""
        tag = f"  sub {req.submodel_id}" if bank else ""
        if req.group is not None:
            tag = f"  ens {req.group.id}/{req.group.combine}" \
                  f" sub {req.submodel_id}"
        print(f"  req {req.id:3d} done: prompt {req.prompt_len:3d} "
              f"+{len(req.out_tokens):3d} tok  "
              f"ttft {req.t_first_token - req.arrival_time:6.3f}s  "
              f"latency {req.t_done - req.arrival_time:6.3f}s{tag}{pre}")

    next_stats = [args.stats_every]

    def stats_line(elapsed: float) -> None:
        """One compact periodic line off the telemetry snapshot."""
        if not args.stats_every or engine.steps < next_stats[0]:
            return
        next_stats[0] = engine.steps + args.stats_every
        m = engine.metrics()
        c, tick = m["counters"], m["tick"]["tick_s"]
        hr = m["derived"]["prefix_hit_rate"]
        print(f"  [tick {c['steps']}] "
              f"{c['generated_tokens'] / max(elapsed, 1e-9):6.1f} tok/s  "
              f"run {len(engine.sched.running)}/{args.slots}  "
              f"wait {len(engine.sched.waiting)}  "
              f"pool {m['pool']['utilization']:.0%}  "
              f"tick p50 {(tick['p50'] or 0) * 1e3:.1f}ms  "
              f"hit {'n/a' if hr is None else format(hr, '.0%')}  "
              f"preempt {m['derived']['preemptions']}")

    try:
        wall = drive(engine, pending, on_done=done_line,
                     after_step=stats_line)
    except (EngineOOM, ValueError) as e:
        print(f"FATAL: unservable request — {e}", file=sys.stderr)
        sys.exit(2)
    if args.record_trace:
        # the RESOLVED ensemble decisions are recorded, so replay does not
        # depend on this run's RNG state
        recorder = TraceRecorder(meta={
            "arch": args.arch, "seed": args.seed, "stream": args.stream,
            "rate": args.rate, "max_prompt": args.max_prompt,
            "gen": args.gen, "long_frac": args.long_frac,
            **engine.obs.engine_config})
        for at, prompt, gen, *ens in pending:
            recorder.add(at, prompt, gen, ensemble=ens[0] if ens else None)
        n = recorder.save(args.record_trace)
        print(f"recorded {n} requests -> {args.record_trace}")
    r = summarize(engine, wall)
    s = engine.stats
    print(f"\n{r['requests']} requests ({r['sequences']} sequences) in "
          f"{wall:.2f}s")
    dev = f" ({r['device_tok_s']:.1f} device tok/s incl. ensemble " \
          f"members)" if r["sequences"] != r["requests"] else ""
    print(f"throughput: {r['tok_s']:.1f} tok/s{dev} ({r['ticks']} ticks, "
          f"{s.generated_tokens / max(r['ticks'], 1):.1f} tok/tick, "
          f"{r['prefill_tokens']} prefill tok)")
    print(f"TTFT    p50 {r['ttft_p50_s']:.3f}s  p99 {r['ttft_p99_s']:.3f}s")
    print(f"latency p50 {r['latency_p50_s']:.3f}s  "
          f"p99 {r['latency_p99_s']:.3f}s")
    _tail_report(engine, args, bank, cfg, wall)


def _tail_report(engine: Engine, args, bank, cfg, wall: float) -> None:
    """Exit-report sections shared by the live and replay drive loops:
    pool / prefix-cache / bank / speculative state, both kernels'
    launches, SLO attainment, the profiler's variants, anomaly alerts and
    the trace export."""
    r = summarize(engine, wall)
    s = engine.stats
    print(f"page-pool peak utilization: {r['peak_utilization']:.0%}  "
          f"preemptions: {r['preemptions']}  block-table rows synced/tick: "
          f"{s.bt_rows_synced / max(s.steps, 1):.2f}")
    if args.prefix_cache:
        hr = s.prefix_hit_rate
        print(f"prefix cache: hit rate "
              f"{'n/a' if hr is None else format(hr, '.0%')}  "
              f"prefill tok saved {s.prefill_tok_saved}  "
              f"evictions {engine.cache_evictions}  "
              f"COW copies {s.cow_page_copies}")
    if bank is not None:
        per = "  ".join(
            f"sub{g}: {r['tok_s_by_submodel'].get(g, 0.0):6.1f} tok/s"
            f" (peak util {s.peak_util_by_submodel.get(g, 0.0):.0%})"
            for g in range(args.submodels))
        print(f"co-batch ratio: {r['cobatch_ratio']:.0%}  {per}")
    if args.speculate:
        print(f"speculative: accept rate {r['accept_rate']:.0%}  "
              f"accepted tok/tick {r['accepted_tok_per_tick']:.2f}  "
              f"drafted {r['spec_drafted']}  draft calls {r['draft_calls']}"
              f"  (K={args.speculate}, circuit {engine.spec.draft.circuit}, "
              f"kept {engine.spec.draft.kept_frac:.0%}); draft paged "
              f"launches {r['draft_attn_launches']} "
              f"({r['draft_decode_launches']} decode)")
    print(f"paged_chunk_attention launches: "
          f"{r['attn_launches'] - r['decode_launches']} ({cfg.num_layers} "
          f"layers x {r['ticks'] - r['decode_ticks']} ticks with prompt "
          f"or verify chunks on a card; 0 on the CPU, which runs the plain "
          f"versions)")
    print(f"paged_attention launches: {r['decode_launches']} "
          f"({cfg.num_layers} layers x {r['decode_ticks']} decode-only ticks "
          f"on a card)")
    if args.slo_class:
        for name, rep in engine.obs.slo.report().items():
            att = rep["attainment"]
            tt = rep["ttft_target_s"]
            lt = rep["latency_target_s"]
            print(f"SLO [{name}] attainment "
                  f"{'n/a' if att is None else format(att, '.0%')} "
                  f"({rep['met']}/{rep['finished']}; targets "
                  f"ttft {'-' if tt is None else f'{tt:g}s'} "
                  f"latency {'-' if lt is None else f'{lt:g}s'}; "
                  f"violations ttft {rep['ttft_violations']} "
                  f"latency {rep['latency_violations']})")
    prof = engine.obs.profiler
    if prof is not None:
        for label, c in prof.cost_report().items():
            unit = "device_ms" if "device_ms_p50" in c else "host_ms"
            p50 = c[f"{unit}_p50"]
            print(f"step {label}: {c['calls']} calls, {unit.replace('_', ' ')}"
                  f" p50 {'n/a' if p50 is None else format(p50, '.3f')}")
        if prof.compiles_post_warm:
            print(f"compiles: {prof.compiles_post_warm} post-warmup "
                  f"(of {prof.compiles_total} observed) — late compiles "
                  f"are a perf regression signal")
    mon = engine.obs.anomaly
    if mon is not None and mon.counts:
        print("alerts: " + "  ".join(f"{k} x{n}"
                                     for k, n in sorted(mon.counts.items())))
        for a in list(mon.alerts)[-5:]:
            print(f"  [{a.kind}] tick {a.tick} t={a.t:.2f}s: {a.message}")
    else:
        print("alerts: none")
    if args.trace_out:
        n = engine.obs.timeline.export(args.trace_out)
        print(f"trace: {n} events over {engine.obs.timeline.ticks} ticks "
              f"-> {args.trace_out} (open in https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
