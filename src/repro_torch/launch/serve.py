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
                                 EngineOOM, ModelBank, Router)


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
          on_done: Optional[Callable] = None) -> float:
    """Serve ``pending`` (arrival, prompt, max_new) triples, or quadruples
    with an ensemble combine, on the wall clock, submitting each at its
    arrival offset; returns the wall seconds until the last request
    finished."""
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
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
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
    args = ap.parse_args(argv)

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
                        draft=draft, device=device)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"{args.arch}: {e}")
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

    try:
        wall = drive(engine, pending, on_done=done_line)
    except (EngineOOM, ValueError) as e:
        print(f"FATAL: unservable request — {e}", file=sys.stderr)
        sys.exit(2)
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


if __name__ == "__main__":
    main()
