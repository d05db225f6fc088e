#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line):
  1. device   a CUDA card is visible; prints its name and power limit, and
              turns TF32 off for matmuls and cuDNN (f32 stays f32).
  2. build    builds every kernel of the serving and training paths from
              ``csrc/`` with nvcc (one process per source, all at once),
              and prints each source's own nvcc time.
  3. kernels  each kernel against its plain PyTorch version on the card.
              Paged chunk attention: qwen3-1.7b and gemma2-27b geometries,
              chunk widths 1/7/64/256, ragged starts, idle slots, poisoned
              dead block-table entries, pools of q's dtype and int8 (bf16
              q on the tensor-core kernel over bf16 and int8 pools, f32 q
              on the CUDA-core one), each case also with a
              ``logit_index`` window whose rows are held against the plain
              version's.  Paged decode attention (each slot's pages split
              over the blocks the split rule gives): MHA, GQA, MQA (two
              row groups), qwen3-1.7b and gemma2-27b geometries; plain,
              window, softcap; lengths that straddle pages, an empty slot,
              poisoned dead entries; pools of q's dtype and int8; against
              its plain version and against the chunk kernel at C == 1.
              Flash attention forward and backward (dq, dk, dv against
              torch autograd through the plain version, same dO; bf16 on
              the tensor-core kernels, f32 on the CUDA-core ones):
              qwen3-1.7b and gemma2-27b geometries, causal / window /
              softcap / non-causal, S 1/7/256/1024; phi3.5-moe's G 4,
              llama4-maverick's G 5, llava-next-34b's G 7 and
              jamba-1.5-large's G 8, causal, S up to 2048; whisper-base's
              8 / 8 heads x 64 (D 64, G 1), causal and non-causal, S
              1/7/448/1536.  The paged
              sweeps also run phi3.5-moe's 32 / 8 heads (G 4).
              Dropout matmul: the JAX sweep's shapes, a ragged one (K 13:
              bf16 on the mma.sync kernel) and the full-width Horn MLP
              shape with a random, an all-dropped, an all-live and a
              one-live-block mask (bf16 on the wgmma kernel).  All with q
              (or x) in f32 and bf16.
  4. parity   the paged engine (qwen3-1.7b at full width, 2 layers, f32)
              against a plain non-paged recompute of the same model on the
              card: identical greedy streams.  Then the same engine on int8
              pools, on the card and on the CPU plain path: the streams
              are compared and the first parting token printed.
  5. serve    the serving path: qwen3-1.7b at full width (28 layers, bf16,
              random weights from a seed) serving 16 requests through
              ``Engine``; every request finishes, and each tick launches
              one paged kernel once per layer: ``paged_attention`` on the
              decode-only ticks (every launch on the route the split rule
              gives: ``split`` at 8 slots), ``paged_chunk_attention``
              (every launch on its tensor-core kernel) on the others.
  5b. int8    phase 5's load twice at one HBM budget: bf16 pools of 28
              pages (below the load's peak, so it preempts), then int8
              pools of the pages the same bytes hold; int8 preempts
              strictly less; every chunk launch of the int8 run on the
              tensor-core kernel's int8 route, every decode launch on the
              split rule's route; tok/s, TTFT, latency, tick time,
              preemptions and the greedy match against bf16 printed.
  6. train    the training path: ``repro_torch.launch.train`` on
              qwen3-1.7b at full width (28 layers, f32 masters, bf16
              compute, Horn on with 4 groups, AdamW at lr 3e-4), batch 8 x
              seq 1024 from the synthetic pipeline, 4 steps; every loss
              finite (the first near ln(vocab), the loss of a uniform
              guess), every grad norm above 0, the flash forward launched
              2 x 28 times a step (remat recomputes each block) and the
              backward 28 times; then one profiled step.
  7. horn mlp Horn's block-sparse MLP, ``mlp_apply(mask_blocks=...)``, on
              all 28 qwen3-1.7b layers at full width (bf16 weights from
              seed 0, x [8, 1024, 2048] through each layer's ffn_norm, 4
              groups at keep 0.5 drawn as the train step draws them): the
              dropout_matmul kernel launched 2 x 28 times, every launch on
              its wgmma kernel, each layer's
              output equal to the dense masked path's; then both paths
              timed over the 28 layers, and the block path profiled.
  8. timing   each kernel, its plain version and one PyTorch library call
              with CUDA events at the shapes its path gives it (paged, on
              bf16 and on int8 pools: the decode kernel at a decode tick,
              the chunk kernel at a decode tick and a 256-token
              prompt-chunk tick, by device time, the int8 decode tick in
              three calls; then both at C == 1 over contexts 16-4096 and
              at 64 slots, with the decode kernel's split count; flash: the
              train steps' (qwen3-1.7b's; gemma3-4b's at head dim 256,
              causal and with its window of 1024, SDPA given a boolean
              mask; whisper-base's encoder at head dim 64, B 16, S 1536,
              non-causal), with |SDPA - plain| beside |kernel - plain|,
              TFLOP/s and the share of the bound, and the wrapper's host
              time per call with and without tensor maps; dropout matmul:
              the Horn MLP's at keep 1, 0.5 and 0.25, beside cuBLAS on
              the kept columns only; SSD chunk scan: mamba2-2.7b's
              prefill on the wgmma kernel, beside the CUDA-core kernel on
              the same inputs, where no single PyTorch call computes the
              same function), beside the least time the card could take
              (for the SSD: bf16 rate for the wgmma kernel, f32 for the
              CUDA-core one).
  9. ssm      mamba2-2.7b through ``make_prefill_step``/``make_decode_step``.
              First 2 layers at full width in f32: the kernel path against
              the plain path (logits, final SSM states), and prefill(S) + 4
              decode steps against prefill(S + k); the same 2 layers in
              bf16 at 2 x 2048, every scan on the wgmma kernel: each scan
              against the plain scan on its inputs, the prefill against
              the plain path.  Then all 64 layers in
              bf16 (random weights from seed 0): a prefill of 4 x 2048
              seeded tokens and 32 greedy decode steps from its cache; the
              SSD kernel launched 64 times by the prefill, all 64 on its
              wgmma kernel, and never by decode, every logit finite; prefill
              wall and tok/s, decode tok/s, peak memory and a profiled
              prefill's device busy share, with the SSD's device time summed
              over every ``ssd_chunk_scan*`` kernel (one per launch, asserted).
 10. mnist    the paper's experiment, which launches no port kernel
              (``build.LAUNCHES`` unchanged across it, asserted): the
              collective trainer's step at paper width (784-512-512-10, 20
              groups x 5, Horn on) on the card against the CPU for 20
              steps, same parameters, batches and CPU-drawn masks, for
              allreduce, local SGD (H 4) and int8 error feedback (each int8
              step from the CPU's state: residuals 0 or 1 quantization
              steps apart); the paper's comparison through
              ``benchmarks/mnist_repro.run()`` at its defaults (2000 steps,
              both arms above 0.90, parallel above non-parallel, printed
              beside the paper's +0.0178 and the JAX package's +0.0225 on a
              CPU), each arm's ms a step, busy share and device ops over 50
              profiled steps, peak memory; ``launch.train --arch
              horn-mnist --steps 200`` in a process of its own (its JSON
              row, accuracy above chance).  Then resumable training:
              qwen3-1.7b at full width, 2 layers, Horn on, momentum SGD,
              through the train CLI with ``--checkpoint-dir``: 4 steps
              straight, and 2 steps + a second invocation resuming to 4,
              bit-equal losses and grad norms.
 11. new archs gemma3-4b (head dim 256) and qwen1.5-4b at full width.
              One 6-layer gemma3-4b superblock, bf16, B 2 x 2048: loss
              and gradients through the flash kernels against the plain
              path (and an f32 truth: FlashAttention's test rule, the
              kernel path's error at most twice the plain bf16 path's).
              Then ``launch.train`` for 4 steps of gemma3-4b and 2 of
              qwen1.5-4b at batch 2 x 2048, AdamW, Horn 4 groups: launch
              counts (2 x layers x steps forward, layers x steps
              backward, every one on ``wgmma_d256`` / ``wgmma_d128``),
              finite losses, the first near its random-init value, step
              wall, tok/s, peak memory, a profiled step with flash's
              device time.  Then each serves phase 5's load in bf16.
 12. bank     Horn's multi-submodel serving and sampling at T > 0.  (a)
              qwen3-1.7b at full width, 2 layers, f32: a ModelBank of 3
              circuits (keep 0.5, 16-unit blocks); routed streams (three
              circuits co-batched) against dedicated ``bank.subset([g])``
              engines, greedy and at temperature 0.8, the logits behind
              them within 1e-4 (where a stream parts, the position and
              the top-2 gap are printed); two T 0.8 runs with an ensemble
              bit-equal; mean-logit and majority-vote ensembles against a
              plain dense-cache recompute of each circuit combined on the
              host; the card's threefry keys, bits and uniforms equal to
              the CPU's.  (b) qwen3-1.7b at full width (28 layers, bf16),
              4 circuits, ``least_loaded`` routing, a quarter of the
              requests mean-logit ensembles, phase 5's load at T 0 and at
              T 0.8: every sequence finishes, an ensemble's members share
              one stream, both paged kernels launch once a layer a tick on
              the routes phase 5 asserts (counted from 0 around each run);
              tok/s, TTFT, tick wall, co-batch ratio, tokens per circuit,
              the bank's device bytes and a profiled decode tick with an
              ensemble printed.
 13. spec     speculative decoding, K 4, the draft circuit 0 of a
              draft-only bank at keep 0.875.  (a) qwen3-1.7b at full
              width, 2 layers, f32, 6 requests on 8 slots: greedy
              speculative streams equal to the non-speculative engine's
              with more than one token a speculating slot-tick and fewer
              ticks; two T 0.8 runs bit-equal; the card's speculative
              streams against the CPU plain path's (first parting token
              and top-2 gap printed); both pools' invariants, the draft
              pool empty at the end; the verify tick's chunk launch (with
              its S_v = 5 window) and a draft step's decode launch (idle
              rows exactly 0) against their plain versions.  (b) 28
              layers, bf16, phase 5's load at T 0 and T 0.8: every
              request finishes, launches asserted by route and by parent
              against draft, the same two launches held in bf16 (T 0);
              tok/s, TTFT, latency, ticks, accept rate, accepted tokens a
              slot-tick, draft calls and a profiled speculating tick
              printed.
 14. obs      observability and deterministic trace replay
              (``serving/observability``), over the three pinned traces
              under ``benchmarks/traces/``.  (a) qwen3-1.7b at full width,
              2 layers, f32: each trace replayed at its header's engine
              settings on the card and on the CPU plain path; equal
              digests, ticks, TTFT and latency (a parting must be a tie:
              top-2 logit gap at most 1e-3, draft or parent, printed);
              both paged kernels' launches equal to the engine's counts.
              (b) 28 layers, bf16: each trace replayed twice on one engine
              with a timeline: the same digest, no compile after warm-up,
              a CUDA-event ``device_ms_p50`` for every step variant, a
              valid Chrome export; per variant calls, device ms p50, the
              tick wall p50 and the busy share printed; the serve CLI's
              ``--record-trace`` then ``--replay`` twice, one digest.  (c)
              phase 5's load with and without telemetry: tick wall p50 of
              each, and two warm decode ticks under
              ``torch.cuda.set_sync_debug_mode("warn")``: the same
              synchronising calls, none in the observability package.
 15. families the MoE, multimodal-prefix and hybrid families, at full
              width, depth cut only as far as the card's memory forces.
              (a) 2 layers, f32, on the card against the CPU plain path:
              phi3.5-moe's ``moe_apply`` on a 256-token chunk and on 8
              decode rows (expert choices and kept masks equal, output
              within 1e-4 of its scale), its ``Engine`` with 4 requests x
              8 tokens, plain and with a 2-circuit bank (equal streams, a
              parting only at a top-2 tie); llama4-maverick (G 5) and
              llava-next-34b (G 7), a prefill of 576 patches + 64 text
              tokens and 4 decode steps (logits within 1e-4).  (b)
              phi3.5-moe, 16 of 32 layers, bf16, phase 5's load: every
              request finishes, both paged kernels once a layer a tick on
              phase 5's routes; tok/s, TTFT, latency, peak memory and a
              profiled decode tick's expert-FFN share; then a 4-circuit
              bank ("moe" masks) on the same load.  (c) phi3.5-moe, 2
              layers, train 3 steps at 2 x 1024 (f32 masters, bf16,
              AdamW, Horn 4 groups): finite losses near ln(vocab), flash
              launches, router losses and dropped fraction.  (d)
              llama4-maverick (48 layers) and llava-next-34b (60), bf16:
              a prefill of 576 patches + 1472 text tokens through
              ``make_prefill_step``, 16 greedy decode steps; flash once a
              layer at the prefill, on its bf16 kernel.  (e)
              jamba-1.5-large, 5 of 72 layers (M M M M A, MoE at 1 and 3):
              the same prefill (2048 text tokens) and decode, the SSD
              kernel 4 times on ``wgmma`` at state 16 and never in decode;
              then each scan and the flash call of that prefill against
              its plain version on the inputs the model gave it, with a
              broken result that each check must reject.
 16. encdec   whisper-base (encoder-decoder).  (a) 2 + 2 layers at full
              width, f32, the same weights and seeded frames on the card
              and on the CPU plain path: the loss, a prefill's logits and
              encoder output and 4 greedy decode steps' logits within
              1e-4.  (b) ``launch.train`` at full size (6 + 6 layers),
              bf16 compute, f32 masters, Horn 4 groups, AdamW, 4 steps of
              16 x 448 decoder tokens beside 1536 seeded bf16 frames:
              finite losses near ln(vocab), flash launched 2 x 12 times a
              step forward (remat) and 12 backward, every launch on
              ``wgmma_d64`` (none for cross-attention); step wall, tok/s,
              busy share, peak memory.  (c) a prefill of 8 x (1536 frames
              + 64 tokens) and 32 greedy decode steps: flash once a layer
              at the prefill on ``wgmma_d64``, never in decode; prefill
              wall, decode step time.  (d) each flash call of (c)'s
              prefill against the plain attention on its inputs, each
              check rejecting a flipped mask and rolled KV heads.
 17. scale    scale-out on ``torch.distributed``, over one NCCL process
              group of one rank (a ``file://`` store in a temp dir; NCCL
              takes one rank per device, so every multi-rank check is the
              CPU tests' job, ``tests/test_torch_distributed.py``).  (a)
              ``psum_mean``, ``merge_grads`` (none and int8) and
              ``psum_mean_compressed`` over the gradients of one
              full-width qwen3-1.7b train step: the f32 cast and the
              dequantized error-feedback value bit for bit; bytes and the
              all-reduce's time.  (b) phase 6's run (qwen3-1.7b, 28
              layers, 8 x 1024, Horn 4 groups, AdamW, remat) mesh-free,
              then its state through ``remesh_state`` onto a 1 x 1
              ``DeviceMesh`` and 4 steps of ``make_train_step(mesh=)``:
              losses and grad norms bit-equal, flash 2 x 28 forward and 28
              backward a step on ``wgmma_d128``, both step walls.  (c) at
              2 layers (full width): save after step 2, restore with
              ``shardings=`` onto a fresh 1 x 1 mesh, steps 3-4 bit-equal
              to the unbroken run's.  (d) ``pipelined_apply`` (S 1) over
              the 28 bf16 blocks as one stage, M 8 micro-batches of 1 x
              1024: forward and gradients against the unpipelined stack
              within 2e-2; ``bubble_fraction(4, 8)``.  (e) ``launch.train
              --full-config --steps 2 --horn-groups 4`` with ``--topology
              zero1``, then ``--topology local_sgd --mesh-data 2``: the
              1 x 1 mesh line, finite losses.
 18. analysis the analysis tooling (``repro_torch.analysis``).  (a) the
              launch-geometry models against the launches: every route of
              the five kernels at hornshape's cases, at phase 8's timing
              shapes and at the engine's serving geometry, under
              torch.profiler; each launch's grid, block and shared memory
              (static + dynamic) in the Chrome trace equal its model's
              (the trace carries no cluster: the decode launcher sets it
              to (gridDim.x, 1, 1), which the grid check covers); launches
              compared by route.  (b) guard-band probes: every operand a
              16-byte-aligned view inside NaN bands (0, the null page, for
              the tables and per-slot arrays; 127 for int8 pools), every
              output allocated inside NaN bands and pre-filled with NaN;
              after each route the bands are unchanged, the outputs finite
              and equal to the plain version's on clean inputs; dead
              block-table entries (and a window's pages before its first
              visible key) point at a NaN-filled null page; two controls
              must be rejected (a live entry at the NaN page, a pool view
              shifted so its last page lies in the band).  (c) ``serve
              --sanitize`` at full width on phase 5's load: bf16 pools,
              int8 pools, speculation at K 4, each 0 alerts over its tick
              count; controls at 2 layers: a lost table (pool-leak), a
              stale device row (block-table), a NaN in one layer's wo
              (the guard names the op), a [B, S, d] + [d] add (the rank
              guard).  (d) the sanitized tick's wall against phase 5's,
              and the hornlint and hornshape CLIs' walls (their ``main``
              in this process; each exits 0).
Phase 3 also holds the SSD chunk scan against its plain version (y and the
final state): the JAX sweep's shapes, S 257 (chunks of 1 token), two more
shapes of the wgmma route and the full-width shape B 2, S 2048, H 80, P
64, N 128, chunk 256, f32 and bf16, each on the route ``kernel.route``
gives it (bf16 at Q % 64 == 0 on the wgmma kernel, the rest on the
CUDA-core one), printed and asserted by its launch count, and jamba-1.5-
large's B 1, S 2048, H 256, P 64, N 16, chunk 256; then the wgmma kernel
again with dt at 0, 1e-30 and -0.05 on some tokens.
Phase 8 reads the paged kernels by device time over windows of 50 calls
profiled after a warm-up run (``device_ms``): a window must hold 50
launches of the timed kernel and read at least its bound, else it is
profiled again and, after three tries, read by CUDA events.
Prints one JSON line of kernel numbers, then, as the last line,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12            # H100 SXM device memory rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # f32 CUDA cores; bf16
TPU_KERNEL = "src/repro/kernels/paged_attention/kernel.py:264"
DECODE_TPU_KERNEL = "src/repro/kernels/paged_attention/kernel.py:349"
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention/kernel.py:85"
DM_TPU_KERNEL = "src/repro/kernels/dropout_matmul/kernel.py:48"
SSD_TPU_KERNEL = "src/repro/kernels/ssd/kernel.py:65"
TRAIN_STEPS = 4
SSM_BATCH, SSM_SEQ, SSM_DECODE = 4, 2048, 32    # the ssm phase's prefill
# phase 16, whisper-base: frames an utterance (the config's encoder_seq),
# the train step's batch x decoder tokens, the prefill's batch x prompt
# and its greedy decode steps
ENCDEC_FRAMES = 1536
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 16, 448
ENCDEC_PREFILL_BATCH, ENCDEC_PROMPT, ENCDEC_DECODE = 8, 64, 32
# the int8 serve phase: phase 5's load on a bf16 pool of this many pages
# (its peak is 49, so it preempts), against int8 pools of the same bytes
INT8_SERVE_BF16_PAGES = 28


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs of the paged-attention kernel
# ---------------------------------------------------------------------------
def paged_case(torch, dev, dtype, *, B, H, KH, D, psize, maxp, C, seed,
               idle=True):
    """Disjoint pages per slot, ragged starts, slot 0 a full chunk, the
    others partial, the last slot idle; dead block-table entries poisoned
    far outside the pool."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    gen = torch.Generator(dev).manual_seed(seed)
    q = torch.randn(B, C, H, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, psize, KH, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, psize, KH, D, generator=gen, device=dev).to(dtype)
    bt = np.full((B, maxp), 999_999, np.int32)
    starts = np.zeros(B, np.int32)
    clens = np.zeros(B, np.int32)
    for b in range(B):
        starts[b] = rng.integers(0, maxp * psize - C + 1)
        clens[b] = C if b == 0 else rng.integers(0 if idle else 1, C + 1)
        if idle and b == B - 1:
            clens[b] = 0
        live = max(1, -(-(int(starts[b]) + int(clens[b])) // psize))
        bt[b, :live] = 1 + b * maxp + np.arange(live)
    ints = [torch.from_numpy(a).to(dev) for a in (bt, starts, clens)]
    return (q, kp, vp, *ints), clens


def quantize_pools(torch, kp, vp):
    """int8 pools of ``kp``/``vp`` with their [P, KH] f32 scales, one per
    (page, kv head), as the int8 serving cache holds them."""
    from repro_torch.optim.compression import quantize_int8

    (kq, ks), (vq, vs) = (quantize_int8(x.float(), axis=(1, 3))
                          for x in (kp, vp))
    return kq, vq, {"k_scale": ks[:, 0, :, 0].contiguous(),
                    "v_scale": vs[:, 0, :, 0].contiguous()}


def phase_kernels(torch, dev, kernel, ref, build):
    """The chunk kernel against its plain version, pools of q's dtype and
    int8 pools (q f32 or bf16); each case again with a ``logit_index`` of
    4 chunk positions a slot (valid and padding rows), whose window rows
    must match the plain version's.  Returns the largest error."""
    geoms = {
        "qwen3-1.7b": dict(B=8, H=16, KH=8, D=128, psize=16, maxp=40, kw={}),
        "gemma2-27b": dict(B=8, H=32, KH=16, D=128, psize=16, maxp=38,
                           kw={"window": 64, "softcap": 50.0}),
        "qwen1.5-4b": dict(B=8, H=20, KH=20, D=128, psize=16, maxp=40,
                           kw={}),
        "gemma3-4b": dict(B=8, H=8, KH=4, D=256, psize=16, maxp=40,
                          kw={"window": 64}),
        "phi3.5-moe": dict(B=8, H=32, KH=8, D=128, psize=16, maxp=40,
                           kw={}),
    }
    tol = {"float32": 2e-5, "bfloat16": 2e-2}
    worst = 0.0
    for name, g in geoms.items():
        kw0 = dict(g.pop("kw"), scale=g["D"] ** -0.5)
        for pools in ("native", "int8"):
            for dtype in ("float32", "bfloat16"):
                for C in (1, 7, 64, 256):
                    args, clens = paged_case(
                        torch, dev, getattr(torch, dtype), C=C, seed=C, **g)
                    kw = dict(kw0)
                    if pools == "int8":
                        kq, vq, scales = quantize_pools(torch, *args[1:3])
                        args = (args[0], kq, vq, *args[3:])
                        kw.update(scales)
                    build.reset_launches()
                    got = kernel.paged_chunk_attention(*args, **kw)
                    want = ref.paged_chunk_attention_ref(*args, **kw)
                    rng = np.random.default_rng(C)
                    widx = torch.from_numpy(rng.integers(
                        0, C, size=(g["B"], 4)).astype(np.int32)).to(dev)
                    got_w = kernel.paged_chunk_attention(
                        *args, **kw, logit_index=widx)[1]
                    want_w = ref.paged_chunk_attention_ref(
                        *args, **kw, logit_index=widx)[1]
                    torch.cuda.synchronize()
                    routes = [k.split(":")[1] for k, v in
                              build.ROUTE_LAUNCHES.items()
                              if k.startswith(kernel.NAME + ":") and v]
                    want_route = kernel.chunk_route(
                        args[0].dtype, pools == "int8", g["D"], g["psize"],
                        g["H"] // g["KH"])
                    assert routes == [want_route], (routes, want_route)
                    err = max((x.float() - y.float()).abs().max().item()
                              for x, y in ((got, want), (got_w, want_w)))
                    worst = max(worst, err)
                    for x, y in ((got, want), (got_w, want_w)):
                        torch.testing.assert_close(
                            x.float(), y.float(), atol=tol[dtype],
                            rtol=tol[dtype])
                    for b, cl in enumerate(clens):
                        assert torch.all(got[b, int(cl):] == 0), (name, C, b)
                    log(f"  {name:11s} {pools:6s} pools, q {dtype:8s} "
                        f"C={C:3d} ({want_route:10s}): max |kernel - plain| "
                        f"= {err:.3g} with the window (tol {tol[dtype]:g})")
    return worst


def decode_case(torch, dev, dtype, *, B, H, KH, D, psize, maxp, seed,
                int8):
    """Decode inputs: disjoint pages per slot, slot 0 at the full table,
    the others at lengths that straddle pages, the last slot empty (length
    0); dead block-table entries poisoned far outside the pool."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    gen = torch.Generator(dev).manual_seed(seed)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    kp, vp = (torch.randn(P, psize, KH, D, generator=gen, device=dev)
              for _ in range(2))
    scales = {}
    if int8:
        kp, vp, scales = quantize_pools(torch, kp, vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    bt = np.full((B, maxp), 999_999, np.int32)
    lengths = rng.integers(1, maxp * psize + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = maxp * psize, 0
    for b in range(B):
        live = -(-int(lengths[b]) // psize)
        bt[b, :live] = 1 + b * maxp + np.arange(live)
    return (q, kp, vp, torch.from_numpy(bt).to(dev),
            torch.from_numpy(lengths).to(dev)), scales


def phase_decode_kernels(torch, dev, kernel, ref):
    """The decode kernel against its plain version, and against the chunk
    kernel at C == 1 (starts = lengths - 1, chunk_lens = 1; a length-0
    slot as an idle row): MHA, GQA, MQA with 16 heads on one kv head (two
    row groups), qwen3-1.7b's and gemma2-27b's decode geometries; plain,
    window and softcap; pools of q's dtype and int8; q f32 and bf16.
    Tolerance f32 2e-5, bf16 2e-2 against both (summation order; one bf16
    ulp at |x| ~ 1 is 7.8e-3).  Returns the largest error of each check."""
    geoms = {
        "MHA": dict(B=3, H=4, KH=4, D=32, psize=8, maxp=5),
        "GQA": dict(B=3, H=8, KH=2, D=64, psize=16, maxp=6),
        "MQA": dict(B=2, H=16, KH=1, D=128, psize=16, maxp=10),
        "qwen3-1.7b": dict(B=8, H=16, KH=8, D=128, psize=16, maxp=40),
        "gemma2-27b": dict(B=8, H=32, KH=16, D=128, psize=16, maxp=38),
        "qwen1.5-4b": dict(B=8, H=20, KH=20, D=128, psize=16, maxp=40),
        "gemma3-4b": dict(B=8, H=8, KH=4, D=256, psize=16, maxp=40),
        "phi3.5-moe": dict(B=8, H=32, KH=8, D=128, psize=16, maxp=40),
    }
    variants = {"plain": {}, "window": {"window": 64},
                "softcap": {"softcap": 50.0}}
    from repro_torch.kernels import build

    tol = {"float32": 2e-5, "bfloat16": 2e-2}
    worst = {"plain": 0.0, "chunk_c1": 0.0}
    for name, g in geoms.items():
        splits = kernel.decode_splits(g["B"], g["KH"], g["H"] // g["KH"],
                                      g["maxp"], kernel.sm_count(dev.index))
        route = f"{kernel.NAME_DECODE}:{kernel.decode_route(splits)}"
        for pools in ("native", "int8"):
            for dtype in ("float32", "bfloat16"):
                errs = {"plain": 0.0, "chunk_c1": 0.0}
                for i, (vname, vkw) in enumerate(variants.items()):
                    args, scales = decode_case(
                        torch, dev, getattr(torch, dtype), seed=i,
                        int8=pools == "int8", **g)
                    kw = dict(vkw, scale=g["D"] ** -0.5, **scales)
                    q, kp, vp, bt, lengths = args
                    build.reset_launches()
                    got = kernel.paged_attention(*args, **kw)
                    assert build.ROUTE_LAUNCHES.get(route) == 1, route
                    want = ref.paged_attention_ref(*args, **kw)
                    live = (lengths > 0).to(torch.int32)
                    chk = kernel.paged_chunk_attention(
                        q[:, None].contiguous(), kp, vp, bt,
                        (lengths - 1) * live, live, **kw)[:, 0]
                    torch.cuda.synchronize()
                    assert torch.all(got[-1] == 0), (name, vname)
                    for what, w in (("plain", want), ("chunk_c1", chk)):
                        errs[what] = max(errs[what], (got.float() - w.float())
                                         .abs().max().item())
                        torch.testing.assert_close(
                            got.float(), w.float(), atol=tol[dtype],
                            rtol=tol[dtype], msg=lambda m: f"{name} {pools} "
                            f"{dtype} {vname} vs {what}: {m}")
                for k in worst:
                    worst[k] = max(worst[k], errs[k])
                log(f"  decode {name:11s} {pools:6s} pools, q {dtype:8s} "
                    f"NS {splits:2d} plain/window/softcap: max |kernel - "
                    f"plain| = "
                    f"{errs['plain']:.3g}, |kernel - chunk kernel at C=1| = "
                    f"{errs['chunk_c1']:.3g} (tol {tol[dtype]:g})")
    return worst


def flash_case(torch, dev, dtype, B, H, KH, S, D, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(B, h, S, D, generator=gen, device=dev).to(dtype)
            for h in (H, KH, KH, H)]                  # q, k, v, dO


def phase_flash_kernels(torch, dev, fkernel, fref):
    """Forward (o) and backward (dq, dk, dv) kernels against the plain
    version and torch autograd through it, same dO.  f32: atol/rtol 1e-4
    (summation order over up to 2048 keys); bf16 inputs and outputs,
    compared in f32: atol/rtol 2e-2 (both sides compute in f32 and round
    once; one bf16 ulp at |x| ~ 1 is 7.8e-3).  gemma3-4b's head dim 256
    runs at S up to 2048, so its window of 1024 masks."""
    geoms = {
        "qwen3-1.7b": dict(H=16, KH=8, D=128, scale=128 ** -0.5, variants={
            "causal": {}, "window": {"window": 64},
            "softcap": {"softcap": 50.0}, "non-causal": {"causal": False}}),
        "gemma2-27b": dict(H=32, KH=16, D=128, scale=144.0 ** -0.5,
                           variants={
            "causal": {}, "window": {"window": 64},
            "softcap": {"softcap": 50.0}, "non-causal": {"causal": False},
            "local": {"window": 64, "softcap": 50.0}}),
        "gemma3-4b": dict(H=8, KH=4, D=256, scale=256 ** -0.5,
                          lengths=(1, 7, 256, 2048), variants={
            "causal": {}, "window": {"window": 64},
            "local": {"window": 1024}, "softcap": {"softcap": 50.0},
            "non-causal": {"causal": False}}),
        # G = H / KH of 4, 5, 7 and 8: phi3.5-moe's train step (S 1024),
        # llama4-maverick's and llava-next-34b's prefill and train steps,
        # jamba-1.5-large's prefill (S 2048); all causal
        "phi3.5-moe": dict(H=32, KH=8, D=128, scale=128 ** -0.5,
                           lengths=(1, 7, 256, 1024, 2048),
                           variants={"causal": {}}),
        "llama4-maverick": dict(H=40, KH=8, D=128, scale=128 ** -0.5,
                                lengths=(1, 7, 256, 2048),
                                variants={"causal": {}}),
        "llava-next-34b": dict(H=56, KH=8, D=128, scale=128 ** -0.5,
                               lengths=(1, 7, 256, 2048),
                               variants={"causal": {}}),
        "jamba-1.5-large": dict(H=64, KH=8, D=128, scale=128 ** -0.5,
                                lengths=(1, 7, 256, 2048),
                                variants={"causal": {}}),
        # whisper-base: D 64 at G 1, the encoder non-causal over its 1536
        # frames, the decoder causal (phase 16 trains at 448 tokens)
        "whisper-base": dict(H=8, KH=8, D=64, scale=64 ** -0.5,
                             lengths=(1, 7, 448, 1536),
                             variants={"causal": {},
                                       "non-causal": {"causal": False}}),
    }
    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    worst = 0.0
    for name, g in geoms.items():
        lengths = g.get("lengths", (1, 7, 256, 1024))
        for dtype in ("float32", "bfloat16"):
            errs = {}
            for vname, vkw in g["variants"].items():
                for S in lengths:
                    q, k, v, do = flash_case(torch, dev, getattr(torch, dtype),
                                             2, g["H"], g["KH"], S, g["D"],
                                             seed=S)
                    kw = dict(dict(causal=True, scale=g["scale"]), **vkw)
                    o, lse = fkernel.flash_attention_fwd(q, k, v, **kw)
                    grads = fkernel.flash_attention_bwd(q, k, v, o, lse, do,
                                                        **kw)
                    leaves = [t.clone().requires_grad_(True)
                              for t in (q, k, v)]
                    want = fref.attention_ref(*leaves, **kw)
                    wgrads = torch.autograd.grad(want, leaves, do)
                    torch.cuda.synchronize()
                    for what, got, w in zip(("o", "dq", "dk", "dv"),
                                            (o, *grads), (want, *wgrads)):
                        err = (got.float() - w.float()).abs().max().item()
                        errs[what] = max(errs.get(what, 0.0), err)
                        torch.testing.assert_close(
                            got.float(), w.float(), atol=tol[dtype],
                            rtol=tol[dtype],
                            msg=lambda m: f"{name} {vname} S={S} {what}: {m}")
                    del leaves, want, wgrads, grads
            worst = max([worst] + list(errs.values()))
            log(f"  flash {name:15s} D {g['D']} G {g['H'] // g['KH']} "
                f"{dtype:8s} "
                f"{len(g['variants'])} variants x S "
                f"{'/'.join(map(str, lengths))}: max |kernel - plain| "
                + " ".join(f"{k} {e:.3g}" for k, e in errs.items())
                + f" (tol {tol[dtype]:g})")
    return worst


# (G, M, K, N, block_n): the JAX sweep (tests/test_kernels.py) plus a
# ragged shape whose K has no tensor map (the mma.sync kernel's), and the
# Horn MLP's up/gate product at qwen3-1.7b width, 4 groups of 2 x 1024
# tokens
DM_SWEEP = [(1, 128, 128, 128, 128), (2, 256, 128, 512, 128),
            (4, 128, 256, 256, 64), (3, 128, 384, 640, 128),
            (2, 7, 13, 128, 64)]
DM_FULL = (4, 2048, 2048, 6144, 128)


def dm_inputs(torch, dev, dtype, G, M, K, N, seed):
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(G, M, K, generator=gen, device=dev).to(dtype)
    w = torch.randn(K, N, generator=gen, device=dev).to(dtype)
    return x, w, gen


def phase_dropout_kernels(torch, dev, dkernel, dref, build):
    """The kernel against the plain version with the JAX sweep's
    tolerances: atol tol * sqrt(K), rtol tol, tol 1e-4 in f32 and 0.15 in
    bf16.  Masks in {0, 2}: random (each block live with probability 0.5)
    on every shape; at full width also all dropped (the output must be
    exactly 0), all live, and group 0 with a single live block.  The last
    sweep shape (K 13) takes the mma.sync kernel in bf16, the others the
    wgmma kernel; f32 takes the CUDA-core kernel."""
    tol = {"float32": 1e-4, "bfloat16": 0.15}
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        errs = []
        build.reset_launches()
        for i, (G, M, K, N, bn) in enumerate(DM_SWEEP + [DM_FULL]):
            x, w, gen = dm_inputs(torch, dev, getattr(torch, dtype), G, M, K,
                                  N, seed=i)
            nb = N // bn
            masks = {"random": 2.0 * (torch.rand(G, nb, generator=gen,
                                                 device=dev) < 0.5).float()}
            if (G, M, K, N, bn) == DM_FULL:
                one = torch.full((G, nb), 2.0, device=dev)
                one[0] = 0.0
                one[0, nb // 3] = 2.0
                masks.update(dropped=torch.zeros(G, nb, device=dev),
                             live=torch.full((G, nb), 2.0, device=dev),
                             one_block=one)
            for mname, mask in masks.items():
                got = dkernel.dropout_matmul(x, w, mask, block_n=bn)
                want = dref.dropout_matmul_ref(x, w, mask, block_n=bn)
                torch.cuda.synchronize()
                errs.append((got - want).abs().max().item())
                torch.testing.assert_close(
                    got, want, atol=tol[dtype] * K ** 0.5, rtol=tol[dtype],
                    msg=lambda m: f"{(G, M, K, N, bn)} {mname}: {m}")
                if mname == "dropped":
                    assert torch.all(got == 0), "dropped tiles not zero"
                del got, want
        worst = max([worst] + errs)
        routes = {k.split(":")[1]: v for k, v in build.ROUTE_LAUNCHES.items()
                  if k.startswith(dkernel.NAME + ":") and v}
        want = ({"f32": len(errs)} if dtype == "float32" else
                {"wgmma": len(errs) - 1, "mma_sync": 1})
        assert routes == want, (routes, want)
        log(f"  dropout_matmul {dtype:8s} {len(DM_SWEEP)} sweep shapes + "
            f"full width x 4 masks: max |kernel - plain| = {max(errs):.3g} "
            f"(tol {tol[dtype]:g} * sqrt(K)); launches by kernel {routes}")
    return worst


# (B, S, H, P, N, chunk): the JAX sweep (tests/test_kernels.py), S 257 at
# the published chunk (257 is prime: chunks of 1 token), shapes of the
# wgmma route's other P and N (N <= 64 on its 64-column tiles), and
# mamba2-2.7b's SSD at full width.  bf16 takes the wgmma kernel where
# ``kernel.route`` says so (Q % 64 == 0, P and N multiples of 16), f32 and
# the rest the CUDA-core one.
SSD_SWEEP = [(1, 64, 2, 16, 16, 16), (2, 128, 3, 16, 32, 32),
             (1, 256, 1, 32, 64, 64), (1, 257, 4, 64, 128, 256),
             (2, 256, 3, 16, 16, 64), (1, 512, 4, 48, 96, 128)]
SSD_FULL = (2, 2048, 80, 64, 128, 256)
# jamba-1.5-large's SSD (d_inner 16384 in heads of 64, state 16) at the
# prefill of phase 15
SSD_JAMBA = (1, 2048, 256, 64, 16, 256)
# shapes of the wgmma route held again with dt at 0, tiny and negative
SSD_EDGE_DT = [(1, 512, 4, 48, 96, 128), SSD_FULL, SSD_JAMBA]


def ssd_inputs(torch, dev, dtype, B, S, H, P, N, seed):
    """x, dt, A, Bm, Cm drawn as the JAX sweep draws them: x, B, C normal
    x 0.5 (x, B, C in ``dtype``), dt = |normal| + 0.1, A = -(|normal| +
    0.5), dt and A f32."""
    gen = torch.Generator(dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = (normal(B, S, H, P) * 0.5).to(dtype)
    dt = normal(B, S, H).abs() + 0.1
    A = -(normal(H).abs() + 0.5)
    Bm = (normal(B, S, N) * 0.5).to(dtype)
    Cm = (normal(B, S, N) * 0.5).to(dtype)
    return x, dt, A, Bm, Cm


def phase_ssd_kernels(torch, dev, skernel, sref, build):
    """y and the final state against the plain version on the same inputs,
    on the route ``kernel.route`` gives each shape (asserted by the launch
    count of that route).  The CUDA-core kernel computes in f32 from the
    same (bf16-rounded) values and differs in summation order only; the
    wgmma kernel feeds each f32 operand as two bf16 terms (~2^-16
    relative).  atol 2e-4 / rtol 1e-3, the JAX tests' tolerance, at every
    shape and in both dtypes."""
    from repro_torch.kernels.ssd.ref import chunk_len
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        errs, routes = [], []
        for i, (B, S, H, P, N, chunk) in enumerate(
                SSD_SWEEP + [SSD_FULL, SSD_JAMBA]):
            args = ssd_inputs(torch, dev, getattr(torch, dtype), B, S, H, P,
                              N, seed=i)
            how = skernel.route(args[0].dtype, P, N, chunk_len(chunk, S))
            key = f"{skernel.NAME}:{how}"
            before = build.ROUTE_LAUNCHES.get(key, 0)
            y, st = skernel.ssd_chunk_scan(*args, chunk=chunk)
            assert build.ROUTE_LAUNCHES.get(key, 0) == before + 1, key
            routes.append(how)
            y_want, st_want = sref.ssd_chunk_scan_ref(*args, chunk=chunk)
            torch.cuda.synchronize()
            for what, got, want in (("y", y, y_want), ("state", st, st_want)):
                assert torch.isfinite(got).all(), (B, S, H, what)
                errs.append((got - want).abs().max().item())
                torch.testing.assert_close(
                    got, want, atol=2e-4, rtol=1e-3,
                    msg=lambda m: f"{(B, S, H, P, N, chunk)} {how} {what}: "
                                  f"{m}")
            log(f"    {dtype:8s} {(B, S, H, P, N, chunk)}: route {how}, max "
                f"|kernel - plain| y {errs[-2]:.3g}, state {errs[-1]:.3g}")
            del args, y, st, y_want, st_want
        worst = max([worst] + errs)
        log(f"  ssd_chunk_scan {dtype:8s} {len(SSD_SWEEP)} sweep shapes + "
            f"full width {SSD_FULL} (mamba2-2.7b) and {SSD_JAMBA} "
            f"(jamba-1.5-large): max |kernel - plain| = {max(errs):.3g}"
            f" (tol 2e-4 + 1e-3 |y|); routes "
            + ", ".join(f"{r} x{routes.count(r)}" for r in sorted(set(routes))))
    # any finite dt: the wgmma kernel multiplies by dt after the exponent
    errs = []
    for i, (B, S, H, P, N, chunk) in enumerate(SSD_EDGE_DT):
        args = list(ssd_inputs(torch, dev, torch.bfloat16, B, S, H, P, N,
                               seed=40 + i))
        dt = args[1]
        dt[:, 0::5] = 0.0
        dt[:, 3::7] = 1e-30
        dt[:, 1::11] = -0.05
        key = f"{skernel.NAME}:wgmma"
        before = build.ROUTE_LAUNCHES.get(key, 0)
        y, st = skernel.ssd_chunk_scan(*args, chunk=chunk)
        assert build.ROUTE_LAUNCHES.get(key, 0) == before + 1, key
        y_want, st_want = sref.ssd_chunk_scan_ref(*args, chunk=chunk)
        torch.cuda.synchronize()
        for what, got, want in (("y", y, y_want), ("state", st, st_want)):
            assert torch.isfinite(got).all(), (B, S, H, what)
            errs.append((got - want).abs().max().item())
            torch.testing.assert_close(
                got, want, atol=2e-4, rtol=1e-3,
                msg=lambda m: f"dt 0 / 1e-30 / -0.05 {(B, S, H, P, N, chunk)}"
                              f" {what}: {m}")
        del args, dt, y, st, y_want, st_want
    log(f"  ssd_chunk_scan bfloat16 wgmma, dt 0 / 1e-30 / -0.05 on some "
        f"tokens, {SSD_EDGE_DT}: max |kernel - plain| = {max(errs):.3g} "
        f"(tol 2e-4 + 1e-3 |y|)")
    return max([worst] + errs)


# ---------------------------------------------------------------------------
# phase 4: paged engine vs a plain non-paged recompute
# ---------------------------------------------------------------------------
def dense_logits(torch, params, cfg, tokens):
    """Last-position logits of a full causal forward over ``tokens`` (no
    pages, no kernel): the plain reference for the paged engine."""
    from repro_torch.configs.base import LOCAL
    from repro_torch.models import layers as L
    from repro_torch.models.attention import _project_qkv

    dev = params.embed.embedding.device
    tok = torch.tensor([tokens], device=dev)
    x = L.embed_apply(params.embed, tok, cfg)
    S = tok.shape[1]
    pos = torch.arange(S, device=dev)[None, :]
    for bp, kind in zip(params.layers, cfg.layer_kinds()):
        window = cfg.sliding_window if kind == LOCAL else None
        theta = 10_000.0 if (kind == LOCAL and cfg.rope_theta > 1e5) \
            else cfg.rope_theta
        h = L.norm_apply(bp.pre_norm, x, cfg)
        q, k, v = _project_qkv(bp.attn, h, h, cfg, pos, use_rope=cfg.use_rope,
                               rope_theta=theta)
        G = cfg.num_heads // cfg.num_kv_heads
        qg = q.reshape(1, S, cfg.num_kv_heads, G, -1).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
        s = s * (cfg.query_scale or cfg.head_dim ** -0.5)
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            s = torch.tanh(s / c) * c
        qp, kp = pos[0][:, None], pos[0][None, :]
        masked = kp > qp
        if window is not None:
            masked = masked | (kp <= qp - window)
        p = torch.softmax(s.masked_fill(masked, float("-inf")), dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
        out = out.reshape(q.shape).to(q.dtype)
        out = L.mm("bshk,hkd->bsd", out, bp.attn.wo, x.dtype)
        if cfg.post_sublayer_norm:
            out = L.norm_apply(bp.post_mixer_norm, out, cfg)
        x = x + out.to(x.dtype)
        h = L.norm_apply(bp.ffn_norm, x, cfg)
        out = L.mlp_apply(bp.mlp, h, cfg)
        if cfg.post_sublayer_norm:
            out = L.norm_apply(bp.post_ffn_norm, out, cfg)
        x = x + out.to(x.dtype)
    x = L.norm_apply(params.final_norm, x[:, -1:], cfg)
    return L.unembed_apply(params.embed, x, cfg)[0, 0]


def phase_parity(torch, dev):
    from repro_torch.configs.base import get_model_config
    from repro_torch.models.params import init_params
    from repro_torch.serving import Engine, EngineConfig

    cfg = dataclasses.replace(get_model_config("qwen3-1.7b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, 1234, device=dev, dtype=torch.float32)
    max_new = 8
    ecfg = EngineConfig(num_slots=4, num_pages=64, page_size=16,
                        max_prompt_len=64, max_new_tokens=max_new,
                        token_budget=16, policy="on_demand",
                        kv_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 23, 40, 61)]
    eng = Engine(cfg, params, ecfg, device=dev)
    for p in prompts:
        eng.submit(p, max_new)
    got = {r.id: list(r.out_tokens) for r in eng.run()}
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            toks = [int(t) for t in p]
            want = []
            for _ in range(max_new):
                want.append(int(torch.argmax(
                    dense_logits(torch, params, cfg, toks + want))))
            assert got[i] == want, f"request {i}: paged {got[i]} != " \
                                   f"dense {want}"
    log(f"  {len(prompts)} requests (prompts {[len(p) for p in prompts]}, "
        f"budget {ecfg.token_budget}: {eng.stats.steps} ticks, "
        f"{eng.stats.prefill_tokens} prefill tokens): paged streams == "
        f"dense recompute")
    eng.pool.check_invariants()
    return phase_parity_int8(torch, dev, cfg, params, ecfg, prompts, max_new)


def phase_parity_int8(torch, dev, cfg, params, ecfg, prompts, max_new):
    """The same engine with int8 pools on the card (both paged kernels)
    and on the CPU (the plain versions), same weights: the greedy streams
    are compared token by token.  Quantize-on-append rounds K/V that
    differ in the last bit between the two devices' GEMMs to neighbouring
    int8 values now and then, so a stream may part; the first parting
    token is printed, not asserted."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.serving import Engine

    ecfg = dataclasses.replace(ecfg, kv_dtype="int8")
    streams = {}
    for where, p in (("card", params), ("cpu", copy.deepcopy(params).to(
            "cpu"))):
        eng = Engine(cfg, p, ecfg, device=dev if where == "card" else "cpu")
        for prompt in prompts:
            eng.submit(prompt, max_new)
        build.reset_launches()
        streams[where] = {r.id: list(r.out_tokens) for r in eng.run()}
        eng.pool.check_invariants()
        assert all(len(t) == max_new for t in streams[where].values())
        if where == "card":
            s = eng.stats
            assert s.decode_launches == cfg.num_layers * s.decode_ticks > 0
            assert build.LAUNCHES[kernel.NAME_DECODE] == s.decode_launches
            assert build.LAUNCHES[kernel.NAME] + s.decode_launches == \
                cfg.num_layers * s.steps
        del eng
    card, cpu = streams["card"], streams["cpu"]
    same = sum(a == b for i in card for a, b in zip(card[i], cpu[i]))
    total = sum(len(t) for t in card.values())
    first = next(((i, j, card[i][j], cpu[i][j]) for i in sorted(card)
                  for j in range(max_new) if card[i][j] != cpu[i][j]), None)
    if first is None:
        log(f"  int8 pools: streams on the card == streams of the CPU plain "
            f"path ({total} tokens)")
    else:
        log(f"  int8 pools: {same}/{total} tokens equal card vs CPU plain "
            f"path; first parting: request {first[0]} token {first[1]} "
            f"(card {first[2]}, CPU {first[3]})")
    return {"int8_tokens": total, "int8_equal": same,
            "int8_first_parting": first}


# ---------------------------------------------------------------------------
# phase 5: the serving path
# ---------------------------------------------------------------------------
def phase_serve(torch, dev, build, kernel, arch="qwen3-1.7b", cfg=None):
    """``arch`` at full width (``cfg``: a config of it cut in depth), bf16
    weights from seed 0, serving phase 5's load through ``Engine``: every
    request finishes, every tick launches one paged kernel a layer, every
    chunk launch on the route ``kernel.chunk_route`` gives the arch's bf16
    q over bf16 pools and every decode launch on the split rule's
    route."""
    from repro_torch.configs.base import get_model_config
    from repro_torch.launch.serve import drive, make_requests, summarize
    from repro_torch.models import api
    from repro_torch.models.params import init_params
    from repro_torch.models import transformer as T
    from repro_torch.serving import Engine, EngineConfig

    cfg = cfg or get_model_config(arch)
    params = init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    gen = 32
    ecfg = EngineConfig(num_slots=8, num_pages=512, page_size=16,
                        max_prompt_len=256, max_new_tokens=gen,
                        token_budget=256, policy="on_demand",
                        kv_dtype="bfloat16", compute_dtype="bfloat16")
    eng = Engine(cfg, params, ecfg, device=dev)
    rng = np.random.default_rng(0)
    # warm up the same engine (cuBLAS handles, allocator), then measure
    drive(eng, [(0.0, p, 4) for _, p, _ in
                make_requests(2, cfg.vocab_size, rng, stream="batch",
                              max_prompt=256, gen=4)])
    eng.reset_stats()
    pending = [(0.0, p, gen) for _, p, _ in
               make_requests(16, cfg.vocab_size, rng, stream="batch",
                             max_prompt=256, gen=gen)]
    build.reset_launches()
    wall = drive(eng, pending)
    launches = {n: build.LAUNCHES[n] for n in (kernel.NAME,
                                               kernel.NAME_DECODE)}
    chunk_route = kernel.chunk_route(
        torch.bfloat16, False, cfg.head_dim, ecfg.page_size,
        cfg.num_heads // cfg.num_kv_heads)
    chunk_tc = build.ROUTE_LAUNCHES.get(f"{kernel.NAME}:{chunk_route}", 0)
    decode_route, splits = engine_decode_route(kernel, eng, dev)
    decode_on_route = build.ROUTE_LAUNCHES.get(
        f"{kernel.NAME_DECODE}:{decode_route}", 0)
    r = summarize(eng, wall)

    assert r["requests"] == len(pending), r
    for req in eng.sched.finished:
        assert len(req.out_tokens) == gen, (req.id, len(req.out_tokens))
        assert all(0 <= t < cfg.vocab_size for t in req.out_tokens)
    s = eng.stats
    assert sum(launches.values()) == cfg.num_layers * s.steps > 0, \
        (launches, s.steps)
    assert launches[kernel.NAME_DECODE] == s.decode_launches == \
        cfg.num_layers * s.decode_ticks > 0, (launches, s.decode_ticks)
    assert launches[kernel.NAME] > 0, launches
    assert chunk_tc == launches[kernel.NAME], (chunk_tc, launches)
    assert decode_on_route == launches[kernel.NAME_DECODE], \
        (decode_route, decode_on_route, launches)
    r["chunk_route"], r["chunk_route_launches"] = chunk_route, chunk_tc
    r["decode_route"], r["decode_splits"] = decode_route, splits
    r["decode_route_launches"] = decode_on_route
    for k, v in eng.cache:
        assert torch.isfinite(k).all() and torch.isfinite(v).all()
    # the lm head on a fresh prompt is finite too (NaN would hide in argmax)
    cache = T.init_paged_cache(cfg, 8, 16, dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        logits, _ = api.paged_step(
            eng.params, cache,
            torch.arange(1, 49, dtype=torch.int32, device=dev)[None],
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.full((1,), 48, dtype=torch.int32, device=dev),
            torch.arange(1, 4, dtype=torch.int32, device=dev)[None], cfg)
    assert torch.isfinite(logits).all()
    plens = [len(p) for _, p, _ in pending]
    log(f"  {cfg.name}, {cfg.num_layers} layers: {r['requests']} "
        f"requests, prompts {min(plens)}-{max(plens)} "
        f"tokens, {gen} new tokens each, 8 slots, 512x16-token pages: "
        f"{r['ticks']} ticks, {r['prefill_tokens']} prefill tokens")
    log(f"  throughput {r['tok_s']:.1f} tok/s  TTFT p50 "
        f"{r['ttft_p50_s'] * 1e3:.1f} ms  latency p50 "
        f"{r['latency_p50_s'] * 1e3:.1f} ms  p99 "
        f"{r['latency_p99_s'] * 1e3:.1f} ms  wall {wall:.3f} s")
    log(f"  {kernel.NAME_DECODE} launches: {launches[kernel.NAME_DECODE]}"
        f" = {cfg.num_layers} layers x {s.decode_ticks} decode-only ticks; "
        f"{kernel.NAME} launches: {launches[kernel.NAME]} = "
        f"{cfg.num_layers} layers x {s.steps - s.decode_ticks} ticks with "
        f"prompt chunks, all {chunk_tc} on the '{chunk_route}' route")
    log(f"  {kernel.NAME_DECODE}: all {decode_on_route} launches on the "
        f"'{decode_route}' route, {splits} blocks a (slot, kv head) over "
        f"{eng.max_pages_per_seq}-page block tables")
    return launches, r, eng


def phase_int8_serve(torch, dev, build, kernel):
    """Phase 5's load (the same 16 prompts after the same 2 warm-up
    requests, 8 slots, 32 new tokens each) on qwen3-1.7b at full width,
    bf16 weights and compute, twice at one HBM budget: bf16 pools of
    ``INT8_SERVE_BF16_PAGES`` pages, below the load's peak of 49, so it
    preempts, then int8 pools of as many pages as the same bytes hold
    (``kv_page_bytes``: 65,536 against 32,832 bytes a page and layer).
    Every request finishes with 32 in-vocabulary tokens, both kernels
    launch once per layer per tick, the pools and scales are finite, and
    int8 preempts strictly less than bf16 (the JAX benchmark's own
    condition, ``serving_bench.py::int8_phase``).  The greedy match
    against the bf16 run is printed: the weights are random."""
    from repro_torch.configs.base import get_model_config
    from repro_torch.launch.serve import drive, make_requests, summarize
    from repro_torch.models.params import init_params
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.kv_cache import kv_page_bytes

    cfg = get_model_config("qwen3-1.7b")
    params = init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    gen = 32
    rng = np.random.default_rng(0)            # phase 5's draws
    warm = [(0.0, p, 4) for _, p, _ in make_requests(
        2, cfg.vocab_size, rng, stream="batch", max_prompt=256, gen=4)]
    pending = [(0.0, p, gen) for _, p, _ in make_requests(
        16, cfg.vocab_size, rng, stream="batch", max_prompt=256, gen=gen)]
    geom = (16, cfg.num_kv_heads, cfg.head_dim)
    page_bytes = {kv: kv_page_bytes(*geom, kv) for kv in ("bfloat16", "int8")}
    budget = INT8_SERVE_BF16_PAGES * page_bytes["bfloat16"]
    out, streams = {}, {}
    for kv in ("bfloat16", "int8"):
        pages = budget // page_bytes[kv]
        eng = Engine(cfg, params, EngineConfig(
            num_slots=8, num_pages=pages, page_size=16, max_prompt_len=256,
            max_new_tokens=gen, token_budget=256, policy="on_demand",
            kv_dtype=kv, compute_dtype="bfloat16"), device=dev)
        drive(eng, warm)
        eng.reset_stats()
        build.reset_launches()
        wall = drive(eng, pending)
        launches = {n: build.LAUNCHES[n] for n in (kernel.NAME,
                                                   kernel.NAME_DECODE)}
        chunk_route = "wgmma_int8" if kv == "int8" else "wgmma"
        decode_route, splits = engine_decode_route(kernel, eng, dev)
        by_route = {"chunk_" + chunk_route: build.ROUTE_LAUNCHES.get(
            f"{kernel.NAME}:{chunk_route}", 0),
            "decode_" + decode_route: build.ROUTE_LAUNCHES.get(
            f"{kernel.NAME_DECODE}:{decode_route}", 0)}
        r = summarize(eng, wall)
        s = eng.stats
        assert by_route["chunk_" + chunk_route] == launches[kernel.NAME] \
            > 0, (kv, by_route, launches)
        assert by_route["decode_" + decode_route] == \
            launches[kernel.NAME_DECODE], (kv, by_route, launches)
        assert r["requests"] == len(pending), r
        for req in eng.sched.finished:
            assert len(req.out_tokens) == gen, (kv, req.id)
            assert all(0 <= t < cfg.vocab_size for t in req.out_tokens)
        assert sum(launches.values()) == cfg.num_layers * s.steps, launches
        assert launches[kernel.NAME_DECODE] == \
            cfg.num_layers * s.decode_ticks > 0, launches
        for layer in eng.cache:
            for t in layer:
                assert t.dtype == torch.int8 or torch.isfinite(t).all(), kv
        streams[kv] = {req.id: list(req.out_tokens)
                       for req in eng.sched.finished}
        r.update(kv_dtype=kv, num_pages=pages, pool_bytes_per_layer=pages *
                 page_bytes[kv], tick_ms=wall / max(s.steps, 1) * 1e3,
                 launches=launches, launches_by_route=by_route,
                 decode_splits=splits)
        out[kv] = r
        mib = pages * page_bytes[kv] / 2**20
        log(f"  {kv:8s} pools, {pages} pages x 16 tokens ({mib:.2f} MiB a "
            f"layer): {r['ticks']} ticks, "
            f"preemptions {r['preemptions']}, peak use "
            f"{r['peak_utilization']:.0%}; {r['tok_s']:.1f} tok/s  TTFT p50 "
            f"{r['ttft_p50_s'] * 1e3:.1f} ms  latency p50 "
            f"{r['latency_p50_s'] * 1e3:.1f} ms  p99 "
            f"{r['latency_p99_s'] * 1e3:.1f} ms  tick {r['tick_ms']:.2f} ms")
        log(f"    {kernel.NAME_DECODE} launches "
            f"{launches[kernel.NAME_DECODE]} = {cfg.num_layers} x "
            f"{s.decode_ticks} decode-only ticks, all on '{decode_route}' "
            f"(NS {splits}); {kernel.NAME} launches "
            f"{launches[kernel.NAME]}, all on '{chunk_route}'")
        del eng
        gc.collect()
    assert out["int8"]["preemptions"] < out["bfloat16"]["preemptions"], out
    a, b = streams["bfloat16"], streams["int8"]
    same = sum(x == y for i in a for x, y in zip(a[i], b[i]))
    total = sum(len(t) for t in a.values())
    out["greedy_match"] = same / total
    log(f"  int8 preemptions {out['int8']['preemptions']} < bf16 "
        f"{out['bfloat16']['preemptions']} at {budget / 2**20:.2f} MiB a "
        f"layer; greedy tokens equal to the bf16 run: {same}/{total} "
        f"({same / total:.1%}, random weights)")
    del params
    return out


def engine_decode_route(kernel, eng, dev):
    """The route of every decode launch of ``eng`` (its slots, heads and
    block-table width by the split rule) and its split count."""
    cfg = eng.cfg
    splits = kernel.decode_splits(
        eng.ecfg.num_slots, cfg.num_kv_heads,
        cfg.num_heads // cfg.num_kv_heads, eng.max_pages_per_seq,
        kernel.sm_count(dev.index))
    return kernel.decode_route(splits), splits


PROFILE_TRIES = 3
# device symbols of the paged kernels, by wrapper name: the chunk source's
# ``paged_chunk_attention_kernel`` (CUDA cores) and ``paged_chunk_tc_kernel``
# (tensor cores), the decode source's ``paged_attention_kernel``
KERNEL_KEYS = {"paged_chunk_attention": "paged_chunk_",
               "paged_attention": "paged_attention_kernel"}


def device_events(torch, fn, warmup: bool = False, cpu: bool = True,
                  scopes=None):
    """CUDA kernel events of ``fn()`` under torch.profiler, or [] when the
    profiler sees none.  The profiler sometimes sees no device activity in
    a window that had some, so a window without device time is profiled
    again (``fn`` runs again), up to ``PROFILE_TRIES`` times; a window that
    needed more than one try, or never saw device time, is logged.

    A window that starts with the profiler misses its first launches (the
    timing windows of 50 calls saw 39 of them, every try): with
    ``warmup`` the profiler runs ``fn()`` once as a warm-up step of its
    schedule, whose events it drops, and reports the second run's (the
    step's own annotation, which spans the step's host time, is not a
    device event here).  ``cpu=False`` traces the device alone, which
    costs less on a window of many thousand ops.  A ``record_function``
    scope (the MoE layer's ``moe_ffn``) also shows as a device range
    spanning its kernels; it is left out, so the kernels count once.  The
    keys of a ``scopes`` dict name such scopes: each is set to the device
    time (us) of the kernels launched inside its CPU ranges, from the same
    window as the events returned."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, PROFILE_TRIES + 1):
        try:
            with profile(activities=[ProfilerActivity.CUDA] + (
                    [ProfilerActivity.CPU] if cpu else []),
                         schedule=schedule(wait=0, warmup=1, active=1)
                         if warmup else None) as prof:
                if warmup:
                    fn()
                    torch.cuda.synchronize()
                    prof.step()                    # into the active step
                fn()
                torch.cuda.synchronize()
        except RuntimeError as e:                  # profiler unavailable
            log(f"  torch.profiler failed ({e}); device time not measured")
            return []
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")
                  and not getattr(e, "is_user_annotation", False)]
        if sum(e.self_device_time_total for e in events) > 0:
            for name in scopes or {}:
                scopes[name] = sum(
                    e.device_time_total for e in prof.events()
                    if e.name == name
                    and e.device_type == torch.autograd.DeviceType.CPU)
            if attempt > 1:
                log(f"  profiler: device events on try {attempt} of "
                    f"{PROFILE_TRIES}")
            return events
    log(f"  profiler: no device events in {PROFILE_TRIES} tries")
    return []


def phase_tick_profile(torch, eng, kernel, ensembles: int = 0):
    """Where a decode tick's time goes: host wall per tick against the
    device time of the kernels it launches (torch.profiler), 8 slots at
    context ~100: ``ensembles`` mean-logit groups over a bank engine's
    circuits first, solo requests in the other slots.  Reports "not
    measured" when the profiler sees no device activity; never changes
    what the engine computes."""
    rng = np.random.default_rng(5)
    used = 0
    for _ in range(ensembles):
        eng.submit(rng.integers(1, eng.cfg.vocab_size, (96,)), 32,
                   ensemble="mean_logit")
        used += eng.bank.num_submodels
    for _ in range(eng.ecfg.num_slots - used):
        eng.submit(rng.integers(1, eng.cfg.vocab_size, (96,)), 32)
    while eng.sched.waiting or any(r.in_prefill
                                   for r in eng.sched.running.values()):
        eng.step()
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    out = {"decode_tick_ms": wall_ms, "device_busy_ms": None,
           "attn_ms": None, "kernels_per_tick": None}
    events = device_events(torch, lambda: [eng.step() for _ in range(n)])
    eng.run()
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    log(f"  decode tick (8 slots, context ~100"
        f"{f', {ensembles} ensemble' if ensembles else ''}): "
        f"{wall_ms:.2f} ms wall")
    if busy <= 0:
        log("  device time per tick: not measured (no device events)")
        return out
    attn = sum(e.self_device_time_total for e in events
               if any(k in e.key for k in KERNEL_KEYS.values())) / n / 1e3
    out.update(device_busy_ms=busy, attn_ms=attn, kernels_per_tick=sum(
        e.count for e in events) / n)
    log(f"  device busy {busy:.2f} ms a tick ({busy / wall_ms:.1%} of the "
        f"wall, profiled), {out['kernels_per_tick']:.0f} device ops a tick, "
        f"paged attention kernels {attn:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / n / 1e3:7.3f} ms  "
            f"x{e.count / n:5.0f}  {e.key[:90]}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the training path
# ---------------------------------------------------------------------------
def phase_train(torch, build, fkernel, arch="qwen3-1.7b", batch=8,
                seq=1024, steps=TRAIN_STEPS, optimizer="adamw",
                prepare=None):
    """``launch.train`` on ``arch`` at full width (f32 masters, bf16
    compute, Horn on with 4 groups, lr 3e-4), ``steps`` steps of batch x
    seq: launch counts (remat: the forward twice an attention layer a
    step, an encoder's layers included, the backward once, every launch
    at the arch's head dim on the bf16 kernels), finite losses, the first
    near its random-init value; then one profiled step.  ``prepare(sess)``
    may change the session before the steps (phase 16 feeds seeded
    frames)."""
    from repro_torch.launch import train

    argv = ["--arch", arch, "--full-config", "--steps", str(steps),
            "--batch", str(batch), "--seq", str(seq), "--horn-groups", "4",
            "--optimizer", optimizer, "--lr", "3e-4", "--log-every", "1",
            "--seed", "0", "--device", "cuda"]
    t0 = time.perf_counter()
    sess = train.setup(argv)
    if prepare is not None:
        prepare(sess)
    cfg, a = sess.run.model, sess.args
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in sess.state["params"].parameters())
    enc = (f" + {cfg.num_encoder_layers} encoder layers"
           if cfg.num_encoder_layers else "")
    log(f"  {cfg.name}: {cfg.num_layers} layers{enc}, d_model "
        f"{cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B "
        f"parameters; f32 masters + {optimizer} moments built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    recs = train.run_steps(sess, steps, log=lambda m: log("  " + m))
    fwd, bwd = build.LAUNCHES[fkernel.FWD], build.LAUNCHES[fkernel.BWD]
    route = fkernel.route(torch.bfloat16, cfg.head_dim)
    on_route = [build.ROUTE_LAUNCHES.get(f"{n}:{route}", 0)
                for n in (fkernel.FWD, fkernel.BWD)]
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers + cfg.num_encoder_layers
    assert fwd == 2 * L * steps and bwd == L * steps, (fwd, bwd, L)
    assert on_route == [fwd, bwd], (route, on_route, fwd, bwd)
    for r in recs:
        assert math.isfinite(r["loss"]) and r["grad_norm"] > 0, r
    # at random init the final norm's unit-RMS rows meet an unembedding of
    # std 1 / sqrt(fan-in): logits of variance d_model / vocab (tied: the
    # embedding's fan-in is the vocab) or 1 (untied), so xent ~ ln(vocab)
    # + variance / 2, the log-mean-exp of Gaussian logits
    var = cfg.d_model / cfg.vocab_size if cfg.tie_embeddings else 1.0
    first = math.log(cfg.vocab_size) + var / 2
    assert abs(recs[0]["loss"] - first) < 0.5, (recs[0], first)
    steady = recs[1:]
    step_s = sum(r["step_s"] for r in steady) / len(steady)
    tok_s = a.batch * a.seq / step_s
    log(f"  {fkernel.FWD} launches: {fwd} = 2 x {L} layers x "
        f"{steps} steps (remat); {fkernel.BWD} launches: {bwd} = "
        f"{L} x {steps}; all on '{route}'")
    log(f"  step wall {step_s * 1e3:.1f} ms (mean of steps 2-{steps})"
        f", {tok_s:,.0f} tok/s, peak memory "
        f"{peak / 2**30:.2f} GiB allocated of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}")

    def one_step():
        sess.state, m = sess.step_fn(sess.state,
                                     sess.batch_at(sess.state["step"]))
        float(m["loss"])

    events = device_events(torch, one_step)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    out = {"arch": cfg.name, "batch": a.batch, "seq": a.seq,
           "optimizer": optimizer, "params": n_params, "steps": recs,
           "step_ms": step_s * 1e3, "tok_s": tok_s,
           "peak_bytes": peak, "launches": {fkernel.FWD: fwd,
                                            fkernel.BWD: bwd},
           "route": route,
           "device_busy_ms": busy or None, "busy_share": None,
           "top_kernels": []}
    if busy <= 0:
        log("  device time per step: not measured (no device events)")
    else:
        out["busy_share"] = busy / (step_s * 1e3)
        flash_ms = {n: sum(e.self_device_time_total for e in events
                           if n in e.key) / 1e3
                    for n in ("flash_fwd", "flash_bwd")}
        out["flash_ms"] = flash_ms
        log(f"  profiled step: device busy {busy:.1f} ms = "
            f"{out['busy_share']:.1%} of the unprofiled step wall; flash "
            f"forward {flash_ms['flash_fwd']:.1f} ms, backward "
            f"{flash_ms['flash_bwd']:.1f} ms")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            out["top_kernels"].append(
                [e.key[:90], e.self_device_time_total / 1e3, e.count])
            log(f"    {e.self_device_time_total / 1e3:8.2f} ms  "
                f"x{e.count:5d}  {e.key[:90]}")
    del sess
    return out


# ---------------------------------------------------------------------------
# phase 7: Horn's block-sparse MLP
# ---------------------------------------------------------------------------
def phase_horn_mlp(torch, dev, build, dkernel):
    """``mlp_apply(mask_blocks=...)`` on every qwen3-1.7b layer at full
    width against ``mlp_apply(hidden_mask=expand_mask(...))``, the dense
    masked path, on the same bf16 inputs.  The two round differently: the
    dense path rounds up, gate, the activation and the product to bf16
    (2^-9 relative each), the block path only h; the down projection sums
    3072 live units, so the difference has a std of ~0.5 % of |y| (rms
    ~0.9), and its largest of 28 x 16.8M outputs lies ~6 std out, plus one
    output ulp.  Tolerance: atol 6e-2, rtol 2e-2 on every element, and a
    mean |difference| below 1e-2 (a wrong block would move |y| by ~0.2)."""
    from repro_torch.configs.base import HornConfig, get_model_config
    from repro_torch.core import parallel_dropout as pd
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params

    cfg = get_model_config("qwen3-1.7b")
    params = init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    B, S, G = 8, 1024, 4
    horn = pd.make_horn_state(0, HornConfig(num_groups=G), 0, dev)
    nb = cfg.d_ff // horn.cfg.block_size
    # the train step's draw: layer i, salt 5, keep_hidden
    masks = [pd.group_block_mask(horn.uniform(i, 5, (G, nb)),
                                 horn.cfg.keep_hidden)
             for i in range(cfg.num_layers)]
    gen = torch.Generator(dev).manual_seed(1)
    worst, mean_diff, kept = 0.0, 0.0, []
    with torch.inference_mode():
        build.reset_launches()
        for i, bp in enumerate(params.layers):
            x = torch.randn(B, S, cfg.d_model, generator=gen,
                            device=dev).to(torch.bfloat16)
            h = L.norm_apply(bp.ffn_norm, x, cfg)
            got = L.mlp_apply(bp.mlp, h, cfg, mask_blocks=masks[i])
            want = L.mlp_apply(bp.mlp, h, cfg, hidden_mask=pd.expand_mask(
                masks[i], cfg.d_ff, B))
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == x.shape
            assert torch.isfinite(got).all(), i
            diff = (got.float() - want.float()).abs()
            worst = max(worst, diff.max().item())
            mean_diff = max(mean_diff, diff.mean().item())
            torch.testing.assert_close(got.float(), want.float(), atol=6e-2,
                                       rtol=2e-2, msg=lambda m: f"layer {i}: "
                                       f"{m}")
            assert mean_diff < 1e-2, (i, mean_diff)
            kept.append((masks[i] > 0).float().mean().item())
            del x, h, got, want, diff
        launches = build.LAUNCHES[dkernel.NAME]
        assert launches == 2 * cfg.num_layers, launches
        on_wgmma = build.ROUTE_LAUNCHES.get(f"{dkernel.NAME}:wgmma", 0)
        assert on_wgmma == launches, (on_wgmma, launches)

        # both paths over the 28 layers, one input, masks drawn in advance
        x = torch.randn(B, S, cfg.d_model, generator=gen,
                        device=dev).to(torch.bfloat16)
        hs = [L.norm_apply(bp.ffn_norm, x, cfg) for bp in params.layers]
        dense_masks = [pd.expand_mask(m, cfg.d_ff, B) for m in masks]

        def all_layers(kw_of):
            for i, bp in enumerate(params.layers):
                L.mlp_apply(bp.mlp, hs[i], cfg, **kw_of(i))

        times = {}
        for name, kw_of in (("block", lambda i: {"mask_blocks": masks[i]}),
                            ("dense", lambda i: {
                                "hidden_mask": dense_masks[i]})):
            all_layers(kw_of)                                  # warm up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                all_layers(kw_of)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) / 3 * 1e3
        events = device_events(torch, lambda: all_layers(
            lambda i: {"mask_blocks": masks[i]}))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    out = {"layers": cfg.num_layers, "B": B, "S": S, "groups": G,
           "keep": horn.cfg.keep_hidden, "kept_frac_mean": sum(kept) /
           len(kept), "launches": launches, "max_abs_err_vs_dense": worst,
           "mean_abs_err_vs_dense": mean_diff, "wgmma_launches": on_wgmma,
           "block_ms": times["block"], "dense_ms": times["dense"],
           "block_device_ms": busy or None, "block_kernel_ms": None,
           "top_kernels": []}
    log(f"  {cfg.num_layers} layers, x [{B}, {S}, {cfg.d_model}] bf16, "
        f"{G} groups, keep {horn.cfg.keep_hidden} (kept blocks "
        f"{out['kept_frac_mean']:.3f}): block path == dense masked path, "
        f"max |diff| {worst:.3g} (tol 6e-2 + 2e-2 |y|), largest layer mean "
        f"|diff| {mean_diff:.3g} (tol 1e-2)")
    log(f"  {dkernel.NAME} launches: {launches} = 2 x {cfg.num_layers} "
        f"layers (gate + up), all {on_wgmma} on the wgmma kernel")
    log(f"  {cfg.num_layers} MLP forwards: block-sparse path "
        f"{times['block']:.2f} ms, dense masked path {times['dense']:.2f} "
        f"ms (host clock, mean of 3)")
    if busy <= 0:
        log("  device time of the block path: not measured (no device "
            "events)")
    else:
        out["block_kernel_ms"] = sum(e.self_device_time_total for e in events
                                     if dkernel.NAME in e.key) / 1e3
        log(f"  profiled block path: device busy {busy:.2f} ms, "
            f"{dkernel.NAME} {out['block_kernel_ms']:.2f} ms of it")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            out["top_kernels"].append(
                [e.key[:90], e.self_device_time_total / 1e3, e.count])
            log(f"    {e.self_device_time_total / 1e3:8.2f} ms  "
                f"x{e.count:5d}  {e.key[:90]}")
    del params, hs
    return out


# ---------------------------------------------------------------------------
# phase 8: timing
# ---------------------------------------------------------------------------
def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, iters: int = 50, key=None, bound_ms=None):
    """Device time per call of ``fn(i)``: the device time of every kernel
    it launches, summed under torch.profiler over ``iters`` calls; None
    when the profiler sees no device activity.  For a kernel shorter than
    its wrapper's host time (~30 us for the paged kernels) CUDA events
    over back-to-back calls time the host's enqueue, not the device.

    ``key`` names the timed kernel (a substring of its device symbol, as
    ``KERNEL_KEYS`` gives it): the window is then profiled after a warm-up
    run of it (``device_events(warmup=True)``), must hold exactly
    ``iters`` launches of that kernel (the other kernels of a call need
    not run once a call) and, with ``bound_ms``, read no less than the
    bound; a window that misses either is profiled again, up to
    ``PROFILE_TRIES`` times, and then reads as not measured (None)."""
    for attempt in range(1, PROFILE_TRIES + 1):
        events = device_events(torch, lambda: [fn(i) for i in range(iters)],
                               warmup=key is not None)
        busy = sum(e.self_device_time_total for e in events)
        if busy <= 0:
            return None
        ms = busy / iters / 1e3
        if key is None:
            return ms
        own = [e for e in events if key in e.key]
        seen = sum(e.count for e in own)
        if seen == iters and (bound_ms is None or ms >= bound_ms):
            if attempt > 1:
                log(f"  profiler: {key} window complete on try {attempt}")
            return ms
        avg = sum(e.self_device_time_total for e in own) / max(seen, 1) / 1e3
        floor = "" if bound_ms is None else \
            f" (bound {bound_ms * 1e3:.2f} us)"
        log(f"  profiler: {key} window of {iters} calls saw {seen} "
            f"launches, {ms * 1e3:.2f} us a call{floor}, {avg * 1e3:.2f} "
            f"us a seen launch; try {attempt} of {PROFILE_TRIES}")
    log(f"  profiler: {key} not measured")
    return None


def tick_inputs(torch, dev, shape: str, copies: int, int8: bool):
    """A tick of the serve phase, q in bf16: ``decode`` is 8 slots at
    context 288 (a 256-token prompt plus 32 generated); ``prefill_chunk`` is
    slot 0 admitting a 256-token prompt chunk beside 7 decode slots.
    ``copies`` independent pools (76 MB together in bf16, more than the 50
    MB L2) keep each launch's K/V cold, as between the layers of a real
    tick; with ``int8`` each pool is quantized per (page, kv head) and
    carries its scales."""
    B, H, KH, D, psize, ctx = 8, 16, 8, 128, 16, 288
    C = 1 if shape == "decode" else 256
    maxp = ctx // psize
    P = B * maxp + 1
    gen = torch.Generator(dev).manual_seed(7)
    q = torch.randn(B, C, H, D, generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    pools = []
    for _ in range(copies):
        kp, vp = (torch.randn(P, psize, KH, D, generator=gen, device=dev,
                              dtype=torch.float32).to(torch.bfloat16)
                  for _ in range(2))
        pools.append(quantize_pools(torch, kp, vp) if int8 else (kp, vp, {}))
    bt = (1 + torch.arange(B * maxp, dtype=torch.int32, device=dev)
          ).reshape(B, maxp)
    starts = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
    clens = torch.ones(B, dtype=torch.int32, device=dev)
    if shape != "decode":
        starts[0], clens[0] = 0, C
    return q, pools, bt, starts, clens


def work(q, KH, starts, clens, psize, int8):
    """Bytes the function must move and flops it must do on these inputs
    (bf16 q and output, no window): each live key's K and V once per
    (slot, kv head), in bf16 or in int8 plus the f32 K and V scale of each
    live (page, kv head); each valid q row once, the whole output once; 4
    flops per (row, visible key, dim)."""
    B, C, H, D = q.shape
    kv_bytes = 1 if int8 else 2
    nbytes, flops = B * C * H * D * 2, 0
    for s, c in zip(starts.tolist(), clens.tolist()):
        nbytes += (s + c) * KH * D * 2 * kv_bytes + c * H * D * 2
        if int8:
            nbytes += -(-(s + c) // psize) * KH * 4 * 2
        flops += sum(4 * H * D * (s + j + 1) for j in range(c))
    return nbytes, flops


def bound(nbytes, flops, dtype="bfloat16"):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_timing(torch, dev, kernel, ref):
    """Both paged kernels at the serve phase's tick shapes, bf16 q, bf16 and
    int8 pools: the decode kernel at the decode tick, the chunk kernel at
    the decode tick and at the prompt-chunk tick; each beside its plain
    version, SDPA with ``enable_gqa`` on K/V gathered (and dequantized to
    bf16) in advance, the gather not timed, and the bound.  ``ms``,
    ``plain_ms`` and ``library_ms`` are device time per call
    (``device_ms``); the decode kernel's ``ms`` is the median of three
    such windows, all three kept as ``ms_windows``.  The CUDA-event times
    of back-to-back calls, which include the host's enqueue where it is
    the slower side, are kept as ``*_event_ms``.  Returns {kernel name:
    {shape: numbers}}."""
    import torch.nn.functional as F

    out = {kernel.NAME: {}, kernel.NAME_DECODE: {}}
    scale = 128 ** -0.5
    copies = 8
    runs = [(kernel.NAME_DECODE, "decode"), (kernel.NAME, "decode"),
            (kernel.NAME, "prefill_chunk")]
    for int8 in (False, True):
        for name, shape in runs:
            q, pools, bt, starts, clens = tick_inputs(torch, dev, shape,
                                                      copies, int8)
            psize, KH = pools[0][0].shape[1], pools[0][0].shape[2]
            if name == kernel.NAME_DECODE:
                qd, lengths = q[:, 0].contiguous(), starts + clens
                fns = (kernel.paged_attention, ref.paged_attention_ref)

                def call(fn, i):
                    kp, vp, sc = pools[i % copies]
                    return fn(qd, kp, vp, bt, lengths, scale=scale, **sc)
            else:
                fns = (kernel.paged_chunk_attention,
                       ref.paged_chunk_attention_ref)

                def call(fn, i):
                    kp, vp, sc = pools[i % copies]
                    return fn(q, kp, vp, bt, starts, clens, scale=scale,
                              **sc)

            got, want = call(fns[0], 0), call(fns[1], 0)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)
            # the library yardstick: SDPA on K/V gathered (and dequantized)
            # in advance, GQA without repeating K/V
            B, C, H, D = q.shape
            S = bt.shape[1] * psize
            gathered = []
            for kp, vp, sc in pools:
                g = []
                for x, xs in ((kp, sc.get("k_scale")),
                              (vp, sc.get("v_scale"))):
                    x = ref.dequantize_pages(x[bt.long()], None if xs is None
                                             else xs[bt.long()])
                    g.append(x.to(torch.bfloat16).reshape(B, S, KH, D)
                             .transpose(1, 2).contiguous())
                gathered.append(g)
            qt = q.transpose(1, 2).contiguous()
            kpos = torch.arange(S, device=dev)[None, None, :]
            qpos = (starts.long()[:, None]
                    + torch.arange(C, device=dev)[None, :])[..., None]
            mask = (kpos < (starts + clens).long()[:, None, None]) & \
                (kpos <= qpos)
            mask = None if shape == "decode" else mask[:, None]

            def run_library(i):
                k, v = gathered[i % copies]
                return F.scaled_dot_product_attention(
                    qt, k, v, attn_mask=mask, scale=scale, enable_gqa=True)

            nbytes, flops = work(q, KH, starts, clens, psize, int8)
            b_ms, b_by = bound(nbytes, flops)
            ev = {"ms": cuda_ms(torch, lambda i: call(fns[0], i), 200),
                  "plain_ms": cuda_ms(torch, lambda i: call(fns[1], i), 20),
                  "library_ms": cuda_ms(torch, run_library, 200)}
            windows = [device_ms(torch, lambda i: call(fns[0], i),
                                 key=KERNEL_KEYS[name], bound_ms=b_ms)
                       for _ in range(3 if name == kernel.NAME_DECODE
                                      else 1)]
            dv = {"ms": None if None in windows else
                  sorted(windows)[len(windows) // 2],
                  "plain_ms": device_ms(torch, lambda i: call(fns[1], i), 10),
                  "library_ms": device_ms(torch, run_library)}
            ms, plain_ms, library_ms = (dv[k] if dv[k] is not None else ev[k]
                                        for k in ("ms", "plain_ms",
                                                  "library_ms"))
            key = shape + ("_int8" if int8 else "")
            G = H // KH
            if name == kernel.NAME_DECODE:
                splits = kernel.decode_splits(B, KH, G, bt.shape[1],
                                              kernel.sm_count(dev.index))
                route = kernel.decode_route(splits)
                blocks = splits * (H // kernel.decode_rows(G)) * B
            else:
                splits = None
                route = kernel.chunk_route(q.dtype, int8, D, psize, G)
                rows = 16 if route == "cuda_core" else kernel.TC_ROWS
                blocks = -(-C * G // rows) * KH * B
            out[name][key] = {
                "kernel_route": route, "splits": splits,
                "ms_windows": windows,
                "B": B, "C": C, "H": H, "KH": KH, "D": D, "psize": psize,
                "dtype": "bfloat16", "pools": "int8" if int8 else "bfloat16",
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "timed_by": "device" if dv["ms"] is not None else "events",
                "event_ms": ev["ms"], "plain_event_ms": ev["plain_ms"],
                "library_event_ms": ev["library_ms"],
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "flops": flops, "max_abs_err": err, "grid_blocks": blocks,
            }
            if len(windows) > 1 and None not in windows:
                log(f"  {name:21s} {key:18s} device time in three windows "
                    f"of 50 calls: "
                    f"{', '.join(f'{w * 1e3:.2f}' for w in windows)} us")
            log(f"  {name:21s} {key:18s} ({route:10s}"
                f"{'' if splits is None else f' NS {splits}'}) device: kernel "
                f"{ms * 1e3:7.2f} us "
                f" plain {plain_ms * 1e3:8.2f} us  SDPA "
                f"{library_ms * 1e3:7.2f} us  bound {b_ms * 1e3:5.2f} us "
                f"({b_by}, {nbytes / 1e6:.2f} MB); events: kernel "
                f"{ev['ms'] * 1e3:.2f} us  max err {err:.3g}")
            del pools, gathered
    return out


def phase_decode_sweep(torch, dev, kernel):
    """Device time of the decode kernel against the chunk kernel at C == 1
    on the same decode ticks (qwen3-1.7b heads, bf16 q, bf16 and int8
    pools, every slot at one context): 8 slots at context 16 to 4096, and
    64 slots at context 288, where the split rule gives one block a unit.
    Each row keeps the decode kernel's split count."""
    H, KH, D, psize = 16, 8, 128, 16
    out = []
    points = [(8, ctx) for ctx in (16, 128, 288, 1024, 4096)] + [(64, 288)]
    for int8 in (False, True):
        for B, ctx in points:
            maxp = ctx // psize
            gen = torch.Generator(dev).manual_seed(ctx)
            q = torch.randn(B, H, D, generator=gen, device=dev).to(
                torch.bfloat16)
            kp, vp = (torch.randn(B * maxp + 1, psize, KH, D, generator=gen,
                                  device=dev).to(torch.bfloat16)
                      for _ in range(2))
            sc = {}
            if int8:
                kp, vp, sc = quantize_pools(torch, kp, vp)
            bt = (1 + torch.arange(B * maxp, dtype=torch.int32, device=dev)
                  ).reshape(B, maxp)
            lengths = torch.full((B,), ctx, dtype=torch.int32, device=dev)
            qc = q[:, None].contiguous()
            kw = dict(scale=D ** -0.5, **sc)

            def dec(i):
                return kernel.paged_attention(q, kp, vp, bt, lengths, **kw)

            def chk(i):
                return kernel.paged_chunk_attention(
                    qc, kp, vp, bt, lengths - 1, torch.ones_like(lengths),
                    **kw)

            torch.testing.assert_close(dec(0).float(), chk(0)[:, 0].float(),
                                       atol=2e-2, rtol=2e-2)
            splits = kernel.decode_splits(B, KH, H // KH, maxp,
                                          kernel.sm_count(dev.index))
            b_ms, _ = bound(*work(qc, KH, lengths - 1,
                                  torch.ones_like(lengths), psize, int8))
            row = {"pools": "int8" if int8 else "bfloat16", "B": B,
                   "ctx": ctx, "splits": splits, "bound_ms": b_ms,
                   "decode_ms": device_ms(
                       torch, dec, key=KERNEL_KEYS[kernel.NAME_DECODE],
                       bound_ms=b_ms),
                   "chunk_ms": device_ms(
                       torch, chk, key=KERNEL_KEYS[kernel.NAME],
                       bound_ms=b_ms)}
            out.append(row)
            if row["decode_ms"] is None or row["chunk_ms"] is None:
                log(f"  sweep {row['pools']:8s} B {B:2d} ctx {ctx:4d}: "
                    f"device time not measured")
                continue
            log(f"  sweep {row['pools']:8s} B {B:2d} ctx {ctx:4d}: "
                f"{kernel.NAME_DECODE} (NS {splits:2d}) "
                f"{row['decode_ms'] * 1e3:7.2f} us, "
                f"{kernel.NAME} at C=1 {row['chunk_ms'] * 1e3:7.2f} us "
                f"(device)")
            del q, kp, vp, sc
    return out


def flash_work(B, H, KH, S, D, itemsize, window=None, causal=True):
    """(forward bytes, forward flops, backward bytes, backward flops) of
    attention at these shapes: causal, with a sliding ``window`` if given,
    or non-causal (every row sees all S keys).  Each input read once and
    each output written once; forward 2 products (QK^T, PV), backward 5
    (S recomputed from the inputs, dP, dV, dQ, dK), 2 * D flops each per
    visible (row, key) pair: min(i + 1, window) keys for row i when
    causal, S when not."""
    w = window or S
    pairs = B * H * (w * (w + 1) // 2 + max(0, S - w) * w) if causal \
        else B * H * S * S
    q = B * H * S * D * itemsize
    kv = B * KH * S * D * itemsize
    lse = B * H * S * 4
    fwd_bytes = q + 2 * kv + q + lse          # q, k, v -> o, lse
    # q, k, v, o, dO, lse -> dq, dk, dv
    bwd_bytes = 3 * q + 2 * kv + lse + q + 2 * kv
    return fwd_bytes, 4 * D * pairs, bwd_bytes, 10 * D * pairs


def host_us(torch, fn, iters: int = 200) -> float:
    """Host time per call of ``fn``: back-to-back calls at a shape whose
    kernels are shorter than the call, so the queue never fills."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


def phase_flash_timing(torch, dev, fkernel, fref):
    """Forward and backward at the train steps' shapes, bf16: qwen3-1.7b's
    (B 8, S 1024, H 16, KH 8, D 128, causal), gemma3-4b's at head dim 256
    (B 2, S 2048, H 8, KH 4; causal, and its local layers' window of 1024)
    and whisper-base's encoder at head dim 64 (B 16, S 1536, H 8, KH 8,
    non-causal; phase 16's train step), each by ``flash_timing``; then the
    forward wrapper's host time per call in bf16 (three tensor maps
    encoded) and f32 (none) at a small shape."""
    out = {"train": flash_timing(torch, dev, fkernel, fref, 8, 16, 8, 1024,
                                 128)}
    for name, window in (("gemma3_train", None),
                         ("gemma3_train_window", 1024)):
        out[name] = flash_timing(torch, dev, fkernel, fref, 2, 8, 4, 2048,
                                 256, window)
    out["whisper_encoder"] = flash_timing(
        torch, dev, fkernel, fref, ENCDEC_TRAIN_BATCH, 8, 8,
        ENCDEC_FRAMES, 64, causal=False)
    kw = dict(scale=128 ** -0.5, causal=True)
    small = {dt: flash_case(torch, dev, dt, 1, 2, 1, 64, 128, 12)[:3]
             for dt in (torch.bfloat16, torch.float32)}
    host = {str(dt).split(".")[1]: host_us(
        torch, lambda a=a: fkernel.flash_attention_fwd(*a, **kw))
        for dt, a in small.items()}
    log(f"  flash forward wrapper host time per call (B 1, H 2, S 64): "
        f"bf16 {host['bfloat16']:.1f} us (3 tensor maps), f32 "
        f"{host['float32']:.1f} us (none)")
    out["host_us"] = host
    return out


def flash_timing(torch, dev, fkernel, fref, B, H, KH, S, D, window=None,
                 causal=True):
    """Forward and backward at one shape (bf16, causal with ``window`` if
    given, or non-causal): kernel, plain version (autograd for the
    backward) and SDPA with ``enable_gqa`` as the library yardstick (with
    a window, through a boolean mask of the visible keys).  Also |SDPA -
    plain| at the same inputs (SDPA rounds P to bf16 as the kernels
    do)."""
    import torch.nn.functional as F

    scale = D ** -0.5
    q, k, v, do = flash_case(torch, dev, torch.bfloat16, B, H, KH, S, D, 11)
    kw = dict(scale=scale, causal=causal, window=window)
    if window is None:
        lib_kw = dict(is_causal=causal)
    else:
        i = torch.arange(S, device=dev)
        lib_kw = dict(attn_mask=(i[None, :] <= i[:, None])
                      & (i[None, :] > i[:, None] - window))
    o, lse = fkernel.flash_attention_fwd(q, k, v, **kw)
    grads = fkernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = fref.attention_ref(*leaves, **kw)
    want = torch.autograd.grad(plain_out, leaves, do, retain_graph=True)
    lib_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(
        *lib_leaves, scale=scale, enable_gqa=True, **lib_kw)
    lib_grads = torch.autograd.grad(lib_out, lib_leaves, do,
                                    retain_graph=True)
    torch.cuda.synchronize()

    def max_err(got, ref):
        return max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, ref))

    errs = {"fwd": max_err([o], [plain_out]), "bwd": max_err(grads, want)}
    lib_errs = {"fwd": max_err([lib_out], [plain_out]),
                "bwd": max_err(lib_grads, want)}
    for got, w in zip((o, *grads), (plain_out, *want)):
        torch.testing.assert_close(got.float(), w.float(), atol=2e-2,
                                   rtol=2e-2)
    del lib_grads

    times = {
        "fwd": cuda_ms(torch, lambda i: fkernel.flash_attention_fwd(
            q, k, v, **kw), 20),
        "fwd_plain": cuda_ms(torch, lambda i: fref.attention_ref(
            q, k, v, **kw), 5),
        "fwd_library": cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            q, k, v, scale=scale, enable_gqa=True, **lib_kw), 20),
        "bwd": cuda_ms(torch, lambda i: fkernel.flash_attention_bwd(
            q, k, v, o, lse, do, **kw), 20),
        "bwd_plain": cuda_ms(torch, lambda i: torch.autograd.grad(
            plain_out, leaves, do, retain_graph=True), 5),
        "bwd_library": cuda_ms(torch, lambda i: torch.autograd.grad(
            lib_out, lib_leaves, do, retain_graph=True), 20),
    }
    fb, ff, bb, bf = flash_work(B, H, KH, S, D, 2, window, causal)
    out = {}
    for name, nbytes, flops in (("fwd", fb, ff), ("bwd", bb, bf)):
        b_ms, b_by = bound(nbytes, flops)
        out[name] = {
            "B": B, "S": S, "H": H, "KH": KH, "D": D, "dtype": "bfloat16",
            "causal": causal, "window": window, "ms": times[name],
            "plain_ms": times[f"{name}_plain"],
            "library_ms": times[f"{name}_library"], "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "max_abs_err": errs[name], "library_max_abs_err": lib_errs[name],
            "tflops": flops / (times[name] * 1e-3) / 1e12,
            "bound_share": b_ms / times[name]}
        log(f"  flash {name} B {B} S {S} H {H}/{KH} D {D} "
            f"{'causal' if causal else 'non-causal'} window {window}: "
            f"kernel {times[name]:8.3f} ms  plain "
            f"{times[name + '_plain']:8.3f} ms  SDPA "
            f"{times[name + '_library']:7.3f} ms  bound {b_ms:.3f} ms "
            f"({b_by}, {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)  "
            f"{out[name]['tflops']:.1f} TFLOP/s = "
            f"{out[name]['bound_share']:.1%} of the bound; max |kernel - "
            f"plain| {errs[name]:.3g}, |SDPA - plain| {lib_errs[name]:.3g}")
    return out


def phase_dropout_timing(torch, dev, dkernel, dref):
    """The Horn MLP's up/gate product (x [4, 2048, 2048], w [2048, 6144],
    bf16, 128-unit blocks) at keep 1, 0.5 and 0.25: the kernel, its plain
    version, cuBLAS on the dense weights (the product without the skip,
    bf16 out) and the sub-model yardstick, one cuBLAS product per group on
    ``submodel.materialize``'s kept columns (gathered in advance).  The
    bound counts x, the w blocks some group keeps and the f32 output once,
    and 2 * M * K flops per kept column of each group."""
    from repro_torch.core import parallel_dropout as pd
    from repro_torch.core import submodel

    G, M, K, N, bn = DM_FULL
    x, w, gen = dm_inputs(torch, dev, torch.bfloat16, G, M, K, N, seed=13)
    w = (w.float() * K ** -0.5).to(torch.bfloat16)
    library_ms = cuda_ms(torch, lambda i: torch.matmul(x, w), 20)
    out = {}
    for keep in (1.0, 0.5, 0.25):
        mask = pd.group_block_mask(torch.rand(G, N // bn, generator=gen,
                                              device=dev), keep)
        got = dkernel.dropout_matmul(x, w, mask, block_n=bn)
        want = dref.dropout_matmul_ref(x, w, mask, block_n=bn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, atol=0.15 * K ** 0.5,
                                   rtol=0.15)
        del got, want
        kept = [submodel.materialize(w, w.t(), mask[g], bn)[0].contiguous()
                for g in range(G)]
        ms = cuda_ms(torch, lambda i: dkernel.dropout_matmul(
            x, w, mask, block_n=bn), 20)
        plain_ms = cuda_ms(torch, lambda i: dref.dropout_matmul_ref(
            x, w, mask, block_n=bn), 5)
        sub_ms = cuda_ms(torch, lambda i: [torch.matmul(x[g], kept[g])
                                           for g in range(G)], 20)
        live = mask > 0
        flops = 2 * M * K * bn * int(live.sum())
        nbytes = (G * M * K * 2 + K * bn * int(live.any(0).sum()) * 2
                  + G * M * N * 4)
        b_ms, b_by = bound(nbytes, flops)
        out[str(keep)] = {
            "G": G, "M": M, "K": K, "N": N, "block_n": bn,
            "dtype": "bfloat16", "keep": keep,
            "kept_frac": float(live.float().mean()), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "submodel_ms": sub_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops, "max_abs_err": err,
            "tflops": flops / (ms * 1e-3) / 1e12}
        log(f"  dropout_matmul keep {keep:4}: kernel {ms:7.3f} ms  plain "
            f"{plain_ms:7.3f} ms  cuBLAS dense {library_ms:6.3f} ms  "
            f"sub-model {sub_ms:6.3f} ms  bound {b_ms:.3f} ms ({b_by}, "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)  "
            f"{out[str(keep)]['tflops']:.1f} TFLOP/s  max err {err:.3g}")
    ratio = out["0.25"]["ms"] / out["1.0"]["ms"]
    log(f"  the skip: keep 0.25 takes {ratio:.3f} x the time of keep 1.0")
    assert ratio < 0.6, f"dropped tiles do not save time ({ratio:.3f})"
    return out


def ssd_work(B, S, H, P, N, Q, itemsize):
    """(bytes, flops) of the chunk scan: x, dt, Bm, Cm and A read once, y
    (f32) and the final state (f32) written once; C.B^T counted once per
    (b, chunk) on its causal triangle (2 N flops a pair), and per (b, h,
    chunk) the triangle times x (2 P a pair), C times the carried state and
    the state update (2 Q N P each)."""
    nc = S // Q
    pairs = Q * (Q + 1) // 2
    nbytes = (B * S * H * P * itemsize + B * S * H * 4 + H * 4
              + 2 * B * S * N * itemsize + B * S * H * P * 4
              + B * H * P * N * 4)
    flops = B * nc * (2 * N * pairs + H * (2 * P * pairs + 4 * Q * N * P))
    return nbytes, flops


def phase_ssd_timing(torch, dev, skernel, sref):
    """The chunk scan at the ssm phase's prefill shape (B 4, S 2048, H 80,
    P 64, N 128, chunk 256, bf16 x/B/C, with the final state): the wgmma
    kernel (the route the wrapper takes there), the CUDA-core kernel on the
    same inputs (``kernel._launch`` with its route named, to compare the
    two in one call) and the plain version.  ``bound_ms`` is at the bf16
    tensor-core rate, the wgmma kernel's (bytes set it at this shape); the
    log also gives it at the f32 rate of the CUDA-core kernel.  No single
    PyTorch call computes an SSD scan, so there is no library time."""
    B, S, H, P, N, chunk = SSM_BATCH, SSM_SEQ, 80, 64, 128, 256
    args = ssd_inputs(torch, dev, torch.bfloat16, B, S, H, P, N, seed=21)
    how = skernel.route(torch.bfloat16, P, N, chunk)
    assert how == "wgmma", how
    y_want, st_want = sref.ssd_chunk_scan_ref(*args, chunk=chunk)
    errs = {}
    for name, run in (
            ("wgmma", lambda: skernel.ssd_chunk_scan(*args, chunk=chunk)),
            ("cuda_core", lambda: skernel._launch(*args, chunk,
                                                   "cuda_core"))):
        y, st = run()
        torch.cuda.synchronize()
        errs[name] = max((y - y_want).abs().max().item(),
                         (st - st_want).abs().max().item())
        torch.testing.assert_close(y, y_want, atol=2e-4, rtol=1e-3)
        torch.testing.assert_close(st, st_want, atol=2e-4, rtol=1e-3)
        del y, st
    del y_want, st_want
    ms = cuda_ms(torch, lambda i: skernel.ssd_chunk_scan(
        *args, chunk=chunk), 20)
    cc_ms = cuda_ms(torch, lambda i: skernel._launch(
        *args, chunk, "cuda_core"), 5, warmup=1)
    plain_ms = cuda_ms(torch, lambda i: sref.ssd_chunk_scan_ref(
        *args, chunk=chunk), 5, warmup=1)
    nbytes, flops = ssd_work(B, S, H, P, N, chunk, 2)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    cc_b_ms, _ = bound(nbytes, flops, "float32")
    out = {"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": chunk,
           "dtype": "bfloat16", "route": how, "ms": ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
           "bound_by": b_by, "cuda_core_ms": cc_ms,
           "bytes": nbytes, "flops": flops,
           "max_abs_err": errs["wgmma"],
           "cuda_core_max_abs_err": errs["cuda_core"],
           "tflops": flops / (ms * 1e-3) / 1e12}
    log(f"  ssd_chunk_scan prefill (B {B}, S {S}, H {H}, P {P}, N {N}, Q "
        f"{chunk}, bf16): wgmma kernel {ms:7.3f} ms [the CUDA-core kernel "
        f"{cc_ms:.3f} ms]  plain {plain_ms:7.3f} ms  library: none (no single PyTorch call)  "
        f"bound {b_ms:.3f} ms ({b_by} at the bf16 rate; {cc_b_ms:.3f} ms "
        f"at the f32 rate), {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB;"
        f" {out['tflops']:.1f} TFLOP/s counted; max err wgmma "
        f"{errs['wgmma']:.3g}, cuda_core {errs['cuda_core']:.3g}")
    return out


def phase_ssm_parity(torch, dev, build, skernel, sref):
    """mamba2-2.7b at full width, 2 layers, f32 weights and compute, batch
    2 x 512 tokens (two 256-token chunks): the prefill through the kernel
    against the same prefill with the plain chunk scan (logits and final
    SSM states), then prefill(512) + 4 decode steps against prefill(512 +
    k), k = 1..4 (chunks of 1 token at 513, 2 at 514, ...).  Tolerance
    atol/rtol 1e-3: the kernel and the plain scan differ by summation order
    (~1e-4 on y at |y| ~ 1, phase 3), diluted through the gated norm and
    two projections; logits here are ~0.2 in size."""
    from repro_torch.configs.base import (RunConfig, ShapeConfig,
                                          get_model_config)
    from repro_torch.core import steps
    from repro_torch.models import ssm
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_model_config("mamba2-2.7b"), num_layers=2,
                              dtype="float32")
    B, S, K = 2, 512, 4
    run = RunConfig(model=cfg, shape=ShapeConfig("ssm", "prefill", S, B),
                    compute_dtype="float32")
    params = init_params(cfg, 1234, device=dev, dtype=torch.float32)
    prefill = steps.make_prefill_step(run, dev)
    decode = steps.make_decode_step(run, dev)
    gen = torch.Generator(dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + K), generator=gen,
                           device=dev)
    build.reset_launches()
    logits, cache = prefill(params, {"tokens": tokens[:, :S]})
    assert build.LAUNCHES[skernel.NAME] == cfg.num_layers
    # the reference path: models/ssm.py takes the plain scan on the card
    with mock.patch.object(ssm, "ssd_chunk_scan", sref.ssd_chunk_scan_ref):
        want, wcache = prefill(params, {"tokens": tokens[:, :S]})
    assert build.LAUNCHES[skernel.NAME] == cfg.num_layers
    torch.cuda.synchronize()
    errs = {"logits": (logits - want).abs().max().item(),
            "state": max((c[1] - w[1]).abs().max().item()
                         for c, w in zip(cache, wcache))}
    torch.testing.assert_close(logits, want, atol=1e-3, rtol=1e-3)
    for (_, st), (_, wst) in zip(cache, wcache):
        torch.testing.assert_close(st, wst, atol=1e-3, rtol=1e-3)
    chain = []
    for k in range(K):
        launches = build.LAUNCHES[skernel.NAME]
        got, cache = decode(params, cache, tokens[:, S + k:S + k + 1], S + k)
        assert build.LAUNCHES[skernel.NAME] == launches     # decode: none
        longer, _ = prefill(params, {"tokens": tokens[:, :S + k + 1]})
        torch.cuda.synchronize()
        chain.append((got - longer).abs().max().item())
        torch.testing.assert_close(got, longer, atol=1e-3, rtol=1e-3,
                                   msg=lambda m: f"decode step {k}: {m}")
    log(f"  2 layers, f32, batch {B} x {S}: kernel path == plain path, max "
        f"|diff| logits {errs['logits']:.3g}, final states "
        f"{errs['state']:.3g} (tol 1e-3); prefill({S}) + {K} decode steps "
        f"== prefill({S} + k): max |diff| "
        + " ".join(f"{e:.3g}" for e in chain) + " (tol 1e-3)")
    del params, cache, wcache
    return {"kernel_vs_plain": errs, "chain": chain}


def phase_ssm_parity_bf16(torch, dev, build, skernel, sref):
    """mamba2-2.7b at full width, 2 layers, bf16 weights and compute, batch
    2 x 2048 tokens: the prefill through the kernel, every scan on the
    wgmma kernel (asserted).  Each scan of that prefill, on the inputs the
    model gave it, against the plain chunk scan on the same inputs: y and
    the final state at atol 2e-4 / rtol 1e-3 (phase 3's tolerance).  Then
    the whole prefill against the same prefill with the plain chunk scan.
    The model rounds y and every activation to bf16, so from the second
    layer on the two paths see inputs that differ where a ~1e-5
    difference tips a bf16 rounding: logits at atol/rtol 2e-2, the bf16
    tolerance of the other phases (one bf16 step at |x| ~ 1 is 7.8e-3);
    each layer's final state within 2e-2 of the plain path's in norm,
    ||got - want|| / ||want||."""
    from repro_torch.configs.base import (RunConfig, ShapeConfig,
                                          get_model_config)
    from repro_torch.core import steps
    from repro_torch.models import ssm
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_model_config("mamba2-2.7b"), num_layers=2)
    B, S = 2, SSM_SEQ
    run = RunConfig(model=cfg, shape=ShapeConfig("ssm", "prefill", S, B))
    params = init_params(cfg, 4321, device=dev, dtype=torch.bfloat16)
    prefill = steps.make_prefill_step(run, dev)
    gen = torch.Generator(dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    calls, scan = [], ssm.ssd_chunk_scan

    def recorded(*args, chunk):
        out = scan(*args, chunk=chunk)
        calls.append((args, chunk, out))
        return out

    build.reset_launches()
    with mock.patch.object(ssm, "ssd_chunk_scan", recorded):
        logits, cache = prefill(params, {"tokens": tokens})
    by_route = {how: build.ROUTE_LAUNCHES.get(f"{skernel.NAME}:{how}", 0)
                for how in skernel.ROUTES}
    assert by_route == {"cuda_core": 0, "wgmma": cfg.num_layers}, by_route
    scan_errs = []
    for i, (args, chunk, (y, st)) in enumerate(calls):
        y_want, st_want = sref.ssd_chunk_scan_ref(*args, chunk=chunk)
        torch.cuda.synchronize()
        scan_errs.append(max((y - y_want).abs().max().item(),
                             (st - st_want).abs().max().item()))
        for what, got, want in (("y", y, y_want), ("state", st, st_want)):
            torch.testing.assert_close(
                got, want, atol=2e-4, rtol=1e-3,
                msg=lambda m: f"layer {i} scan {what}: {m}")
    del calls, y, st, y_want, st_want
    with mock.patch.object(ssm, "ssd_chunk_scan", sref.ssd_chunk_scan_ref):
        want, wcache = prefill(params, {"tokens": tokens})
    assert build.LAUNCHES[skernel.NAME] == cfg.num_layers
    torch.cuda.synchronize()
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()
    got_f, want_f = logits.float(), want.float()
    errs = {"scan_by_layer": scan_errs,
            "logits": (got_f - want_f).abs().max().item(),
            "logits_differing": (got_f != want_f).float().mean().item(),
            "logits_max_abs": want_f.abs().max().item(),
            "state_by_layer": [(c[1] - w[1]).abs().max().item()
                               for c, w in zip(cache, wcache)],
            "state_rel_norm_by_layer": [
                ((c[1] - w[1]).norm() / w[1].norm()).item()
                for c, w in zip(cache, wcache)]}
    log(f"  2 layers, bf16, batch {B} x {S}: launches by route {by_route}; "
        f"each scan against the plain scan on its inputs: max |diff| "
        + " ".join(f"{e:.3g}" for e in scan_errs)
        + f" (tol 2e-4 + 1e-3 |y|); whole prefill against the plain path: "
        f"logits max |diff| {errs['logits']:.3g} ({errs['logits_differing']:.2%}"
        f" of logits differ, max |logit| {errs['logits_max_abs']:.3g}; tol "
        f"2e-2), final states by layer max |diff| "
        + " ".join(f"{e:.3g}" for e in errs["state_by_layer"])
        + ", relative norm "
        + " ".join(f"{e:.3g}" for e in errs["state_rel_norm_by_layer"])
        + " (tol 2e-2)")
    torch.testing.assert_close(got_f, want_f, atol=2e-2, rtol=2e-2)
    for i, rel in enumerate(errs["state_rel_norm_by_layer"]):
        assert rel <= 2e-2, f"layer {i} state: relative norm {rel:.3g}"
    del params, cache, wcache
    return {"kernel_vs_plain": errs, "launches_by_route": by_route}


def phase_ssm(torch, dev, build, skernel):
    """All 64 layers of mamba2-2.7b in bf16 through the step factories:
    a prefill of 4 x 2048 seeded tokens, then 32 greedy decode steps from
    its cache (tokens fed back), after a warm-up on the same steps."""
    from repro_torch.configs.base import (RunConfig, ShapeConfig,
                                          get_model_config)
    from repro_torch.core import steps
    from repro_torch.models.params import init_params

    cfg = get_model_config("mamba2-2.7b")
    B, S, G = SSM_BATCH, SSM_SEQ, SSM_DECODE
    run = RunConfig(model=cfg, shape=ShapeConfig("ssm", "prefill", S, B))
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_inner {cfg.ssm_expand * cfg.d_model}, "
        f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} heads x "
        f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, vocab {cfg.vocab_size}"
        f"; {n_params / 1e9:.3f} B bf16 parameters built in "
        f"{time.perf_counter() - t0:.1f} s")
    prefill = steps.make_prefill_step(run, dev)
    decode = steps.make_decode_step(run, dev)
    gen = torch.Generator(dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)

    logits, cache = prefill(params, {"tokens": tokens})      # warm up
    for i in range(2):
        logits, cache = decode(params, cache,
                               torch.argmax(logits, -1)[:, None], S + i)
    del logits, cache
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = build.LAUNCHES[skernel.NAME]
    assert launches == cfg.num_layers, launches
    by_route = {how: build.ROUTE_LAUNCHES.get(f"{skernel.NAME}:{how}", 0)
                for how in skernel.ROUTES}
    assert by_route["wgmma"] == launches, by_route
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    prefill_cache = cache
    t0 = time.perf_counter()
    for i in range(G):
        nxt = torch.argmax(logits, -1)[:, None]
        logits, cache = decode(params, cache, nxt, S + i)
        assert torch.isfinite(logits).all(), i
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    assert build.LAUNCHES[skernel.NAME] == launches, "decode ran the scan"
    for conv, st in cache:
        assert torch.isfinite(conv).all() and torch.isfinite(st).all()
    peak = torch.cuda.max_memory_allocated()
    out = {"layers": cfg.num_layers, "batch": B, "seq": S,
           "decode_steps": G, "launches_per_prefill": launches,
           "launches_by_route": by_route,
           "prefill_s": prefill_s, "prefill_tok_s": B * S / prefill_s,
           "decode_step_ms": decode_s / G * 1e3,
           "decode_tok_s": B * G / decode_s, "peak_bytes": peak,
           "device_busy_ms": None, "busy_share": None, "ssd_ms": None,
           "ssd_kernels": None,
           "top_kernels": []}
    log(f"  prefill {B} x {S}: {prefill_s * 1e3:.1f} ms wall, "
        f"{out['prefill_tok_s']:,.0f} tok/s; {skernel.NAME} launches: "
        f"{launches} = {cfg.num_layers} layers x 1 prefill, by route "
        f"{by_route}")
    log(f"  {G} greedy decode steps at batch {B}: "
        f"{out['decode_step_ms']:.2f} ms a step, {out['decode_tok_s']:.1f} "
        f"tok/s; {skernel.NAME} launches in decode: 0; peak memory "
        f"{peak / 2**30:.2f} GiB allocated")
    n = 8

    def decode_steps():
        c, lg = prefill_cache, logits
        for i in range(n):
            lg, c = decode(params, c, torch.argmax(lg, -1)[:, None],
                           S + G + i)

    events = device_events(torch, decode_steps)
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    out.update(decode_device_busy_ms=busy or None, decode_busy_share=None,
               decode_ops_per_step=None)
    if busy <= 0:
        log("  device time of a decode step: not measured (no device "
            "events)")
    else:
        out.update(decode_busy_share=busy / out["decode_step_ms"],
                   decode_ops_per_step=sum(e.count for e in events) / n)
        log(f"  profiled decode: device busy {busy:.2f} ms a step = "
            f"{out['decode_busy_share']:.1%} of the unprofiled step wall, "
            f"{out['decode_ops_per_step']:.0f} device ops a step")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:4]:
            log(f"    {e.self_device_time_total / n / 1e3:7.3f} ms  "
                f"x{e.count / n:5.0f}  {e.key[:90]}")
    events = device_events(torch, lambda: prefill(params, {"tokens": tokens}))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy <= 0:
        log("  device time of a prefill: not measured (no device events)")
    else:
        # every kernel of the scan is named ssd_chunk_scan_*: the sum
        # covers each launch of the profiled prefill, all on the wgmma one
        ssd = [e for e in events if "ssd_chunk_scan" in e.key]
        assert sum(e.count for e in ssd) == launches, \
            [(e.key, e.count) for e in ssd]
        assert all("ssd_chunk_scan_wgmma_kernel" in e.key for e in ssd), \
            [e.key for e in ssd]
        out.update(device_busy_ms=busy, busy_share=busy / (prefill_s * 1e3),
                   ssd_ms=sum(e.self_device_time_total for e in ssd) / 1e3,
                   ssd_kernels=[[e.key[:90], e.count] for e in ssd])
        log(f"  profiled prefill: device busy {busy:.1f} ms = "
            f"{out['busy_share']:.1%} of the unprofiled prefill wall; "
            f"{skernel.NAME} {out['ssd_ms']:.1f} ms over "
            + ", ".join(f"{e.key[:60]} x{e.count}" for e in ssd))
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            out["top_kernels"].append(
                [e.key[:90], e.self_device_time_total / 1e3, e.count])
            log(f"    {e.self_device_time_total / 1e3:8.2f} ms  "
                f"x{e.count:5d}  {e.key[:90]}")
    del params, cache, prefill_cache
    return out


# ---------------------------------------------------------------------------
# phase 10: the paper's MNIST experiment, and resumable training
# ---------------------------------------------------------------------------
MNIST_PARITY_STEPS = 20
PAPER_DELTA, JAX_CPU_DELTA = 0.0178, 0.0225   # paper; JAX on a CPU, seed 0


def cpu_drawn_horn(torch):
    """``collective_trainer.horn_state`` drawing its uniforms on the CPU
    whatever the device, so the card and the CPU apply the same masks."""
    from repro_torch.core.parallel_dropout import HornState

    @dataclasses.dataclass(frozen=True)
    class CpuDrawn(HornState):
        def uniform(self, layer_idx, salt, shape):
            cpu = dataclasses.replace(self, device=torch.device("cpu"))
            return HornState.uniform(cpu, layer_idx, salt, shape).to(
                self.device)

    def horn_state(cfg, step, num_groups, device):
        if not cfg.enabled:
            return None
        return CpuDrawn(0, int(step), cfg, num_groups, torch.device(device))
    return horn_state


def normwise(got, want) -> float:
    """max |got - want| over max |want|, over every leaf."""
    return max(float((got[k].cpu() - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


def phase_mnist_parity(torch, dev):
    """``make_step_fn`` at paper width (784-512-512-10, G 20 x b 5, Horn
    on, lr 0.005, mu 0.98) on the card against the CPU, from the same
    parameters, batches and CPU-drawn uniforms, for 20 steps: allreduce
    and local SGD (H 4) chained on each device, parameters within 1e-4
    and momentum within 1e-3 of their leaf's largest value (f32 sums in
    other orders, about 1e-6 of a value a step, over 20 momentum steps; a
    ReLU whose pre-activation lies within rounding of 0 passes a sample's
    gradient on one device only).  int8: each card step starts from the
    CPU's state; a residual differs by 0 or 1 quantization steps (a
    rounding tie of q), momentum by the groups' mean of that and
    parameters by -lr times it, within 1e-3 and 1e-4 of the leaf's
    largest value; fewer than 0.1 % of the values flip."""
    from repro_torch.configs.base import HornConfig, TopologyConfig
    from repro_torch.core import collective_trainer as CT
    from repro_torch.core.neuron_centric import paper_mnist_network
    from repro_torch.data.mnist import synthetic_mnist
    from repro_torch.data.pipeline import MnistBatcher
    from repro_torch.optim import compression as C

    G, b, lr, mu = 20, 5, 0.005, 0.98
    net = paper_mnist_network()
    hcfg = HornConfig(enabled=True, num_groups=G, block_size=1)
    cpu = torch.device("cpu")
    d = synthetic_mnist(n_train=2000, n_test=10)
    batcher = MnistBatcher(d["x_train"], d["y_train"], G * b, seed=0)
    scales = {}
    compress = C.ef_compress_tree

    def recording(*a, **kw):      # the card steps second: its scales stay
        q, s, r = compress(*a, **kw)
        scales.update({k: v.cpu() for k, v in s.items()})
        return q, s, r

    out = {}
    with mock.patch.object(CT, "horn_state", cpu_drawn_horn(torch)), \
            mock.patch.object(C, "ef_compress_tree", recording):
        for name, topo in (("allreduce", {}),
                           ("local_sgd", dict(kind="local_sgd",
                                              local_sgd_period=4)),
                           ("int8", dict(grad_compression="int8"))):
            tcfg = TopologyConfig(**topo)
            steps = {x: CT.make_step_fn(net, hcfg, tcfg, lr, mu, G, x)
                     for x in (cpu, dev)}
            host = CT.init_groups(net, G, 0, cpu)
            card = [{k: v.to(dev) for k, v in t.items()} for t in host]
            worst = {"params": 0.0, "momentum": 0.0, "loss": 0.0}
            flips = 0
            for step in range(MNIST_PARITY_STEPS):
                bt = batcher.group_batch_at(step, G)
                if name == "int8":      # the card steps from the CPU's state
                    card = [{k: v.to(dev) for k, v in t.items()}
                            for t in host]
                *host, hl = steps[cpu](*host, bt, step)
                *card, cl = steps[dev](*card, bt, step)
                assert math.isfinite(float(cl)), (name, step)
                worst["loss"] = max(worst["loss"], abs(float(cl) - float(hl))
                                    / abs(float(hl)))
                if name == "int8":
                    dr = {k: card[2][k].cpu() - host[2][k] for k in host[2]}
                    for k, v in dr.items():
                        q_steps = v.abs() / scales[k]
                        off = (q_steps - q_steps.round()).abs().max()
                        assert off < 1e-3 and q_steps.round().max() <= 1, \
                            (name, step, k, float(off))
                        flips += int(q_steps.round().sum())
                    dg = {k: -v.mean(0, keepdim=True).expand_as(v)
                          for k, v in dr.items()}
                    want_m = {k: host[1][k] + dg[k] for k in dg}
                    want_p = {k: host[0][k] - lr * dg[k] for k in dg}
                    worst["momentum"] = max(worst["momentum"],
                                            normwise(card[1], want_m))
                    worst["params"] = max(worst["params"],
                                          normwise(card[0], want_p))
                else:
                    worst["momentum"] = max(worst["momentum"],
                                            normwise(card[1], host[1]))
                    worst["params"] = max(worst["params"],
                                          normwise(card[0], host[0]))
            n = sum(v.numel() for v in host[0].values())
            log(f"  {name}: {MNIST_PARITY_STEPS} steps, card against CPU: "
                f"params {worst['params']:.3g}, momentum "
                f"{worst['momentum']:.3g} of the leaf's largest value, loss "
                f"{worst['loss']:.3g} relative"
                + (f"; {flips} of {n * MNIST_PARITY_STEPS} int8 values one "
                   f"quantization step apart" if name == "int8" else ""))
            assert worst["params"] < 1e-4 and worst["momentum"] < 1e-3, \
                (name, worst)
            if name == "int8":
                assert flips < 1e-3 * n * MNIST_PARITY_STEPS, flips
            out[name] = dict(worst, int8_flips=flips)
    return out


def mnist_arm_profile(torch, dev, num_groups, batch_per_group, data,
                      n=50):
    """One arm of the comparison for ``n`` steps after 20 of warm-up:
    the host wall a step (after a sync) and, under torch.profiler, the
    device busy time and device ops a step."""
    from repro_torch.configs.base import HornConfig, TopologyConfig
    from repro_torch.core import collective_trainer as CT
    from repro_torch.core.neuron_centric import paper_mnist_network
    from repro_torch.data.pipeline import MnistBatcher

    net = paper_mnist_network()
    step_fn = CT.make_step_fn(
        net, HornConfig(enabled=True, num_groups=num_groups, block_size=1),
        TopologyConfig(), 0.005, 0.98, num_groups, dev)
    batcher = MnistBatcher(data["x_train"], data["y_train"],
                           num_groups * batch_per_group, seed=0)
    state = list(CT.init_groups(net, num_groups, 0, dev))
    at = [0]

    def steps(k):
        for _ in range(k):
            *state[:], loss = step_fn(
                *state, batcher.group_batch_at(at[0], num_groups), at[0])
            at[0] += 1
        assert math.isfinite(float(loss))

    steps(20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(n)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    events = device_events(torch, lambda: steps(n))
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    out = {"step_ms": wall, "device_busy_ms": busy or None,
           "busy_share": busy / wall if busy else None,
           "ops_per_step": sum(e.count for e in events) / n if busy else None}
    return out


def phase_mnist(torch, dev):
    """The paper's comparison through ``benchmarks/mnist_repro.run()`` at
    its defaults (2000 steps, eval every 500, lr 0.005, mu 0.98, 10000
    training samples), both arms on the card: every recorded loss
    finite, both final accuracies above 0.90, parallel above
    non-parallel; then each arm's host wall, device busy share and ops a
    step over 50 profiled steps, and the peak memory."""
    from repro_torch.benchmarks import mnist_repro
    from repro_torch.data.mnist import load_mnist

    results = {}
    real = mnist_repro.paper_comparison

    def keep(**kw):
        results.update(real(**kw))
        return results

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(mnist_repro, "paper_comparison", keep):
        rows, detail = mnist_repro.run()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    out = {"wall_s": wall, "peak_bytes": peak, "rows": rows, "arms": {}}
    for key, res in results.items():
        assert all(math.isfinite(x) for x in res.loss), (key, res.loss)
        ms = res.wall_s / res.steps[-1] * 1e3
        out["arms"][key] = dict(detail[key], loss=res.loss, step_ms=ms)
        log(f"  {res.name}: accuracy "
            + ", ".join(f"{a:.4f}@{s}" for s, a in zip(res.steps,
                                                         res.accuracy))
            + f"; final {res.final_accuracy:.4f}; {ms:.3f} ms a step "
            f"(host wall over {res.steps[-1]} steps, evaluations included,"
            f" after a sync); data {res.data_source}")
    npar, par = (results[k].final_accuracy
                 for k in ("non_parallel", "parallel"))
    delta = par - npar
    out.update(delta=delta, data_source=results["parallel"].data_source)
    log(f"  parallel - non-parallel: {delta:+.4f} (paper, real MNIST: "
        f"{PAPER_DELTA:+.4f}; the JAX package on a CPU, seed 0, "
        f"synthetic-7seg: {JAX_CPU_DELTA:+.4f}); {wall:.1f} s for both "
        f"arms; peak memory {peak / 2**20:.1f} MiB allocated")
    for r in rows:
        log("    " + ",".join(str(x) for x in r))
    assert npar > 0.90 and par > 0.90, (npar, par)
    assert par > npar, (npar, par)
    data = load_mnist(n_train=10000)
    for key, (G, b) in (("non_parallel", (1, 100)), ("parallel", (20, 5))):
        prof = mnist_arm_profile(torch, dev, G, b, data)
        out["arms"][key]["profile"] = prof
        if prof["device_busy_ms"] is None:
            log(f"  {key} ({G} x {b}): {prof['step_ms']:.3f} ms a step; "
                f"device time not measured (no device events)")
        else:
            log(f"  {key} ({G} x {b}), 50 profiled steps: "
                f"{prof['step_ms']:.3f} ms a step of host wall, device busy "
                f"{prof['device_busy_ms'] * 1e3:.1f} us a step "
                f"({prof['busy_share']:.1%}), "
                f"{prof['ops_per_step']:.0f} device ops a step")
    return out


def phase_mnist_cli(torch):
    """``python -m repro_torch.launch.train --arch horn-mnist --steps
    200 --device cuda`` in a process of its own: its JSON row, a final
    accuracy above chance (0.1)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "horn-mnist", "--steps", "200", "--device", "cuda"]
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    row = json.loads(r.stdout)
    log(f"  {' '.join(argv[1:])}: {time.perf_counter() - t0:.1f} s; row "
        f"{json.dumps(row)}")
    assert row["steps"] == [50, 100, 150, 200], row
    assert row["final_accuracy"] > 0.1, row
    return row


def phase_resume(torch):
    """qwen3-1.7b at full width, 2 layers, Horn on (4 groups), momentum SGD,
    through the train CLI with ``--checkpoint-dir``: 4 steps straight
    through, then 2 steps and a second invocation that resumes to 4;
    steps 3-4 must give bit-equal losses and grad norms."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    real = train.get_model_config

    def two_layers(arch):
        return dataclasses.replace(real(arch), num_layers=2)

    argv = ["--arch", "qwen3-1.7b", "--full-config", "--batch", "4",
            "--seq", "512", "--horn-groups", "4", "--optimizer", "sgdm",
            "--lr", "3e-4", "--seed", "0", "--device", "cuda",
            "--log-every", "1"]
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    times = {}
    try:
        with mock.patch.object(train, "get_model_config", two_layers):
            def cli(name, steps):
                t0 = time.perf_counter()
                recs = train.main(argv + ["--steps", str(steps),
                                          "--checkpoint-dir",
                                          str(Path(root) / name)])["steps"]
                torch.cuda.synchronize()
                times[f"{name}{steps}"] = time.perf_counter() - t0
                gc.collect()
                torch.cuda.empty_cache()
                return recs

            straight = cli("straight", 4)
            size = sum(f.stat().st_size for f in
                       (Path(root) / "straight").rglob("*") if f.is_file())
            shutil.rmtree(Path(root) / "straight")
            first = cli("split", 2)
            resumed = cli("split", 4)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a = [(r["loss"], r["grad_norm"]) for r in straight]
    b = [(r["loss"], r["grad_norm"]) for r in first + resumed]
    log(f"  straight  {a}")
    log(f"  resumed   {b}")
    log(f"  checkpoint {size / 2**30:.2f} GiB on disk; CLI walls "
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    assert [r["step"] for r in first + resumed] == [1, 2, 3, 4]
    assert all(math.isfinite(x) for pair in a for x in pair)
    assert a == b, (a, b)
    return {"straight": a, "resumed": b, "checkpoint_bytes": size,
            "walls_s": times}


# ---------------------------------------------------------------------------
# phase 11: gemma3-4b (head dim 256) and qwen1.5-4b at full width
# ---------------------------------------------------------------------------
SUPERBLOCK_TOL = 2e-2


def phase_superblock(torch, dev, build, fkernel, fref):
    """One 6-layer superblock of gemma3-4b (5 local layers, window 1024,
    and a global one) at full width, bf16 weights and compute from seed
    0: loss and every parameter's gradient of one forward and backward on
    B 2 x S 2048 seeded tokens through the flash kernels, against the same
    with ``models.attention.flash_attention`` routed to the plain version
    (and its autograd).  The loss within the bf16 tolerance 2e-2 of the
    plain path's.  The gradients by FlashAttention's own test rule: each
    leaf's largest error against an f32 truth (the same weights in f32,
    f32 compute, the plain path) at most twice the plain bf16 path's (the
    two bf16 sides differ in roundings of attention only: the kernels
    round P and dS to bf16, the plain version its f32 output once; a
    norm's scale vector sums 32,768 (token, head) rows, so there the two
    differ by a few bf16 ulps of the leaf's scale)."""
    from repro_torch.configs.base import get_model_config
    from repro_torch.models import api, attention
    from repro_torch.models.params import cast_params, init_params

    cfg = dataclasses.replace(get_model_config("gemma3-4b"), num_layers=6)
    params = init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    for p in params.parameters():
        p.requires_grad_(True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 2049)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def loss_and_grads(model, c):
        loss, _ = api.model_loss(model, batch, c, remat=False)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        return float(loss.detach()), [g.float() for g in grads]

    def plain(q, k, v, *, scale, causal=True, window=None, softcap=None):
        return fref.attention_ref(q, k, v, scale=scale, causal=causal,
                                  window=window, softcap=softcap)

    build.reset_launches()
    loss, grads = loss_and_grads(params, cfg)
    route = fkernel.route(torch.bfloat16, cfg.head_dim)
    launched = [build.ROUTE_LAUNCHES.get(f"{n}:{route}", 0)
                for n in (fkernel.FWD, fkernel.BWD)]
    assert launched == [6, 6], (route, launched)
    with mock.patch.object(attention, "flash_attention", plain):
        build.reset_launches()
        want_loss, want = loss_and_grads(params, cfg)
        truth_loss, truth = loss_and_grads(
            cast_params(params, torch.float32),
            dataclasses.replace(cfg, dtype="float32"))
        assert build.LAUNCHES[fkernel.FWD] == 0
    loss_err = abs(loss - want_loss) / abs(want_loss)
    names = [n for n, _ in params.named_parameters()]
    ratio, vs_plain = {}, {}
    for n, g, w, t in zip(names, grads, want, truth):
        assert torch.isfinite(g).all(), n
        scale = t.abs().max().clamp_min(1e-30)
        e_kernel = float((g - t).abs().max() / scale)
        e_plain = float((w - t).abs().max() / scale)
        ratio[n] = e_kernel / max(e_plain, 1e-6)
        vs_plain[n] = float((g - w).abs().max() / scale)
    worst = max(ratio, key=ratio.get)
    far = max(vs_plain, key=vs_plain.get)
    log(f"  gemma3-4b superblock (6 layers, full width, bf16, B 2 x S "
        f"2048): loss {loss:.5f} kernels, {want_loss:.5f} plain, "
        f"{truth_loss:.5f} f32 (rel to plain {loss_err:.2e}, tol "
        f"{SUPERBLOCK_TOL:g}); launches {launched[0]} fwd + {launched[1]} "
        f"bwd on '{route}'")
    log(f"  {len(ratio)} gradients, error against f32 of the kernel path "
        f"over the plain bf16 path's: largest {ratio[worst]:.2f} "
        f"({worst}), {sum(r > 1 for r in ratio.values())} above 1 "
        f"(limit 2); largest |kernel - plain| {vs_plain[far]:.2e} of the "
        f"leaf's scale ({far})")
    assert loss_err <= SUPERBLOCK_TOL, (loss, want_loss)
    assert ratio[worst] <= 2.0, (worst, ratio[worst])
    return {"loss": loss, "plain_loss": want_loss, "f32_loss": truth_loss,
            "loss_rel_err": loss_err, "grad_err_ratio_max": ratio[worst],
            "grad_err_ratio_argmax": worst,
            "grad_vs_plain_max": vs_plain[far],
            "grad_vs_plain_argmax": far, "launches": launched}


def phase_new_archs(torch, dev, build, kernel, fkernel, fref):
    """gemma3-4b and qwen1.5-4b at full width: the superblock check, then
    training through ``launch.train`` (gemma3-4b 4 steps, qwen1.5-4b 2, at
    B 2 x S 2048 with AdamW; S > 1024, so gemma3-4b's 28 local layers
    mask by their window), then each serving phase 5's load in bf16."""
    out = {"superblock": phase_superblock(torch, dev, build, fkernel, fref)}
    gc.collect()
    torch.cuda.empty_cache()
    for arch, steps in (("gemma3-4b", TRAIN_STEPS), ("qwen1.5-4b", 2)):
        log(f"  train {arch}: {steps} steps, B 2 x S 2048, AdamW")
        out[f"train_{arch}"] = phase_train(
            torch, build, fkernel, arch=arch, batch=2, seq=2048,
            steps=steps)
        gc.collect()
        torch.cuda.empty_cache()
    for arch in ("gemma3-4b", "qwen1.5-4b"):
        log(f"  serve {arch}: phase 5's load, bf16")
        launches, served, eng = phase_serve(torch, dev, build, kernel, arch)
        served["launches"] = launches
        out[f"serve_{arch}"] = served
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12: Horn multi-submodel serving (ModelBank circuits, Router,
# on-device ensembles) and sampling at temperature > 0
# ---------------------------------------------------------------------------
BANK_HORN = dict(enabled=True, keep_hidden=0.5, keep_input=1.0,
                 block_size=16)
LOGIT_TOL = 1e-4                 # f32 logits of one position, two batches


class LogitTap:
    """Records the logits the unified step computes for each running
    request, keyed by (request id, stream position they predict): every
    row of the step's ``logit_index`` window (the last valid position, or
    a speculative verify window), a row at chunk position j predicting
    position start + j + 1.  Wraps ``models.api.paged_step`` while ``eng``
    runs; the draft's steps (no window) are not recorded, and a position
    a later tick predicts again keeps the later row.  Only the parity
    checks use it (one host copy a tick)."""

    def __init__(self, eng):
        from repro_torch.models import api

        self.store, self._api, self._orig = {}, api, api.paged_step
        tap = self

        def paged_step(*args, **kw):
            logits, cache = tap._orig(*args, **kw)
            idx = kw.get("logit_index")
            if idx is None:
                return logits, cache
            pos = (args[3][:, None] + idx + 1).tolist()
            lens = args[4].tolist()
            rows = logits.float().cpu()
            for slot, req in eng.sched.running.items():
                if lens[slot]:
                    for j, at in enumerate(pos[slot]):
                        tap.store[(req.id, at)] = rows[slot, j]
            return logits, cache

        self._wrapped = paged_step

    def __enter__(self):
        self._api.paged_step = self._wrapped
        return self

    def __exit__(self, *exc):
        self._api.paged_step = self._orig


def first_parting(a, b):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def top2_gap(torch, logits) -> float:
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def compare_streams(torch, what, key, got, want, tap_got, tap_want,
                    tol=LOGIT_TOL):
    """Two streams of one prompt (``key``: the first engine's request id,
    the prompt length, the second's request id) and the logits behind
    them: max |d| of the logits at every position both computed on the
    same prefix, held to ``tol`` (None: printed, not held); where the
    streams part, the position and the top-2 gap there are printed.
    Returns (equal, max |d|)."""
    rid, plen, rid2 = key
    j = first_parting(got, want)
    upto = min(len(got), len(want)) if j is None else j + 1
    d = 0.0
    for i in range(upto):
        a, b = tap_got.get((rid, plen + i)), tap_want.get((rid2, plen + i))
        if a is not None and b is not None:
            d = max(d, float((a - b).abs().max()))
    if j is not None:
        gap = top2_gap(torch, tap_got[(rid, plen + j)])
        log(f"    {what}: streams part at token {j} ({got[j]} vs "
            f"{want[j]}), top-2 logit gap there {gap:.3e}")
    assert tol is None or d <= tol, (what, d)
    return j is None, d


def phase_bank_parity(torch, dev):
    """Phase 12(a): qwen3-1.7b at full width, 2 layers, f32 (TF32 off),
    a bank of 3 circuits at keep 0.5 in 16-unit blocks.  Routed streams
    (three circuits co-batched) against dedicated ``bank.subset([g])``
    engines, greedy and at temperature 0.8; two sampled runs bit-equal;
    mean-logit and majority-vote ensembles against a plain recompute of
    each circuit (dense-cache decode through ``lm_forward(serve_masks=)``,
    no paged kernel), combined on the host; the card's threefry bits
    against the CPU's."""
    from repro_torch.configs.base import HornConfig, get_model_config
    from repro_torch.core import prng
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving import Engine, EngineConfig, ModelBank, Router

    out = {}
    # the card's threefry against the CPU's: integer math, so exact
    keys = {d: prng.fold_in(prng.fold_in(prng.key(2 ** 31 - 1, d),
                                         torch.arange(8, device=d) * 7),
                            torch.arange(8, device=d) + 3)
            for d in ("cpu", dev)}
    assert torch.equal(keys[dev].cpu(), keys["cpu"])
    for what, fn in (("bits", prng.random_bits), ("uniforms", prng.uniform)):
        got = {d: fn(keys[d], (151936,)) for d in keys}
        assert torch.equal(got[dev].cpu(), got["cpu"]), what
    logits = torch.randn(8, 151936,
                         generator=torch.Generator().manual_seed(0))
    draws = {d: prng.categorical(keys[d], logits.to(d) / 0.8).cpu()
             for d in keys}
    cat_equal = int((draws[dev] == draws["cpu"]).sum())
    log(f"  threefry: keys, 8 x 151936 bits and uniforms on the card == the "
        f"CPU's; categorical draws equal {cat_equal}/8")
    out["threefry_card_eq_cpu"] = True
    out["categorical_equal"] = cat_equal

    cfg = dataclasses.replace(get_model_config("qwen3-1.7b"), num_layers=2,
                              dtype="float32")
    params = init_params(cfg, 1234, device=dev, dtype=torch.float32)
    bank = ModelBank(cfg, HornConfig(**BANK_HORN), 3, seed=0)
    max_new = 8
    base = EngineConfig(num_slots=4, num_pages=64, page_size=16,
                        max_prompt_len=64, max_new_tokens=max_new,
                        token_budget=32, policy="on_demand",
                        kv_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 23, 40)]

    def routed(temperature, ensemble=None):
        eng = Engine(cfg, params, dataclasses.replace(
            base, temperature=temperature), bank=bank,
            router=Router(3, policy="explicit"), device=dev)
        with LogitTap(eng) as tap:
            reqs = [eng.submit(p, max_new, submodel_id=g)
                    for g, p in enumerate(prompts)]
            group = eng.submit(prompts[1], max_new, ensemble=ensemble) \
                if ensemble else None
            eng.run()
        eng.pool.check_invariants()
        assert eng.stats.ticks_cobatched >= 1
        return eng, reqs, group, tap.store

    for temperature in (0.0, 0.8):
        eng, reqs, group, tap = routed(
            temperature, "mean_logit" if temperature else None)
        equal, worst = 0, 0.0
        for g, (req, p) in enumerate(zip(reqs, prompts)):
            ded = Engine(cfg, params, dataclasses.replace(
                base, temperature=temperature), bank=bank.subset([g]),
                router=Router(1, policy="explicit"), device=dev)
            ded._next_id = req.id             # same (request, step) keys
            with LogitTap(ded) as dtap:
                r = ded.submit(p, max_new, submodel_id=0)
                ded.run()
            same, d = compare_streams(
                torch, f"T {temperature} circuit {g}", (req.id, len(p), r.id),
                list(req.out_tokens), list(r.out_tokens), tap, dtap.store)
            equal += same
            worst = max(worst, d)
        line = (f"  routed (3 circuits co-batched, co-batch ratio "
                f"{eng.stats.cobatch_ratio:.0%}) vs dedicated engines at T "
                f"{temperature}: {equal}/3 streams identical, logits max "
                f"|d| {worst:.2e} (tol {LOGIT_TOL:g})")
        res = {"streams_equal": equal, "logit_max_abs_diff": worst,
               "cobatch_ratio": eng.stats.cobatch_ratio}
        if temperature:
            again = routed(temperature, "mean_logit")
            first = [list(r.out_tokens) for r in reqs] + [group.out_tokens]
            second = [list(r.out_tokens) for r in again[1]] + \
                [again[2].out_tokens]
            assert first == second, (first, second)
            line += "; two runs (with a mean-logit ensemble) bit-equal"
            res["two_runs_equal"] = True
            del again
        log(line)
        out[f"routed_t{temperature}"] = res
        del eng
        gc.collect()

    # ensembles against the plain recompute, combined on the host
    prompt = prompts[1]
    L, G = len(prompt), bank.num_submodels
    masks = [{k: torch.from_numpy(v[[g]]).to(dev)
              for k, v in bank.masks.items()} for g in range(G)]
    for combine in ("mean_logit", "majority_vote"):
        eng = Engine(cfg, params, base, bank=bank, device=dev)
        with LogitTap(eng) as tap:
            group = eng.submit(prompt, max_new, ensemble=combine)
            eng.run()
        got = group.out_tokens
        assert all(list(m.out_tokens) == got for m in group.members)
        want, worst = [], 0.0
        with torch.inference_mode():
            ctx = T.init_cache(cfg, 1, L + max_new, dtype=torch.float32,
                               device=dev)
            for i, t in enumerate(prompt[:-1]):  # the dense-parent context
                _, ctx = api.decode_step(
                    params, ctx, torch.tensor([[int(t)]], device=dev), i,
                    cfg)
            caches = [[tuple(t.clone() for t in e) for e in ctx]
                      for _ in range(G)]
            feed = int(prompt[-1])
            for i in range(max_new):
                rows = []
                for g in range(G):
                    lg, caches[g] = api.decode_step(
                        params, caches[g], torch.tensor([[feed]], device=dev),
                        L - 1 + i, cfg, serve_masks=masks[g])
                    rows.append(lg[0].float().cpu())
                    mine = tap.store.get((group.members[g].id, L + i))
                    if mine is not None:
                        worst = max(worst, float((mine - rows[-1]).abs().max()))
                if combine == "mean_logit":
                    want.append(int(torch.argmax(torch.stack(rows).mean(0))))
                else:
                    votes = torch.bincount(
                        torch.stack([torch.argmax(r) for r in rows]),
                        minlength=cfg.vocab_size)
                    want.append(int(torch.argmax(votes)))
                if want[-1] != got[i]:
                    log(f"    {combine}: parts from the recompute at token "
                        f"{i} ({got[i]} vs {want[-1]}), top-2 gap of the "
                        f"mean logits "
                        f"{top2_gap(torch, torch.stack(rows).mean(0)):.3e}")
                    break
                feed = want[-1]
        assert worst <= LOGIT_TOL, (combine, worst)
        equal = got == want
        log(f"  {combine} ensemble of 3 circuits (prompt {L}, context "
            f"prefilled once by the dense parent, "
            f"{eng.stats.prefill_tokens} prefill tokens): stream "
            f"{'==' if equal else '!='} the plain recompute combined on the "
            f"host; member logits max |d| {worst:.2e}")
        out[f"ensemble_{combine}"] = {"stream_equal": equal,
                                      "logit_max_abs_diff": worst}
        del eng
        gc.collect()
    del params
    return out


def phase_bank_serve(torch, dev, build, kernel, params, temperature,
                     cfg=None):
    """Phase 12(b): qwen3-1.7b at full width (28 layers, bf16) as a bank
    of 4 circuits at keep 0.5 (16-unit blocks), ``least_loaded`` routing,
    a quarter of the requests mean-logit ensembles over all 4, serving
    phase 5's load (2 warm-up requests, then 16 at t=0, 32 new tokens
    each) at ``temperature``.  Every sequence finishes in-vocabulary, an
    ensemble's members carry one stream, each tick launches one paged
    kernel a layer on the routes phase 5 asserts; tok/s, TTFT, tick wall,
    co-batch ratio, tokens per circuit and a profiled tick printed."""
    from repro_torch.configs.base import HornConfig, get_model_config
    from repro_torch.launch.serve import (drive, make_requests, summarize,
                                          with_ensembles)
    from repro_torch.serving import Engine, EngineConfig, ModelBank, Router

    cfg = cfg or get_model_config("qwen3-1.7b")
    G, gen = 4, 32
    bank = ModelBank(cfg, HornConfig(**BANK_HORN), G, seed=0)
    ecfg = EngineConfig(num_slots=8, num_pages=512, page_size=16,
                        max_prompt_len=256, max_new_tokens=gen,
                        token_budget=256, policy="on_demand",
                        kv_dtype="bfloat16", compute_dtype="bfloat16",
                        temperature=temperature, seed=0)
    eng = Engine(cfg, params, ecfg, bank=bank,
                 router=Router(G, policy="least_loaded"), device=dev)
    rng = np.random.default_rng(0)            # phase 5's draws
    warm = [(0.0, p, 4) for _, p, _ in make_requests(
        2, cfg.vocab_size, rng, stream="batch", max_prompt=256, gen=4)]
    pending = with_ensembles([(0.0, p, gen) for _, p, _ in make_requests(
        16, cfg.vocab_size, rng, stream="batch", max_prompt=256, gen=gen)],
        rng, 0.25, "mean_logit")
    drive(eng, [warm[0] + (None,), warm[1] + ("mean_logit",)])
    eng.reset_stats()
    build.reset_launches()
    wall = drive(eng, pending)
    launches = {n: build.LAUNCHES[n] for n in (kernel.NAME,
                                               kernel.NAME_DECODE)}
    chunk_route = kernel.chunk_route(
        torch.bfloat16, False, cfg.head_dim, ecfg.page_size,
        cfg.num_heads // cfg.num_kv_heads)
    chunk_on = build.ROUTE_LAUNCHES.get(f"{kernel.NAME}:{chunk_route}", 0)
    decode_route, splits = engine_decode_route(kernel, eng, dev)
    decode_on = build.ROUTE_LAUNCHES.get(
        f"{kernel.NAME_DECODE}:{decode_route}", 0)
    r = summarize(eng, wall)
    s = eng.stats
    n_ens = sum(1 for p in pending if p[3])
    assert r["requests"] == len(pending), r
    assert r["sequences"] == len(pending) + (G - 1) * n_ens, r
    for req in eng.sched.finished:
        assert len(req.out_tokens) == gen, (req.id, len(req.out_tokens))
        assert all(0 <= t < cfg.vocab_size for t in req.out_tokens)
        if req.group is not None:
            assert list(req.out_tokens) == req.group.out_tokens
    assert sum(launches.values()) == cfg.num_layers * s.steps > 0, launches
    assert launches[kernel.NAME_DECODE] == s.decode_launches == \
        cfg.num_layers * s.decode_ticks > 0, (launches, s.decode_ticks)
    assert chunk_on == launches[kernel.NAME] > 0, (chunk_on, launches)
    assert decode_on == launches[kernel.NAME_DECODE], (decode_on, launches)
    assert s.cobatch_ratio > 0 and set(s.tokens_by_submodel) == set(range(G))
    assert eng.router.loads == [0] * G
    r.update(temperature=temperature, ensembles=n_ens, launches=launches,
             chunk_route=chunk_route, decode_route=decode_route,
             decode_splits=splits, tick_ms=wall / max(s.steps, 1) * 1e3,
             tokens_by_submodel=dict(s.tokens_by_submodel),
             bank_device_bytes=bank.device_bytes())
    log(f"  T {temperature}: {r['requests']} requests ({n_ens} mean-logit "
        f"ensembles of {G}, {r['sequences']} sequences), {r['ticks']} "
        f"ticks: {r['tok_s']:.1f} tok/s ({r['device_tok_s']:.1f} device "
        f"tok/s)  TTFT p50 {r['ttft_p50_s'] * 1e3:.1f} ms  p99 "
        f"{r['ttft_p99_s'] * 1e3:.1f} ms  tick {r['tick_ms']:.2f} ms  "
        f"wall {wall:.3f} s")
    units = " + ".join(f"{k} {v.shape[-1]}" for k, v in bank.masks.items())
    log(f"    co-batch ratio {s.cobatch_ratio:.0%}; tokens by circuit "
        f"{dict(sorted(s.tokens_by_submodel.items()))}; bank on the card "
        f"{bank.device_bytes():,} B ((G+1) x {cfg.num_layers} layers x "
        f"({units}) x 4)")
    log(f"    {kernel.NAME_DECODE} launches {launches[kernel.NAME_DECODE]}"
        f" = {cfg.num_layers} x {s.decode_ticks} decode-only ticks, all on "
        f"'{decode_route}' (NS {splits}); {kernel.NAME} launches "
        f"{launches[kernel.NAME]} = {cfg.num_layers} x "
        f"{s.steps - s.decode_ticks} ticks with prompt chunks, all on "
        f"'{chunk_route}'")
    r["tick_profile"] = phase_tick_profile(torch, eng, kernel, ensembles=1)
    del eng
    gc.collect()
    return r


def phase_bank(torch, dev, build, kernel):
    """Phase 12: 12(a) parity, then 12(b) at temperature 0 and 0.8."""
    from repro_torch.configs.base import get_model_config
    from repro_torch.models.params import init_params

    t0 = time.perf_counter()
    out = {"parity": phase_bank_parity(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(get_model_config("qwen3-1.7b"), 0, device=dev,
                         dtype=torch.bfloat16)
    for temperature in (0.0, 0.8):
        out[f"serve_t{temperature}"] = phase_bank_serve(
            torch, dev, build, kernel, params, temperature)
        gc.collect()
        torch.cuda.empty_cache()
    del params
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 12: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: speculative decoding (a Horn circuit drafts, the parent verifies
# a K + 1 window through the paged kernels)
# ---------------------------------------------------------------------------
SPEC_K = 4
DRAFT_HORN = dict(enabled=True, keep_hidden=0.875, keep_input=1.0,
                  block_size=16)


class KernelCapture:
    """Copies the inputs of two paged-kernel launches while ``eng`` runs,
    and lets them run unchanged: the first launch of the chunk kernel in a
    verify tick (the parent's first launch after a draft call, where a
    slot's chunk holds ``S_v`` tokens), and the first launch of the decode
    kernel in a draft step
    (inside ``eng.spec.propose``), one with an idle row when there is one.
    ``hold`` then runs each kernel and its plain version on the copies,
    the chunk kernel also with the S_v-row verify window as its
    ``logit_index``."""

    def __init__(self, torch, kernel, eng, S_v):
        self.torch, self.kernel, self.eng, self.S_v = torch, kernel, eng, S_v
        self.got, self._in_draft, self._idle_seen = {}, False, False
        self._drafted = False

    @staticmethod
    def _copy(args, kw):
        def own(t):
            return t.clone() if hasattr(t, "clone") else t
        return [own(a) for a in args], {k: own(v) for k, v in kw.items()}

    def __enter__(self):
        k, cap = self.kernel, self
        self._orig = (k.paged_chunk_attention, k.paged_attention,
                      self.eng.spec.propose)

        def chunk(*args, **kw):
            if cap._drafted and not cap._in_draft and "verify" not in \
                    cap.got and bool((args[5] == cap.S_v).any()):
                cap.got["verify"] = cap._copy(args, kw)
            return cap._orig[0](*args, **kw)

        def decode(*args, **kw):
            # the first draft decode launch, replaced once by the first
            # with an idle row
            if cap._in_draft and not cap._idle_seen:
                idle = bool((args[4] == 0).any())
                if idle or "draft_decode" not in cap.got:
                    cap.got["draft_decode"] = cap._copy(args, kw)
                    cap._idle_seen = idle
            return cap._orig[1](*args, **kw)

        def propose(*args, **kw):
            cap._in_draft = True
            try:
                return cap._orig[2](*args, **kw)
            finally:
                cap._in_draft, cap._drafted = False, True

        k.paged_chunk_attention, k.paged_attention = chunk, decode
        self.eng.spec.propose = propose
        return self

    def __exit__(self, *exc):
        self.kernel.paged_chunk_attention, self.kernel.paged_attention = \
            self._orig[:2]
        del self.eng.spec.propose

    def hold(self, ref, tol):
        """Each captured launch again through the kernel and its plain
        version: max |d| of the outputs (and of the verify window's rows),
        held to ``tol``; the decode launch's idle rows (length 0, on the
        null page) must be exactly 0.  Returns {shape: max |d|}."""
        torch, kernel = self.torch, self.kernel
        assert set(self.got) == {"verify", "draft_decode"}, set(self.got)
        out = {}
        for what, (fk, fr) in (
                ("verify", (kernel.paged_chunk_attention,
                            ref.paged_chunk_attention_ref)),
                ("draft_decode", (kernel.paged_attention,
                                  ref.paged_attention_ref))):
            args, kw = self.got[what]
            if what == "verify":
                # the verify window of each slot, left-aligned on its chunk
                # (the unified step's rows for a speculating slot)
                j = torch.arange(self.S_v, device=args[5].device)[None, :]
                kw = dict(kw, logit_index=torch.minimum(
                    j, torch.clamp(args[5][:, None] - 1, min=0)).to(
                        torch.int32).contiguous())
            got, want = fk(*args, **kw), fr(*args, **kw)
            torch.cuda.synchronize()
            pairs = list(zip(got, want)) if isinstance(got, tuple) \
                else [(got, want)]
            out[what] = max((x.float() - y.float()).abs().max().item()
                            for x, y in pairs)
            for x, y in pairs:
                torch.testing.assert_close(x.float(), y.float(), atol=tol,
                                           rtol=tol)
            if what == "draft_decode":
                idle = args[4] == 0
                assert torch.all(got[idle] == 0), "idle draft row not 0"
        return out


def spec_launch_checks(torch, kernel, build, eng, dev):
    """The paged-kernel launches of a speculating run, read from 0 before
    it: the parent's (one a layer a tick: the decode kernel on decode-only
    ticks, the chunk kernel on the others, verify ticks included) and the
    draft's (one a layer a draft paged step: the decode kernel at C == 1),
    which together are ``build.LAUNCHES``; by route, every chunk launch on
    ``chunk_route``'s kernel and every decode launch on the split rule's
    route for its block table (the parent's and the draft's own width).
    Returns the counts."""
    cfg, s, spec = eng.cfg, eng.stats, eng.spec
    L = cfg.num_layers
    assert s.attn_launches == L * s.steps > 0, (s.attn_launches, s.steps)
    assert s.decode_launches == L * s.decode_ticks, s.decode_launches
    assert s.draft_attn_launches == L * spec.paged_steps > 0, \
        (s.draft_attn_launches, spec.paged_steps)
    assert s.draft_decode_launches == L * spec.decode_steps > 0, \
        (s.draft_decode_launches, spec.decode_steps)
    parent_chunk = s.attn_launches - s.decode_launches
    draft_chunk = s.draft_attn_launches - s.draft_decode_launches
    assert parent_chunk > 0
    assert build.LAUNCHES[kernel.NAME] == parent_chunk + draft_chunk
    assert build.LAUNCHES[kernel.NAME_DECODE] == \
        s.decode_launches + s.draft_decode_launches
    chunk_route = kernel.chunk_route(
        getattr(torch, eng.ecfg.compute_dtype), eng.ecfg.kv_dtype == "int8",
        cfg.head_dim, eng.ecfg.page_size, cfg.num_heads // cfg.num_kv_heads)
    assert build.ROUTE_LAUNCHES.get(f"{kernel.NAME}:{chunk_route}", 0) == \
        parent_chunk + draft_chunk, (chunk_route, dict(build.ROUTE_LAUNCHES))
    routes = {}
    for who, maxp, n in (("parent", eng.max_pages_per_seq,
                          s.decode_launches),
                         ("draft", spec.max_pages_per_seq,
                          s.draft_decode_launches)):
        splits = kernel.decode_splits(
            eng.ecfg.num_slots, cfg.num_kv_heads,
            cfg.num_heads // cfg.num_kv_heads, maxp,
            kernel.sm_count(dev.index))
        route = kernel.decode_route(splits)
        routes[who] = (route, splits)
        routes.setdefault(route, 0)
        routes[route] += n
    for route in {routes["parent"][0], routes["draft"][0]}:
        assert build.ROUTE_LAUNCHES.get(
            f"{kernel.NAME_DECODE}:{route}", 0) == routes[route], routes
    return {"parent_chunk": parent_chunk,
            "parent_decode": s.decode_launches,
            "draft_chunk": draft_chunk,
            "draft_decode": s.draft_decode_launches,
            "chunk_route": chunk_route,
            "decode_route_parent": routes["parent"],
            "decode_route_draft": routes["draft"]}


def phase_spec_parity(torch, dev, kernel, ref):
    """Phase 13(a): qwen3-1.7b at full width, 2 layers, f32 (TF32 off), 8
    slots, 6 requests (two slots stay idle), K 4; the draft a draft-only
    bank's circuit at keep 0.875.  Greedy speculative streams equal the
    non-speculative engine's, with more than one token a speculating
    slot-tick and fewer ticks; two T 0.8 speculative runs bit-equal; the
    card's speculative streams against the CPU plain path's (the first
    parting token and the top-2 gap there printed); both pools' invariants
    hold and the draft pool ends empty; the verify tick's chunk launch (an
    S_v = 5 window) and a draft step's decode launch held against their
    plain versions on the same inputs."""
    from repro_torch.configs.base import HornConfig, get_model_config
    from repro_torch.models.params import init_params
    from repro_torch.serving import Engine, EngineConfig, ModelBank

    cfg = dataclasses.replace(get_model_config("qwen3-1.7b"), num_layers=2,
                              dtype="float32")
    params = {"card": init_params(cfg, 1234, device=dev,
                                  dtype=torch.float32)}
    params["cpu"] = copy.deepcopy(params["card"]).to("cpu")
    horn = HornConfig(**DRAFT_HORN)
    drafts = {w: ModelBank(cfg, horn, 1, seed=0).draft_model(0, p)
              for w, p in params.items()}
    max_new = 12
    base = EngineConfig(num_slots=8, num_pages=128, page_size=16,
                        max_prompt_len=64, max_new_tokens=max_new,
                        token_budget=64, policy="on_demand",
                        kv_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 17, 23, 31, 40, 61)]

    def serve(where, spec, temperature=0.0, capture=False):
        ecfg = dataclasses.replace(base, temperature=temperature,
                                   speculate_k=SPEC_K if spec else 0)
        eng = Engine(cfg, params[where], ecfg,
                     draft=drafts[where] if spec else None,
                     device=dev if where == "card" else "cpu")
        cap = KernelCapture(torch, kernel, eng, SPEC_K + 1) if capture \
            else None
        with LogitTap(eng) as tap, cap or contextlib.nullcontext():
            for p in prompts:
                eng.submit(p, max_new)
            eng.run()
        eng.pool.check_invariants()
        if spec:
            eng.spec.pool.check_invariants()
            assert eng.spec.pool.num_seqs == 0
        streams = {r.id: list(r.out_tokens) for r in eng.sched.finished}
        assert all(len(t) == max_new for t in streams.values())
        return eng, streams, tap.store, cap

    out = {}
    t0 = time.perf_counter()
    plain, want, _, _ = serve("card", False)
    eng, got, tap, cap = serve("card", True, capture=True)
    s = eng.stats
    assert got == want, (got, want)
    assert s.accepted_tok_per_tick > 1 and s.steps < plain.stats.steps, \
        (s.accepted_tok_per_tick, s.steps, plain.stats.steps)
    out["greedy"] = {"streams_equal": True, "ticks": s.steps,
                     "ticks_plain": plain.stats.steps,
                     "accept_rate": s.accept_rate,
                     "accepted_tok_per_tick": s.accepted_tok_per_tick,
                     "draft_calls": eng.spec.draft_calls}
    log(f"  greedy, K {SPEC_K}, {len(prompts)} requests x {max_new} tokens "
        f"on 8 slots: speculative streams == non-speculative ({s.steps} "
        f"ticks against {plain.stats.steps}); accept rate "
        f"{s.accept_rate:.1%}, {s.accepted_tok_per_tick:.2f} tokens a "
        f"speculating slot-tick, {eng.spec.draft_calls} draft calls; both "
        f"pools' invariants hold, the draft pool ends empty "
        f"({time.perf_counter() - t0:.1f} s)")
    errs = cap.hold(ref, 2e-5)
    out["kernel_vs_plain"] = errs
    vq = cap.got["verify"][0][0]
    log(f"  verify tick's {kernel.NAME} (C {vq.shape[1]}, S_v "
        f"{SPEC_K + 1} window, f32 q on "
        f"'{kernel.chunk_route(vq.dtype, False, cfg.head_dim, 16, 2)}'): "
        f"max |kernel - plain| {errs['verify']:.3g}; a draft step's "
        f"{kernel.NAME_DECODE} (idle rows 0): {errs['draft_decode']:.3g} "
        f"(tol 2e-5)")
    del plain, cap

    t0 = time.perf_counter()
    runs = [serve("card", True, temperature=0.8)[1] for _ in range(2)]
    assert runs[0] == runs[1], runs
    out["t0.8_two_runs_equal"] = True
    log(f"  T 0.8: two speculative runs bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    _, cpu, cpu_tap, _ = serve("cpu", True)
    equal, worst = 0, 0.0
    for rid, p in enumerate(prompts):
        same, d = compare_streams(torch, f"request {rid} card vs CPU",
                                  (rid, len(p), rid), got[rid], cpu[rid],
                                  tap, cpu_tap, tol=None)
        equal += same
        worst = max(worst, d)
    out["card_vs_cpu"] = {"streams_equal": equal, "logit_max_abs_diff":
                          worst}
    log(f"  greedy speculative streams, card vs the CPU plain path: "
        f"{equal}/{len(prompts)} equal, logits max |d| {worst:.2e} on "
        f"shared prefixes ({time.perf_counter() - t0:.1f} s)")
    del eng, params, drafts
    gc.collect()
    return out


def phase_spec_tick_profile(torch, eng, kernel, n=2):
    """A speculating decode tick with its draft call: 8 slots at context
    ~100, host wall per tick over ``n`` ticks, then ``n`` ticks profiled:
    device busy, ops and the paged kernels' device time (the chunk kernel
    is the parent's verify, the decode kernel the draft's C == 1 steps).
    Reports "not measured" when the profiler sees no device activity."""
    rng = np.random.default_rng(5)
    for _ in range(eng.ecfg.num_slots):
        eng.submit(rng.integers(1, eng.cfg.vocab_size, (96,)), 32)
    while eng.sched.waiting or any(r.in_prefill
                                   for r in eng.sched.running.values()):
        eng.step()
    torch.cuda.synchronize()
    calls0 = eng.spec.draft_calls
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    assert eng.spec.draft_calls - calls0 == n, "a timed tick did not draft"
    out = {"spec_tick_ms": wall_ms, "device_busy_ms": None,
           "kernels_per_tick": None}
    events = device_events(torch, lambda: [eng.step() for _ in range(n)],
                           cpu=False)
    eng.run()
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    log(f"  speculating tick (8 slots, context ~100, K {SPEC_K}, with its "
        f"draft call): {wall_ms:.2f} ms wall")
    if busy <= 0:
        log("  device time per tick: not measured (no device events)")
        return out
    by = {name: sum(e.self_device_time_total for e in events
                    if key in e.key) / n / 1e3
          for name, key in KERNEL_KEYS.items()}
    out.update(device_busy_ms=busy, kernels_per_tick=sum(
        e.count for e in events) / n, paged_ms=by)
    log(f"  device busy {busy:.2f} ms a tick ({busy / wall_ms:.1%} of the "
        f"wall, profiled), {out['kernels_per_tick']:.0f} device ops a tick; "
        f"{kernel.NAME} {by[kernel.NAME]:.3f} ms, {kernel.NAME_DECODE} "
        f"{by[kernel.NAME_DECODE]:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / n / 1e3:7.3f} ms  "
            f"x{e.count / n:5.0f}  {e.key[:90]}")
    return out


def phase_spec_serve(torch, dev, build, kernel, ref, params, draft,
                     temperature):
    """Phase 13(b): qwen3-1.7b at full width (28 layers, bf16), phase 5's
    load (2 warm-up requests, then 16 at t=0, prompts 5-203, 32 new tokens,
    8 slots, budget 256) with ``--speculate 4`` and a draft-only circuit
    at keep 0.875, at ``temperature``: every request finishes with 32
    in-vocabulary tokens, launch counts asserted by route and by parent
    against draft (``spec_launch_checks``), the verify and draft-decode
    launches held against their plain versions (T 0), tok/s, TTFT,
    latency, ticks, accept rate, accepted tokens a tick and draft calls
    printed, and a speculating tick profiled."""
    from repro_torch.configs.base import get_model_config
    from repro_torch.launch.serve import drive, make_requests, summarize
    from repro_torch.serving import Engine, EngineConfig

    cfg = get_model_config("qwen3-1.7b")
    gen = 32
    ecfg = EngineConfig(num_slots=8, num_pages=512, page_size=16,
                        max_prompt_len=256, max_new_tokens=gen,
                        token_budget=256, policy="on_demand",
                        kv_dtype="bfloat16", compute_dtype="bfloat16",
                        temperature=temperature, seed=0, speculate_k=SPEC_K)
    eng = Engine(cfg, params, ecfg, draft=draft, device=dev)
    rng = np.random.default_rng(0)            # phase 5's draws
    warm = [(0.0, p, 4) for _, p, _ in make_requests(
        2, cfg.vocab_size, rng, stream="batch", max_prompt=256, gen=4)]
    pending = [(0.0, p, gen) for _, p, _ in make_requests(
        16, cfg.vocab_size, rng, stream="batch", max_prompt=256, gen=gen)]
    t0 = time.perf_counter()
    drive(eng, warm)
    log(f"  T {temperature}: warm-up {time.perf_counter() - t0:.1f} s")
    eng.reset_stats()
    cap = KernelCapture(torch, kernel, eng, SPEC_K + 1) \
        if temperature == 0 else None
    build.reset_launches()
    with cap or contextlib.nullcontext():
        wall = drive(eng, pending)
    launches = spec_launch_checks(torch, kernel, build, eng, dev)
    r = summarize(eng, wall)
    s = eng.stats
    assert r["requests"] == len(pending), r
    for req in eng.sched.finished:
        assert len(req.out_tokens) == gen, (req.id, len(req.out_tokens))
        assert all(0 <= t < cfg.vocab_size for t in req.out_tokens)
    eng.pool.check_invariants()
    eng.spec.pool.check_invariants()
    assert eng.spec.pool.num_seqs == 0
    r.update(temperature=temperature, launches=launches,
             tick_ms=wall / max(s.steps, 1) * 1e3,
             draft_paged_steps=eng.spec.paged_steps,
             draft_decode_steps=eng.spec.decode_steps)
    log(f"  T {temperature}: {r['requests']} requests, {r['ticks']} ticks "
        f"({s.decode_ticks} decode-only): {r['tok_s']:.1f} tok/s  TTFT p50 "
        f"{r['ttft_p50_s'] * 1e3:.1f} ms  latency p99 "
        f"{r['latency_p99_s'] * 1e3:.1f} ms  tick {r['tick_ms']:.2f} ms  "
        f"wall {wall:.3f} s")
    log(f"    accept rate {s.accept_rate:.1%}, {s.accepted_tok_per_tick:.2f}"
        f" tokens a speculating slot-tick ({s.spec_slot_ticks} slot-ticks, "
        f"{s.spec_drafted} drafted, {s.spec_accepted} accepted, "
        f"{s.spec_committed} committed), {r['draft_calls']} draft calls, "
        f"{eng.spec.paged_steps} draft paged steps")
    log(f"    parent: {kernel.NAME} {launches['parent_chunk']} = "
        f"{cfg.num_layers} x {s.steps - s.decode_ticks} ticks, "
        f"{kernel.NAME_DECODE} {launches['parent_decode']}; draft: "
        f"{kernel.NAME} {launches['draft_chunk']}, {kernel.NAME_DECODE} "
        f"{launches['draft_decode']} = {cfg.num_layers} x "
        f"{eng.spec.decode_steps} C == 1 steps; chunks all on "
        f"'{launches['chunk_route']}', decode on "
        f"'{launches['decode_route_parent'][0]}' (NS "
        f"{launches['decode_route_parent'][1]} parent, "
        f"{launches['decode_route_draft'][1]} draft)")
    if cap is not None:
        r["kernel_vs_plain"] = cap.hold(ref, 2e-2)
        log(f"    verify tick's {kernel.NAME} (bf16, S_v {SPEC_K + 1}) max "
            f"|kernel - plain| {r['kernel_vs_plain']['verify']:.3g}; draft "
            f"step's {kernel.NAME_DECODE} "
            f"{r['kernel_vs_plain']['draft_decode']:.3g} (tol 2e-2)")
        del cap
    t0 = time.perf_counter()
    r["tick_profile"] = phase_spec_tick_profile(torch, eng, kernel)
    log(f"    tick profile {time.perf_counter() - t0:.1f} s")
    del eng
    gc.collect()
    return r


def phase_spec(torch, dev, build, kernel, ref):
    """Phase 13: 13(a) parity, then 13(b) at temperature 0 and 0.8."""
    from repro_torch.configs.base import HornConfig, get_model_config
    from repro_torch.models.params import init_params
    from repro_torch.serving import ModelBank

    t0 = time.perf_counter()
    out = {"parity": phase_spec_parity(torch, dev, kernel, ref)}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_model_config("qwen3-1.7b")
    params = init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    draft = ModelBank(cfg, HornConfig(**DRAFT_HORN), 1, seed=0).draft_model(
        0, params)
    log(f"  draft: circuit 0 of a draft-only bank, keep 0.875, d_ff "
        f"{draft.cfg.d_ff} of {cfg.d_ff} (kept {draft.kept_frac:.1%})")
    for temperature in (0.0, 0.8):
        out[f"serve_t{temperature}"] = phase_spec_serve(
            torch, dev, build, kernel, ref, params, draft, temperature)
        gc.collect()
        torch.cuda.empty_cache()
    del params, draft
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 13: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 14: observability and deterministic trace replay
# ---------------------------------------------------------------------------
TRACES = ROOT / "benchmarks" / "traces"
PINNED = ("bursty_multiclass", "decode_heavy", "shared_prefix")
TIE_GAP = 1e-3                   # a top-2 logit gap this small is a tie


def trace_engine(torch, meta, cfg, params, dev, telemetry, **over):
    """The engine a pinned trace's header meta describes (the JAX package's
    ``benchmarks/regression.py::build_engine``: its slots, pages, budget,
    policy, prefix cache, K and the draft circuit 0 of a draft-only bank
    at the meta's keep, 16-unit blocks), over ``cfg``/``params`` on
    ``dev``; ``over`` replaces EngineConfig fields."""
    from repro_torch.launch.serve import build_draft
    from repro_torch.serving import Engine, EngineConfig

    psize, seed = int(meta["page_size"]), int(meta.get("seed", 0))
    ecfg = EngineConfig(
        num_slots=int(meta["slots"]), num_pages=int(meta["pages"]),
        page_size=psize,
        max_prompt_len=-(-int(meta["max_prompt"]) // psize) * psize,
        max_new_tokens=int(meta["gen"]),
        token_budget=max(int(meta["budget"]), int(meta["slots"])),
        seed=seed, policy=meta.get("policy", "on_demand"),
        prefix_cache=bool(meta.get("prefix_cache", True)),
        speculate_k=int(meta.get("speculate_k", 0)),
        kv_dtype=meta.get("kv_dtype", "float32"),
        compute_dtype=meta.get("compute_dtype", "float32"))
    ecfg = dataclasses.replace(ecfg, **over)
    draft = build_draft(cfg, params, None, speculate=ecfg.speculate_k,
                        draft_circuit=0,
                        draft_keep=float(meta.get("draft_keep", 0.875)),
                        mask_block=16, seed=seed)
    return Engine(cfg, params, ecfg, draft=draft, device=dev,
                  telemetry=telemetry)


class DraftTap:
    """Records every draft call of ``eng``: the proposals by slot, and the
    logits of each of the call's k paged steps (the draft's steps run
    ``models.api.paged_step`` without a ``logit_index``), one host copy a
    step.  Only the parity check uses it."""

    def __init__(self, eng):
        from repro_torch.models import api

        self.calls, self.logits = [], []
        self._api, self._orig = api, None
        self._spec, self._propose = eng.spec, eng.spec.propose
        tap, inside = self, [False]

        def paged_step(*args, **kw):
            out = tap._orig(*args, **kw)
            if inside[0] and kw.get("logit_index") is None:
                tap.logits[-1].append(out[0].float().cpu())
            return out

        def propose(units, k, key):
            inside[0] = True
            tap.logits.append([])
            try:
                drafts, q = tap._propose(units, k, key)
            finally:
                inside[0] = False
            tap.calls.append({s: [int(t) for t in drafts[s, :k]]
                              for s, _ in units})
            return drafts, q

        self._wrapped = (paged_step, propose)

    def __enter__(self):
        # wraps whatever is bound now (a LogitTap entered before it)
        self._orig = self._api.paged_step
        self._api.paged_step, self._spec.propose = self._wrapped
        return self

    def __exit__(self, *exc):
        self._api.paged_step = self._orig
        self._spec.propose = self._propose


def replay_tie_guard(torch, name, recs, card, cpu):
    """Card against CPU replay of one trace on fresh engines (submission i
    is request id i): (result, engine, LogitTap, DraftTap or None) each.
    Where the draft's proposals part, the card's top-2 draft logit gap
    there, and where a stream parts, the top-2 gap of the card's parent
    logits there (as ``compare_streams`` reads it), must be a tie (at most
    ``TIE_GAP``); with no parting, the digest, ticks, TTFT, latency and
    accept rate must be equal.  Returns what was found."""
    res, _, tap, dtap = card
    cres, _, _, cdtap = cpu
    out = {"digest_equal": res.token_digest == cres.token_digest,
           "ties": []}
    if dtap is not None:
        for i, (a, b) in enumerate(zip(dtap.calls, cdtap.calls)):
            if a == b:
                continue
            slot = next(s for s in sorted(a) if a[s] != b.get(s))
            j = first_parting(a[slot], b[slot])
            gap = top2_gap(torch, dtap.logits[i][j][slot])
            log(f"    {name}: draft call {i}, slot {slot}: proposals part "
                f"at {j} ({a[slot][j]} vs {b[slot][j]}), top-2 draft logit "
                f"gap {gap:.3e}")
            assert gap <= TIE_GAP, (name, "draft", i, gap)
            out["ties"].append({"draft_call": i, "gap": gap})
            break
    plens = [len(r.prompt) for r in sorted(recs, key=lambda r: r.arrival_s)]
    for (i, got), (_, want) in zip(res.streams, cres.streams):
        j = first_parting(got, want)
        if j is None:
            continue
        gap = top2_gap(torch, tap.store[(i, plens[i] + j)])
        log(f"    {name}: stream {i} parts at token {j} ({got[j]} vs "
            f"{want[j]}), top-2 logit gap on the card {gap:.3e}")
        assert gap <= TIE_GAP, (name, "stream", i, gap)
        out["ties"].append({"stream": i, "token": j, "gap": gap})
        break
    if not out["ties"]:
        assert out["digest_equal"], name
        assert (res.ticks, res.ttft_s, res.latency_s, res.accept_rate) == \
            (cres.ticks, cres.ttft_s, cres.latency_s, cres.accept_rate), name
    return out


def phase_replay_parity(torch, dev, build, kernel):
    """Phase 14(a): qwen3-1.7b at full width, 2 layers, f32 (TF32 off),
    weights from seed 0.  Each pinned trace replayed at its meta's engine
    settings on the card and, in the same process, through the plain path
    on the CPU: equal digests, ticks, TTFT and latency, or a named tie
    (``replay_tie_guard``); on the card, both paged kernels' launches
    (counted from 0 around the replay) equal the engine's own counts,
    parent and draft."""
    from repro_torch.configs.base import get_model_config
    from repro_torch.models.params import init_params
    from repro_torch.serving import Telemetry
    from repro_torch.serving.observability import load_trace, replay

    cfg = dataclasses.replace(get_model_config("qwen3-1.7b"), num_layers=2,
                              dtype="float32")
    params = {"card": init_params(cfg, 0, device=dev, dtype=torch.float32)}
    params["cpu"] = copy.deepcopy(params["card"]).to("cpu")
    out = {}
    for name in PINNED:
        t0 = time.perf_counter()
        recs, meta = load_trace(str(TRACES / f"{name}.jsonl"))
        tick_dt = float(meta.get("tick_dt", 0.01))
        runs = {}
        for where in ("card", "cpu"):
            eng = trace_engine(torch, meta, cfg, params[where],
                               dev if where == "card" else "cpu",
                               Telemetry(trace_maxlen=None))
            dtap = DraftTap(eng) if eng.spec is not None else None
            build.reset_launches()
            with LogitTap(eng) as tap, dtap or contextlib.nullcontext():
                res = replay(eng, recs, tick_dt=tick_dt)
            counted = {n: build.LAUNCHES[n]
                       for n in (kernel.NAME, kernel.NAME_DECODE)}
            eng.pool.check_invariants()
            runs[where] = (res, eng, tap, dtap)
            if where == "cpu":
                assert sum(counted.values()) == 0, counted
                continue
            launches, s = counted, eng.stats
            assert launches[kernel.NAME] + launches[kernel.NAME_DECODE] == \
                s.attn_launches + s.draft_attn_launches, (launches, s)
            assert launches[kernel.NAME_DECODE] == \
                s.decode_launches + s.draft_decode_launches, (launches, s)
            assert s.attn_launches == cfg.num_layers * s.steps > 0
            assert s.decode_launches == cfg.num_layers * s.decode_ticks
        res = runs["card"][0]
        got = replay_tie_guard(torch, name, recs, runs["card"], runs["cpu"])
        got.update(ticks=res.ticks, cpu_ticks=runs["cpu"][0].ticks,
                   generated_tokens=res.generated_tokens,
                   accept_rate=res.accept_rate, digest=res.token_digest,
                   launches=launches)
        out[name] = got
        log(f"  {name}: {len(recs)} requests, {res.ticks} ticks, "
            f"{res.generated_tokens} tokens, digest "
            f"{res.token_digest[:16]}: card "
            f"{'==' if got['digest_equal'] else '!='} CPU plain path"
            f"{'' if not got['ties'] else ' (a tie, above)'}; TTFT and "
            f"latency lists equal: "
            f"{res.ttft_s == runs['cpu'][0].ttft_s}; accept rate "
            f"{res.accept_rate:.3f}; launches {launches[kernel.NAME]} "
            f"chunk + {launches[kernel.NAME_DECODE]} decode == the "
            f"engine's counts ({time.perf_counter() - t0:.1f} s)")
        del runs
        gc.collect()
    del params
    return out


def phase_replay_serve(torch, dev, build, kernel, params):
    """Phase 14(b): qwen3-1.7b at full width (28 layers, bf16), each pinned
    trace on one engine with ``Telemetry(timeline=True)``, warmed as the
    JAX package's regression harness warms it (replayed until a replay
    mints no new compile cell: the prefix cache's hits change the chunk
    widths of the second replay, at most 4 times; that replay is the
    first of two), then once more: the digest identical run to run, no compile cell after the warmup
    boundary, a CUDA-event ``device_ms_p50`` for every profiler variant,
    the Chrome export valid; per variant the calls and device ms p50 of
    the last run, its tick wall p50 and busy share (CUDA-event device ms
    over host tick wall)."""
    import tempfile

    from repro_torch.configs.base import get_model_config
    from repro_torch.serving import Telemetry
    from repro_torch.serving.observability import (load_trace, replay,
                                                   validate_chrome_trace)

    cfg = get_model_config("qwen3-1.7b")
    out = {}
    for name in PINNED:
        t0 = time.perf_counter()
        recs, meta = load_trace(str(TRACES / f"{name}.jsonl"))
        tick_dt = float(meta.get("tick_dt", 0.01))
        eng = trace_engine(torch, meta, cfg, params, dev,
                           Telemetry(timeline=True),
                           kv_dtype="bfloat16", compute_dtype="bfloat16")
        prof = eng.obs.profiler
        cold, warmups = None, 0
        while True:                 # the last of these is the first run
            build.reset_launches()
            first = replay(eng, recs, tick_dt=tick_dt)
            cold = cold or first
            warmups += 1
            if not prof.compiles_total or warmups == 4:
                break
        assert prof.compiles_total == 0, prof.summary()
        warmups -= 1
        launches1 = {n: build.LAUNCHES[n]
                     for n in (kernel.NAME, kernel.NAME_DECODE)}
        before = prof.cost_report()
        build.reset_launches()
        second = replay(eng, recs, tick_dt=tick_dt)
        launches = {n: build.LAUNCHES[n]
                    for n in (kernel.NAME, kernel.NAME_DECODE)}
        cost = prof.cost_report()
        assert second.token_digest == first.token_digest, name
        assert (second.ticks, second.ttft_s, second.latency_s) == \
            (first.ticks, first.ttft_s, first.latency_s), name
        assert prof.compiles_post_warm == 0, prof.summary()
        assert launches == launches1, (launches, launches1)
        s = eng.stats
        assert launches[kernel.NAME] + launches[kernel.NAME_DECODE] == \
            s.attn_launches + s.draft_attn_launches > 0, (launches, s)
        for req in eng.sched.finished:
            assert all(0 <= t < cfg.vocab_size for t in req.out_tokens)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / f"{name}.trace.json"
            n_events = eng.obs.timeline.export(str(path))
            doc = json.loads(path.read_text())
        assert validate_chrome_trace(doc) == n_events > 0
        walls = sorted(second.tick_wall_s)
        wall_p50 = float(np.percentile(walls, 50)) * 1e3
        variants = {}
        for label, c in cost.items():
            assert c["device_ms_p50"] is not None, (label, c)
            b = before.get(label, {"calls": 0, "device_ms_total": 0.0})
            calls = c["calls"] - b["calls"]
            total = c["device_ms_total"] - b["device_ms_total"]
            variants[label] = {"calls": calls, "device_ms_p50":
                               c["device_ms_p50"], "device_ms_total": total}
        busy = sum(v["device_ms_total"] for v in variants.values()) \
            / (sum(walls) * 1e3)
        out[name] = {"ticks": second.ticks, "digest": second.token_digest,
                     "generated_tokens": second.generated_tokens,
                     "accept_rate": second.accept_rate,
                     "tick_wall_p50_ms": wall_p50, "busy_share": busy,
                     "chrome_events": n_events, "launches": launches,
                     "warmup_replays": warmups,
                     "cold_digest_equal": cold.token_digest
                     == second.token_digest,
                     "variants_seen": len(cost),
                     "variants": variants,
                     "decode_tok_s_p10": second.summary()[
                         "decode_tok_s_p10"]}
        log(f"  {name}: {len(recs)} requests, {second.ticks} ticks, "
            f"{second.generated_tokens} tokens, digest "
            f"{second.token_digest[:16]} twice after {warmups} warm-up "
            f"replay(s) (cold replay's digest "
            f"{'equal' if cold.token_digest == second.token_digest else 'other'}"
            f"); 0 compiles after warm-up; "
            f"tick wall p50 {wall_p50:.2f} ms; CUDA-event device time "
            f"{busy:.1%} of the tick walls; accept rate "
            f"{second.accept_rate:.3f}; {n_events} Chrome events, valid; "
            f"launches {launches[kernel.NAME]} chunk + "
            f"{launches[kernel.NAME_DECODE]} decode "
            f"({time.perf_counter() - t0:.1f} s)")
        for label, v in sorted(variants.items()):
            log(f"    {label}: {v['calls']} calls, device ms p50 "
                f"{v['device_ms_p50']:.3f} ({v['device_ms_p50'] / wall_p50:.1%}"
                f" of the tick wall p50)")
        del eng
        gc.collect()
    return out


def phase_replay_cli(torch):
    """Phase 14(b), the CLI: ``launch.serve --full-config`` (28 layers,
    bf16) records a batch of 6 requests with ``--record-trace``, then
    ``--replay`` serves the file twice; the same digest both times.  The
    entry point runs in this process (``serve.main(argv)``), the file in a
    temporary directory."""
    import contextlib as cl
    import io
    import re
    import tempfile

    from repro_torch.launch import serve

    def run(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with cl.redirect_stdout(buf):
            serve.main(["--full-config", "--device", "cuda", *argv])
        gc.collect()
        torch.cuda.empty_cache()
        return buf.getvalue(), time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        trace = str(Path(tmp) / "t.jsonl")
        text, sec = run("--requests", "6", "--gen", "8", "--stream", "batch",
                        "--max-prompt", "64", "--record-trace", trace)
        assert f"recorded 6 requests -> {trace}" in text, text[-2000:]
        log(f"  serve --full-config --record-trace: 6 requests recorded "
            f"({sec:.1f} s)")
        digests = []
        for _ in range(2):
            text, sec = run("--replay", trace)
            digests.append(re.search(r"digest ([0-9a-f]{64})",
                                     text).group(1))
            assert "alerts:" in text and "device ms p50" in text, \
                text[-2000:]
            log(f"  serve --replay: digest {digests[-1][:16]} ({sec:.1f} s)")
    assert digests[0] == digests[1], digests
    return {"digest": digests[0], "runs": 2}


def sync_sites(torch, fn):
    """The synchronising CUDA calls ``fn()`` makes
    (``torch.cuda.set_sync_debug_mode("warn")`` warns once a call), each
    as (the line that made the call, the innermost line of the port under
    it: ``file:line`` of ``src/``, or "-" when no port code is on the
    stack)."""
    import traceback
    import warnings

    src = str(ROOT / "src")
    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(src)]
        sites.append((f"{Path(filename).name}:{lineno}",
                      f"{Path(ours[-1].filename).name}:{ours[-1].lineno}"
                      if ours else "-"))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def phase_telemetry_cost(torch, dev, params):
    """Phase 14(c): phase 5's load (28 layers, bf16, 16 requests x 32
    tokens after 2 warm-up requests) with ``Telemetry()`` and with
    ``Telemetry(tracer=False, profiler=False, anomaly=False)``, three
    times each in alternation: the tick wall p50 of each run and of each
    setting, and the host time spent in the telemetry hooks a tick
    (``Telemetry.on_*`` and the profiler's wrappers, timed around each
    call).  Then, after one priming pass of the sync debug mode, two warm
    decode ticks under ``torch.cuda.set_sync_debug_mode("warn")`` with
    each setting, twice in alternation: the same synchronising calls from
    the same lines of the port, none in the observability package."""
    from repro_torch.configs.base import get_model_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.serving import Engine, EngineConfig, Telemetry

    cfg = get_model_config("qwen3-1.7b")
    ecfg = EngineConfig(num_slots=8, num_pages=512, page_size=16,
                        max_prompt_len=256, max_new_tokens=32,
                        token_budget=256, policy="on_demand",
                        kv_dtype="bfloat16", compute_dtype="bfloat16")
    settings = {"on": lambda: Telemetry(),
                "off": lambda: Telemetry(tracer=False, profiler=False,
                                         anomaly=False)}
    engines = {k: Engine(cfg, params, ecfg, device=dev, telemetry=mk())
               for k, mk in settings.items()}
    rng = np.random.default_rng(0)                # phase 5's draws
    warm = make_requests(2, cfg.vocab_size, rng, stream="batch",
                         max_prompt=256, gen=4)
    load = make_requests(16, cfg.vocab_size, rng, stream="batch",
                         max_prompt=256, gen=32)

    def serve(eng, reqs, gen):
        for _, p, _ in reqs:
            eng.submit(p, gen)
        walls = []
        while eng.sched.has_work():
            t0 = time.perf_counter()
            eng.step()
            walls.append(time.perf_counter() - t0)
        return walls

    # host time inside telemetry: every Telemetry hook, timed around each
    # call, and a profiler wrapper's own work, timed on a no-op step
    obs = engines["on"].obs
    hook_s = [0.0]

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                hook_s[0] += time.perf_counter() - t0
        return call

    for name in ("on_submit", "on_admit", "on_prefill_chunk", "on_token",
                 "on_speculate", "on_preempt", "on_finish", "on_tick"):
        setattr(obs, name, timed(getattr(obs, name)))
    from repro_torch.serving.observability import StepProfiler
    prof = StepProfiler()
    noop = prof.wrap("noop", lambda: None, key_fn=lambda a, kw: ((), ""),
                     device=dev)
    for _ in range(10):
        noop()
    t0 = time.perf_counter()
    for i in range(2000):
        noop()
        if i % 8 == 7:
            prof.drain()
    wrap_us = (time.perf_counter() - t0) / 2000 * 1e6
    t0 = time.perf_counter()
    for _ in range(2000):
        (lambda: None)()
    wrap_us -= (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    del prof, noop

    for eng in engines.values():
        serve(eng, warm, 4)
        eng.reset_stats()
    walls = {k: [] for k in engines}
    runs = {k: [] for k in engines}
    hooks_us = []
    for _ in range(3):
        for k, eng in engines.items():
            hook_s[0] = 0.0
            w = serve(eng, load, 32)
            if k == "on":
                hooks_us.append(hook_s[0] / len(w) * 1e6)
            walls[k] += w
            runs[k].append(float(np.percentile(w, 50)) * 1e3)
            eng.reset_stats()
    p50 = {k: float(np.percentile(v, 50)) * 1e3 for k, v in walls.items()}
    cost = p50["on"] / p50["off"] - 1.0
    log(f"  phase 5's load, three times a setting in alternation: tick "
        f"wall p50 {p50['on']:.2f} ms with Telemetry() (runs "
        f"{', '.join(f'{x:.2f}' for x in runs['on'])}), {p50['off']:.2f} ms"
        f" with tracer, profiler and anomaly off (runs "
        f"{', '.join(f'{x:.2f}' for x in runs['off'])}): {cost:+.1%}; "
        f"{len(walls['on'])} and {len(walls['off'])} ticks")
    hooks = float(np.median(hooks_us)) + wrap_us
    log(f"  host time in telemetry: {hooks:.1f} us a tick "
        f"({hooks / 1e3 / p50['on']:.2%} of the tick wall p50): the hooks "
        f"{', '.join(f'{x:.1f}' for x in hooks_us)} us a tick in the three "
        f"runs, the profiler's wrapper {wrap_us:.1f} us a call (CUDA "
        f"events recorded, drained every 8 calls)")
    for eng in engines.values():
        rng = np.random.default_rng(5)
        for _ in range(ecfg.num_slots):
            eng.submit(rng.integers(1, cfg.vocab_size, (96,)), 32)
        while eng.sched.waiting or any(r.in_prefill
                                       for r in eng.sched.running.values()):
            eng.step()
        eng.step()                                 # warm decode tick
    sync_sites(torch, lambda: None)                # the debug mode's priming
    sites = {k: [] for k in engines}
    for _ in range(2):
        for k, eng in engines.items():
            sites[k].append(sync_sites(torch, lambda: [eng.step()
                                                       for _ in range(2)]))
    for eng in engines.values():
        eng.run()
    ours = {k: [[p for _, p in r] for r in v] for k, v in sites.items()}
    log(f"  two warm decode ticks under sync debug mode, twice a setting: "
        f"with Telemetry() {[len(r) for r in sites['on']]} synchronising "
        f"calls, without {[len(r) for r in sites['off']]}; sites "
        f"{sorted(set(x for r in sites['on'] + sites['off'] for x in r))}")
    assert ours["on"] == ours["off"], sites
    assert not any(p.split(":")[0] in (
        "telemetry.py", "profiler.py", "trace.py", "metrics.py",
        "anomaly.py", "slo.py", "stats.py") for r in ours["on"] for p in r)
    per_tick = len(sites["on"][0]) / 2
    del engines, obs
    gc.collect()
    return {"tick_wall_p50_ms": p50, "tick_wall_p50_runs_ms": runs,
            "telemetry_cost": cost, "telemetry_us_per_tick": hooks,
            "profiler_wrap_us": wrap_us,
            "ticks": {k: len(v) for k, v in walls.items()},
            "syncs_per_tick": per_tick,
            "sync_sites": sorted(set(x for r in sites["on"] for x in r))}


def phase_observability(torch, dev, build, kernel):
    """Phase 14: 14(a) replay parity, 14(b) replays and the CLI round trip
    at 28 layers, 14(c) what telemetry costs a tick."""
    from repro_torch.configs.base import get_model_config
    from repro_torch.models.params import init_params

    t0 = time.perf_counter()
    out = {"parity": phase_replay_parity(torch, dev, build, kernel)}
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(get_model_config("qwen3-1.7b"), 0, device=dev,
                         dtype=torch.bfloat16)
    out["replay"] = phase_replay_serve(torch, dev, build, kernel, params)
    gc.collect()
    torch.cuda.empty_cache()
    out["telemetry_cost"] = phase_telemetry_cost(torch, dev, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["cli"] = phase_replay_cli(torch)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 14: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the MoE, multimodal-prefix and hybrid families
# ---------------------------------------------------------------------------
# depth of each arch on the card: cut only as far as 79.18 GiB forces (bf16
# weights: phi3.5-moe 32 layers 78.0 GiB, 16 layers 39.2; jamba 72 layers
# far past it, 5 (M M M M A, MoE at 1 and 3) 44.7); widths never cut
FAMILY_DEPTH = {"phi3.5-moe-42b": 16, "llama4-maverick-400b": 48,
                "llava-next-34b": 60, "jamba-1.5-large-398b": 5}
FAMILY_PREFILL = 2048            # tokens a prefill, patches included
FAMILY_DECODE = 16               # greedy decode steps after it
TIE_GAP = 1e-3                   # a stream may part only at a top-2 tie


def family_cfg(arch, num_layers=None, **over):
    from repro_torch.configs.base import get_model_config

    return dataclasses.replace(get_model_config(arch), num_layers=num_layers
                               or FAMILY_DEPTH[arch], **over)


def release(torch):
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_layer_parity(torch, dev, cfg, params, cpu_params):
    """Phase 15(a), the layer: layer 0's ``moe_apply`` on the card and on
    the CPU plain path (f32, TF32 off) on one 256-token chunk and on 8
    decode rows of one token: the expert choices and the kept masks equal,
    the output within 1e-4 of its largest value (the fan-in-E init makes
    expert outputs ~1e3; the two devices sum 4096 and 6400 terms in
    different orders), the aux within 1e-5."""
    from repro_torch.models import layers as L

    out = {}
    for what, (R, S) in (("chunk", (1, 256)), ("decode", (8, 1))):
        gen = torch.Generator(dev).manual_seed(S)
        x = torch.randn(R, S, cfg.d_model, generator=gen, device=dev)
        res = {}
        with torch.inference_mode():
            for where, p, xx in (("card", params, x),
                                 ("cpu", cpu_params, x.cpu())):
                moe = p.layers[0].moe
                rt = L.moe_route(moe, xx, cfg)
                y, aux = L.moe_apply(moe, xx, cfg)
                res[where] = (rt.gate_e.cpu(), rt.keep.cpu(), y.cpu(),
                              {k: v.item() for k, v in aux.items()})
        (ce, ck, cy, ca), (pe, pk, py, pa) = res["card"], res["cpu"]
        err, scale = (cy - py).abs().max().item(), py.abs().max().item()
        out[what] = {"rows": R, "tokens": S, "capacity":
                     L.moe_capacity(cfg, S), "choices_equal":
                     torch.equal(ce, pe), "kept_equal": torch.equal(ck, pk),
                     "max_abs_err": err, "max_abs_out": scale,
                     "aux_card": ca, "aux_cpu": pa}
        log(f"  moe_apply {what} ({R} x {S} tokens, capacity "
            f"{out[what]['capacity']}): expert choices equal "
            f"{out[what]['choices_equal']}, kept equal "
            f"{out[what]['kept_equal']}; max |card - CPU| {err:.3g} of max "
            f"|out| {scale:.3g} (tol 1e-4 of it); aux card {ca}, CPU {pa}")
        assert out[what]["choices_equal"] and out[what]["kept_equal"], what
        assert err <= 1e-4 * scale, (what, err, scale)
        for k in L.MOE_AUX:
            assert abs(ca[k] - pa[k]) <= 1e-5 * max(1.0, abs(pa[k])), k
    return out


def phase_moe_engine_parity(torch, dev, cfg, params, cpu_params):
    """Phase 15(a), the engine: 4 requests x 8 greedy tokens through
    ``Engine`` on the card and on the CPU plain path, plain and with a
    2-circuit bank (its "moe" masks live): the streams equal, the logits
    behind them within 1e-4 where both computed them on one prefix, a
    parting only at a top-2 tie (gap printed)."""
    from repro_torch.configs.base import HornConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.serving import Engine, EngineConfig, ModelBank

    max_new = 8
    ecfg = EngineConfig(num_slots=4, num_pages=64, page_size=16,
                        max_prompt_len=64, max_new_tokens=max_new,
                        token_budget=64, policy="on_demand",
                        kv_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 23, 40, 61)]
    out = {}
    for name, G in (("plain", 0), ("bank", 2)):
        runs = {}
        for where, p, d in (("card", params, dev), ("cpu", cpu_params,
                                                    "cpu")):
            bank = ModelBank(cfg, HornConfig(**BANK_HORN), G, seed=0) \
                if G else None
            eng = Engine(cfg, p, ecfg, bank=bank, device=d)
            build.reset_launches()
            with LogitTap(eng) as tap:
                reqs = [eng.submit(pr, max_new) for pr in prompts]
                eng.run()
            eng.pool.check_invariants()
            launches = sum(build.LAUNCHES[n] for n in (kernel.NAME,
                                                       kernel.NAME_DECODE))
            if where == "card":
                assert launches == cfg.num_layers * eng.stats.steps > 0
            runs[where] = (reqs, tap.store)
            del eng
        (creqs, ctap), (preqs, ptap) = runs["card"], runs["cpu"]
        equal, worst = 0, 0.0
        for i, (a, b, pr) in enumerate(zip(creqs, preqs, prompts)):
            got, want = list(a.out_tokens), list(b.out_tokens)
            same, d = compare_streams(torch, f"{name} request {i}",
                                      (a.id, len(pr), b.id), got, want,
                                      ctap, ptap)
            j = first_parting(got, want)
            if j is not None:
                assert top2_gap(torch, ctap[(a.id, len(pr) + j)]) <= \
                    TIE_GAP, (name, i, j)
            equal += same
            worst = max(worst, d)
        out[name] = {"streams_equal": equal, "logit_max_abs_diff": worst}
        log(f"  engine {name}{f' ({G} circuits)' if G else ''}: "
            f"{equal}/{len(prompts)} streams card == CPU plain path, "
            f"logits max |d| {worst:.2e} (tol {LOGIT_TOL:g})")
    return out


def phase_prefix_parity(torch, dev, build, fkernel, arch):
    """Phase 15(a) for a multimodal arch: 2 layers at full width, f32, a
    prefill of 1 x (576 patches + 64 text tokens) through
    ``make_prefill_step`` and 4 greedy decode steps (tokens chosen on the
    card, fed to both) on the card and on the CPU plain path: logits
    within 1e-4 at every step; the card's prefill launches flash once a
    layer on its f32 kernel, at G = H / KH of the arch."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core import steps
    from repro_torch.models.params import init_params

    cfg = family_cfg(arch, 2, dtype="float32")
    text, K = 64, 4
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "p", "prefill", cfg.num_patches + text + K, 1),
        compute_dtype="float32")
    params = init_params(cfg, 1234, device=dev, dtype=torch.float32)
    cpu_params = copy.deepcopy(params).to("cpu")
    gen = torch.Generator(dev).manual_seed(15)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, text),
                                     generator=gen, device=dev),
             "patch_embeds": torch.randn(1, cfg.num_patches, cfg.d_model,
                                         generator=gen, device=dev)}
    logits = {}
    for where, p, d in (("card", params, dev), ("cpu", cpu_params, "cpu")):
        prefill = steps.make_prefill_step(run, d)
        decode = steps.make_decode_step(run, d)
        build.reset_launches()
        lg, cache = prefill(p, {k: v.to(d) for k, v in batch.items()})
        rows = [lg.float().cpu()]
        if where == "card":
            route = fkernel.route(torch.float32, cfg.head_dim)
            assert build.LAUNCHES[fkernel.FWD] == build.ROUTE_LAUNCHES.get(
                f"{fkernel.FWD}:{route}") == cfg.num_layers
            fed = []
        for k in range(K):
            if where == "card":
                fed.append(torch.argmax(rows[-1], -1)[:, None])
            lg, cache = decode(p, cache, fed[k].to(d),
                               cfg.num_patches + text + k)
            rows.append(lg.float().cpu())
        logits[where] = rows
        del cache
    errs = [(a - b).abs().max().item()
            for a, b in zip(logits["card"], logits["cpu"])]
    log(f"  {arch} (G {cfg.num_heads // cfg.num_kv_heads}), 2 layers, f32: "
        f"prefill 1 x ({cfg.num_patches} patches + {text} text) + {K} "
        f"decode steps, card vs CPU plain path: logits max |d| by step "
        + " ".join(f"{e:.2e}" for e in errs) + f" (tol {LOGIT_TOL:g}); "
        f"flash launches at prefill: {cfg.num_layers} on "
        f"'{fkernel.route(torch.float32, cfg.head_dim)}'")
    assert max(errs) <= LOGIT_TOL, errs
    del params, cpu_params
    return {"logit_max_abs_diff_by_step": errs}


def prefill_decode(torch, dev, build, fkernel, skernel, arch):
    """Phase 15(d)/(e): ``arch`` at its phase-15 depth, full width, bf16
    weights from seed 0: a prefill of 1 x 2048 tokens (a multimodal arch:
    576 random patch embeddings + 1472 text tokens) through
    ``make_prefill_step`` after one warm-up prefill, then 16 greedy
    ``make_decode_step`` steps.  Flash launches once an attention layer at
    the prefill on its bf16 kernel and never in decode; the SSD kernel once
    a mamba layer on ``wgmma`` and never in decode; every logit finite.
    Returns (results, params, the prefill's inputs)."""
    from repro_torch.configs.base import MAMBA, RunConfig, ShapeConfig
    from repro_torch.core import steps
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params

    cfg = family_cfg(arch)
    npatch, text = cfg.num_patches, FAMILY_PREFILL - cfg.num_patches
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "p", "prefill", FAMILY_PREFILL + FAMILY_DECODE, 1))
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    release(torch)                   # the init's f32 temporaries
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(dev).manual_seed(0)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, text),
                                     generator=gen, device=dev)}
    if npatch:
        batch["patch_embeds"] = torch.randn(
            1, npatch, cfg.d_model, generator=gen,
            device=dev).to(torch.bfloat16)
    prefill = steps.make_prefill_step(run, dev)
    decode = steps.make_decode_step(run, dev)
    logits, cache = prefill(params, batch)                  # warm up
    del logits, cache
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    kinds = cfg.layer_kinds()
    n_attn = sum(k != MAMBA for k in kinds)
    n_mamba = len(kinds) - n_attn
    frt = fkernel.route(torch.bfloat16, cfg.head_dim)
    launches = {fkernel.FWD: build.LAUNCHES[fkernel.FWD],
                skernel.NAME: build.LAUNCHES[skernel.NAME]}
    on_route = {f"{fkernel.FWD}:{frt}": build.ROUTE_LAUNCHES.get(
        f"{fkernel.FWD}:{frt}", 0), f"{skernel.NAME}:wgmma":
        build.ROUTE_LAUNCHES.get(f"{skernel.NAME}:wgmma", 0)}
    assert launches == {fkernel.FWD: n_attn, skernel.NAME: n_mamba}, launches
    assert list(on_route.values()) == [n_attn, n_mamba], on_route
    assert logits.shape == (1, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for i in range(FAMILY_DECODE):
        nxt = torch.argmax(logits, -1)[:, None]
        logits, cache = decode(params, cache, nxt, FAMILY_PREFILL + i)
        assert torch.isfinite(logits).all(), i
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    assert {fkernel.FWD: build.LAUNCHES[fkernel.FWD],
            skernel.NAME: build.LAUNCHES[skernel.NAME]} == launches, \
        "decode launched a prefill kernel"
    peak = torch.cuda.max_memory_allocated()
    del cache
    events = device_events(torch, lambda: prefill(params, batch))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = [[e.key[:90], e.self_device_time_total / 1e3, e.count]
           for e in sorted(events, key=lambda e: -e.self_device_time_total)
           [:6]]
    out = {"arch": arch, "layers": cfg.num_layers, "params": n_params,
           "G": cfg.num_heads // cfg.num_kv_heads, "patches": npatch,
           "text": text, "init_s": init_s, "prefill_s": prefill_s,
           "prefill_tok_s": FAMILY_PREFILL / prefill_s,
           "decode_step_ms": decode_s / FAMILY_DECODE * 1e3,
           "peak_bytes": peak, "launches": launches,
           "launches_on_route": on_route,
           "prefill_device_busy_ms": busy or None, "prefill_top_kernels": top}
    log(f"  {arch}: {cfg.num_layers} layers ({n_attn} attention, {n_mamba} "
        f"mamba, {sum(isinstance(m, L.MoE) for m in params.modules())} "
        f"MoE), {n_params / 1e9:.2f} B bf16 parameters built in "
        f"{init_s:.1f} s; G {out['G']}")
    log(f"    prefill 1 x ({npatch} patches + {text} text): "
        f"{prefill_s * 1e3:.1f} ms wall ({out['prefill_tok_s']:,.0f} tok/s); "
        f"{FAMILY_DECODE} greedy decode steps: {out['decode_step_ms']:.2f} "
        f"ms a step; peak memory {peak / 2**30:.2f} GiB allocated")
    log(f"    launches at prefill {launches} (on route {on_route}); in "
        f"decode: none")
    if busy > 0:
        log(f"    profiled prefill: device busy {busy:.1f} ms "
            f"({busy / (prefill_s * 1e3):.1%} of the unprofiled wall)")
        for name, ms, count in top:
            log(f"      {ms:8.2f} ms  x{count:5d}  {name}")
    else:
        log("    device time of the prefill: not measured (no device events)")
    del logits
    return out, params, batch


def rejects(check, what):
    """A control: ``check()`` on a deliberately broken result must raise
    AssertionError; returns the failure's first line."""
    try:
        check()
    except AssertionError as e:
        return str(e).strip().splitlines()[0]
    raise AssertionError(f"control {what}: the check passed a broken result")


def phase_hybrid_parity(torch, dev, fref, sref, params, batch):
    """Phase 15(e) for jamba (too large for the CPU in f32): each kernel
    call of its bf16 prefill against the kernel's plain version on the
    inputs the model gave it, as phase 9 holds each scan: the 4 scans (y
    and the final state at atol 2e-4 / rtol 1e-3, phase 3's tolerance)
    and the attention layer's flash call at G 8 (atol / rtol 2e-2, phase
    3's bf16 tolerance).  The whole prefill is not held against a plain
    path: its ~1e4 residual stream (the fan-in-E expert init, ROADMAP
    section 3) hides the attention layer's output under the bf16 steps of
    the residual, so the logits read the same with the flash kernel or the
    plain attention.  Controls, which each check must reject: the last
    scan's final state zeroed, and the plain attention with the KV heads
    rolled by one (every query head on the wrong group)."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core import steps
    from repro_torch.models import attention, ssm

    cfg = family_cfg("jamba-1.5-large-398b")
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "p", "prefill", FAMILY_PREFILL, 1))
    prefill = steps.make_prefill_step(run, dev)
    scan, flash = ssm.ssd_chunk_scan, attention.flash_attention
    scans, flashes = [], []

    def recorded_scan(*args, chunk):
        out = scan(*args, chunk=chunk)
        scans.append((args, chunk, out))
        return out

    def recorded_flash(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        flashes.append((q, k, v, kw, out))
        return out

    with mock.patch.object(ssm, "ssd_chunk_scan", recorded_scan), \
            mock.patch.object(attention, "flash_attention", recorded_flash):
        prefill(params, batch)
    assert len(scans) == 4 and len(flashes) == 1, (len(scans), len(flashes))
    scan_errs = []
    for args, chunk, (y, st) in scans:
        y_want, st_want = sref.ssd_chunk_scan_ref(*args, chunk=chunk)
        scan_errs.append(max((y - y_want).abs().max().item(),
                             (st - st_want).abs().max().item()))
        torch.testing.assert_close(y, y_want, atol=2e-4, rtol=1e-3)
        torch.testing.assert_close(st, st_want, atol=2e-4, rtol=1e-3)
    scan_control = rejects(lambda: torch.testing.assert_close(
        torch.zeros_like(st), st_want, atol=2e-4, rtol=1e-3),
        "scan state zeroed")
    del scans, y, st, y_want
    q, k, v, kw, o = flashes.pop()
    want = fref.attention_ref(q, k, v, **kw)
    flash_err = (o.float() - want.float()).abs().max().item()
    torch.testing.assert_close(o.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    wrong = fref.attention_ref(q, torch.roll(k, 1, 1), torch.roll(v, 1, 1),
                               **kw)
    wrong_err = (wrong.float() - want.float()).abs().max().item()
    flash_control = rejects(lambda: torch.testing.assert_close(
        wrong.float(), want.float(), atol=2e-2, rtol=2e-2),
        "KV heads rolled")
    G = q.shape[1] // k.shape[1]
    log(f"  jamba, {cfg.num_layers} layers, bf16, 1 x {FAMILY_PREFILL}: "
        f"each of {len(scan_errs)} scans against the plain scan on its "
        f"inputs: max |d| " + " ".join(f"{e:.3g}" for e in scan_errs)
        + f" (tol 2e-4 + 1e-3 |y|); the flash call (G {G}) against the "
        f"plain attention on its inputs: max |d| {flash_err:.3g} (tol 2e-2 "
        f"+ 2e-2 |o|)")
    log(f"    controls rejected: last scan's final state zeroed (max "
        f"|state| {st_want.abs().max().item():.3g}): {scan_control}; KV "
        f"heads rolled by one (max |d| {wrong_err:.3g}): {flash_control}")
    return {"scan_max_abs_err": scan_errs, "flash_max_abs_err": flash_err,
            "control_state_zeroed_max_abs": st_want.abs().max().item(),
            "control_heads_rolled_max_abs": wrong_err}


def moe_tick_share(torch, eng, n=4):
    """Device time of ``n`` decode ticks (8 running slots) from one
    ``device_events`` window: the busy time and the time of the kernels
    launched inside the MoE layers' ``moe_ffn`` scope (the three expert
    products and the activation), beside the unprofiled tick wall; None
    where the profiler saw no device time."""
    rng = np.random.default_rng(6)
    for _ in range(eng.ecfg.num_slots):
        eng.submit(rng.integers(1, eng.cfg.vocab_size, (96,)),
                   n * (PROFILE_TRIES + 1) + 8)
    while eng.sched.waiting or any(r.in_prefill
                                   for r in eng.sched.running.values()):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    scopes = {"moe_ffn": 0.0}
    events = device_events(torch, lambda: [eng.step() for _ in range(n)],
                           scopes=scopes)
    eng.run()
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    ffn = scopes["moe_ffn"] / n / 1e3
    out = {"decode_tick_ms": wall, "busy_ms": None, "moe_ffn_ms": None}
    if busy <= 0:
        log(f"  decode tick (8 slots): {wall:.2f} ms wall; device time not "
            f"measured (no device events)")
        return out
    out.update(busy_ms=busy, moe_ffn_ms=ffn or None)
    log(f"  decode tick (8 slots): {wall:.2f} ms wall, device busy "
        f"{busy:.2f} ms ({busy / wall:.1%}, profiled), of it the experts' "
        f"FFN (moe_ffn scope) {ffn:.2f} ms ({ffn / busy:.1%})")
    return out


def phase_families(torch, dev, build, kernel, fkernel, fref, skernel, sref):
    """Phase 15: phi3.5-moe, llama4-maverick, llava-next-34b and jamba-1.5-
    large on the card.  (a) 2 layers f32 against the CPU plain path (not
    jamba: its kernel calls are held in (e)); (b) phi3.5-moe
    at 16 layers serving phase 5's load, plain and as a 4-circuit bank;
    (c) phi3.5-moe at 2 layers training; (d) llama4 at 48 and llava at 60
    layers, prefill + decode; (e) jamba at 5 layers, prefill + decode."""
    from repro_torch.launch import train
    from repro_torch.models.params import init_params

    t0 = time.perf_counter()
    out = {}
    moe = "phi3.5-moe-42b"
    log("  (a) 2 layers at full width, f32, card vs CPU plain path")
    cfg = family_cfg(moe, 2, dtype="float32")
    params = init_params(cfg, 1234, device=dev, dtype=torch.float32)
    cpu_params = copy.deepcopy(params).to("cpu")
    out["moe_layer"] = phase_moe_layer_parity(torch, dev, cfg, params,
                                              cpu_params)
    out["moe_engine"] = phase_moe_engine_parity(torch, dev, cfg, params,
                                                cpu_params)
    del params, cpu_params
    release(torch)
    for arch in ("llama4-maverick-400b", "llava-next-34b"):
        out[f"parity_{arch}"] = phase_prefix_parity(torch, dev, build,
                                                    fkernel, arch)
        release(torch)

    log(f"  (b) serve {moe}, {FAMILY_DEPTH[moe]} layers, bf16, phase 5's "
        f"load")
    cfg = family_cfg(moe)
    torch.cuda.reset_peak_memory_stats()
    launches, served, eng = phase_serve(torch, dev, build, kernel, moe, cfg)
    served["launches"] = launches
    served["moe_tick"] = moe_tick_share(torch, eng)
    served["peak_bytes"] = torch.cuda.max_memory_allocated()
    params = eng.params
    del eng
    release(torch)
    log(f"    peak memory {served['peak_bytes'] / 2**30:.2f} GiB allocated")
    out["serve"] = served
    log(f"  (b) the same load on a bank of 4 circuits (\"moe\" masks), T 0")
    out["serve_bank"] = phase_bank_serve(torch, dev, build, kernel, params,
                                         0.0, cfg)
    del params
    release(torch)

    log(f"  (c) train {moe}, 2 layers at full width")
    real = train.get_model_config

    def two_layers(arch):
        return dataclasses.replace(real(arch), num_layers=2)

    with mock.patch.object(train, "get_model_config", two_layers):
        trained = phase_train(torch, build, fkernel, arch=moe, batch=2,
                              seq=1024, steps=3)
    for r in trained["steps"]:
        assert all(math.isfinite(r[k]) for k in ("load_balance_loss",
                                                 "router_z_loss",
                                                 "dropped_frac")), r
    log("    aux by step: " + "; ".join(
        f"lb {r['load_balance_loss']:.4f} z {r['router_z_loss']:.3f} "
        f"dropped {r['dropped_frac']:.4f}" for r in trained["steps"]))
    out["train"] = trained
    release(torch)

    log("  (d) llama4-maverick and llava-next-34b at full depth, bf16")
    for arch in ("llama4-maverick-400b", "llava-next-34b"):
        res, params, _ = prefill_decode(torch, dev, build, fkernel, skernel,
                                        arch)
        out[arch] = res
        del params
        release(torch)

    log("  (e) jamba-1.5-large, 5 layers, bf16")
    arch = "jamba-1.5-large-398b"
    res, params, batch = prefill_decode(torch, dev, build, fkernel, skernel,
                                        arch)
    out[arch] = res
    out["jamba_parity"] = phase_hybrid_parity(torch, dev, fref, sref,
                                              params, batch)
    del params, batch
    release(torch)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 15: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: the encoder-decoder family (whisper-base)
# ---------------------------------------------------------------------------
def encdec_cfg(**over):
    from repro_torch.configs.base import get_model_config

    return dataclasses.replace(get_model_config("whisper-base"), **over)


def encdec_batch(torch, dev, cfg, batch, prompt, seed, dtype, labels=False):
    """Seeded tokens [batch, prompt] (and labels) and normal frames
    [batch, ENCDEC_FRAMES, d_model] in ``dtype``, on ``dev``."""
    gen = torch.Generator(dev).manual_seed(seed)
    out = {"tokens": torch.randint(1, cfg.vocab_size, (batch, prompt),
                                   generator=gen, device=dev),
           "frames": torch.randn(batch, ENCDEC_FRAMES, cfg.d_model,
                                 generator=gen, device=dev).to(dtype)}
    if labels:
        out["labels"] = torch.randint(1, cfg.vocab_size, (batch, prompt),
                                      generator=gen, device=dev)
    return out


def phase_encdec_parity(torch, dev, build, fkernel):
    """Phase 16(a): whisper-base at full width, 2 + 2 layers, f32, the
    same weights (seed 1234) and seeded frames on the card and on the CPU
    plain path: the loss of a seeded batch, then a prefill of 2 x (1536
    frames + 64 tokens) through ``make_prefill_step`` (logits and the
    encoder output) and 4 greedy decode steps fed that output (tokens
    chosen on the card, fed to both), all within 1e-4.  The card's
    prefill launches flash once a layer (2 encoder, non-causal; 2
    decoder) on its f32 kernel and its decode none."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core import steps
    from repro_torch.models import api
    from repro_torch.models.params import init_params

    cfg = encdec_cfg(num_layers=2, num_encoder_layers=2, dtype="float32")
    B, K = 2, 4
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "p", "prefill", ENCDEC_PROMPT + K, B), compute_dtype="float32")
    params = init_params(cfg, 1234, device=dev, dtype=torch.float32)
    cpu_params = copy.deepcopy(params).to("cpu")
    batch = encdec_batch(torch, dev, cfg, B, ENCDEC_PROMPT, 16,
                         torch.float32, labels=True)
    n = cfg.num_layers + cfg.num_encoder_layers
    route = fkernel.route(torch.float32, cfg.head_dim)
    losses, logits, encs = {}, {}, {}
    for where, p, d in (("card", params, dev), ("cpu", cpu_params, "cpu")):
        b = {k: v.to(d) for k, v in batch.items()}
        with torch.no_grad():
            losses[where] = api.model_loss(p, b, cfg, remat=False)[0].item()
        prefill = steps.make_prefill_step(run, d)
        decode = steps.make_decode_step(run, d)
        build.reset_launches()
        lg, cache, enc = prefill(p, {k: b[k] for k in ("tokens", "frames")})
        rows = [lg.float().cpu()]
        if where == "card":
            assert build.LAUNCHES[fkernel.FWD] == build.ROUTE_LAUNCHES.get(
                f"{fkernel.FWD}:{route}") == n, dict(build.ROUTE_LAUNCHES)
            fed = []
        for k in range(K):
            if where == "card":
                fed.append(torch.argmax(rows[-1], -1)[:, None])
            lg, cache = decode(p, cache, fed[k].to(d), ENCDEC_PROMPT + k,
                               enc)
            rows.append(lg.float().cpu())
        if where == "card":
            assert build.LAUNCHES[fkernel.FWD] == n, "decode launched flash"
        logits[where], encs[where] = rows, enc.float().cpu()
        del cache, enc
    loss_err = abs(losses["card"] - losses["cpu"])
    enc_err = (encs["card"] - encs["cpu"]).abs().max().item()
    errs = [(a - b).abs().max().item()
            for a, b in zip(logits["card"], logits["cpu"])]
    log(f"  (a) 2 + 2 layers, f32, B {B}: loss card {losses['card']:.6f} "
        f"CPU {losses['cpu']:.6f} (|d| {loss_err:.2e}); prefill {B} x "
        f"({ENCDEC_FRAMES} frames + {ENCDEC_PROMPT} tokens) + {K} decode "
        f"steps: encoder output max |d| {enc_err:.2e}, logits max |d| by "
        f"step " + " ".join(f"{e:.2e}" for e in errs) + f" (tol "
        f"{LOGIT_TOL:g}); flash at prefill: {n} on '{route}', none in "
        f"decode")
    assert loss_err <= LOGIT_TOL and enc_err <= LOGIT_TOL, (loss_err,
                                                            enc_err)
    assert max(errs) <= LOGIT_TOL, errs
    del params, cpu_params
    return {"loss": losses, "loss_abs_diff": loss_err,
            "encoder_out_max_abs_diff": enc_err,
            "logit_max_abs_diff_by_step": errs}


def seeded_frames(torch, seed):
    """A ``phase_train`` hook: each step's batch gets normal bf16 frames
    [batch, encoder_seq, d_model] from ``seed + step`` on the card, in
    place of the CLI's zero f32 frames, so the encoder runs in bf16 on the
    tensor-core flash kernels."""
    def prepare(sess):
        cfg, a, base = sess.run.model, sess.args, sess.batch_at

        def batch_at(step):
            gen = torch.Generator(sess.device).manual_seed(seed + step)
            return dict(base(step), frames=torch.randn(
                a.batch, cfg.encoder_seq, cfg.d_model, generator=gen,
                device=sess.device).to(torch.bfloat16))

        sess.batch_at = batch_at
    return prepare


def encdec_prefill_decode(torch, dev, build, fkernel):
    """Phase 16(c): whisper-base at full size (6 + 6 layers), bf16 weights
    from seed 0: a prefill of 8 x (1536 seeded bf16 frames + 64 tokens)
    through ``make_prefill_step`` after one warm-up prefill (its memory
    left in PyTorch's caching allocator, so the timed prefill makes no
    ``cudaMalloc``), then 32 greedy ``make_decode_step`` steps fed its
    encoder output; one decode step and one prefill profiled.  Flash
    launches once a self-attention layer at the prefill (6 encoder, 6
    decoder), all on ``wgmma_d64``, and never in decode (cross-attention
    and dense decode stay plain); every logit finite.  Returns (results,
    params, the prefill's inputs)."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core import steps
    from repro_torch.models.params import init_params

    cfg = encdec_cfg()
    B = ENCDEC_PREFILL_BATCH
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "p", "prefill", ENCDEC_PROMPT + ENCDEC_DECODE, B))
    params = init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in params.parameters())
    batch = encdec_batch(torch, dev, cfg, B, ENCDEC_PROMPT, 0,
                         torch.bfloat16)
    prefill = steps.make_prefill_step(run, dev)
    decode = steps.make_decode_step(run, dev)
    logits, cache, enc = prefill(params, batch)            # warm up
    del logits, cache, enc          # kept in the allocator for the next
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, enc = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n = cfg.num_layers + cfg.num_encoder_layers
    route = fkernel.route(torch.bfloat16, cfg.head_dim)
    launches = {fkernel.FWD: build.LAUNCHES[fkernel.FWD],
                fkernel.BWD: build.LAUNCHES[fkernel.BWD]}
    on_route = build.ROUTE_LAUNCHES.get(f"{fkernel.FWD}:{route}", 0)
    assert launches == {fkernel.FWD: n, fkernel.BWD: 0}, launches
    assert on_route == n, (route, on_route)
    assert logits.shape == (B, cfg.vocab_size) and enc.shape == (
        B, ENCDEC_FRAMES, cfg.d_model) and enc.dtype == torch.bfloat16
    assert torch.isfinite(logits).all() and torch.isfinite(enc).all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ENCDEC_DECODE):
        nxt = torch.argmax(logits, -1)[:, None]
        logits, cache = decode(params, cache, nxt, ENCDEC_PROMPT + i, enc)
        assert torch.isfinite(logits).all(), i
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    assert build.LAUNCHES[fkernel.FWD] == n, "decode launched flash"
    peak = torch.cuda.max_memory_allocated()
    # one decode step profiled (it rewrites the last position, in range)
    step_events = device_events(torch, lambda: decode(
        params, cache, nxt, ENCDEC_PROMPT + ENCDEC_DECODE - 1, enc))
    decode_busy = sum(e.self_device_time_total for e in step_events) / 1e3
    del cache, enc
    events = device_events(torch, lambda: prefill(params, batch))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    flash_ms = sum(e.self_device_time_total for e in events
                   if "flash_fwd" in e.key) / 1e3
    top = [[e.key[:90], e.self_device_time_total / 1e3, e.count]
           for e in sorted(events, key=lambda e: -e.self_device_time_total)
           [:6]]
    out = {"layers": [cfg.num_encoder_layers, cfg.num_layers],
           "params": n_params, "batch": B, "frames": ENCDEC_FRAMES,
           "prompt": ENCDEC_PROMPT, "prefill_s": prefill_s,
           "prefill_tok_s": B * ENCDEC_PROMPT / prefill_s,
           "decode_steps": ENCDEC_DECODE,
           "decode_step_ms": decode_s / ENCDEC_DECODE * 1e3,
           "decode_tok_s": B * ENCDEC_DECODE / decode_s,
           "peak_bytes": peak, "launches": launches,
           "launches_on_route": {f"{fkernel.FWD}:{route}": on_route},
           "prefill_device_busy_ms": busy or None,
           "decode_step_device_busy_ms": decode_busy or None,
           "prefill_flash_ms": flash_ms if busy > 0 else None,
           "prefill_top_kernels": top}
    log(f"  (c) {cfg.num_encoder_layers} + {cfg.num_layers} layers, bf16, "
        f"{n_params / 1e6:.1f} M parameters: prefill {B} x "
        f"({ENCDEC_FRAMES} frames + {ENCDEC_PROMPT} tokens) "
        f"{prefill_s * 1e3:.1f} ms wall; {ENCDEC_DECODE} greedy decode "
        f"steps {out['decode_step_ms']:.2f} ms a step "
        f"({out['decode_tok_s']:,.0f} tok/s); peak memory "
        f"{peak / 2**30:.2f} GiB allocated")
    if decode_busy > 0:
        log(f"    profiled decode step: device busy {decode_busy:.2f} ms "
            f"({decode_busy / out['decode_step_ms']:.1%} of the unprofiled "
            f"step)")
    else:
        log("    device time of a decode step: not measured (no device "
            "events)")
    log(f"    flash launches at prefill: {n} ({cfg.num_encoder_layers} "
        f"non-causal, {cfg.num_layers} causal), all on '{route}'; in "
        f"decode: none")
    if busy > 0:
        log(f"    profiled prefill: device busy {busy:.1f} ms "
            f"({busy / (prefill_s * 1e3):.1%} of the unprofiled wall), "
            f"flash forward {flash_ms:.2f} ms")
        for name, ms, count in top:
            log(f"      {ms:8.2f} ms  x{count:5d}  {name}")
    else:
        log("    device time of the prefill: not measured (no device events)")
    del logits
    return out, params, batch


def encdec_flash_calls(torch, dev, fref, params, batch):
    """Phase 16(d): each flash call of (c)'s prefill against the plain
    attention on the inputs the model gave it, bf16, at phase 3's bf16
    tolerance (atol / rtol 2e-2): the 6 encoder calls non-causal over the
    1536 frames, the 6 decoder calls causal over the 64 tokens, in that
    order.  Each check must reject two broken controls: the plain
    attention with the mask flipped (causal for an encoder call,
    non-causal for a decoder one) and with the KV heads rolled by one
    (every query head on another head's keys)."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.core import steps
    from repro_torch.models import attention

    cfg = encdec_cfg()
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "p", "prefill", ENCDEC_PROMPT + ENCDEC_DECODE, ENCDEC_PREFILL_BATCH))
    prefill = steps.make_prefill_step(run, dev)
    flash, calls = attention.flash_attention, []

    def recorded(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    with mock.patch.object(attention, "flash_attention", recorded):
        prefill(params, batch)
    causal = [c[3]["causal"] for c in calls]
    assert causal == [False] * cfg.num_encoder_layers \
        + [True] * cfg.num_layers, causal
    errs, control_errs, controls = [], [], []
    while calls:
        q, k, v, kw, o = calls.pop(0)
        want = fref.attention_ref(q, k, v, **kw)

        def check(got):
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)

        errs.append((o.float() - want.float()).abs().max().item())
        check(o)
        flipped = fref.attention_ref(q, k, v, **dict(kw,
                                                     causal=not kw["causal"]))
        rolled = fref.attention_ref(q, torch.roll(k, 1, 1),
                                    torch.roll(v, 1, 1), **kw)
        control_errs.append([(t.float() - want.float()).abs().max().item()
                             for t in (flipped, rolled)])
        controls.append([rejects(lambda: check(flipped), "mask flipped"),
                         rejects(lambda: check(rolled), "KV heads rolled")])
        del q, k, v, o, want, flipped, rolled
    E = cfg.num_encoder_layers
    log(f"  (d) each flash call of (c)'s prefill against the plain attention "
        f"on its inputs: max |d| encoder " + " ".join(
            f"{e:.3g}" for e in errs[:E]) + "; decoder " + " ".join(
            f"{e:.3g}" for e in errs[E:]) + " (tol 2e-2 + 2e-2 |o|)")
    log(f"    controls rejected by all {len(errs)} checks: mask flipped "
        f"(max |d| {min(c[0] for c in control_errs):.3g} or more), KV heads "
        f"rolled by one (max |d| {min(c[1] for c in control_errs):.3g} or "
        f"more); first: {controls[0][0]}")
    return {"flash_max_abs_err": errs, "control_max_abs": control_errs}


def phase_encdec(torch, dev, build, fkernel, fref):
    """Phase 16: whisper-base on the card.  (a) 2 + 2 layers f32 against
    the CPU plain path; (b) training at full size; (c) prefill and greedy
    decode at full size; (d) (c)'s flash calls one by one."""
    t0 = time.perf_counter()
    out = {"parity": phase_encdec_parity(torch, dev, build, fkernel)}
    release(torch)
    log(f"  (b) train whisper-base, 6 + 6 layers, {ENCDEC_TRAIN_BATCH} x "
        f"{ENCDEC_TRAIN_SEQ} decoder tokens beside {ENCDEC_FRAMES} seeded "
        f"bf16 frames")
    out["train"] = phase_train(torch, build, fkernel, arch="whisper-base",
                               batch=ENCDEC_TRAIN_BATCH,
                               seq=ENCDEC_TRAIN_SEQ,
                               prepare=seeded_frames(torch, 16))
    release(torch)
    res, params, batch = encdec_prefill_decode(torch, dev, build, fkernel)
    out["serve"] = res
    out["calls"] = encdec_flash_calls(torch, dev, fref, params, batch)
    del params, batch
    release(torch)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 16: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: scale-out on torch.distributed, on the one card
# ---------------------------------------------------------------------------
SCALE_STEPS = 4                  # phase 6's steps, seed and settings
SCALE_SAVE_AT = 2                # 17(c): the checkpoint's step
SCALE_RESUME_LAYERS = 2          # 17(c): depth of the restarted run
PIPE_MICRO = 8                   # 17(d): M micro-batches of 1 x 1024
PIPE_SEQ = 1024


def scale_run(num_layers=None):
    """Phase 6's run at full width: qwen3-1.7b, batch 8 x 1024, f32
    masters, bf16 compute, Horn on with 4 groups, AdamW at lr 3e-4, remat,
    seed 0 (``num_layers`` cuts the depth)."""
    from repro_torch.configs.base import (HornConfig, RunConfig, ShapeConfig,
                                          get_model_config)
    cfg = get_model_config("qwen3-1.7b")
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    return RunConfig(model=cfg, shape=ShapeConfig("cli", "train", 1024, 8),
                     horn=HornConfig(num_groups=4), optimizer="adamw",
                     learning_rate=3e-4, seed=0)


def scale_batches(run):
    from repro_torch.data.pipeline import (SyntheticTokenPipeline,
                                           TokenPipelineConfig)
    return SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=run.model.vocab_size, seq_len=run.shape.seq_len,
        global_batch=run.shape.global_batch, seed=run.seed)).batch_at


def scale_steps(torch, state, step, batch_at, n):
    """``n`` steps: [(loss, grad norm, host wall s)], synced each step."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch_at(state["step"]))
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        out.append((loss, gnorm, time.perf_counter() - t0))
    return state, out


def phase_scale_merges(torch, dev, group):
    """17(a): the merges across the NCCL group of one rank over the
    gradients of one full-width qwen3-1.7b train step (bf16, phase 6's
    step 0): at world size 1 ``psum_mean`` and ``merge_grads(none)`` must
    give the f32 cast bit for bit, ``merge_grads(int8)`` and
    ``psum_mean_compressed`` the dequantized error-feedback value of the
    single-process arithmetic (``ef_compress``)."""
    from repro_torch.configs.base import TopologyConfig
    from repro_torch.core import group_sync as gs
    from repro_torch.core import steps as S
    from repro_torch.core.parallel_dropout import make_horn_state
    from repro_torch.models import api
    from repro_torch.models.params import cast_params
    from repro_torch.optim import compression as C

    run = scale_run()
    state = S.init_state(run, dev)
    cparams = cast_params(state["params"], torch.bfloat16)
    names = [n for n, _ in cparams.named_parameters()]
    leaves = [p.requires_grad_(True) for p in cparams.parameters()]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in scale_batches(run)(0).items()}
    horn = make_horn_state(run.seed, run.horn, 0, dev)
    loss, _ = api.model_loss(cparams, batch, run.model, horn=horn)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    del cparams, leaves, state
    release(torch)
    nbytes = sum(g.numel() * 4 for g in grads.values())
    out = {"leaves": len(grads), "f32_bytes": nbytes}

    def exact(what, got, want):
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        assert not bad, (what, bad[:4])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged = gs.psum_mean(grads, group)
    torch.cuda.synchronize()
    out["psum_mean_s"] = time.perf_counter() - t0
    exact("psum_mean", merged, {k: g.float() for k, g in grads.items()})
    exact("merge_grads none", gs.merge_grads(grads, group,
                                             TopologyConfig())[0], merged)
    f32 = list(merged.values())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for x in f32:
        torch.distributed.all_reduce(x, group=group)
    ev[1].record()
    torch.cuda.synchronize()
    out["all_reduce_ms"] = ev[0].elapsed_time(ev[1])
    del merged, f32
    release(torch)
    int8 = TopologyConfig(grad_compression="int8")
    got, res = gs.merge_grads(grads, group, int8)
    for k, g in grads.items():
        q, sc, r = C.ef_compress(g, None)
        assert torch.equal(got[k], C.dequantize_int8(q, sc)), k
        assert torch.equal(res[k], r), k
        direct = C.psum_mean_compressed({k: q}, {k: sc}, group)[k]
        assert torch.equal(direct, got[k]), k
    del got, res, grads
    release(torch)
    log(f"  (a) merges over the NCCL group of 1 rank, {out['leaves']} "
        f"gradient leaves of a qwen3-1.7b step, {nbytes / 2**30:.2f} GiB in "
        f"f32: psum_mean and merge_grads(none) == the f32 cast, "
        f"merge_grads(int8) and psum_mean_compressed == ef_compress's "
        f"dequantized value and residual, bit for bit; psum_mean "
        f"{out['psum_mean_s'] * 1e3:.1f} ms wall, the all-reduce alone "
        f"{out['all_reduce_ms']:.3f} ms (CUDA events)")
    return out


def phase_scale_train(torch, dev, build, fkernel):
    """17(b): phase 6's 4 steps mesh-free, then through ``remesh_state``
    onto a 1 x 1 DeviceMesh and 4 steps of ``make_train_step(mesh=)``:
    losses and grad norms bit-equal; flash 2 x 28 forward and 28 backward
    a step, all on ``wgmma_d128``; both step walls."""
    from repro_torch.core import steps as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.elastic import remesh_state

    run = scale_run()
    batch_at = scale_batches(run)
    L = run.model.num_layers
    state = S.init_state(run, dev)
    _, free = scale_steps(torch, state, S.make_train_step(run, dev),
                          batch_at, SCALE_STEPS)
    del state
    release(torch)
    mesh = make_test_mesh(1, 1)
    state = remesh_state(S.init_state(run, dev), S.state_axes(run),
                         S.make_ctx(run.model, mesh, run.shape))
    kinds = sorted({type(p.data).__name__
                    for p in state["params"].parameters()})
    step = S.make_train_step(run, dev, mesh=mesh)
    build.reset_launches()
    _, meshed = scale_steps(torch, state, step, batch_at, SCALE_STEPS)
    fwd, bwd = build.LAUNCHES[fkernel.FWD], build.LAUNCHES[fkernel.BWD]
    route = fkernel.route(torch.bfloat16, run.model.head_dim)
    on_route = [build.ROUTE_LAUNCHES.get(f"{n}:{route}", 0)
                for n in (fkernel.FWD, fkernel.BWD)]
    del state, step
    release(torch)
    a = [(l, g) for l, g, _ in free]
    b = [(l, g) for l, g, _ in meshed]
    log(f"  (b) 1 x 1 DeviceMesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        f" on {mesh.device_type}, parameters as {kinds}")
    log(f"      mesh-free (loss, grad norm) {a}")
    log(f"      mesh      (loss, grad norm) {b}")
    assert kinds == ["DTensor"], kinds
    assert a == b, (a, b)
    assert fwd == 2 * L * SCALE_STEPS and bwd == L * SCALE_STEPS, (fwd, bwd)
    assert on_route == [fwd, bwd], (route, on_route)
    wall = {k: sum(r[2] for r in v[1:]) / (len(v) - 1) * 1e3
            for k, v in (("mesh_free", free), ("mesh", meshed))}
    log(f"      bit-equal over {SCALE_STEPS} steps (tolerance 0); "
        f"{fkernel.FWD} {fwd} = 2 x {L} x {SCALE_STEPS}, {fkernel.BWD} "
        f"{bwd} = {L} x {SCALE_STEPS}, all on '{route}'; step wall (mean of "
        f"steps 2-{SCALE_STEPS}) mesh-free {wall['mesh_free']:.1f} ms, "
        f"mesh {wall['mesh']:.1f} ms")
    return {"mesh_free": a, "mesh": b, "step_ms": wall,
            "launches": {fkernel.FWD: fwd, fkernel.BWD: bwd},
            "route": route}


def phase_scale_resume(torch, dev):
    """17(c): elastic restart at full width, ``SCALE_RESUME_LAYERS``
    layers (a full-depth checkpoint is 24 GB): 4 unbroken steps on a 1 x 1
    mesh; then 2 steps, a save, a restore with ``shardings=`` onto a fresh
    1 x 1 mesh, and steps 3-4, bit-equal to the unbroken run's."""
    import shutil
    import tempfile

    from repro_torch.core import steps as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.train import TrainStateCheckpointer
    from repro_torch.runtime.elastic import remesh_state

    run = scale_run(SCALE_RESUME_LAYERS)
    batch_at = scale_batches(run)

    def fresh():
        mesh = make_test_mesh(1, 1)
        step = S.make_train_step(run, dev, mesh=mesh)
        return mesh, step

    mesh, step = fresh()
    ctx = S.make_ctx(run.model, mesh, run.shape)
    state = remesh_state(S.init_state(run, dev), S.state_axes(run), ctx)
    _, unbroken = scale_steps(torch, state, step, batch_at, SCALE_STEPS)
    state = remesh_state(S.init_state(run, dev), S.state_axes(run), ctx)
    state, first = scale_steps(torch, state, step, batch_at, SCALE_SAVE_AT)
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        ck = TrainStateCheckpointer(root, run)
        t0 = time.perf_counter()
        ck.save(SCALE_SAVE_AT, state)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(root).rglob("*")
                   if f.is_file())
        like = state
        mesh2, step2 = fresh()
        t0 = time.perf_counter()
        restored, at = ck.restore(like, shardings=S.state_shardings(
            run, mesh2))
        restore_s = time.perf_counter() - t0
        del state, like
        release(torch)
        _, resumed = scale_steps(torch, restored, step2, batch_at,
                                 SCALE_STEPS - SCALE_SAVE_AT)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del restored
    release(torch)
    a = [(l, g) for l, g, _ in unbroken]
    b = [(l, g) for l, g, _ in first + resumed]
    log(f"  (c) elastic restart, {SCALE_RESUME_LAYERS} layers at full "
        f"width: checkpoint of step {at} {size / 2**30:.2f} GiB, saved in "
        f"{save_s:.1f} s, restored onto a fresh 1 x 1 mesh in "
        f"{restore_s:.1f} s")
    log(f"      unbroken {a}")
    log(f"      restarted {b}")
    assert at == SCALE_SAVE_AT and a == b, (at, a, b)
    return {"unbroken": a, "restarted": b, "checkpoint_bytes": size,
            "save_s": save_s, "restore_s": restore_s}


def phase_scale_pipeline(torch, dev, build, fkernel, group):
    """17(d): ``pipelined_apply`` on the NCCL group (S 1) over qwen3-1.7b's
    28 bf16 blocks as one stage, M 8 micro-batches of 1 x 1024 hidden
    states (seeded), held against the unpipelined stack run on each
    micro-batch: the forward bit for bit and every parameter's gradient of
    mean(out^2) within 2e-2 of its largest value (phase 11's rule: each
    bf16 gradient sums 8 bf16 contributions, whose order autograd picks).
    The stack on the whole 8 x 1024 batch at once (other GEMM shapes) is
    printed beside it.  Flash is launched once a layer a micro-batch,
    forward and backward."""
    from repro_torch.configs.base import ATTN
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.runtime.pipeline import bubble_fraction, pipelined_apply

    cfg = scale_run().model
    layers = init_params(cfg, 0, device=dev, dtype=torch.bfloat16).layers
    params = list(layers.parameters())
    for p in params:
        p.requires_grad_(True)
    gen = torch.Generator(dev).manual_seed(17)
    x = torch.randn(PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    positions = torch.arange(PIPE_SEQ, device=dev)[None, :]

    def block_fn(stage, h):
        for li, bp in enumerate(stage):
            h = T._block_apply(bp, h, cfg, kind=ATTN, layer_idx=li,
                               positions=positions)[0]
        return h

    def run(fn):
        out = fn()
        return out.detach(), torch.autograd.grad(
            out.float().square().mean(), params)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp(min=1e-30)).item()

    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, g_pipe = run(lambda: pipelined_apply(block_fn, layers, x,
                                              group=group))
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    launches = {n: build.LAUNCHES[n] for n in (fkernel.FWD, fkernel.BWD)}
    ref, g_ref = run(lambda: torch.stack([block_fn(layers, x[m])
                                          for m in range(PIPE_MICRO)]))
    same = torch.equal(out, ref)
    grad_err = max(rel(a, b) for a, b in zip(g_pipe, g_ref))
    del ref, g_ref
    release(torch)
    full, g_full = run(lambda: block_fn(layers, x[:, 0]).unsqueeze(1))
    full_err = rel(out, full)
    full_grad_err = max(rel(a, b) for a, b in zip(g_pipe, g_full))
    L = cfg.num_layers
    log(f"  (d) pipelined_apply, S 1 (NCCL), M {PIPE_MICRO} x 1 x "
        f"{PIPE_SEQ} over {L} bf16 blocks: {pipe_s:.2f} s forward + "
        f"backward; against the stack on each micro-batch: forward "
        f"{'bit-equal' if same else 'DIFFERS'}, gradients (each of "
        f"{len(params)}) max |d| / max |ref| at most {grad_err:.3g} "
        f"(tolerance 2e-2); against the stack on the whole 8 x "
        f"{PIPE_SEQ} batch: forward {full_err:.3g}, gradients "
        f"{full_grad_err:.3g}; flash {launches}; bubble_fraction(4, 8) = "
        f"{bubble_fraction(4, 8):.4f}")
    assert same and grad_err <= SUPERBLOCK_TOL, (same, grad_err)
    assert launches == {fkernel.FWD: L * PIPE_MICRO,
                        fkernel.BWD: L * PIPE_MICRO}, launches
    del layers, params, out, full, g_pipe, g_full
    release(torch)
    return {"forward_bit_equal": same, "grad_err": grad_err,
            "full_batch_fwd_err": full_err,
            "full_batch_grad_err": full_grad_err, "seconds": pipe_s,
            "launches": launches, "bubble_4_8": bubble_fraction(4, 8)}


def phase_scale_cli(torch):
    """17(e): the train CLI at full width on the card with what it refused
    before: ``--topology zero1``, then ``--topology local_sgd
    --mesh-data 2`` (clamped to the one rank): each prints the topology,
    the 1 x 1 mesh line and finite losses."""
    import io

    from repro_torch.launch import train

    out = {}
    for extra in (["--topology", "zero1"],
                  ["--topology", "local_sgd", "--mesh-data", "2"]):
        argv = ["--arch", "qwen3-1.7b", "--full-config", "--steps", "2",
                "--horn-groups", "4", "--device", "cuda", "--log-every",
                "1"] + extra
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = train.main(argv)
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            log("      " + line)
        assert "mesh: {'data': 1, 'model': 1}  arch: qwen3-1.7b" in text
        assert text.startswith(f"topology: {extra[1]}: ")
        assert all(math.isfinite(r["loss"]) for r in res["steps"])
        out[" ".join(extra)] = {"losses": [r["loss"] for r in res["steps"]],
                                "wall_s": wall,
                                "launches": {k: res["launches"][k] for k in
                                             ("flash_attention_fwd",
                                              "flash_attention_bwd")}}
        log(f"  (e) launch.train {' '.join(extra)}: {wall:.1f} s")
        release(torch)
    return out


def phase_scaleout(torch, dev, build, fkernel):
    """Phase 17 on the one card: (a) merges, (b) the 1 x 1 mesh step, (c)
    elastic restart, (d) the GPipe schedule, (e) the CLI, all over one
    NCCL process group of one rank from a ``file://`` store in a temp
    dir."""
    import shutil
    import tempfile

    import torch.distributed as dist

    log("  multi-rank runs are held on the CPU (tests/test_torch_"
        "distributed.py: 4 gloo ranks): NCCL takes one rank per device, "
        "and this machine has one card, so every run here is world size 1")
    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", init_method=f"file://{store}/pg",
                            rank=0, world_size=1, device_id=dev)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        group = dist.group.WORLD
        out = {"merges": phase_scale_merges(torch, dev, group)}
        out["train"] = phase_scale_train(torch, dev, build, fkernel)
        out["resume"] = phase_scale_resume(torch, dev)
        out["pipeline"] = phase_scale_pipeline(torch, dev, build, fkernel,
                                               group)
        out["cli"] = phase_scale_cli(torch)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 17: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: the analysis tooling
# ---------------------------------------------------------------------------
GUARD_BAND = 4096                # elements of each band around an operand
PROBE_TOL = {"float32": 1e-3, "bfloat16": 3e-2}   # max |d| / max(1, |ref|)


def kernel_base_name(name: str) -> str:
    """``paged_chunk_tc_kernel`` of a Chrome-trace kernel name such as
    ``void (anonymous namespace)::paged_chunk_tc_kernel<64, false>(...)``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1].split()[-1]


def trace_launches(torch, fn, names):
    """(kernel, grid, block, shared memory) of every launch of ``fn()``
    whose kernel is one of ``names``, in launch order, from the Chrome
    trace torch.profiler exports.  ``fn`` runs once as the schedule's
    warm-up step and once profiled."""
    import os
    import tempfile
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    return [(kernel_base_name(e["name"]), list(e["args"]["grid"]),
             list(e["args"]["block"]), int(e["args"]["shared memory"]))
            for e in kernels if kernel_base_name(e["name"]) in names]


def _rand(torch, dev, gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def launch_call(torch, dev, call, nan_page=False):
    """Inputs for the wrapper call a model's ``call`` describes, on the
    card, and a zero-argument function that makes the call.  Block-table
    entries outside the pool (hornshape's dead entries) become the null
    page 0."""
    from repro_torch.kernels.dropout_matmul import kernel as dkernel
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.kernels.ssd import kernel as skernel

    c = dict(call)
    m = c.pop("model")
    gen = torch.Generator(dev).manual_seed(18)
    i32 = dict(dtype=torch.int32, device=dev)
    if m.startswith("paged."):
        B, H, KH, D, P, psize = (c[k] for k in ("B", "H", "KH", "D", "P",
                                                "psize"))
        dt = c["dtype"]
        kp, vp = (_rand(torch, dev, gen, (P, psize, KH, D), dt)
                  for _ in range(2))
        sc = {}
        if c["quant"]:
            kp, vp, sc = quantize_pools(torch, kp, vp)
        table = np.asarray(c["block_tables"]).copy()
        table[(table < 0) | (table >= P)] = 0
        bt = torch.as_tensor(table, **i32)
        kw = dict(scale=D ** -0.5, window=c["window"], **sc)
        if m == "paged.decode":
            q = _rand(torch, dev, gen, (B, H, D), dt)
            lens = torch.as_tensor(np.asarray(c["lengths"]), **i32)
            return lambda: kernel.paged_attention(q, kp, vp, bt, lens, **kw)
        q = _rand(torch, dev, gen, (B, c["C"], H, D), dt)
        st = torch.as_tensor(np.asarray(c["starts"]), **i32)
        cl = torch.as_tensor(np.asarray(c["chunk_lens"]), **i32)
        if c["logit_index"] is not None:
            kw["logit_index"] = torch.as_tensor(c["logit_index"], **i32)
        return lambda: kernel.paged_chunk_attention(q, kp, vp, bt, st, cl,
                                                    **kw)
    if m.startswith("flash."):
        B, H, KH, Sq, Skv, D, dt = (c[k] for k in ("B", "H", "KH", "Sq",
                                                   "Skv", "D", "dtype"))
        q = _rand(torch, dev, gen, (B, H, Sq, D), dt)
        k, v = (_rand(torch, dev, gen, (B, KH, Skv, D), dt)
                for _ in range(2))
        kw = dict(scale=D ** -0.5, causal=c["causal"], window=c["window"])
        if m == "flash.fwd":
            return lambda: fkernel.flash_attention_fwd(q, k, v, **kw)
        o, lse = fkernel.flash_attention_fwd(q, k, v, **kw)
        do = _rand(torch, dev, gen, (B, H, Sq, D), dt)
        return lambda: fkernel.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    if m == "dropout":
        G, M, K, N, dt = (c[k] for k in ("G", "M", "K_", "N", "dtype"))
        x = _rand(torch, dev, gen, (G, M, K), dt)
        w = _rand(torch, dev, gen, (K, N), dt, K ** -0.5)
        mask = torch.as_tensor(np.asarray(c["mask_blocks"], np.float32),
                               device=dev)
        return lambda: dkernel.dropout_matmul(x, w, mask,
                                              block_n=c["block_n"])
    if m == "ssd":
        B, S, H, P, N, dt = (c[k] for k in ("B", "S", "H", "P", "N",
                                            "dtype"))
        x, dtv, A, Bm, Cm = ssd_inputs(torch, dev, dt, B, S, H, P, N, 18)
        return lambda: skernel.ssd_chunk_scan(x, dtv, A, Bm, Cm,
                                              chunk=c["chunk"])
    raise ValueError(f"no call for model {m!r}")


def model_geometries(call, sms):
    """The launches the model ``call["model"]`` gives for ``call``, on a
    card of ``sms`` SMs."""
    from repro_torch.kernels.dropout_matmul import geometry as dgeo
    from repro_torch.kernels.flash_attention import geometry as fgeo
    from repro_torch.kernels.paged_attention import geometry as pgeo
    from repro_torch.kernels.ssd import geometry as sgeo

    c = dict(call)
    m = c.pop("model")
    if "sm_count" in c:
        c["sm_count"] = sms
    return {"paged.chunk": lambda: [pgeo.chunk_geometry(**c)],
            "paged.decode": lambda: [pgeo.decode_geometry(**c)],
            "flash.fwd": lambda: [fgeo.fwd_geometry(**c)],
            "flash.bwd": lambda: fgeo.bwd_geometries(**c),
            "dropout": lambda: [dgeo.geometry(**c)],
            "ssd": lambda: [sgeo.geometry(**c)]}[m]()


def geometry_calls(torch, sms):
    """(label, call) of every wrapper call phase 18(a) makes: each call of
    hornshape's registry (a call whose launches depend on the SM count is
    taken on this card), phase 8's timing shapes and the engine's serving
    geometry (qwen3-1.7b, 8 slots, 512 x 16-token pages, 18-page tables;
    chunk buckets 64 and 256 on bf16 and int8 pools, the decode tick)."""
    from repro_torch.analysis import hornshape as hs

    out, seen = [], set()
    for label, build in hs.registry():
        for g in build():
            c = dict(g.call)
            if "sm_count" in c:
                c["sm_count"] = sms
            key = repr(sorted((k, repr(v)) for k, v in c.items()))
            if key not in seen:
                seen.add(key)
                out.append((label, c))
    bf = torch.bfloat16
    B, H, KH, D, psize, maxp, P = 8, 16, 8, 128, 16, 18, 512
    for quant in (False, True):
        for C in (64, 256):
            starts = [0] + [288 - C - b for b in range(1, B)]
            clens = [C] + [1] * (B - 1)
            live = [-(-(s + n) // psize) for s, n in zip(starts, clens)]
            out.append((f"serve/chunk{C}{'-int8' if quant else ''}", dict(
                model="paged.chunk", B=B, C=C, H=H, KH=KH, D=D, psize=psize,
                maxp=maxp, P=P, dtype=bf, quant=quant, starts=starts,
                chunk_lens=clens, block_tables=hs.paged_table(B, maxp, P,
                                                              live),
                window=None, logit_index=None)))
        lens = [288 - 3 * b for b in range(B)]
        out.append((f"serve/decode{'-int8' if quant else ''}", dict(
            model="paged.decode", B=B, H=H, KH=KH, D=D, psize=psize,
            maxp=maxp, P=P, dtype=bf, quant=quant, lengths=lens,
            block_tables=hs.paged_table(B, maxp, P, [-(-n // psize)
                                                     for n in lens]),
            window=None, sm_count=sms)))
    for label, (B, H, KH, S, D, causal, window) in (
            ("phase8/flash-train", (8, 16, 8, 1024, 128, True, None)),
            ("phase8/flash-gemma3", (2, 8, 4, 2048, 256, True, None)),
            ("phase8/flash-gemma3-window", (2, 8, 4, 2048, 256, True, 1024)),
            ("phase8/flash-whisper", (ENCDEC_TRAIN_BATCH, 8, 8,
                                      ENCDEC_FRAMES, 64, False, None))):
        for m in ("flash.fwd", "flash.bwd"):
            out.append((label, dict(model=m, B=B, H=H, KH=KH, Sq=S, Skv=S,
                                    D=D, dtype=bf, causal=causal,
                                    window=window)))
    # the decode kernel at every split count 1-8 on this card: B slots of
    # one kv head and one query head, B = ceil(2 SMs / NS) units
    from repro_torch.kernels.paged_attention import kernel as pk
    for ns in range(1, 9):
        B = -(-pk.DECODE_WAVES * sms // ns)
        assert pk.decode_splits(B, 1, 1, 8, sms) == ns, (ns, B)
        lens = [int(n) for n in np.random.default_rng(ns).integers(0, 65, B)]
        out.append((f"card/decode-ns{ns}", dict(
            model="paged.decode", B=B, H=1, KH=1, D=32, psize=8, maxp=8,
            P=64, dtype=bf, quant=False, lengths=lens,
            block_tables=hs.paged_table(B, 8, 64, [-(-n // 8)
                                                   for n in lens]),
            window=None, sm_count=sms)))
    G, M, K, N, bn = DM_FULL
    mask = (np.random.default_rng(18).random((G, N // bn)) < 0.5) * 2.0
    out.append(("phase8/dropout", dict(model="dropout", G=G, M=M, K_=K, N=N,
                                      dtype=bf, mask_blocks=mask,
                                      block_n=bn, sm_count=sms)))
    for label, shape in (("phase8/ssd", SSD_FULL), ("phase15/ssd-jamba",
                                                    SSD_JAMBA)):
        B, S, H, P_, N_, chunk = shape
        out.append((label, dict(model="ssd", B=B, S=S, H=H, P=P_, N=N_,
                                dtype=bf, chunk=chunk)))
    return out


def phase_geometry_twin(torch, dev, kernel):
    """18(a): every call's launches in the trace against its model's."""
    sms = kernel.sm_count(dev.index)
    calls = geometry_calls(torch, sms)
    by_family = {}
    for label, call in calls:
        by_family.setdefault(call["model"].split(".")[0], []).append(
            (label, call))
    compared = {}
    for family, items in by_family.items():
        fns, want, labels = [], [], []
        for label, call in items:
            fns.append(launch_call(torch, dev, call))
            for g in model_geometries(call, sms):
                l = g.launch()
                want.append((l["kernel"], l["grid"], l["block"],
                             l["shared_memory"]))
                labels.append((label, g.name))
        names = {w[0] for w in want}

        def run_all(fns=fns):
            for fn in fns:
                fn()
        for attempt in range(1, PROFILE_TRIES + 1):
            got = trace_launches(torch, run_all, names)
            if len(got) == len(want):
                break
            log(f"  18(a) {family}: the trace holds {len(got)} launches of "
                f"{len(want)}, try {attempt} of {PROFILE_TRIES}")
        assert len(got) == len(want), (family, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == w, (f"18(a) {labels[i][0]} ({labels[i][1]}): the "
                            f"trace's launch {g} != the model's {w}")
            compared[labels[i][1]] = compared.get(labels[i][1], 0) + 1
        log(f"  18(a) {family}: {len(items)} calls, {len(want)} launches, "
            f"grid/block/shared memory equal to the models'")
    for name in sorted(compared):
        log(f"    {name}: {compared[name]} launches compared")
    return {"calls": len(calls), "launches_compared": compared}


class GuardedAlloc:
    """Allocations inside guard bands: ``banded`` places a tensor's
    contents in a 16-byte-aligned view between two bands of ``fill``;
    while active, ``torch.empty``/``empty_like``/``zeros`` (the wrappers'
    output allocations) return such views, NaN bands around a NaN body (a
    zero body for ``zeros``).  ``check`` reports every band that changed
    and every output with a non-finite element."""

    def __init__(self, torch):
        self.torch = torch
        self.real = {n: getattr(torch, n) for n in ("empty", "empty_like",
                                                    "zeros")}
        self.regions = []            # (label, buf, view, saved bands)
        self.outputs = []

    @staticmethod
    def band_fill(dtype, torch):
        if dtype.is_floating_point:
            return float("nan")
        return 127 if dtype == torch.int8 else 0

    def banded(self, label, t, shift=0, fill=None):
        torch = self.torch
        n = t.numel()
        buf = self.real["empty"](n + 2 * GUARD_BAND + shift, dtype=t.dtype,
                                 device=t.device)
        buf.fill_(self.band_fill(t.dtype, torch) if fill is None else fill)
        buf[GUARD_BAND:GUARD_BAND + n].copy_(t.reshape(-1))
        view = buf[GUARD_BAND + shift:GUARD_BAND + shift + n].view(t.shape)
        assert view.data_ptr() % 16 == 0 and view.is_contiguous()
        self.regions.append((label, buf, view, self._bands(buf, view)))
        return view

    @staticmethod
    def _bands(buf, view):
        lo = (view.data_ptr() - buf.data_ptr()) // buf.element_size()
        hi = lo + view.numel()
        return (lo, hi, buf[:lo].clone(), buf[hi:].clone())

    def _out(self, shape, dtype, device, body):
        torch = self.torch
        t = self.real["zeros"](shape, dtype=dtype, device=device)
        if body is not None:
            t.fill_(body)
        view = self.banded(f"out{len(self.outputs)}", t,
                           fill=self.band_fill(dtype, torch))
        self.outputs.append(view)
        return view

    def __enter__(self):
        torch = self.torch
        nan = float("nan")

        def empty(*shape, dtype=None, device=None, **kw):
            shape = shape[0] if len(shape) == 1 and isinstance(
                shape[0], (tuple, list, torch.Size)) else shape
            dtype = dtype or torch.get_default_dtype()
            return self._out(tuple(shape), dtype, device,
                             nan if dtype.is_floating_point else None)

        def empty_like(t, **kw):
            return self._out(tuple(t.shape), t.dtype, t.device,
                             nan if t.dtype.is_floating_point else None)

        def zeros(*shape, dtype=None, device=None, **kw):
            shape = shape[0] if len(shape) == 1 and isinstance(
                shape[0], (tuple, list, torch.Size)) else shape
            return self._out(tuple(shape), dtype or torch.get_default_dtype(),
                             device, None)
        torch.empty, torch.empty_like, torch.zeros = empty, empty_like, zeros
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.torch, n, fn)

    def check(self):
        torch = self.torch
        torch.cuda.synchronize()
        bad = []
        for label, buf, view, (lo, hi, before, after) in self.regions:
            for side, old, new in (("before", before, buf[:lo]),
                                   ("after", after, buf[hi:])):
                same = (old == new) | (torch.isnan(old) & torch.isnan(new)) \
                    if old.is_floating_point() else old == new
                if not bool(same.all()):
                    bad.append(f"{label}: the band {side} it was written")
        for i, t in enumerate(self.outputs):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                bad.append(f"out{i}: {int((~torch.isfinite(t)).sum())} "
                           f"non-finite elements")
        return bad


def _close(torch, got, want, dtype):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    tol = PROBE_TOL[str(dtype).split(".")[1]]
    return None if err <= tol else f"differs from the plain version by " \
                                   f"{err:.2e} (> {tol})"


def probe_paged(torch, dev, kernel, ref, *, decode, dtype, quant, B, C=1,
                H=16, KH=8, D=128, psize=16, maxp=12, P=40, window=None,
                S_w=0, control=None, sm=None):
    """One guard-band probe of a paged kernel: q, pools, scales, table and
    per-slot arrays banded; the null page 0 filled with NaN (int8: its
    scales), every dead table entry (past the live pages, and before a
    window's first visible page) pointing at it.  ``control``:
    ``"live_nan"`` points a live entry at the NaN page; ``"shifted"``
    shifts the pool views by a page so their last page lies in the band and
    points a live entry at it.  Returns the failures."""
    gen = torch.Generator(dev).manual_seed(81)
    rng = np.random.default_rng(81)
    full = maxp * psize
    if decode:
        lens = [full - 1, 0, psize + 1] + [int(x) for x in rng.integers(
            1, full + 1, B - 3)]
        ends, firsts = lens, [max(0, n - window) if window else 0
                              for n in lens]
    else:
        starts = [0, 5, full - C] + [int(x) for x in rng.integers(
            0, full - C, B - 3)]
        clens = [C, 0, C] + [int(x) for x in rng.integers(1, C + 1, B - 3)]
        starts[1] = 0                      # the engine's idle slot
        ends = [s + c for s, c in zip(starts, clens)]
        firsts = [max(0, s - window + 1) if window and c else 0
                  for s, c in zip(starts, clens)]
    table = np.zeros((B, maxp), np.int32)
    for b in range(B):
        n = -(-ends[b] // psize) if ends[b] else 0
        table[b, firsts[b] // psize:n] = rng.integers(1, P - 1, n - firsts[
            b] // psize)
    kp, vp = (_rand(torch, dev, gen, (P, psize, KH, D), dtype)
              for _ in range(2))
    sc = {}
    if quant:
        kp, vp, sc = quantize_pools(torch, kp, vp)
    # the kernel's pools: the null page NaN (int8: its scales); the plain
    # version, which gathers the null page and masks it, gets the clean ones
    kpn, vpn = kp.clone(), vp.clone()
    scn = {n: t.clone() for n, t in sc.items()}
    if quant:
        scn["k_scale"][0] = scn["v_scale"][0] = float("nan")
    else:
        kpn[0] = vpn[0] = float("nan")
    live_b = 0                             # a slot with live pages
    if control == "live_nan":
        table[live_b, -(-ends[live_b] // psize) - 1] = 0
    if control == "shifted":
        table[live_b, -(-ends[live_b] // psize) - 1] = P - 1
    i32 = dict(dtype=torch.int32, device=dev)
    g = GuardedAlloc(torch)
    pe = psize * KH * D
    shift = pe if control == "shifted" else 0
    kpg, vpg = (g.banded(n, t, shift=shift)
                for n, t in (("k_pages", kpn), ("v_pages", vpn)))
    scg = {n: g.banded(n, t) for n, t in scn.items()}
    btg = g.banded("block_tables", torch.as_tensor(table, **i32))
    kw = dict(scale=D ** -0.5, window=window)
    # the plain version on clean inputs: dead entries at a finite page
    clean = table.copy()
    clean[clean == 0] = 1
    if decode:
        q = _rand(torch, dev, gen, (B, H, D), dtype)
        qg = g.banded("q", q)
        lg = g.banded("lengths", torch.as_tensor(lens, **i32))
        with g:
            out = kernel.paged_attention(qg, kpg, vpg, btg, lg, **kw, **scg)
        want = ref.paged_attention_ref(
            q, kp, vp, torch.as_tensor(clean, **i32),
            torch.as_tensor(lens, **i32), **kw, **sc)
        outs = [(out, want)]
    else:
        q = _rand(torch, dev, gen, (B, C, H, D), dtype)
        qg = g.banded("q", q)
        stg, clg = (g.banded(n, torch.as_tensor(v, **i32))
                    for n, v in (("starts", starts), ("chunk_lens", clens)))
        li = None
        if S_w:
            li = torch.as_tensor([[max(0, c - S_w + j) for j in range(S_w)]
                                  for c in clens], **i32)
            kw["logit_index"] = g.banded("logit_index", li)
        with g:
            out = kernel.paged_chunk_attention(qg, kpg, vpg, btg, stg, clg,
                                               **kw, **scg)
        if li is not None:
            kw["logit_index"] = li
        want = ref.paged_chunk_attention_ref(
            q, kp, vp, torch.as_tensor(clean, **i32),
            torch.as_tensor(starts, **i32), torch.as_tensor(clens, **i32),
            **kw, **sc)
        outs = list(zip(out, want)) if S_w else [(out, want)]
    bad = g.check()
    for i, (got, w) in enumerate(outs):
        if not bool(torch.isfinite(got).all()):
            bad.append(f"output {i}: {int((~torch.isfinite(got)).sum())} "
                       f"non-finite elements")
        elif control is None:
            d = _close(torch, got, w, dtype)
            if d:
                bad.append(d)
    return bad


def probe_call(torch, dev, label, fn, ref, dtype):
    """A guard-band probe of a non-paged kernel: ``fn(g)`` bands its inputs
    through ``g.banded`` and makes the call inside ``with g``; ``ref()``
    is the plain version on the same (clean) inputs."""
    g = GuardedAlloc(torch)
    got = fn(g)
    bad = g.check()
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = ref()
    want = want if isinstance(want, (tuple, list)) else (want,)
    for i, (a, b) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(a).all()):
            bad.append(f"output {i}: {int((~torch.isfinite(a)).sum())} "
                       f"non-finite elements")
            continue
        d = _close(torch, a, b, dtype)
        if d:
            bad.append(d)
    return bad


def phase_guard_bands(torch, dev, kernel, ref, fkernel, fref, dkernel, dref,
                      skernel, sref):
    """18(b): every route inside guard bands, then the two controls."""
    bf, f32 = torch.bfloat16, torch.float32
    results = {}
    paged = [
        ("chunk:cuda_core f32 window", dict(decode=False, dtype=f32,
                                            quant=False, B=4, C=70,
                                            window=40, S_w=3)),
        ("chunk:cuda_core bf16 psize 12", dict(decode=False, dtype=bf,
                                               quant=False, B=4, C=20,
                                               psize=12)),
        ("chunk:wgmma window", dict(decode=False, dtype=bf, quant=False,
                                    B=4, C=70, window=40, S_w=3)),
        ("chunk:wgmma_int8 window", dict(decode=False, dtype=bf, quant=True,
                                         B=4, C=70, window=40, S_w=3)),
        ("decode:split window", dict(decode=True, dtype=bf, quant=False,
                                     B=4, window=50)),
        ("decode:split int8", dict(decode=True, dtype=bf, quant=True, B=4)),
        ("decode:single", dict(decode=True, dtype=f32, quant=False, B=40)),
    ]
    for label, kw in paged:
        bad = probe_paged(torch, dev, kernel, ref, **kw)
        assert not bad, (label, bad)
        results[label] = "clean"
    for control in ("live_nan", "shifted"):
        bad = probe_paged(torch, dev, kernel, ref, decode=False, dtype=bf,
                          quant=False, B=4, C=70, control=control)
        assert bad, f"18(b) control {control} was not rejected"
        results[f"control {control}"] = f"rejected: {bad[0]}"
        bad = probe_paged(torch, dev, kernel, ref, decode=True, dtype=bf,
                          quant=False, B=4, control=control)
        assert bad, f"18(b) decode control {control} was not rejected"
    gen = torch.Generator(dev).manual_seed(82)
    for dt, D, causal, window in ((bf, 128, True, None), (f32, 64, False, 48),
                                  (bf, 256, True, None), (bf, 64, False,
                                                          None)):
        B, H, KH, S = 2, 4, 2, 200
        q = _rand(torch, dev, gen, (B, H, S, D), dt)
        k, v, do = (_rand(torch, dev, gen, s, dt) for s in (
            (B, KH, S, D), (B, KH, S, D), (B, H, S, D)))
        kw = dict(scale=D ** -0.5, causal=causal, window=window)

        def run(g, q=q, k=k, v=v, do=do, kw=kw):
            qg, kg, vg, dog = (g.banded(n, t) for n, t in (
                ("q", q), ("k", k), ("v", v), ("dout", do)))
            with g:
                o, lse = fkernel.flash_attention_fwd(qg, kg, vg, **kw)
                dq, dk, dv = fkernel.flash_attention_bwd(qg, kg, vg, o, lse,
                                                         dog, **kw)
            return o, dq, dk, dv

        def plain(q=q, k=k, v=v, do=do, kw=kw):
            qq, kk, vv = (t.float().requires_grad_() for t in (q, k, v))
            o = fref.attention_ref(qq, kk, vv, **kw)
            o.backward(do.float())
            return o, qq.grad, kk.grad, vv.grad
        label = f"flash {fkernel.route(dt, D)}{' window' if window else ''}"
        bad = probe_call(torch, dev, label, run, plain, dt)
        assert not bad, (label, bad)
        results[label] = "clean"
    for dt, K, bn in ((bf, 128, 128), (bf, 128, 64), (bf, 13, 128),
                      (f32, 128, 128)):
        G, M, N = 2, 300, 512
        x, w, _ = dm_inputs(torch, dev, dt, G, M, K, N, seed=83)
        mask = (torch.rand(G, N // bn, generator=gen, device=dev) < 0.5
                ).float() * 2.0

        def run(g, x=x, w=w, mask=mask, bn=bn):
            xg, wg, mg = (g.banded(n, t) for n, t in (
                ("x", x), ("w", w), ("mask_blocks", mask)))
            with g:
                return dkernel.dropout_matmul(xg, wg, mg, block_n=bn)
        label = f"dropout_matmul {dkernel.route(dt, K)} block_n {bn}"
        bad = probe_call(torch, dev, label, run, lambda x=x, w=w, mask=mask,
                         bn=bn: dref.dropout_matmul_ref(x, w, mask,
                                                        block_n=bn), dt)
        assert not bad, (label, bad)
        results[label] = "clean"
    for dt, shape in ((bf, (2, 256, 3, 64, 64, 128)),
                      (f32, (2, 200, 3, 48, 40, 64))):
        B, S, H, P_, N_, chunk = shape
        ins = ssd_inputs(torch, dev, dt, B, S, H, P_, N_, 84)

        def run(g, ins=ins, chunk=chunk):
            gi = [g.banded(n, t) for n, t in zip(("x", "dt", "A", "Bm", "Cm"),
                                                 ins)]
            with g:
                return skernel.ssd_chunk_scan(*gi, chunk=chunk)
        Q = sref.chunk_len(chunk, S)
        label = f"ssd_chunk_scan {skernel.route(dt, P_, N_, Q)}"
        bad = probe_call(torch, dev, label, run, lambda ins=ins, chunk=chunk:
                         sref.ssd_chunk_scan_ref(*ins, chunk=chunk), dt)
        assert not bad, (label, bad)
        results[label] = "clean"
    for label, r in results.items():
        log(f"  18(b) {label}: {r}")
    return results


def serve_sanitized(argv):
    """``launch.serve.main(argv)`` in this process, its standard output
    captured; the kernel entries the guards wrap are restored after.
    Returns (exit code, output lines)."""
    import importlib
    import io
    from repro_torch.analysis.sanitize import KERNEL_ENTRIES
    from repro_torch.launch import serve

    saved = [(importlib.import_module(m), a) for m, a in KERNEL_ENTRIES]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    buf = io.StringIO()
    code = 0
    try:
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    return code, buf.getvalue().splitlines()


SANITIZE_LOAD = ["--arch", "qwen3-1.7b", "--full-config", "--device", "cuda",
                 "--stream", "batch", "--requests", "16", "--slots", "8",
                 "--pages", "512", "--page-size", "16", "--max-prompt",
                 "256", "--gen", "32", "--budget", "256", "--policy",
                 "on_demand", "--compute-dtype", "bfloat16", "--sanitize"]


def phase_sanitize_runs(torch, dev, build, kernel):
    """18(c): ``serve --sanitize`` at full width on phase 5's load, three
    ways, then the in-process controls at 2 layers."""
    out = {}
    for label, extra in (("bf16", ["--kv-dtype", "bfloat16"]),
                         ("int8", ["--kv-dtype", "int8"]),
                         ("speculate4", ["--kv-dtype", "bfloat16",
                                         "--speculate", "4"])):
        build.reset_launches()
        t0 = time.perf_counter()
        code, lines = serve_sanitized(SANITIZE_LOAD + extra)
        run_s = time.perf_counter() - t0
        assert code == 0, (label, code, lines[-20:])
        verdict = lines[-1]
        summary = next(ln for ln in lines if " requests (" in ln
                       and ln.endswith("s"))
        ticks = int(next(ln for ln in lines if ln.startswith("throughput:"))
                    .split("(")[1].split()[0])
        checked = int(verdict.split(" over ")[1].split()[0])
        assert verdict.startswith("sanitizer: 0 invariant alerts over ") \
            and checked == ticks > 0, (label, verdict, ticks)
        wall = float(summary.split(" in ")[1].rstrip("s"))
        launches = dict(build.LAUNCHES)
        assert launches[kernel.NAME] > 0 and launches[kernel.NAME_DECODE] \
            > 0, launches
        out[label] = {"ticks": ticks, "checked_ticks": checked,
                      "wall_s": wall, "tick_s": wall / ticks,
                      "run_s": run_s,
                      "launches": {n: launches[n] for n in (
                          kernel.NAME, kernel.NAME_DECODE)}}
        for ln in lines:
            if ln.startswith(("throughput", "speculative:")):
                log(f"  18(c) {label}: {ln}")
        log(f"  18(c) {label}: {verdict}; {summary}; "
            f"{wall / ticks * 1e3:.1f} ms a tick")
    out["controls"] = phase_sanitize_controls(torch, dev)
    return out


def phase_sanitize_controls(torch, dev):
    """The sanitizer's controls on a 2-layer full-width engine: a lost
    table, a stale device row, a NaN in one layer's wo, a rank mismatch;
    each must fire."""
    from repro_torch.analysis.sanitize import (KERNEL_ENTRIES,
                                               NaNGuardError,
                                               RankPromotionError, Sanitizer)
    from repro_torch.configs.base import get_model_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.params import init_params
    from repro_torch.serving import Engine, EngineConfig
    import importlib

    saved = [(importlib.import_module(m), a) for m, a in KERNEL_ENTRIES]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    cfg = dataclasses.replace(get_model_config("qwen3-1.7b"), num_layers=2)
    params = init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    ecfg = EngineConfig(num_slots=8, num_pages=512, page_size=16,
                        max_prompt_len=256, max_new_tokens=8,
                        token_budget=256, kv_dtype="bfloat16",
                        compute_dtype="bfloat16")
    fired = {}
    try:
        def engine():
            eng = Engine(cfg, params, ecfg, device=dev)
            san = Sanitizer()
            san.install_torch_guards()
            san.attach(eng)
            for _, p, g in make_requests(4, cfg.vocab_size,
                                         np.random.default_rng(5),
                                         stream="batch", max_prompt=64,
                                         gen=8):
                eng.submit(p, g)
            eng.step(0.0)
            eng.step(0.0)
            assert san.alerts == [], san.render_report()
            return eng, san

        eng, san = engine()
        rid = next(iter(eng.sched.running.values())).id
        eng.pool._tables.pop(rid)              # a lost table
        san.check(eng, eng.steps)
        fired["pool-leak"] = [a.render() for a in san.alerts
                              if a.kind == "pool-leak"]
        eng, san = engine()
        slot = next(iter(eng.sched.running))
        eng._bt.dev[slot, 0] += 1              # the device row goes stale
        eng.step(0.0)
        fired["block-table"] = [a.render() for a in san.alerts
                                if a.kind == "block-table"]
        eng, san = engine()
        try:
            with san.guards:
                x = torch.ones(8, 16, cfg.d_model, device=dev)
                x + torch.ones(cfg.d_model, device=dev)
            fired["rank"] = []
        except RankPromotionError as e:
            fired["rank"] = [str(e)]
        eng, san = engine()
        wo = eng.params.layers[1].attn.wo    # the engine's (shared) weight
        keep = wo[0, 0, 0].clone()
        with torch.no_grad():
            wo[0, 0, 0] = float("nan")
        try:
            eng.step(0.0)
            fired["nan"] = []
        except NaNGuardError as e:
            fired["nan"] = [str(e)]
        finally:
            with torch.no_grad():
                wo[0, 0, 0] = keep
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    for kind, msgs in fired.items():
        assert msgs, f"18(c) control {kind} did not fire"
        log(f"  18(c) control {kind}: {msgs[0][:200]}")
    assert "einsum" in fired["nan"][0] and "attention.py" in fired["nan"][0]
    return {k: v[0] for k, v in fired.items()}


def phase_analysis_clis():
    """18(d): the hornlint and hornshape CLIs' walls, each ``main`` run in
    this process on the checkout (each must exit 0)."""
    import io
    from repro_torch.analysis import hornlint, hornshape

    out = {}
    for name, main, argv in (
            ("hornlint", hornlint.main,
             [str(ROOT / "src" / "repro_torch"), "--root", str(ROOT)]),
            ("hornshape", hornshape.main, [])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        wall = time.perf_counter() - t0
        last = buf.getvalue().strip().splitlines()[-1]
        assert rc == 0, (name, rc, buf.getvalue()[-2000:])
        log(f"  18(d) {name}: exit 0 in {wall:.2f} s: {last}")
        out[name] = {"wall_s": wall, "last_line": last}
    return out


def phase_analysis(torch, dev, build, kernel, ref, fkernel, fref, dkernel,
                   dref, skernel, sref, served=None):
    """Phase 18: (a) the geometry twin, (b) guard bands, (c) ``serve
    --sanitize`` and its controls, (d) cost."""
    t0 = time.perf_counter()
    out = {"geometry": phase_geometry_twin(torch, dev, kernel)}
    log(f"  18(a) in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    out["guard_bands"] = phase_guard_bands(torch, dev, kernel, ref, fkernel,
                                           fref, dkernel, dref, skernel,
                                           sref)
    log(f"  18(b) in {time.perf_counter() - t1:.1f} s")
    release(torch)
    t1 = time.perf_counter()
    out["sanitize"] = phase_sanitize_runs(torch, dev, build, kernel)
    log(f"  18(c) in {time.perf_counter() - t1:.1f} s")
    release(torch)
    out["clis"] = phase_analysis_clis()
    if served is not None:
        base = served["wall_s"] / served["ticks"]
        for label in ("bf16", "int8", "speculate4"):
            s = out["sanitize"][label]
            log(f"  18(d) sanitized {label} tick {s['tick_s'] * 1e3:.1f} ms "
                f"against phase 5's {base * 1e3:.1f} ms "
                f"({s['tick_s'] / base:.2f}x)")
        out["phase5_tick_s"] = base
    log(f"  phase 18 in {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()

    def phase(msg: str) -> None:
        log(f"{msg} (at {time.perf_counter() - t_start:.0f} s)")

    phase("phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"  card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmul and cuDNN: float32 runs in float32")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from repro_torch.kernels import build
    from repro_torch.kernels.dropout_matmul import kernel as dkernel
    from repro_torch.kernels.dropout_matmul import ref as dref
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.paged_attention import kernel, ref
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.kernels.ssd import ref as sref

    phase("phase 2: build")
    t0 = time.perf_counter()
    sources = [kernel.SOURCE, kernel.SOURCE_DECODE, fkernel.SOURCE,
               dkernel.SOURCE, skernel.SOURCE]
    build.build(sources)
    log(f"  {', '.join(str(s.relative_to(ROOT)) for s in sources)} built "
        f"in {time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for src in sources:
        log(f"    nvcc {src.name}: "
            f"{build.BUILD_SECONDS.get(src.name, 0.0):.1f} s")

    phase("phase 3: kernels against their plain versions")
    chunk_sweep_err = phase_kernels(torch, dev, kernel, ref, build)
    decode_sweep_err = phase_decode_kernels(torch, dev, kernel, ref)
    flash_sweep_err = phase_flash_kernels(torch, dev, fkernel, fref)
    dm_sweep_err = phase_dropout_kernels(torch, dev, dkernel, dref, build)
    ssd_sweep_err = phase_ssd_kernels(torch, dev, skernel, sref, build)

    phase("phase 4: paged engine against a dense recompute")
    parity = phase_parity(torch, dev)

    phase("phase 5: serve qwen3-1.7b (28 layers, bf16)")
    launches, served, eng = phase_serve(torch, dev, build, kernel)
    served["tick_profile"] = phase_tick_profile(torch, eng, kernel)
    served["parity_int8"] = parity
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 5b: serve qwen3-1.7b (28 layers, bf16) on bf16 and on int8 "
        "pools of equal bytes")
    served["int8"] = phase_int8_serve(torch, dev, build, kernel)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 6: train qwen3-1.7b (28 layers, f32 masters, bf16 compute, "
        "Horn, AdamW)")
    trained = phase_train(torch, build, fkernel)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 7: Horn block-sparse MLP, qwen3-1.7b (28 layers, bf16)")
    horn_mlp = phase_horn_mlp(torch, dev, build, dkernel)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 8: timing")
    shapes = phase_timing(torch, dev, kernel, ref)
    decode_sweep = phase_decode_sweep(torch, dev, kernel)
    flash = phase_flash_timing(torch, dev, fkernel, fref)
    dm = phase_dropout_timing(torch, dev, dkernel, dref)
    ssd = phase_ssd_timing(torch, dev, skernel, sref)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 9: ssm, mamba2-2.7b prefill and greedy decode")
    ssm_parity = phase_ssm_parity(torch, dev, build, skernel, sref)
    gc.collect()
    torch.cuda.empty_cache()
    ssm_parity["bf16"] = phase_ssm_parity_bf16(torch, dev, build, skernel,
                                               sref)
    gc.collect()
    torch.cuda.empty_cache()
    ssm = phase_ssm(torch, dev, build, skernel)
    ssm["parity"] = ssm_parity
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 10: horn-mnist, the paper's experiment (784-512-512-10), and "
        "resumable training")
    before = dict(build.LAUNCHES)
    mnist = {"parity": phase_mnist_parity(torch, dev)}
    mnist.update(phase_mnist(torch, dev))
    mnist["cli"] = phase_mnist_cli(torch)
    assert dict(build.LAUNCHES) == before, (before, dict(build.LAUNCHES))
    log("  port kernel launches across the MNIST path: 0 (build.LAUNCHES "
        "unchanged)")
    gc.collect()
    torch.cuda.empty_cache()
    mnist["resume"] = phase_resume(torch)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 11: gemma3-4b (head dim 256) and qwen1.5-4b at full width: "
        "a superblock against the plain path, training, serving")
    new_archs = phase_new_archs(torch, dev, build, kernel, fkernel, fref)

    phase("phase 12: Horn multi-submodel serving, qwen3-1.7b: a bank of "
          "circuits, routing, on-device ensembles, sampling at T > 0")
    bank = phase_bank(torch, dev, build, kernel)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 13: speculative decoding, qwen3-1.7b: a Horn circuit "
          "drafts, the parent verifies a K + 1 window")
    spec = phase_spec(torch, dev, build, kernel, ref)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 14: observability and deterministic replay of the pinned "
          "traces, qwen3-1.7b")
    obs = phase_observability(torch, dev, build, kernel)
    gc.collect()
    torch.cuda.empty_cache()

    phase("phase 15: the MoE, multimodal-prefix and hybrid families: "
          "phi3.5-moe, llama4-maverick, llava-next-34b, jamba-1.5-large")
    fam = phase_families(torch, dev, build, kernel, fkernel, fref, skernel,
                         sref)
    release(torch)

    phase("phase 16: the encoder-decoder family, whisper-base: card against "
          "CPU, training, prefill and decode, flash call by call")
    encdec = phase_encdec(torch, dev, build, fkernel, fref)
    release(torch)

    phase("phase 17: scale-out on torch.distributed (one NCCL rank): "
          "merges, the 1 x 1 mesh step, elastic restart, GPipe, the CLI")
    scale = phase_scaleout(torch, dev, build, fkernel)
    release(torch)

    phase("phase 18: the analysis tooling: launch geometry against the "
          "trace, guard bands, serve --sanitize, the CLIs")
    analysis = phase_analysis(torch, dev, build, kernel, ref, fkernel, fref,
                              dkernel, dref, skernel, sref, served)

    # headline shapes: the prompt-chunk tick for the chunk kernel (decode
    # ticks go to the decode kernel), the decode tick for the decode kernel
    kernels = []
    for name, source, tpu, shape, sweep_err in (
            (kernel.NAME, kernel.SOURCE, TPU_KERNEL, "prefill_chunk",
             chunk_sweep_err),
            (kernel.NAME_DECODE, kernel.SOURCE_DECODE, DECODE_TPU_KERNEL,
             "decode", max(decode_sweep_err.values()))):
        d = shapes[name][shape]
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(source.relative_to(ROOT)), "replaces": tpu,
            "launches": launches[name],
            "max_abs_err": max([sweep_err] + [s["max_abs_err"] for s in
                                              shapes[name].values()]),
            "ms": d["ms"], "kernel_ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
            "library_ms": d["library_ms"], "headline_shape": shape,
            "shapes": shapes[name],
        })
    for k in kernels:                   # phase 12's own runs of the path
        k["launches_phase12"] = {
            f"T {t}": bank[f"serve_t{t}"]["launches"][k["name"]]
            for t in (0.0, 0.8)}
    # phase 13's runs: the parent's and the draft's launches of each
    for k, which in zip(kernels, ("chunk", "decode")):
        k["launches_phase13"] = {
            f"T {t}": {who: spec[f"serve_t{t}"]["launches"][f"{who}_{which}"]
                       for who in ("parent", "draft")} for t in (0.0, 0.8)}
        errs = [spec["parity"]["kernel_vs_plain"],
                spec["serve_t0.0"]["kernel_vs_plain"]]
        shape = "verify" if which == "chunk" else "draft_decode"
        k["max_abs_err_phase13"] = max(e[shape] for e in errs)
        k["max_abs_err"] = max(k["max_abs_err"], k["max_abs_err_phase13"])
    # phase 14's replays of the pinned traces: the card's launches of each
    # at 2 layers (14(a)) and at 28 (14(b), the second replay)
    for k in kernels[:2]:
        k["launches_phase14"] = {
            part: {t: obs[part][t]["launches"][k["name"]] for t in PINNED}
            for part in ("parity", "replay")}
    # phase 15: phi3.5-moe's serving (plain and a 4-circuit bank)
    for k in kernels[:2]:
        k["launches_phase15"] = {
            "phi3.5-moe serve": fam["serve"]["launches"][k["name"]],
            "phi3.5-moe bank": fam["serve_bank"]["launches"][k["name"]]}
    kernels[0]["launches_by_kernel"] = {
        served["chunk_route"]: served["chunk_route_launches"],
        "wgmma_int8 (phase 5b)":
            served["int8"]["int8"]["launches_by_route"]["chunk_wgmma_int8"]}
    kernels[-1]["launches_by_kernel"] = {
        served["decode_route"]: served["decode_route_launches"]}
    kernels[-1]["context_sweep"] = decode_sweep
    # flash at head dim 128 (qwen3-1.7b's train step, phase 6) and at 256
    # (gemma3-4b's, phase 11), each with its own launches
    g3 = new_archs["train_gemma3-4b"]
    for part, name in (("fwd", fkernel.FWD), ("bwd", fkernel.BWD)):
        for run, shapes in ((trained, ("train",)),
                            (g3, ("gemma3_train", "gemma3_train_window"))):
            f = flash[shapes[0]][part]
            kernels.append({
                "name": name if run is trained
                else f"{name}:{run['route']}", "route": "cuda",
                "source": str(fkernel.SOURCE.relative_to(ROOT)),
                "replaces": FLASH_TPU_KERNEL,
                "launches": run["launches"][name],
                "max_abs_err": max([flash_sweep_err] + [
                    flash[k][part]["max_abs_err"] for k in shapes]),
                "ms": f["ms"], "kernel_ms": f["ms"],
                "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
                "bound_by": f["bound_by"], "library_ms": f["library_ms"],
                "head_dim": f["D"],
                "shapes": {k: flash[k][part] for k in shapes},
            })
            if run is trained:          # phase 15's runs at head dim 128
                kernels[-1]["launches_phase15"] = {
                    "phi3.5-moe train": fam["train"]["launches"][name]}
                kernels[-1]["launches_phase17"] = {
                    "mesh train": scale["train"]["launches"][name],
                    "pipeline": scale["pipeline"]["launches"][name],
                    **{f"cli {k}": v["launches"][name]
                       for k, v in scale["cli"].items()}}
                if part == "fwd":
                    kernels[-1]["launches_phase15"].update(
                        {f"{a} prefill": fam[a]["launches"][name] for a in (
                            "llama4-maverick-400b", "llava-next-34b",
                            "jamba-1.5-large-398b")})
    # flash at head dim 64 and G 1 (whisper-base, phase 16): its train
    # step's launches, timed at the encoder's shape (non-causal)
    for part, name in (("fwd", fkernel.FWD), ("bwd", fkernel.BWD)):
        f = flash["whisper_encoder"][part]
        errs = [flash_sweep_err, f["max_abs_err"]]
        if part == "fwd":
            errs += encdec["calls"]["flash_max_abs_err"]
        kernels.append({
            "name": f"{name}:{encdec['train']['route']}", "route": "cuda",
            "source": str(fkernel.SOURCE.relative_to(ROOT)),
            "replaces": FLASH_TPU_KERNEL,
            "launches": encdec["train"]["launches"][name],
            "max_abs_err": max(errs), "ms": f["ms"], "kernel_ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": f["library_ms"],
            "head_dim": f["D"], "shapes": {"whisper_encoder": f},
            "launches_phase16": {
                "train": encdec["train"]["launches"][name],
                "prefill": encdec["serve"]["launches"][name]},
        })
    d = dm["0.5"]                       # the Horn MLP's keep rate
    kernels.append({
        "name": dkernel.NAME, "route": "cuda",
        "source": str(dkernel.SOURCE.relative_to(ROOT)),
        "replaces": DM_TPU_KERNEL, "launches": horn_mlp["launches"],
        "max_abs_err": max([dm_sweep_err] + [s["max_abs_err"]
                                             for s in dm.values()]),
        "ms": d["ms"], "kernel_ms": d["ms"], "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": d["library_ms"], "submodel_ms": d["submodel_ms"],
        "launches_by_kernel": {"wgmma": horn_mlp["wgmma_launches"]},
        "keep_sweep": dm,
    })
    kernels.append({
        "name": skernel.NAME, "route": "cuda",
        "source": str(skernel.SOURCE.relative_to(ROOT)),
        "replaces": SSD_TPU_KERNEL, "launches": ssm["launches_per_prefill"],
        "max_abs_err": max(ssd_sweep_err, ssd["max_abs_err"]),
        "ms": ssd["ms"], "kernel_ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes an SSD chunk scan",
        "launches_by_kernel": ssm["launches_by_route"],
        "launches_phase15": {"jamba-1.5-large prefill": fam[
            "jamba-1.5-large-398b"]["launches"][skernel.NAME]},
        "shapes": {"prefill": ssd},
    })
    line = {"kernels": kernels, "card": card, "serve": served,
            "train": trained, "horn_mlp": horn_mlp, "ssm": ssm,
            "mnist": mnist, "new_archs": new_archs, "bank": bank,
            "spec": spec, "observability": obs, "families": fam,
            "encdec": encdec, "scaleout": scale, "analysis": analysis,
            "flash_host_us": flash["host_us"]}
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
