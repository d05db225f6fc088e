"""Continuous-batching inference engine over the paged KV cache.

One engine tick = one call of the unified paged step, whatever the tick
holds.  The scheduler fills a fixed *token budget* with a mix of decode
tokens (one per running slot) and prompt chunks from admitting requests;
the step appends every token's K/V to the page pools in place, runs paged
attention and samples every slot's next token on the device (greedy, or
at ``temperature > 0`` a categorical draw keyed by the JAX package's
threefry ``fold_in(fold_in(key(seed), request), step)``).  A tick whose
chunk bucket is 1 holds decode tokens only and runs the decode kernel
``paged_attention``; wider ticks run ``paged_chunk_attention`` (both CUDA
kernels on a card).  Positions are per slot: slot b's chunk starts at the
number of KV tokens it already has in pages.  KV pools are f32, bf16 or
int8; int8 pools quantize on append, with one f32 scale per (page, kv
head) riding beside them, and hold about twice the pages of bf16 in the
same bytes.

Multi-submodel serving (Horn §2 at inference): pass a ``ModelBank`` and
the engine serves its G parallel circuits behind the same scheduler and
page pool.  A ``Router`` tags each request with a ``submodel_id``, the
step gathers that slot's circuit masks on the device, and tokens of
different circuits co-batch in one tick.  ``submit(..., ensemble=...)``
fans one prompt across all G circuits in lockstep and combines their
logits on the device (mean-logit or majority vote) before sampling: the
paper's collective ensemble served as one request.  The group's shared
prompt context [0, len - 1) is encoded by the dense parent (the bank's
sentinel row), so the leader prefills it once and the members fork its
pages.

Under the ``on_demand`` policy, pool pressure preempts the youngest running
sequence (or ensemble group) back to the head of the waiting queue (its KV
is recomputed on re-admission through the same chunked-prefill path);
``EngineOOM`` is kept for a sequence that can never fit the pool even
alone.  With ``prefix_cache`` on, full prompt pages are content-addressed
and adopted by later requests with the same prefix; writes into shared
pages copy them first (copy-on-write, ``core/steps.py::make_page_copy_step``).

Chunk widths are bucketed to powers of two, as in the JAX engine.

Speculative decoding (``EngineConfig.speculate_k`` and a
``ModelBank.draft_model``): each speculating decode slot first runs the
materialized draft circuit for up to K tokens (one draft call a tick,
batched across slots, against the draft's private page pool:
``serving/speculative.py``), then the parent verifies all K + 1 positions
inside the tick's one call, chunk kernel and all.  Greedy commits the
longest draft prefix equal to the parent's argmax, so the stream is the
non-speculative stream token for token; at temperature > 0 it is
rejection sampling against the draft's distribution, reproducible per
(request, step) key.  The token budget meters the parent's work: a
speculating slot costs 1 + K verified tokens, the drafted tokens nothing.
The draft's paged-kernel launches are counted apart from the parent's.

Observability (``serving/observability``, the port of the JAX package's):
the engine writes a ``Telemetry`` at every stage of a request (submit,
admit, prefill chunk, token, speculate, preempt, finish) and of a tick
(its five phase marks, per-slot spans while a timeline records, pool
counters, the KV bytes its attention reads).  The profiler wraps the
unified step (and the draft's) with the JAX engine's variant labels and
times each call with CUDA events read after the tick's host pull.
``metrics()`` is the read surface; ``reset_stats()`` zeroes counters and
telemetry together.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig
from repro_torch.core import prng
from repro_torch.core import steps as S
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.kernel import NAME, NAME_DECODE
from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of
from repro_torch.models.params import cast_params
from repro_torch.serving.block_table import (BlockTableMirror, marshal_i32,
                                             pow2_bucket)
from repro_torch.serving.kv_cache import PagePool, PagePoolOOM, kv_page_bytes
from repro_torch.serving.model_bank import DraftModel, ModelBank
from repro_torch.serving.observability import EngineStats, Telemetry
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import (EnsembleGroup, FCFSScheduler,
                                           Request, speculative_draft_len)
from repro_torch.serving.speculative import DraftRunner

COMBINES = ("mean_logit", "majority_vote")


def _unified_step_key(args, kw):
    """Compile-cell label for the profiler, the JAX engine's: the unified
    step specialises on the chunk-width bucket (tokens arg), the verify
    window extent (draft_probs arg) and the ensembles flag; everything
    else is shape-fixed per engine."""
    c = args[2].shape[1]                  # tokens [B, C]
    sv = args[12].shape[1] + 1            # draft_probs [B, S_v - 1, V]
    ens = bool(kw.get("ensembles", False))
    return (c, sv, ens), f"C={c},Sv={sv},ens={ens}"


class EngineOOM(RuntimeError):
    """The page pool cannot serve a sequence even after preempting every
    other running sequence.  The engine state is left consistent."""


@dataclass(frozen=True)
class EngineConfig:
    num_slots: int = 8               # decode batch width
    num_pages: int = 256             # pool size (page 0 is the null page)
    page_size: int = 16              # tokens per KV page
    max_prompt_len: int = 256
    max_new_tokens: int = 64         # default + hard cap per request
    token_budget: int = 256          # tokens per unified tick (decode+chunks)
    temperature: float = 0.0         # <= 0: greedy; else sampled
    seed: int = 0                    # root of the sampling keys
    policy: str = "reserve"          # "reserve" | "on_demand" (see scheduler)
    eos_id: Optional[int] = None
    kv_dtype: str = "bfloat16"       # page pools: float32 | bfloat16 | int8
    compute_dtype: str = "bfloat16"  # parameter dtype during serving
    prefix_cache: bool = True        # content-addressed page reuse + COW
    speculate_k: int = 0             # draft tokens verified a decode tick
                                     # (0: no speculation; > 0 needs a
                                     # DraftModel passed to the Engine)

    @property
    def max_model_len(self) -> int:
        return self.max_prompt_len + self.max_new_tokens


@dataclass
class _Entry:
    """What one slot contributes to this tick's device call."""
    req: Request
    start: int                       # KV tokens already in pages
    tokens: np.ndarray               # [chunk_len] int32
    chunk_len: int
    sample_step: int                 # fold_in step of the sampling key
    record: bool                     # keep the sampled token?
    mask_id: int                     # circuit-mask row the step gathers
                                     # (the dense sentinel for an
                                     # ensemble's shared prompt context)
    draft_len: int = 0               # drafted tokens this chunk verifies
                                     # (tokens[1:1 + draft_len])


class Engine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *,
                 bank: Optional[ModelBank] = None,
                 router: Optional[Router] = None,
                 draft: Optional[DraftModel] = None, device="cuda",
                 telemetry: Optional[Telemetry] = None):
        bad = [k for k in cfg.layer_pattern if k not in (ATTN, LOCAL)]
        if bad or cfg.is_encoder_decoder or cfg.num_patches or cfg.learned_pos:
            raise ValueError(
                f"paged serving supports decoder-only attention LMs; "
                f"{cfg.name} has {bad or 'an unsupported input frontend'}")
        if ecfg.speculate_k > 0:
            if draft is None:
                raise ValueError(
                    "speculate_k > 0 needs a DraftModel "
                    "(ModelBank.draft_model) to propose tokens")
            if draft.cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft.cfg.vocab_size} != parent vocab "
                    f"{cfg.vocab_size}: drafted ids would be meaningless")
        elif draft is not None:
            raise ValueError("a DraftModel needs speculate_k > 0 to be used")
        if bank is not None:
            if bank.cfg != cfg:
                raise ValueError(
                    f"bank was built for {bank.cfg.name}, engine serves "
                    f"{cfg.name}")
            router = router if router is not None \
                else Router(bank.num_submodels)
            if router.num_submodels != bank.num_submodels:
                raise ValueError(
                    f"router spans {router.num_submodels} submodels, "
                    f"bank holds {bank.num_submodels}")
        elif router is not None:
            raise ValueError("a Router needs a ModelBank to route over")
        if ecfg.kv_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"kv_dtype {ecfg.kv_dtype!r}: expected "
                             f"float32, bfloat16 or int8")
        if ecfg.max_prompt_len % ecfg.page_size:
            raise ValueError("max_prompt_len must be page-aligned")
        if ecfg.token_budget < ecfg.num_slots:
            raise ValueError(
                f"token_budget ({ecfg.token_budget}) must cover one decode "
                f"token per slot ({ecfg.num_slots})")
        self.device = resolve_device(device)
        wrong = {str(p.device) for p in params.parameters()
                 if p.device != self.device}
        if wrong:
            raise ValueError(f"params live on {sorted(wrong)}, the engine "
                             f"on {self.device}")
        self.cfg, self.ecfg = cfg, ecfg
        self.bank, self.router = bank, router
        # cast once here: the step never casts parameters per tick
        self.params = cast_params(params, dtype_of(ecfg.compute_dtype))
        self.pool = PagePool(ecfg.num_pages, ecfg.page_size,
                             prefix_cache=ecfg.prefix_cache)
        self.sched = FCFSScheduler(ecfg.num_slots, self.pool,
                                   policy=ecfg.policy)
        self.max_pages_per_seq = self.pool.pages_for(ecfg.max_model_len)
        # the mask row of dense-parent chunks (an ensemble's shared prompt
        # context): device_masks appends an all-ones row at index G
        self._dense_mask_id = bank.num_submodels if bank is not None else 0
        # telemetry before the step: the profiler wraps it and must see
        # its very first (warmup) call
        self.obs = telemetry if telemetry is not None else Telemetry()
        self._step = S.make_unified_paged_step(
            cfg, temperature=ecfg.temperature,
            bank_masks=bank.device_masks(self.device)
            if bank is not None else None)
        if self.obs.profiler is not None:
            self._step = self.obs.profiler.wrap(
                "unified_step", self._step, key_fn=_unified_step_key,
                device=self.device)
        self._page_copy = S.make_page_copy_step()
        self.cache = T.init_paged_cache(cfg, ecfg.num_pages, ecfg.page_size,
                                        dtype=dtype_of(ecfg.kv_dtype),
                                        device=self.device)
        # a preempted request's re-prefill (up to max_model_len - 1 kv
        # tokens) takes extra ticks rather than a wider chunk bucket
        self.max_chunk = min(ecfg.token_budget, ecfg.max_prompt_len)
        self._bt = BlockTableMirror(ecfg.num_slots, self.max_pages_per_seq,
                                    self.device)
        self._root_key = prng.key(ecfg.seed, self.device)
        self.spec: Optional[DraftRunner] = DraftRunner(
            draft, ecfg, self.device, profiler=self.obs.profiler) \
            if draft is not None else None
        # the S_v == 1 verify window of a tick with no speculating slot
        self._noprobs = torch.zeros((ecfg.num_slots, 0, 1),
                                    dtype=torch.float32, device=self.device)
        self._next_id = 0
        self._next_group_id = 0
        # serving counters live on an EngineStats dataclass
        # (observability/stats.py); the properties set after the class
        # keep every counter readable/writable as a plain engine attribute
        self.stats = EngineStats()
        self._evictions_base = 0         # pool evictions at last reset
        # estimated bytes one tick's paged attention reads per live KV
        # page across all layers (roofline gauges; see kv_page_bytes)
        self._kv_bytes_per_page = cfg.num_layers * kv_page_bytes(
            ecfg.page_size, cfg.num_kv_heads, cfg.head_dim, ecfg.kv_dtype)
        # stamp the tuning knobs into exported traces + metrics snapshots
        self.obs.set_engine_config(
            kv_dtype=ecfg.kv_dtype, compute_dtype=ecfg.compute_dtype,
            speculate_k=ecfg.speculate_k,
            bank_size=bank.num_submodels if bank is not None else 0,
            num_slots=ecfg.num_slots, num_pages=ecfg.num_pages,
            page_size=ecfg.page_size, token_budget=ecfg.token_budget,
            max_prompt_len=ecfg.max_prompt_len,
            max_new_tokens=ecfg.max_new_tokens, policy=ecfg.policy,
            prefix_cache=ecfg.prefix_cache,
            temperature=ecfg.temperature, seed=ecfg.seed,
            device=str(self.device))

    @property
    def preemptions(self) -> int:
        return self.sched.preemptions

    @property
    def accept_rate(self) -> float:
        return self.stats.accept_rate

    @property
    def accepted_tok_per_tick(self) -> float:
        return self.stats.accepted_tok_per_tick

    @property
    def cobatch_ratio(self) -> float:
        return self.stats.cobatch_ratio

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        return self.stats.prefix_hit_rate

    @property
    def cache_evictions(self) -> int:
        """Prefix-cache evictions since the last ``reset_stats``."""
        if self.pool.cache is None:
            return 0
        return self.pool.cache.evictions - self._evictions_base

    def metrics(self) -> dict:
        """Full telemetry snapshot: counters, derived rates, pool/router/
        cache/spec state, latency + tick distributions, SLO attainment.
        Also refreshes ``self.obs.registry``."""
        self.obs.collect(self)
        return self.obs.snapshot(self)

    def reset_stats(self) -> None:
        """Zero the serving counters without touching the pool (warm up on
        the engine you measure, then discard the warmup's contribution).
        Telemetry (histograms, traces, timeline, SLO scores) resets with
        the counters, and the profiler marks the warmup boundary."""
        self.stats.reset()
        if self.spec is not None:
            self.spec.reset_stats()
        if self.pool.cache is not None:
            self._evictions_base = self.pool.cache.evictions
        self.sched.preemptions = 0
        self.sched.finished.clear()
        self.obs.reset()

    # -- request intake ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               arrival_time: float = 0.0, *,
               submodel_id: Optional[int] = None, session=None,
               ensemble: Optional[str] = None, slo_class: str = "default"
               ) -> Union[Request, EnsembleGroup]:
        """Queue one request.  With a ModelBank attached, the Router picks
        (or validates) the circuit; ``ensemble`` ("mean_logit" or
        "majority_vote") instead fans the prompt across ALL G circuits as
        one lockstep group and returns the ``EnsembleGroup``.
        ``slo_class`` names the priority class the finished request is
        scored under (observability/slo.py)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if not 0 < len(prompt) <= self.ecfg.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt)} not in [1, "
                f"{self.ecfg.max_prompt_len}] — an empty prompt has no "
                f"token to decode from")
        mnt = min(max_new_tokens or self.ecfg.max_new_tokens,
                  self.ecfg.max_new_tokens)

        if ensemble is not None:
            if self.bank is None:
                raise ValueError("ensemble mode requires a ModelBank")
            if submodel_id is not None or session is not None:
                raise ValueError(
                    "ensemble fans across ALL circuits — submodel_id/"
                    "session routing hints conflict with it")
            if ensemble not in COMBINES:
                raise ValueError(
                    f"unknown combine {ensemble!r}; known: {COMBINES}")
            G = self.bank.num_submodels
            if G > self.ecfg.num_slots:
                raise ValueError(
                    f"ensemble needs {G} slots (one per circuit) but the "
                    f"engine has {self.ecfg.num_slots}")
            group = EnsembleGroup(id=self._next_group_id, combine=ensemble,
                                  share=self.ecfg.prefix_cache)
            self._next_group_id += 1
            # the shared context [0, len - 1) is dense-parent encoded
            # (namespace b"dense"); each member's circuit engages at the
            # last prompt token, so the leader can prefill it for all
            group.members = [
                Request(id=self._next_id + g, prompt=prompt,
                        max_new_tokens=mnt, arrival_time=arrival_time,
                        eos_id=self.ecfg.eos_id, submodel_id=g, group=group,
                        kv_namespace=b"dense", mask_from=len(prompt) - 1,
                        slo_class=slo_class)
                for g in range(G)]
            self._check_feasible(group.members[0])
            self._next_id += G
            for g in range(G):
                self.router.acquire(g)
            for req in group.members:
                self.sched.submit(req)
                self.obs.on_submit(req, arrival_time)
            return group

        req = Request(id=self._next_id, prompt=prompt, max_new_tokens=mnt,
                      arrival_time=arrival_time, eos_id=self.ecfg.eos_id,
                      slo_class=slo_class)
        self._check_feasible(req)
        if self.bank is not None:
            req.submodel_id = self.router.route(
                submodel_id=submodel_id, session=session, prompt=prompt)
            req.kv_namespace = b"sub:%d" % req.submodel_id
        elif submodel_id not in (None, 0):
            raise ValueError("submodel routing requires a ModelBank")
        self._next_id += 1
        self.sched.submit(req)
        self.obs.on_submit(req, arrival_time)
        return req

    def _check_feasible(self, req: Request) -> None:
        """Reject a request that could never be admitted, even into an
        empty pool (it would pin the FCFS head forever)."""
        need = self._admission_need(req)
        if need > self.pool.capacity:
            raise ValueError(
                f"request needs {need} page(s) at admission "
                f"(policy={self.ecfg.policy}) but the pool has only "
                f"{self.pool.capacity}; raise num_pages or shrink "
                f"prompt/max_new_tokens")

    def _admission_need(self, req: Request) -> int:
        """Worst-case pages the whole scheduling unit (solo, or every
        ensemble member) needs available to admit."""
        unit = req.group.members if req.group is not None else [req]
        return self.sched.unit_admission_pages(unit)

    def finished_streams(self) -> List[Request]:
        """Finished requests, one per delivered token stream: solo requests
        and the leader of each ensemble group (every member carries the
        group's stream)."""
        return [r for r in self.sched.finished
                if r.group is None or r is r.group.leader]

    # -- internals -----------------------------------------------------------
    def _sync_block_tables(self) -> None:
        self.stats.bt_rows_synced += self._bt.sync(
            self.pool, self.sched.running,
            lambda r: (r.id, r.admit_seq, self.pool.table_version(r.id)))

    def _sample_peak(self) -> None:
        self.stats.peak_utilization = max(self.stats.peak_utilization,
                                          self.pool.utilization())
        if self.bank is not None:
            peak = self.stats.peak_util_by_submodel
            for owner, util in self.pool.utilization_by_owner().items():
                if util > peak.get(owner, 0.0):
                    peak[owner] = util

    def _evict_finished(self, now: float) -> List[Request]:
        """Free the finished requests' slots and pages, hand their circuits
        back to the router and drop their draft state.  Every finished
        request passes through here exactly once, and telemetry scores it
        here."""
        done = self.sched.evict_finished(now)
        for req in done:
            self.obs.on_finish(req, req.t_done)
            if self.router is not None:
                self.router.release(req.submodel_id)
            if self.spec is not None:
                self.spec.drop(req.id)
        return done

    def _flush_copies(self, pairs) -> None:
        """Issue the device page copies a COW swap requires."""
        if not pairs:
            return
        src, dst = marshal_i32(self.device, *zip(*pairs))
        self.cache = self._page_copy(self.cache, src.long(), dst.long())
        self.stats.cow_page_copies += len(pairs)

    def _prepare_entry_write(self, req: Request, start: int,
                             end: int) -> None:
        """Grow the request's table through ``end`` tokens and COW any page
        in the written range [start, end) that others still hold.  May
        raise PagePoolOOM — the preempt-youngest loop answers."""
        self.pool.ensure(req.id, end)
        self._flush_copies(self.pool.prepare_write(req.id, start, end))

    # -- tick planning -------------------------------------------------------
    def _plan_tick(self, now: float) -> Dict[int, _Entry]:
        """Fill the token budget; preempt the youngest running unit (a
        sequence or a whole ensemble group, and replan) on pool pressure;
        raise EngineOOM only when no preemption can help."""
        while True:
            try:
                return self._try_plan()
            except PagePoolOOM as e:
                victim = self.sched.preempt_youngest()
                if victim is None:
                    raise EngineOOM(
                        f"tick {self.stats.steps}: {e}; no other sequence "
                        f"left to preempt — this request can never fit; "
                        f"raise --pages, lower --gen, or use --policy "
                        f"reserve") from e
                for m in (victim.group.members if victim.group is not None
                          else [victim]):
                    m.t_preempted = now
                    self.obs.on_preempt(m, now)
                    if self.spec is not None:
                        # a preempted request's draft K/V is rebuilt by one
                        # catch-up chunk on re-admission
                        self.spec.drop(m.id)

    def _try_plan(self) -> Dict[int, _Entry]:
        entries: Dict[int, _Entry] = {}
        budget = self.ecfg.token_budget
        decode, prefill = [], []
        for slot, req in sorted(self.sched.running.items()):
            (prefill if req.in_prefill else decode).append((slot, req))

        # the tick's draft length: one for every speculating slot (one
        # verify-window width a call), sized so the budget covers every
        # decode slot's pending token plus 1 + k verified tokens for each
        # speculating slot
        spec_k = self.ecfg.speculate_k if self.spec is not None else 0

        def allowance(r: Request) -> int:
            # a tick commits at most 1 + dl tokens, so a draft past the
            # request's remaining allowance minus one can never land; the
            # same bound keeps the verify chunk's K/V writes inside
            # max_model_len and the reserve policy's admission reserve
            return r.prompt_len + r.max_new_tokens - r.context_len - 1

        # only slots that can land a draft share the speculative budget
        n_spec = sum(1 for _, r in decode
                     if r.spec_eligible and allowance(r) > 0) \
            if spec_k else 0
        k_tick = min(speculative_draft_len(spec_k, budget, len(decode),
                                           n_spec), self.max_chunk - 1)
        for slot, req in decode:
            dl = 0
            if k_tick > 0 and req.spec_eligible:
                dl = max(0, min(k_tick, allowance(req)))
            # the pending token's K/V lands at context_len - 1, the
            # drafts' after it
            self._prepare_entry_write(req, req.context_len - 1,
                                      req.context_len + dl)
            toks = np.zeros((1 + dl,), np.int32)
            toks[0] = req.out_tokens[-1]     # drafts land in toks[1:] later
            entries[slot] = _Entry(
                req=req, start=req.context_len - 1, tokens=toks,
                chunk_len=1 + dl, sample_step=len(req.out_tokens),
                record=True, mask_id=req.submodel_id, draft_len=dl)
            budget -= 1 + dl
        # prompt chunks soak up whatever budget the decode tokens left,
        # oldest admission first (it holds pages; finish it soonest).
        # Ensemble groups advance in LOCKSTEP (every member the same chunk
        # width, so all finish prefill in the same tick and their combined
        # logits give the group's first token together), and chunks break
        # at ``mask_from``: an ensemble stream is dense-parent encoded
        # before it and member-masked from it on.  With sharing, only the
        # leader computes the dense region, then the group forks.
        prefill.sort(key=lambda sr: sr[1].admit_seq)
        planned_groups = set()
        for slot, req in prefill:
            group = req.group
            if group is not None:
                if group.id in planned_groups:
                    continue
                planned_groups.add(group.id)
                if group.share and not group.forked:
                    leader = group.leader
                    if leader.prefill_pos < leader.mask_from:
                        unit = [(leader.slot, leader)]   # dense solo advance
                    else:
                        self.stats.prefill_tok_saved += \
                            self.sched.fork_group(group)
                        unit = [(m.slot, m) for m in group.members]
                else:
                    unit = [(m.slot, m) for m in group.members]
            else:
                unit = [(slot, req)]
            n = len(unit)
            r0 = unit[0][1]
            want = len(r0.kv_tokens) - r0.prefill_pos
            dense = r0.prefill_pos < r0.mask_from
            if dense:                       # stop at the mask boundary
                want = min(want, r0.mask_from - r0.prefill_pos)
            cl = min(want, max(budget, 0) // n, self.max_chunk)
            if cl <= 0:
                continue                          # budget exhausted
            # write-prep members BEFORE the leader: each member's COW of the
            # shared boundary page redeems its own deferred-reserve credit,
            # and the leader, whose admission reserve covers the original
            # page, is the last holder left and writes it in place
            for s, r in unit[1:] + unit[:1]:
                kv = r.kv_tokens
                finishes = r.prefill_pos + cl == len(kv)
                self._prepare_entry_write(r, r.prefill_pos,
                                          r.prefill_pos + cl)
                entries[s] = _Entry(
                    req=r, start=r.prefill_pos,
                    tokens=kv[r.prefill_pos:r.prefill_pos + cl],
                    chunk_len=cl, sample_step=0,
                    # the chunk that completes a *fresh* prompt yields the
                    # first token; a preempted request's next token is
                    # already known
                    record=finishes and not r.out_tokens,
                    mask_id=self._dense_mask_id if dense else r.submodel_id)
            budget -= cl * n
        return entries

    # -- one engine tick -----------------------------------------------------
    def step(self, now: Optional[float] = None,
             tick_clock=None) -> List[Request]:
        """Admit + advance every running slot by one device call.  Returns
        the requests that finished this tick.  ``tick_clock`` (a zero-arg
        callable on the epoch of ``now``) stamps events after the device
        call; without it every event of the tick shares ``now``."""
        now = time.monotonic() if now is None else now
        tick_now = tick_clock if tick_clock else (lambda: now)
        pc = time.perf_counter                    # timeline clock (µs spans)
        m_start = pc()
        for req in self.sched.admit(now):
            self.stats.cache_hit_tokens += req.num_cached_tokens
            self.stats.cache_eligible_tokens += req.cache_eligible_tokens
            self.stats.prefill_tok_saved += req.num_cached_tokens
            self.obs.on_admit(req, now)
        self._sample_peak()                       # admissions allocate pages
        done = self._evict_finished(tick_now())   # e.g. max_new == 1
        if not self.sched.running:
            if self.sched.waiting:
                head = self.sched.waiting[0]
                need = self._admission_need(head)
                if need > self.pool.capacity:
                    raise EngineOOM(
                        f"request {head.id} needs {need} page(s) to "
                        f"re-admit but the pool has only "
                        f"{self.pool.capacity}; its context can never "
                        f"fit — raise --pages or lower --gen")
            return done

        entries = self._plan_tick(now)
        self._sample_peak()                       # decode growth allocates
        if not entries:
            return done
        m_plan = pc()

        # draft proposals first: one draft call for every speculating
        # slot, whose tokens then ride the verify chunks of the parent call
        spec_units = [(slot, e) for slot, e in entries.items()
                      if e.draft_len > 0]
        draft_probs = self._noprobs
        draft_span = ()
        if spec_units:
            t_draft = pc()
            chunk0, decode0 = build.LAUNCHES[NAME], build.LAUNCHES[NAME_DECODE]
            drafts, draft_probs = self.spec.propose(
                [(s, e.req) for s, e in spec_units],
                max(e.draft_len for _, e in spec_units), self._root_key)
            decode = build.LAUNCHES[NAME_DECODE] - decode0
            self.stats.draft_decode_launches += decode
            self.stats.draft_attn_launches += \
                build.LAUNCHES[NAME] - chunk0 + decode
            for slot, e in spec_units:
                e.tokens[1:1 + e.draft_len] = drafts[slot, :e.draft_len]
            draft_span = (("draft", t_draft, pc()),)

        B = self.ecfg.num_slots
        C = pow2_bucket(max(e.chunk_len for e in entries.values()))
        tokens = np.zeros((B, C), np.int32)
        starts = np.zeros((B,), np.int32)
        chunk_lens = np.zeros((B,), np.int32)
        req_ids = np.zeros((B,), np.int32)
        sample_steps = np.zeros((B,), np.int32)
        submodel_ids = np.zeros((B,), np.int32)
        seg_ids = np.arange(B, dtype=np.int32)    # solo: own segment
        vote_flags = np.zeros((B,), np.int32)
        draft_lens = np.zeros((B,), np.int32)
        for slot, e in entries.items():
            tokens[slot, :e.chunk_len] = e.tokens
            starts[slot] = e.start
            chunk_lens[slot] = e.chunk_len
            req_ids[slot] = e.req.id
            sample_steps[slot] = e.sample_step
            submodel_ids[slot] = e.mask_id
            draft_lens[slot] = e.draft_len
            group = e.req.group
            if group is not None:
                seg_ids[slot] = group.leader.slot
                if group.combine == "majority_vote":
                    vote_flags[slot] = 1          # members sample, then vote
                else:
                    # mean-logit: one sampling key per group, one draw
                    req_ids[slot] = group.leader.id
        self.stats.ticks_nonempty += 1
        if len({e.req.submodel_id for e in entries.values()}) > 1:
            self.stats.ticks_cobatched += 1
        self._sync_block_tables()
        # ticks without an ensemble group skip the on-device combine
        ensembles = any(e.req.group is not None for e in entries.values())
        m_host = pc()
        (d_tokens, d_starts, d_chunk_lens, d_req_ids, d_sample_steps,
         d_submodel_ids, d_seg_ids, d_vote_flags, d_draft_lens) = \
            marshal_i32(self.device, tokens, starts, chunk_lens, req_ids,
                        sample_steps, submodel_ids, seg_ids, vote_flags,
                        draft_lens)
        chunk0, decode0 = build.LAUNCHES[NAME], build.LAUNCHES[NAME_DECODE]
        sampled, accepted = self._step(
            self.params, self.cache, d_tokens, d_starts, d_chunk_lens,
            self._bt.dev, d_req_ids, d_sample_steps, d_submodel_ids,
            d_seg_ids, d_vote_flags, d_draft_lens, draft_probs,
            self._root_key, ensembles=ensembles)
        # the one deliberate host pull of a tick (a verify tick's two
        # outputs in one transfer)
        if spec_units:
            both = np.asarray(  # hornlint: sync-ok
                torch.stack([sampled, accepted]).cpu())
            sampled, accepted = both[0], both[1]
        else:
            sampled = np.asarray(sampled.cpu())  # hornlint: sync-ok
        m_dev = pc()
        decode = build.LAUNCHES[NAME_DECODE] - decode0
        self.stats.decode_launches += decode
        self.stats.attn_launches += build.LAUNCHES[NAME] - chunk0 + decode
        self.stats.decode_ticks += C == 1
        self.stats.steps += 1
        post = tick_now()

        for slot, e in entries.items():
            req = e.req
            was_prefill = req.in_prefill
            if was_prefill:
                self.stats.prefill_tokens += e.chunk_len
                self.obs.on_prefill_chunk(req, post, e.start, e.chunk_len)
            if e.draft_len:
                self._commit_spec(slot, e, int(sampled[slot]),
                                  int(accepted[slot]), post)
                continue
            # decode writes K/V too (position context_len - 1): advance
            # prefill_pos past every write of this tick
            req.prefill_pos = max(req.prefill_pos, e.start + e.chunk_len)
            if was_prefill and req.page_hashes:
                # content-index every freshly materialized full page of the
                # publishable (namespace-uniform) region
                full = min(req.prefill_pos, req.publishable_end) \
                    // self.ecfg.page_size
                if full:
                    self.pool.publish_prefix(req.id, req.page_hashes, full)
            if e.record:
                self.sched.record_token(slot, int(sampled[slot]), post)
                self.stats.generated_tokens += 1
                by = self.stats.tokens_by_submodel
                by[req.submodel_id] = by.get(req.submodel_id, 0) + 1
                self.obs.on_token(req, post)

        finished = self._evict_finished(post)
        # the tick's phase spans + per-slot device-window annotations:
        # per-slot tuples are only built while a timeline records
        if self.obs.timeline is not None:
            slot_events = [
                (slot, f"verify+{e.draft_len}" if e.draft_len
                 else ("decode" if e.sample_step else "prefill"),
                 m_host, m_dev,
                 {"req": e.req.id, "tokens": e.chunk_len, "start": e.start})
                for slot, e in entries.items()]
            counters = {"used_pages": self.pool.used_pages,
                        "cached_pages": self.pool.cached_pages,
                        "running": len(self.sched.running),
                        "waiting": len(self.sched.waiting)}
        else:
            slot_events, counters = (), None
        # estimated KV traffic of this tick's device call (roofline
        # gauges): every live slot's paged attention walks its whole
        # table each layer
        kv_read_bytes = self._kv_bytes_per_page * sum(
            self.pool.pages_for(e.req.context_len)
            for e in entries.values())
        self.obs.on_tick(self.stats.steps - 1,
                         (m_start, m_plan, m_host, m_dev, pc()),
                         slot_events=slot_events, extra_spans=draft_span,
                         counters=counters,
                         tokens=int(sum(e.chunk_len
                                        for e in entries.values())),
                         t=post, used_pages=self.pool.used_pages,
                         live_pages=self.pool.live_table_pages,
                         kv_read_bytes=kv_read_bytes)
        return done + finished

    def _commit_spec(self, slot: int, e: _Entry, sampled: int, acc: int,
                     now: float) -> None:
        """Land a verify verdict: commit the accepted drafts and the one
        verified token the parent sampled after them, stopping at EOS or
        max_new exactly where sequential decode would; then roll the page
        tail back to the committed K/V (a release of references through
        ``truncate_seq``, never a copy) and tell the draft runner which of
        its proposals survived."""
        req = e.req
        acc = min(acc, e.draft_len)
        n0 = req.context_len                  # before any commit
        c = 0
        for tok in [int(t) for t in e.tokens[1:1 + acc]] + [sampled]:
            self.sched.record_token(slot, tok, now)
            c += 1
            self.stats.generated_tokens += 1
            by = self.stats.tokens_by_submodel
            by[req.submodel_id] = by.get(req.submodel_id, 0) + 1
            if req.finished:                  # EOS or max_new mid-window
                break
        self.stats.spec_slot_ticks += 1
        self.stats.spec_drafted += e.draft_len
        self.stats.spec_accepted += min(acc, c)
        self.stats.spec_committed += c
        self.obs.on_speculate(req, now, e.draft_len, min(acc, c), c)
        self.obs.on_token(req, now, n=c)
        if req.finished:
            # the pages go with the slot and the draft state with it
            # (``_evict_finished``)
            req.prefill_pos = n0 + min(acc, c)
            return
        # valid K/V: the context plus exactly the accepted drafts (the
        # verify chunk wrote every draft's; the rejected tail is stale and
        # its pages go back, credited again under reserve so the
        # admission reserve survives the rollback)
        req.prefill_pos = n0 + acc
        self.pool.truncate_seq(req.id, req.prefill_pos,
                               recredit=self.ecfg.policy == "reserve")
        self.spec.commit(req, acc)

    def run(self, *, clock=None) -> List[Request]:
        """Drive until every submitted request has finished."""
        clock = clock or time.monotonic
        while self.sched.has_work():
            self.step(clock())
        return self.sched.finished


def _stats_attr(name: str) -> property:
    def get(self):
        return getattr(self.stats, name)

    def set_(self, v):
        setattr(self.stats, name, v)

    return property(get, set_)


# every EngineStats counter stays a plain engine attribute
# (``engine.generated_tokens``, ``engine.steps``), as on the JAX engine:
# derived from the dataclass fields, so a counter added to EngineStats is
# an engine attribute too
for _f in dataclasses.fields(EngineStats):
    setattr(Engine, _f.name, _stats_attr(_f.name))
del _f
