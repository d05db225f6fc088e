"""FCFS continuous-batching scheduler: admission queue + slot lifecycle +
preemption, prefix-cache-aware.  A copy of ``repro/serving/scheduler.py``;
the port's engine does not form ensemble groups yet, the scheduler keeps
their logic for when it does.

Requests wait in arrival order; a request joins the running batch as soon as
a slot is free AND the page pool can cover it under the admission policy.
Admitted requests stream their prompt into the page pool in token-budget
chunks (the engine's unified tick), then decode; slots are evicted the
moment a request finishes, so the next waiting request joins mid-flight —
no batch barrier.

Admission consults the pool's prefix cache first: the longest cached
page-prefix of the prompt is *adopted* (refcount + 1 per page, zero fresh
pages, zero prefill compute) and chunked prefill starts at
``num_cached_tokens`` — only the uncached tail is sized, allocated, and
computed.  Preemption releases page *references* (``free_seq`` decrements
refcounts); physical pages return to the free list — or are held by the
prefix cache — only when the last reference drops.

Admission policies:
  "reserve"    allocate worst-case pages (prompt + max_new, minus the
               cached prefix) up front; decode can never OOM the pool
               (throughput-conservative, vLLM-v0 style reservation).
               Shared-prefill ensemble members cannot position-map their
               tail pages until they fork off the leader's prompt pages,
               so their worst case is *promised* at admission (deferred
               credits the pool charges against every later allocation)
               and redeemed at fork/COW time.
  "on_demand"  allocate prompt pages (+1 token of headroom) only; pages are
               pulled from the free list as sequences grow.  Higher packing;
               when a pathological mix exhausts the pool mid-decode the
               engine *preempts* the youngest running sequence back to the
               head of the waiting queue (references released, KV recomputed
               on re-admission through the same chunked-prefill path)
               instead of dying — throughput degrades, the server survives.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serving.kv_cache import PagePool, chain_hashes


@dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""

    id: int
    prompt: np.ndarray                  # [len] int32 token ids
    max_new_tokens: int
    arrival_time: float = 0.0
    eos_id: Optional[int] = None
    submodel_id: int = 0                # which ModelBank circuit serves this
    group: Optional["EnsembleGroup"] = None   # set for ensemble members
    kv_namespace: bytes = b"dense"      # content-hash namespace: which
                                        # encoder produced this KV (engine
                                        # sets b"sub:g" for routed requests)
    mask_from: int = 0                  # first position the circuit masks
                                        # apply at (ensemble members share a
                                        # dense-encoded prompt context
                                        # [0, mask_from); solo requests: 0)
    slo_class: str = "default"          # SLO priority class (observability/
                                        # slo.py) the finished request is
                                        # scored under

    # runtime (engine/scheduler-owned)
    slot: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    prefill_pos: int = 0                # kv_tokens already written to pages
    admit_seq: int = -1                 # global admission order (preemption
                                        # evicts the youngest = max admit_seq)
    num_preemptions: int = 0
    num_cached_tokens: int = 0          # prefix-cache hit at last admission
    cache_eligible_tokens: int = 0      # tokens the lookup could have matched
    page_hashes: List[bytes] = field(default_factory=list)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    t_preempted: Optional[float] = None  # last preemption (engine clock)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def context_len(self) -> int:
        return self.prompt_len + len(self.out_tokens)

    @property
    def num_kv_tokens(self) -> int:
        """Tokens whose KV must be in pages before decode can proceed: the
        prompt plus every generated token except the last (whose KV is
        written by the decode step that consumes it)."""
        return self.prompt_len + max(0, len(self.out_tokens) - 1)

    @property
    def kv_tokens(self) -> np.ndarray:
        """The token stream chunked prefill feeds through the pool.  For a
        fresh request this is the prompt; after a preemption it also carries
        the already-generated tokens, so re-admission rebuilds the exact KV
        state the sequence had when evicted."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out_tokens[:-1], np.int32)])

    @property
    def publishable_end(self) -> int:
        """Tokens of ``kv_tokens`` whose pages may be content-indexed
        under ``kv_namespace``.  An ensemble member's stream is dense-
        encoded only up to ``mask_from`` (its masked tail is private to
        the member's circuit); a solo stream is uniformly encoded."""
        return self.mask_from if self.group is not None \
            else self.num_kv_tokens

    @property
    def match_cap(self) -> int:
        """Tokens a prefix-cache lookup may cover at admission.  A fresh
        request must recompute at least its last prompt token — the chunk
        that completes prefill yields the first sampled token; a preempted
        request's next token is already known, so its whole recompute
        stream is fair game (capped at the publishable region)."""
        if self.group is not None:
            return self.mask_from
        if self.out_tokens:
            return self.num_kv_tokens
        return self.prompt_len - 1

    @property
    def spec_eligible(self) -> bool:
        """May a draft circuit speculate for this request this tick?
        Decode-phase solo (or routed) requests only: ensemble members
        advance in lockstep through on-device logit combining, so a
        per-member draft tail would have to be accepted by the *combined*
        distribution — they decode one token per tick instead."""
        return self.group is None and not self.in_prefill

    @property
    def in_prefill(self) -> bool:
        """Still streaming prompt (or recomputed) KV into pages; a fresh
        request stays in prefill until its first token is sampled."""
        return self.prefill_pos < self.num_kv_tokens or not self.out_tokens

    @property
    def finished(self) -> bool:
        if self.out_tokens and self.eos_id is not None \
                and self.out_tokens[-1] == self.eos_id:
            return True
        return len(self.out_tokens) >= self.max_new_tokens


@dataclass
class EnsembleGroup:
    """One prompt fanned across every circuit of a ModelBank (paper §2's
    collective ensemble at inference): G member requests, one per submodel,
    advance in lockstep and share one combined token stream.

    Members are scheduled as an atomic unit — admitted together (slots +
    pages for every member, or none), preempted together, finished together.
    Per-step logits are combined *on device* inside the unified step
    (``combine``: mean of member logits, or a majority vote over member
    samples), so every member records the same token and their KV states
    stay consistent with the shared stream.

    The prompt *context* — attention K/V for positions [0, prompt_len - 1)
    — is encoded by the dense parent (circuit masks engage from
    ``mask_from`` = prompt_len - 1 onward: each member encodes the last
    prompt token and its decode tail through its own masked FFNs), so the
    context is byte-identical across members by construction.  With
    ``share`` set (engine prefix cache on) it is therefore computed ONCE:
    the leader prefills it, members fork the leader's prompt pages
    (refcount G) and only their per-member tails copy-on-write on
    divergence.  With ``share`` unset every member re-prefills the same
    bytes into private pages — the compatibility path the parity tests
    compare against."""

    id: int
    combine: str                        # "mean_logit" | "majority_vote"
    members: List[Request] = field(default_factory=list)
    share: bool = False                 # prefill the shared context once
    forked: bool = False                # members mapped the leader's pages

    @property
    def leader(self) -> Request:
        return self.members[0]

    @property
    def out_tokens(self) -> List[int]:
        return self.leader.out_tokens

    @property
    def finished(self) -> bool:
        return all(m.finished for m in self.members)


def _unit(req: Request) -> List[Request]:
    """The atomic scheduling unit ``req`` belongs to (its whole ensemble
    group, or just itself)."""
    return req.group.members if req.group is not None else [req]


def speculative_draft_len(k: int, budget: int, n_decode: int,
                          n_spec: int) -> int:
    """Uniform per-tick draft length for the tick's speculating slots.

    A speculating slot consumes ``1 + draft_len`` tokens of the tick's
    budget — the budget meters *parent* compute, so it counts the tokens
    the parent verifies (the pending token plus every draft), never the
    tokens the draft circuit generated to propose them.  Every decode slot
    (speculating or not) costs its one pending token first; whatever
    remains is split evenly across the speculating slots so the tick keeps
    a single verify window width.  Clamped to [0, k]; 0 degrades the tick
    to plain decode (budget exhausted by the decode batch itself)."""
    if n_spec <= 0 or k <= 0:
        return 0
    return max(0, min(k, (budget - n_decode) // n_spec))


@dataclass
class _AdmissionPlan:
    """Sized admission for one request of a unit."""
    req: Request
    cached: List[int]                   # prefix-cache pages to adopt
    cached_tokens: int
    fresh: int                          # pages to allocate now
    deferred: int                       # pages to promise (reserve members)
    hashes: List[bytes]                 # content ids for publish_prefix
    probed: int = 0                     # hashes the cache lookup walked over


class FCFSScheduler:
    """First-come-first-served admission into ``num_slots`` decode slots."""

    def __init__(self, num_slots: int, pool: PagePool, *,
                 policy: str = "reserve"):
        if policy not in ("reserve", "on_demand"):
            raise ValueError(policy)
        self.num_slots = num_slots
        self.pool = pool
        self.policy = policy
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}       # slot -> request
        self._free_slots = list(range(num_slots - 1, -1, -1))
        self._admit_counter = 0
        self.finished: List[Request] = []
        self.preemptions = 0

    # -- queue --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- admission sizing ----------------------------------------------------
    @staticmethod
    def _is_shared_member(req: Request) -> bool:
        """True for a non-leader member of a share-mode ensemble: it maps
        the leader's prompt pages at fork time instead of allocating its
        own."""
        g = req.group
        return g is not None and g.share and req is not g.leader

    def _worst_case_pages(self, req: Request) -> int:
        """Pages the policy wants covered for ``req`` ignoring cache hits.
        For a preempted request re-admitting, ``num_kv_tokens`` carries the
        grown context, so on_demand re-reserves everything its recomputed
        KV (+1 token of headroom) needs."""
        if self.policy == "reserve":
            return self.pool.pages_for(req.prompt_len + req.max_new_tokens)
        return self.pool.pages_for(req.num_kv_tokens + 1)

    def admission_pages(self, req: Request) -> int:
        """Pages the policy demands available before ``req`` may join,
        assuming no prefix-cache hit (the worst case — feasibility checks
        use this).  A shared-prefill ensemble member only ever owns its
        tail: the shared full prompt pages are the leader's."""
        need = self._worst_case_pages(req)
        if self._is_shared_member(req):
            need = max(0, need - req.mask_from // self.pool.page_size)
        return need

    def unit_admission_pages(self, unit: List[Request]) -> int:
        """Worst-case pages the whole scheduling unit needs available to
        admit (no cache hits)."""
        return sum(self.admission_pages(r) for r in unit)

    def _plan_admission(self, unit: List[Request]) -> List[_AdmissionPlan]:
        """Size every request of a unit against the pool's prefix cache:
        cached prompt pages are adopted, only the uncached tail is
        allocated fresh, and shared-prefill member tails are deferred
        (reserve) or grown lazily (on_demand).

        Lookups here are non-promoting *peeks*: a blocked FCFS head replans
        every tick, and counting each retry as a cache hit (or letting it
        refresh LRU recency) would keep stale pages hot and inflate the hit
        rate — stats are committed only when ``admit`` actually adopts the
        plan (the negative cache still short-circuits known-cold walks)."""
        plans = []
        P = self.pool.page_size
        for req in unit:
            if self._is_shared_member(req):
                deferred = self.admission_pages(req) \
                    if self.policy == "reserve" else 0
                plans.append(_AdmissionPlan(req, [], 0, 0, deferred, []))
                continue
            # the chain is deterministic per (namespace, stream prefix) and
            # streams only ever append, so reuse the hashes from a previous
            # attempt (a blocked FCFS head replans every tick) unless a
            # preemption grew the publishable region since
            hashes = req.page_hashes
            if len(hashes) != req.publishable_end // P:
                hashes = chain_hashes(
                    req.kv_namespace,
                    np.asarray(req.kv_tokens[:req.publishable_end],
                               np.int32), P)
                req.page_hashes = hashes
            cap = req.match_cap
            probe = hashes[:cap // P]
            cached = self.pool.match_pages(probe, peek=True) \
                if self.pool.cache is not None else []
            fresh = max(0, self._worst_case_pages(req) - len(cached))
            plans.append(_AdmissionPlan(req, cached, len(cached) * P,
                                        fresh, 0, hashes, len(probe)))
        return plans

    # -- lifecycle ----------------------------------------------------------
    def admit(self, now: float) -> List[Request]:
        """Move FCFS-head requests into free slots while the pool allows.
        Strict FCFS: if the head doesn't fit, nothing behind it jumps the
        queue (no head-of-line bypass — keeps latency ordering honest).
        Ensemble groups admit atomically: the whole unit needs a slot and
        pages for every member, or nothing moves."""
        admitted = []
        while self.waiting and self._free_slots:
            unit = _unit(self.waiting[0])
            if len(unit) > len(self._free_slots):
                break
            # group members sit contiguously at the queue head (submitted
            # together; preemption pushes the whole unit back together)
            assert all(self.waiting[i] is r for i, r in enumerate(unit)), \
                "ensemble members not contiguous at queue head"
            plans = self._plan_admission(unit)
            pinned = frozenset(p for pl in plans for p in pl.cached)
            need = sum(pl.fresh + pl.deferred for pl in plans)
            if not self.pool.can_alloc(need, pinned=pinned):
                break
            for pl in plans:
                req = pl.req
                self.waiting.popleft()
                req.slot = self._free_slots.pop()
                req.t_admitted = now
                req.admit_seq = self._admit_counter
                self._admit_counter += 1
                req.prefill_pos = pl.cached_tokens
                req.num_cached_tokens = pl.cached_tokens
                req.cache_eligible_tokens = \
                    0 if self._is_shared_member(req) else req.match_cap
                req.page_hashes = pl.hashes
                if pl.probed:      # adoption commits the peeked lookup
                    self.pool.commit_match(len(pl.cached),
                                           len(pl.cached) < pl.probed)
                self.pool.alloc_pages(req.id, pl.fresh,
                                      owner=req.submodel_id,
                                      cached=pl.cached, deferred=pl.deferred)
                self.running[req.slot] = req
                admitted.append(req)
        return admitted

    def fork_group(self, group: EnsembleGroup) -> int:
        """Map the leader's shared prompt pages — the dense-encoded context
        [0, mask_from) — into every other member's table (refcount + 1 per
        page; the trailing partial page copy-on-writes when the member's
        masked tail first touches it).  Members resume prefill at
        ``mask_from``: their masked last prompt token + decode tail is all
        they ever compute.  Returns prefill tokens saved vs. the
        re-prefill path."""
        leader = group.leader
        n_shared = self.pool.pages_for(leader.mask_from)
        shared = self.pool.table(leader.id)[:n_shared]
        saved = 0
        for m in group.members[1:]:
            self.pool.adopt_prefix(m.id, shared)
            m.prefill_pos = m.mask_from
            saved += m.mask_from
        group.forked = True
        return saved

    def preempt_youngest(self) -> Optional[Request]:
        """Evict the most recently admitted running scheduling unit (a solo
        sequence, or a whole ensemble group) back to the HEAD of the waiting
        queue: its page references are released (shared pages survive under
        their other holders; exclusive pages go back to the free list or
        the prefix cache) and its KV is recomputed on re-admission via
        chunked prefill.  Returns the victim (a group's leader), or None
        when fewer than two units run (evicting the sole survivor could
        never free pages for it — that is a genuine, unservable OOM the
        engine must surface)."""
        units: Dict[int, List[Request]] = {}      # keyed by leader id
        for req in self.running.values():
            units.setdefault(_unit(req)[0].id, _unit(req))
        if len(units) < 2:
            return None
        victims = max(units.values(),
                      key=lambda u: max(r.admit_seq for r in u))
        self.preemptions += 1
        # appendleft keeps FCFS order when several preemptions stack up in
        # one tick: younger victims are pushed first and end up behind the
        # older ones preempted after them; reversed() keeps a group's
        # members in member order at the head
        for victim in reversed(victims):
            del self.running[victim.slot]
            self._free_slots.append(victim.slot)
            self.pool.free_seq(victim.id)
            victim.slot = None
            victim.prefill_pos = 0
            victim.num_preemptions += 1
            self.waiting.appendleft(victim)
        if victims[0].group is not None:
            victims[0].group.forked = False
        return victims[0]

    def record_token(self, slot: int, token: int, now: float) -> None:
        req = self.running[slot]
        if not req.out_tokens:
            req.t_first_token = now
        req.out_tokens.append(token)

    def evict_finished(self, now: float) -> List[Request]:
        """Free slots + page references of every finished running request."""
        done = []
        for slot in sorted(self.running):
            req = self.running[slot]
            if req.finished:
                req.t_done = now
                del self.running[slot]
                self._free_slots.append(slot)
                self.pool.free_seq(req.id)
                req.slot = None
                done.append(req)
        self.finished.extend(done)
        return done
