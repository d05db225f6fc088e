"""Speculative decoding: a materialized Horn circuit drafts, the parent
verifies.

The port of ``repro/serving/speculative.py``.  Each engine tick, every
speculating decode slot runs the draft circuit for up to K tokens (one
draft call a tick, batched across slots: a catch-up chunk, then K - 1
single-token paged steps), and the parent then verifies the K + 1
positions inside the one budgeted call every other slot shares: a verify
chunk is a (K + 1)-token chunk whose window of logits is scored against
the drafts.  K sequential parent ticks collapse into one.

The draft's K/V lives in a private page pool and paged cache, not the
parent's: the circuit's K/V bytes differ from the parent's for the same
tokens (other FFN units feed the residual stream), so pages are never
shared between the two, and a draft page never answers a parent prefix-
cache lookup.  The pool is sized never to run out (``num_slots``
sequences of at most ``max_model_len + K`` tokens): draft state is a pure
function of a request's committed stream, rebuilt by the catch-up chunk
after a preemption, so it needs none of the parent pool's preemption or
copy-on-write machinery.

Rollback is a release of references: when the parent rejects a draft
tail, ``commit`` (and the engine, for the parent's pages) truncates the
page tables back to the accepted prefix.  Stale K/V beyond it is
overwritten by the next write at those positions and never read
(attention masks keys past each slot's length).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import steps as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of
from repro_torch.models.params import cast_params
from repro_torch.serving.block_table import (BlockTableMirror, marshal_i32,
                                             pow2_bucket)
from repro_torch.serving.kv_cache import PagePool
from repro_torch.serving.model_bank import DraftModel
from repro_torch.serving.scheduler import Request


class DraftRunner:
    """Host-side orchestration of the draft circuit's speculative state:
    one private page pool and paged cache on ``device``, a draft position
    per request (committed tokens whose K/V the draft has written), and
    one draft step per draft length in use.  The draft's parameters are
    cast to the engine's compute dtype once, here."""

    def __init__(self, draft: DraftModel, ecfg, device):
        wrong = {str(p.device) for p in draft.params.parameters()
                 if p.device != device}
        if wrong:
            raise ValueError(f"draft params live on {sorted(wrong)}, the "
                             f"engine on {device}")
        self.draft = draft
        self.ecfg = ecfg
        self.device = device
        B = ecfg.num_slots
        self.k_max = ecfg.speculate_k
        psize = ecfg.page_size
        # worst case a slot: a full context plus the drafted tail
        max_tokens = ecfg.max_model_len + self.k_max
        self.max_pages_per_seq = -(-max_tokens // psize)
        self.pool = PagePool(B * self.max_pages_per_seq + 1, psize)
        self.params = cast_params(draft.params, dtype_of(ecfg.compute_dtype))
        self.cache = T.init_paged_cache(draft.cfg, self.pool.num_pages,
                                        psize, dtype=dtype_of(ecfg.kv_dtype),
                                        device=device)
        self._steps: Dict[int, object] = {}      # draft length -> step
        self._pos: Dict[int, int] = {}           # req id -> draft K/V tokens
        self._pending: Dict[int, Tuple[int, int]] = {}  # req id -> (n, k)
        self._bt = BlockTableMirror(B, self.max_pages_per_seq, device)
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero the call counters: ``draft_calls``, the draft's paged steps
        (``paged_steps``, k a call) and those at C == 1, which run the
        decode kernel (``decode_steps``: the k - 1 proposal steps, and the
        catch-up when its bucket is 1)."""
        self.draft_calls = self.paged_steps = self.decode_steps = 0

    def _step_for(self, k: int):
        if k not in self._steps:
            self._steps[k] = S.make_draft_spec_step(
                self.draft.cfg, k=k, temperature=self.ecfg.temperature)
        return self._steps[k]

    def _catch_up_chunk(self, req: Request) -> np.ndarray:
        """The committed tokens the draft has not written K/V for:
        stream[pos, context_len) of prompt + out_tokens, sliced without
        rebuilding the whole stream (steady decode needs 1-2 tokens off
        the tail of out_tokens)."""
        lo, plen = self._pos[req.id], req.prompt_len
        tail = np.asarray(req.out_tokens[max(0, lo - plen):], np.int32)
        if lo >= plen:
            return tail
        return np.concatenate([req.prompt[lo:], tail]) if len(tail) \
            else req.prompt[lo:]

    # -- per-tick API --------------------------------------------------------
    def propose(self, units: List[Tuple[int, Request]], k: int, root_key
                ) -> Tuple[np.ndarray, torch.Tensor]:
        """Draft ``k`` tokens for every (slot, request) of ``units`` in one
        draft call.  Returns (drafts [B, k] host int32, draft_probs [B, k,
        Vq] device f32: the rejection sampler's q, a width-1 dummy when
        greedy).  Rows of slots not in ``units`` are garbage the verify
        masks out (draft_lens 0)."""
        B = self.ecfg.num_slots
        planned: Dict[int, Tuple[Request, np.ndarray]] = {}
        width = 1
        for slot, req in units:
            if req.id not in self._pos:
                self.pool.alloc_pages(req.id, 0, owner="draft")
                self._pos[req.id] = 0
            # d_k's K/V is written by the NEXT catch-up, like the engine's
            # pending token: hence context_len + k - 1
            self.pool.ensure(req.id, req.context_len + k - 1)
            chunk = self._catch_up_chunk(req)
            planned[slot] = (req, chunk)
            width = max(width, len(chunk))
        C = pow2_bucket(width)
        tokens = np.zeros((B, C), np.int32)
        starts = np.zeros((B,), np.int32)
        lens = np.zeros((B,), np.int32)
        req_ids = np.zeros((B,), np.int32)
        steps = np.zeros((B,), np.int32)
        for slot, (req, chunk) in planned.items():
            tokens[slot, :len(chunk)] = chunk
            starts[slot] = self._pos[req.id]
            lens[slot] = len(chunk)
            req_ids[slot] = req.id
            steps[slot] = len(req.out_tokens)
        # only this tick's drafters are active: the row of a slot that
        # does not draft is synced to the null page.  The state key folds
        # in admit_seq as the engine's does: table versions restart on
        # free and realloc, so (id, version) alone could repeat across a
        # preempt / re-admit cycle and keep a stale row.
        self._bt.sync(self.pool, {s: r for s, (r, _) in planned.items()},
                      lambda r: (r.id, r.admit_seq,
                                 self.pool.table_version(r.id)))
        (d_tokens, d_starts, d_lens, d_req_ids, d_steps) = marshal_i32(
            self.device, tokens, starts, lens, req_ids, steps)
        drafts, probs = self._step_for(k)(
            self.params, self.cache, d_tokens, d_starts, d_lens,
            self._bt.dev, d_req_ids, d_steps, root_key)
        self.draft_calls += 1
        self.paged_steps += k
        self.decode_steps += k - 1 + (C == 1)
        for slot, (req, _) in planned.items():
            self._pending[req.id] = (req.context_len, k)
            self._pos[req.id] = req.context_len + k - 1
        # deliberate: the engine edits the drafts into the verify chunks
        # on the host, so the proposal is pulled here
        return drafts.cpu().numpy(), probs       # hornlint: sync-ok

    def commit(self, req: Request, accepted: int) -> None:
        """The verify's verdict on ``req``'s last proposal: keep the
        accepted drafts' K/V and release the rejected tail's pages (stale
        K/V inside the boundary page is overwritten by the next catch-up
        at those positions)."""
        n, k = self._pending.pop(req.id)
        self._pos[req.id] = min(n + accepted, n + k - 1)
        self.pool.truncate_seq(req.id, self._pos[req.id])

    def drop(self, req_id: int) -> None:
        """Forget a request (finished, preempted or aborted): draft state
        is rebuilt from the committed stream, so a preempted request pays
        one catch-up chunk on re-admission, and the pool never holds more
        than ``num_slots`` live draft sequences."""
        if req_id in self._pos:
            self.pool.free_seq(req_id)
            del self._pos[req_id]
            self._pending.pop(req_id, None)

    def stats(self) -> dict:
        """Draft-side numbers (acceptance lives on the engine's stats)."""
        return {
            "draft_calls": self.draft_calls,
            "paged_steps": self.paged_steps,
            "decode_steps": self.decode_steps,
            "live_seqs": len(self._pos),
            "pool_utilization": self.pool.utilization(),
        }
