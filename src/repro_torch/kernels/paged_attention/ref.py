"""Plain PyTorch versions of the paged-attention kernels.

Gathers the K/V pages named by each sequence's block table into a contiguous
[B, maxp * psize, KH, D] view (int8 pages dequantized by their
per-(page, kv head) scale right after the gather) and runs a masked softmax
in f32: the same math the CUDA kernels perform tile by tile in shared
memory.  Two entry points, sharing one softmax:

  paged_attention_ref        one query token per sequence (decode)
  paged_chunk_attention_ref  a C-token chunk per sequence (the unified
                             serving step)

The wrappers in ``ops.py`` run them for CPU tensors; tests and
``chip_smoke.py`` hold the kernels against them.  Two more plain versions
spell out the arithmetic of the kernels' designs, for the tests only:

  paged_attention_split_ref        the decode kernel's split of each
                                   slot's live pages over several blocks
                                   and their log-sum-exp merge
  paged_chunk_attention_int8_ref   the tensor-core chunk kernel on int8
                                   pools: the int8 values as they are, the
                                   scales on the columns of S and of P
"""
from __future__ import annotations

from typing import Optional

import torch

f32 = torch.float32
NEG_INF = -1e30

# The pool reserves page 0 as the null page: vacated block-table rows, the
# padding tokens of a chunk and dead block-table entries all route there.
NULL_PAGE = 0


def dequantize_pages(pages, scale):
    """int8 pages [..., psize, KH, D] + per-(page, kv-head) scale [..., KH]
    -> f32 pages; ``scale=None`` returns the pages as they are."""
    if scale is None:
        return pages
    return pages.to(f32) * scale[..., None, :, None]


def live_block_tables(block_tables, lengths, psize: int):
    """``block_tables`` with every entry past ``ceil(length / psize)`` set
    to the null page, so stale or garbage ids there are never indexed."""
    maxp = block_tables.shape[1]
    live = torch.arange(maxp, device=block_tables.device)[None, :] * psize \
        < lengths[:, None]
    return torch.where(live, block_tables, NULL_PAGE).long()


def _gather(pages, scale, bt):
    """[B, maxp * psize, KH, D] f32 keys or values of the pages ``bt``."""
    B, maxp = bt.shape
    x = dequantize_pages(pages[bt], None if scale is None else scale[bt])
    return x.reshape(B, maxp * pages.shape[1], *pages.shape[2:]).to(f32)


def _attend(qg, k, v, masked, *, scale: float, softcap):
    """qg [B, C, KH, G, D], k/v [B, S, KH, D] in f32, masked [B, C, S] ->
    softmax(q k^T) v [B, C, KH, G, D] over the unmasked keys."""
    s = torch.einsum("bchgd,bshd->bhgcs", qg, k) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = torch.where(masked, NEG_INF, 0.0).to(f32)
    s = s + mask[:, None, None]                           # [B, KH, G, C, S]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgcs,bshd->bchgd", p, v)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale: float, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        k_scale=None, v_scale=None):
    """Single-token decode attention over a block-paged KV pool.

    q:            [B, H, D]   one query token per sequence
    k/v_pages:    [P, psize, KH, D]  shared page pool (page 0 = null page),
                  q's dtype, or int8 with ``k_scale``/``v_scale``
    block_tables: [B, maxp] int32    page ids per sequence
    lengths:      [B] int32          valid KV tokens per sequence, the
                                     token just written at length - 1
    k/v_scale:    [P, KH] f32        int8-pool mode
    Returns [B, H, D] in q's dtype; a slot of length 0 emits zeros.

    The same function as ``paged_chunk_attention_ref`` at C == 1 with
    ``starts = lengths - 1`` and ``chunk_lens = 1``, and on the CPU the
    same bits: both run ``_attend`` on identical masks.
    """
    B, H, D = q.shape
    psize, KH = k_pages.shape[1], k_pages.shape[2]
    S = block_tables.shape[1] * psize
    lengths = lengths.long()
    bt = live_block_tables(block_tables, lengths, psize)
    k, v = _gather(k_pages, k_scale, bt), _gather(v_pages, v_scale, bt)
    qg = q.reshape(B, 1, KH, H // KH, D).to(f32)
    kp = torch.arange(S, device=q.device)[None, None, :]          # [1, 1, S]
    last = (lengths - 1)[:, None, None]
    masked = kp >= lengths[:, None, None]
    if window is not None:
        masked = masked | (kp <= last - window)
    out = _attend(qg, k, v, masked, scale=scale, softcap=softcap)
    # an empty slot's row is all masked: softmax would average garbage
    out = torch.where((lengths > 0)[:, None, None, None, None], out, 0.0)
    return out.reshape(B, H, D).to(q.dtype)


def paged_chunk_attention_ref(q, k_pages, v_pages, block_tables, starts,
                              chunk_lens, *, scale: float,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              k_scale=None, v_scale=None, logit_index=None):
    """Chunk-append attention over a block-paged KV pool.

    q:            [B, C, H, D]  a chunk of C tokens per sequence, right-padded
                  (token j of sequence b sits at absolute position
                  ``starts[b] + j``; rows with j >= chunk_lens[b] are padding)
    k/v_pages:    [P, psize, KH, D]  shared page pool, q's dtype or int8.
                  The chunk's own K/V must already be written
                  (append-then-attend)
    block_tables: [B, maxp] int32    page ids per sequence
    starts:       [B] int32          KV tokens in pages *before* this chunk
    chunk_lens:   [B] int32          valid tokens in this chunk (0 = idle slot)
    k/v_scale:    [P, KH] f32        int8-pool mode
    logit_index:  [B, S_w] int       optional: chunk positions in [0, C);
                  the return is then (out, out_win [B, S_w, H, D]) with
                  out_win[b, s] = out[b, logit_index[b, s]] (the TPU
                  kernel's fused verify window)
    Returns [B, C, H, D] in q's dtype; padding rows and idle slots are 0.
    """
    B, C, H, D = q.shape
    psize, KH = k_pages.shape[1], k_pages.shape[2]
    S = block_tables.shape[1] * psize
    dev = q.device
    starts, chunk_lens = starts.long(), chunk_lens.long()
    lengths = starts + chunk_lens
    bt = live_block_tables(block_tables, lengths, psize)
    k, v = _gather(k_pages, k_scale, bt), _gather(v_pages, v_scale, bt)
    qg = q.reshape(B, C, KH, H // KH, D).to(f32)
    kp = torch.arange(S, device=dev)[None, None, :]               # [1, 1, S]
    qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    masked = kp >= lengths[:, None, None]
    masked = masked | (kp > qpos[..., None])              # causal own-chunk
    if window is not None:
        masked = masked | (kp <= qpos[..., None] - window)
    out = _attend(qg, k, v, masked, scale=scale, softcap=softcap)
    # padding rows (j >= chunk_len) attend to the prior context too; zero
    # them, as the kernel does when it writes its output
    valid = torch.arange(C, device=dev)[None, :] < chunk_lens[:, None]
    out = torch.where(valid[:, :, None, None, None], out, 0.0)
    out = out.reshape(B, C, H, D).to(q.dtype)
    if logit_index is None:
        return out
    idx = logit_index.long()
    if idx.dim() != 2 or idx.shape[0] != B or bool(
            ((idx < 0) | (idx >= C)).any()):
        raise ValueError(f"paged_chunk_attention: logit_index must be [B, "
                         f"S_w] chunk positions in [0, {C}) with B = {B}")
    win = torch.gather(out, 1, idx[:, :, None, None].expand(-1, -1, H, D))
    return out, win


def decode_split_ranges(lengths, psize: int, num_splits: int,
                        window: Optional[int] = None):
    """[B, NS] first and end key (exclusive) of each split of the decode
    kernel: the live pages [first visible page, ceil(length / psize)) cut
    into ``num_splits`` ranges of floor(j * npages / NS) pages, each range
    cut to the visible keys.  An empty range has end <= first."""
    lengths = lengths.long()
    k_lo = (lengths - window).clamp(min=0) if window else \
        torch.zeros_like(lengths)
    p_lo = k_lo // psize
    npg = torch.where(lengths > 0, (lengths + psize - 1) // psize - p_lo, 0)
    j = torch.arange(num_splits, device=lengths.device)[None, :]
    pa = p_lo[:, None] + j * npg[:, None] // num_splits
    pb = p_lo[:, None] + (j + 1) * npg[:, None] // num_splits
    first = torch.maximum(k_lo[:, None], pa * psize)
    end = torch.minimum(lengths[:, None], pb * psize)
    return first, end


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths, *,
                              scale: float, num_splits: int,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              k_scale=None, v_scale=None):
    """``paged_attention_ref`` computed as the decode kernel computes it:
    each split's keys (``decode_split_ranges``) give a partial state (the
    max m, the sum l of exp(s - m) and the accumulator of exp(s - m) v, in
    f32), and the partials merge by log-sum-exp: M = max m_j, O = sum_j
    acc_j exp(m_j - M) / sum_j l_j exp(m_j - M).  An empty split has m =
    -inf and drops out; a slot with no visible key gets zeros."""
    B, H, D = q.shape
    psize, KH = k_pages.shape[1], k_pages.shape[2]
    S = block_tables.shape[1] * psize
    bt = live_block_tables(block_tables, lengths.long(), psize)
    k, v = _gather(k_pages, k_scale, bt), _gather(v_pages, v_scale, bt)
    qg = q.reshape(B, KH, H // KH, D).to(f32)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    first, end = decode_split_ranges(lengths, psize, num_splits, window)
    kp = torch.arange(S, device=q.device)[None, None, :]
    # [B, NS, S]: key kp belongs to split j
    member = (kp >= first[..., None]) & (kp < end[..., None])
    sj = torch.where(member[:, None, None], s[:, :, :, None, :],
                     -torch.inf)                       # [B, KH, G, NS, S]
    m = sj.amax(dim=-1)                                # -inf when empty
    live = m > -torch.inf
    p = torch.exp(sj - torch.where(live, m, 0.0)[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgjs,bshd->bhgjd", p, v)
    M = m.amax(dim=-1, keepdim=True)
    f = torch.where(live, torch.exp(m - torch.where(M > -torch.inf, M, 0.0)),
                    0.0)
    num = (acc * f[..., None]).sum(dim=-2)
    den = (l * f).sum(dim=-1)
    out = torch.where(den[..., None] > 0, num / den.clamp(min=1e-30)[
        ..., None], 0.0)
    return out.reshape(B, H, D).to(q.dtype)


def paged_chunk_attention_int8_ref(q, k_pages, v_pages, block_tables,
                                   starts, chunk_lens, *, scale: float,
                                   k_scale, v_scale,
                                   window: Optional[int] = None,
                                   softcap: Optional[float] = None,
                                   logit_index=None):
    """``paged_chunk_attention_ref`` on int8 pools, computed as the
    tensor-core kernel computes it: K and V stay the int8 integers (exact
    in bf16 and f32); S = q . k_int is multiplied column by column by the
    K scale of the key's page before the softcap and the mask; the row sum
    l adds the unscaled P = exp(S - m); and the copy of P that meets V is
    multiplied by the V scale of the key's page: O = sum_j P_j vs_j
    v_int_j / l."""
    B, C, H, D = q.shape
    psize, KH = k_pages.shape[1], k_pages.shape[2]
    S = block_tables.shape[1] * psize
    dev = q.device
    starts, chunk_lens = starts.long(), chunk_lens.long()
    lengths = starts + chunk_lens
    bt = live_block_tables(block_tables, lengths, psize)
    k, v = _gather(k_pages, None, bt), _gather(v_pages, None, bt)
    # [B, S, KH] the scale of each key's page
    ks = k_scale[bt].repeat_interleave(psize, dim=1)
    vs = v_scale[bt].repeat_interleave(psize, dim=1)
    qg = q.reshape(B, C, KH, H // KH, D).to(f32)
    s = torch.einsum("bchgd,bshd->bhgcs", qg, k)
    s = s * ks.permute(0, 2, 1)[:, :, None, None, :] * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kp = torch.arange(S, device=dev)[None, None, :]
    qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]
    masked = (kp >= lengths[:, None, None]) | (kp > qpos[..., None])
    if window is not None:
        masked = masked | (kp <= qpos[..., None] - window)
    s = torch.where(masked[:, None, None], -torch.inf, s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m > -torch.inf, m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    pv = p * vs.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bhgcs,bshd->bchgd", pv, v) / \
        l.clamp(min=1e-30).permute(0, 3, 1, 2, 4)
    valid = torch.arange(C, device=dev)[None, :] < chunk_lens[:, None]
    o = torch.where(valid[:, :, None, None, None], o, 0.0)
    out = o.reshape(B, C, H, D).to(q.dtype)
    if logit_index is None:
        return out
    idx = logit_index.long()
    win = torch.gather(out, 1, idx[:, :, None, None].expand(-1, -1, H, D))
    return out, win
