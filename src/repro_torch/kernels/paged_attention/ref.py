"""Plain PyTorch versions of the paged-attention kernels.

Gathers the K/V pages named by each sequence's block table into a contiguous
[B, maxp * psize, KH, D] view and runs a masked softmax in f32: the same
math the CUDA kernel performs tile by tile in shared memory.  The wrappers
in ``ops.py`` run it for CPU tensors; tests and ``chip_smoke.py`` hold the
kernel against it.
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
    """int8 pool [P, psize, KH, D] + per-(page, kv-head) scale [P, KH] ->
    f32 pool; ``scale=None`` returns the pool as it is."""
    if scale is None:
        return pages
    return pages.to(f32) * scale[:, None, :, None]


def live_block_tables(block_tables, lengths, psize: int):
    """``block_tables`` with every entry past ``ceil(length / psize)`` set
    to the null page, so stale or garbage ids there are never indexed."""
    maxp = block_tables.shape[1]
    live = torch.arange(maxp, device=block_tables.device)[None, :] * psize \
        < lengths[:, None]
    return torch.where(live, block_tables, NULL_PAGE).long()


def paged_chunk_attention_ref(q, k_pages, v_pages, block_tables, starts,
                              chunk_lens, *, scale: float,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None):
    """Chunk-append attention over a block-paged KV pool.

    q:            [B, C, H, D]  a chunk of C tokens per sequence, right-padded
                  (token j of sequence b sits at absolute position
                  ``starts[b] + j``; rows with j >= chunk_lens[b] are padding)
    k/v_pages:    [P, psize, KH, D]  shared page pool.  The chunk's own K/V
                  must already be written (append-then-attend)
    block_tables: [B, maxp] int32    page ids per sequence
    starts:       [B] int32          KV tokens in pages *before* this chunk
    chunk_lens:   [B] int32          valid tokens in this chunk (0 = idle slot)
    Returns [B, C, H, D] in q's dtype; padding rows and idle slots are 0.
    """
    B, C, H, D = q.shape
    psize, KH = k_pages.shape[1], k_pages.shape[2]
    maxp = block_tables.shape[1]
    G = H // KH
    S = maxp * psize
    dev = q.device
    starts, chunk_lens = starts.long(), chunk_lens.long()
    lengths = starts + chunk_lens
    bt = live_block_tables(block_tables, lengths, psize)

    k = k_pages[bt].reshape(B, S, KH, D).to(f32)
    v = v_pages[bt].reshape(B, S, KH, D).to(f32)
    qg = q.reshape(B, C, KH, G, D).to(f32)

    s = torch.einsum("bchgd,bshd->bhgcs", qg, k) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kp = torch.arange(S, device=dev)[None, None, :]               # [1, 1, S]
    qpos = starts[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    masked = kp >= lengths[:, None, None]
    masked = masked | (kp > qpos[..., None])              # causal own-chunk
    if window is not None:
        masked = masked | (kp <= qpos[..., None] - window)
    mask = torch.where(masked, NEG_INF, 0.0).to(f32)
    s = s + mask[:, None, None]                           # [B, KH, G, C, S]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgcs,bshd->bchgd", p, v)
    # padding rows (j >= chunk_len) attend to the prior context too; zero
    # them, as the kernel does when it writes its output
    valid = torch.arange(C, device=dev)[None, :] < chunk_lens[:, None]
    out = torch.where(valid[:, :, None, None, None], out, 0.0)
    return out.reshape(B, C, H, D).to(q.dtype)
