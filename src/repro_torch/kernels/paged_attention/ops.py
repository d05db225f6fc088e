"""Device-dispatched paged attention and the paged KV-pool append.

``paged_chunk_attention`` takes the plain version for CPU tensors and the
CUDA kernel for CUDA tensors; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import (
    NULL_PAGE, paged_chunk_attention_ref)

__all__ = ["NULL_PAGE", "paged_chunk_attention", "paged_pool_append"]


def paged_chunk_attention(q, k_pages, v_pages, block_tables, starts,
                          chunk_lens, *, scale: float,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None):
    """[B, C, H, D] chunk-append paged attention (the unified serving step:
    decode tokens are C == 1 chunks, prompt chunks are wider)."""
    if q.device.type == "cpu":
        return paged_chunk_attention_ref(
            q, k_pages, v_pages, block_tables, starts, chunk_lens,
            scale=scale, window=window, softcap=softcap)
    if q.device.type == "cuda":
        return kernel.paged_chunk_attention(
            q, k_pages, v_pages, block_tables, starts, chunk_lens,
            scale=scale, window=window, softcap=softcap)
    raise ValueError(f"paged_chunk_attention: no version for {q.device}")


def paged_pool_append(pool, new, block_tables, starts, chunk_lens):
    """Scatter each sequence's C-token chunk into its pages, in place.

    pool: [P, psize, KH, D]; new: [B, C, KH, D]; block_tables: [B, maxp];
    starts: [B] absolute position of each chunk's first token; chunk_lens:
    [B] valid tokens per chunk.  Padding tokens (j >= chunk_len) are routed
    to the null page, so a partly filled chunk never writes beyond the
    sequence's pages; several of them may land on the same null-page slot,
    which no one reads as live data.  Returns ``pool``.
    """
    B, C = new.shape[:2]
    psize, maxp = pool.shape[1], block_tables.shape[1]
    j = torch.arange(C, device=pool.device)[None, :]
    pos = starts.long()[:, None] + j                            # [B, C]
    pidx = (pos // psize).clamp(0, maxp - 1)
    page = torch.gather(block_tables.long(), 1, pidx)
    page = torch.where(j < chunk_lens.long()[:, None], page, NULL_PAGE)
    slot = pos % psize
    pool[page.reshape(-1), slot.reshape(-1)] = \
        new.reshape((B * C,) + tuple(new.shape[2:])).to(pool.dtype)
    return pool
