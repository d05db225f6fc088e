"""Device-dispatched paged attention and the paged KV-pool appends.

``paged_attention`` (decode) and ``paged_chunk_attention`` take the plain
version for CPU tensors and their CUDA kernel for CUDA tensors; a CUDA
tensor launches the kernel or raises.  ``k_scale``/``v_scale`` ([P, KH]
f32) select the int8-pool mode of both.  The appends are plain tensor code
on either device, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import (
    NULL_PAGE, paged_attention_ref, paged_chunk_attention_ref)
from repro_torch.optim.compression import quantize_int8

__all__ = ["NULL_PAGE", "paged_attention", "paged_chunk_attention",
           "paged_pool_append", "paged_pool_append_quant"]

f32 = torch.float32


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: float, window: Optional[int] = None,
                    softcap: Optional[float] = None, k_scale=None,
                    v_scale=None):
    """[B, H, D] paged decode attention: one query token per slot over its
    ``lengths`` [B] KV tokens (the engine's decode-only ticks)."""
    kw = dict(scale=scale, window=window, softcap=softcap, k_scale=k_scale,
              v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths, **kw)
    if q.device.type == "cuda":
        return kernel.paged_attention(q, k_pages, v_pages, block_tables,
                                      lengths, **kw)
    raise ValueError(f"paged_attention: no version for {q.device}")


def paged_chunk_attention(q, k_pages, v_pages, block_tables, starts,
                          chunk_lens, *, scale: float,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None, k_scale=None,
                          v_scale=None, logit_index=None):
    """[B, C, H, D] chunk-append paged attention (the unified serving step:
    decode tokens are C == 1 chunks, prompt chunks are wider).  With
    ``logit_index`` [B, S_w] it returns ``(out, out_win [B, S_w, H, D])``,
    the chunk rows at those positions gathered in the kernel's epilogue."""
    kw = dict(scale=scale, window=window, softcap=softcap, k_scale=k_scale,
              v_scale=v_scale, logit_index=logit_index)
    if q.device.type == "cpu":
        return paged_chunk_attention_ref(
            q, k_pages, v_pages, block_tables, starts, chunk_lens, **kw)
    if q.device.type == "cuda":
        return kernel.paged_chunk_attention(
            q, k_pages, v_pages, block_tables, starts, chunk_lens, **kw)
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


def paged_pool_append_quant(pool, scale, new, block_tables, starts,
                            chunk_lens):
    """int8 variant of ``paged_pool_append``: quantize on append, in place.

    pool: [P, psize, KH, D] int8; scale: [P, KH] f32, one symmetric scale
    per (page, kv head) (``quantize_int8`` semantics); new: [B, C, KH, D].
    Each page that receives a valid token is gathered, dequantized, has the
    new tokens spliced in at f32 and is re-quantized whole with a fresh
    scale, so a page's scale always reflects its current contents.  Pages
    are bit-for-bit what the JAX ``ops.paged_pool_append_quant`` writes
    there.  Unlike it, no other page is rewritten: JAX also re-quantizes
    the pages of its fixed window that no token lands in (an idle row's
    first pages, the page after a chunk's end), which gives a page
    quantized before its own bytes back but a never-written page (scale 0)
    the floor scale 1e-12 (ROADMAP section 3).  Padding tokens are spliced
    into a spare page that is thrown away, and the windows' unwritten
    entries write the null page, which no one reads as live data.
    Returns (pool, scale).
    """
    _, psize, KH, D = pool.shape
    B, C = new.shape[:2]
    maxp = block_tables.shape[1]
    dev = pool.device
    starts, chunk_lens = starts.long(), chunk_lens.long()
    # pages a row's chunk can touch: the page holding ``start`` plus every
    # page the C tokens can spill into
    T = (C + psize - 1) // psize + 1
    p0 = starts // psize                                        # [B]
    prel = p0[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    written = (prel * psize < (starts + chunk_lens)[:, None]) \
        & (chunk_lens[:, None] > 0) & (prel < maxp)
    pages = torch.gather(block_tables.long(), 1, prel.clamp(0, maxp - 1))
    pages = torch.where(written, pages, NULL_PAGE)              # [B, T]
    got = pool[pages].to(f32) * scale[pages][:, :, None, :, None]
    got = torch.cat([got, got.new_zeros(B, 1, psize, KH, D)], 1)  # + spare
    # splice the chunk's tokens into the gathered pages at f32
    j = torch.arange(C, device=dev)[None, :]
    pos = starts[:, None] + j                                   # [B, C]
    t = torch.where(j < chunk_lens[:, None], pos // psize - p0[:, None], T)
    b_ix = torch.arange(B, device=dev)[:, None].expand(B, C)
    got[b_ix.reshape(-1), t.reshape(-1), (pos % psize).reshape(-1)] = \
        new.reshape(B * C, KH, D).to(f32)
    q, nsc = quantize_int8(got[:, :T], axis=(2, 4))            # [B,T,1,KH,1]
    pool[pages.reshape(-1)] = q.reshape(-1, psize, KH, D)
    scale[pages.reshape(-1)] = nsc.reshape(-1, KH)
    return pool, scale
