"""GQA attention, paged serving path.

``attn_apply`` is the paged branch of ``repro.models.attention.attn_apply``:
project q/k/v (qkv bias, qk-norm, RoPE), append the chunk's K/V to the page
pools in place, run ``paged_chunk_attention`` (the CUDA kernel on a card,
the plain version on the CPU) and project back.
"""
from __future__ import annotations

from torch import nn

from repro_torch.configs.base import LOCAL, ModelConfig
from repro_torch.kernels.paged_attention.ops import (paged_chunk_attention,
                                                     paged_pool_append)
from repro_torch.models.layers import Norm, apply_rope, mm, norm_apply


class Attention(nn.Module):
    """``wq [d, H, hd]``, ``wk``/``wv [d, KH, hd]``, ``wo [H, hd, d]``,
    optional ``bq``/``bk``/``bv`` and ``q_norm``/``k_norm``."""

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim)
        self.wq = make((d, h, hd))
        self.wk = make((d, kv, hd))
        self.wv = make((d, kv, hd))
        self.wo = make((h, hd, d))
        if cfg.qkv_bias:
            self.bq = make((h, hd), "zeros")
            self.bk = make((kv, hd), "zeros")
            self.bv = make((kv, hd), "zeros")
        if cfg.qk_norm:
            self.q_norm = Norm(cfg, hd, make)
            self.k_norm = Norm(cfg, hd, make)


def _project_qkv(params, x, cfg: ModelConfig, positions, *, use_rope: bool,
                 rope_theta: float):
    q = mm("bsd,dhk->bshk", x, params.wq)
    k = mm("bsd,dhk->bshk", x, params.wk)
    v = mm("bsd,dhk->bshk", x, params.wv)
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    if cfg.qk_norm:
        q = norm_apply(params.q_norm, q, cfg)
        k = norm_apply(params.k_norm, k, cfg)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attn_apply(params, x, cfg: ModelConfig, *, kind: str, positions, cache,
               cache_index, block_tables, chunk_lens):
    """Unified paged step for one layer.  x: [B, C, d] chunk activations;
    ``cache`` is this layer's (k_pages, v_pages) [P, psize, KH, D] pair,
    written in place; ``cache_index`` [B] counts KV tokens already in pages
    per slot and ``chunk_lens`` [B] the valid tokens of each slot's chunk
    (decode slots 1, prompt chunks up to C, idle slots 0).  Returns
    [B, C, d] in x.dtype."""
    window = cfg.sliding_window if kind == LOCAL else None
    theta = 10_000.0 if (kind == LOCAL and cfg.rope_theta > 1e5) \
        else cfg.rope_theta
    # gemma2 scales queries by query_pre_attn_scalar instead of head_dim
    scale = cfg.query_scale if cfg.query_scale else cfg.head_dim ** -0.5
    k_pages, v_pages = cache
    q, k_new, v_new = _project_qkv(params, x, cfg, positions,
                                   use_rope=cfg.use_rope, rope_theta=theta)
    paged_pool_append(k_pages, k_new, block_tables, cache_index, chunk_lens)
    paged_pool_append(v_pages, v_new, block_tables, cache_index, chunk_lens)
    out = paged_chunk_attention(
        q.contiguous(), k_pages, v_pages, block_tables, cache_index,
        chunk_lens, scale=scale, window=window, softcap=cfg.attn_logit_softcap)
    return mm("bshk,hkd->bsd", out, params.wo, x.dtype)
