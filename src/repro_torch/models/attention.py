"""GQA attention: the non-paged self-attention branch (training) and the
paged serving branch.

``attn_apply`` ports two branches of ``repro.models.attention.attn_apply``.
Both project q/k/v (qkv bias, qk-norm, RoPE).  With ``cache=None`` (train):
transpose to [B, H, S, D], run ``flash_attention`` (the CUDA forward and
backward kernels on a card, the plain version on the CPU) and transpose
back.  With a page-pool ``cache`` (the unified serving step): append the
chunk's K/V to the pools in place and run ``paged_chunk_attention``.  Then
the optional Horn head mask and the out-projection.
"""
from __future__ import annotations

from torch import nn

from repro_torch.configs.base import LOCAL, ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
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


def attn_apply(params, x, cfg: ModelConfig, *, kind: str, positions,
               cache=None, cache_index=None, block_tables=None,
               chunk_lens=None, head_mask=None):
    """Attention sublayer for one layer; returns [B, S, d] in x.dtype.

    Train (``cache is None``): x [B, S, d] attends to itself, ``positions``
    [1, S].  Paged step: x [B, C, d] chunk activations; ``cache`` is this
    layer's (k_pages, v_pages) [P, psize, KH, D] pair, written in place;
    ``cache_index`` [B] counts KV tokens already in pages per slot and
    ``chunk_lens`` [B] the valid tokens of each slot's chunk (decode slots
    1, prompt chunks up to C, idle slots 0).  ``head_mask`` ([B, 1, H, 1]
    or None) is Horn's per-group head dropout."""
    window = cfg.sliding_window if kind == LOCAL else None
    theta = 10_000.0 if (kind == LOCAL and cfg.rope_theta > 1e5) \
        else cfg.rope_theta
    # gemma2 scales queries by query_pre_attn_scalar instead of head_dim
    scale = cfg.query_scale if cfg.query_scale else cfg.head_dim ** -0.5
    q, k, v = _project_qkv(params, x, cfg, positions,
                           use_rope=cfg.use_rope, rope_theta=theta)
    if cache is None:
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale, causal=True, window=window,
            softcap=cfg.attn_logit_softcap).transpose(1, 2)
    else:
        k_pages, v_pages = cache
        paged_pool_append(k_pages, k, block_tables, cache_index, chunk_lens)
        paged_pool_append(v_pages, v, block_tables, cache_index, chunk_lens)
        out = paged_chunk_attention(
            q.contiguous(), k_pages, v_pages, block_tables, cache_index,
            chunk_lens, scale=scale, window=window,
            softcap=cfg.attn_logit_softcap)
    if head_mask is not None:
        out = out * head_mask.to(out.dtype)
    return mm("bshk,hkd->bsd", out, params.wo, x.dtype)
