"""GQA attention: the non-paged self-attention branch (train and
prefill), the dense-cache decode branch and the paged serving branch.

``attn_apply`` ports three branches of
``repro.models.attention.attn_apply``.  All project q/k/v (qkv bias,
qk-norm, RoPE).  With ``cache=None`` (train, prefill): transpose to
[B, H, S, D], run ``flash_attention`` (the CUDA forward and backward
kernels on a card, the plain version on the CPU) and transpose back; the
new K/V are returned for a prefill cache.  With a dense ``(k_buf, v_buf)``
cache and a scalar ``cache_index`` (one-token decode): write the token's
K/V into the buffers in place (``cache_update``) and run
``decode_attention``, one masked softmax over the whole buffer.  With a
page-pool ``cache`` and ``block_tables`` (the unified serving step):
append the chunk's K/V to the pools in place (``paged_pool_append``, or
``paged_pool_append_quant`` for int8 pools, whose cache is the 4-tuple
``(k_pages, v_pages, k_scale, v_scale)``), then run ``paged_attention``
when the tick's chunk width is 1 (a decode-only tick) and
``paged_chunk_attention`` otherwise; both are CUDA kernels on a card.
Then the optional Horn head mask and the out-projection.

``causal=False`` runs the non-paged branch without the causal mask (an
encoder's self-attention).  Cross-attention (``kv_x``, the encoder
output) projects k/v from ``kv_x`` without RoPE and runs one
plain masked softmax over all of it (``decode_attention``) in every mode,
with no cache and never through flash, as the JAX package sends it to its
plain path.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import LOCAL, ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import (
    paged_attention, paged_chunk_attention, paged_pool_append,
    paged_pool_append_quant)
from repro_torch.models.layers import Norm, apply_rope, mm, norm_apply

f32 = torch.float32
NEG_INF = -1e30


def paged_decode_lengths(cache_index, chunk_lens):
    """Keys each slot attends to in a C == 1 paged step: its cached tokens
    plus its new one, and none for an idle slot (``chunk_lens`` 0), which
    then emits zeros as ``paged_chunk_attention`` does."""
    return torch.where(chunk_lens > 0, cache_index + chunk_lens, 0)


class Attention(nn.Module):
    """``wq [d, H, hd]``, ``wk``/``wv [d, KH, hd]``, ``wo [H, hd, d]``,
    optional ``bq``/``bk``/``bv`` and ``q_norm``/``k_norm`` (never on a
    ``cross`` attention)."""

    AXES = {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "kv_head_dim"),
            "wv": ("embed", "kv_heads", "kv_head_dim"),
            "wo": ("heads", "head_dim", "embed"),
            "bq": ("heads", "head_dim"),
            "bk": ("kv_heads", "kv_head_dim"),
            "bv": ("kv_heads", "kv_head_dim")}

    def __init__(self, cfg: ModelConfig, make, *, cross: bool = False):
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
        if cfg.qk_norm and not cross:
            self.q_norm = Norm(cfg, hd, make)
            self.k_norm = Norm(cfg, hd, make)


def _project_qkv(params, x, kv_x, cfg: ModelConfig, positions, *,
                 use_rope: bool, rope_theta: float):
    """q from ``x``, k and v from ``kv_x`` (``x`` itself but for
    cross-attention, which has no qk-norm and no RoPE)."""
    q = mm("bsd,dhk->bshk", x, params.wq)
    k = mm("bsd,dhk->bshk", kv_x, params.wk)
    v = mm("bsd,dhk->bshk", kv_x, params.wv)
    if cfg.qkv_bias:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    if hasattr(params, "q_norm"):
        q = norm_apply(params.q_norm, q, cfg)
        k = norm_apply(params.k_norm, k, cfg)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def cache_update(buf, new, pos: int):
    """Write ``new`` [B, Sq, KH, D] into ``buf`` [B, S_max, KH, D] at
    token ``pos``, in place.  An update that does not fit raises, where
    ``dynamic_update_slice`` would clamp ``pos`` and overwrite the last
    tokens: the same result wherever the JAX function is in range."""
    pos, Sq = int(pos), new.shape[1]
    if pos < 0 or pos + Sq > buf.shape[1]:
        raise ValueError(
            f"cache_update: tokens {pos}..{pos + Sq - 1} do not fit a cache "
            f"of {buf.shape[1]} tokens (a prefill's own (k, v) holds only "
            f"the prompt: decode continues T.decode_cache_of_prefill's)")
    buf[:, pos:pos + Sq] = new.to(buf.dtype)
    return buf


def decode_attention(q, k_buf, v_buf, *, scale: float, window, softcap,
                     kv_len, q_positions):
    """Attention of a few query tokens over a whole dense cache: one masked
    softmax over [B, KH, G, Sq, S] in f32, keys at or past ``kv_len`` [B]
    and (with ``window``) keys at or before ``q_position - window``
    masked.  q: [B, Sq, H, D]; k_buf/v_buf: [B, S, KH, D] -> [B, Sq, H, D]
    in q's dtype."""
    B, Sq, H, D = q.shape
    S, KH = k_buf.shape[1], k_buf.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.to(f32), k_buf.to(f32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kp = torch.arange(S, device=q.device)[None, None, :]
    mask = torch.zeros(B, Sq, S, dtype=f32, device=q.device)
    qp = q_positions[..., :, None]
    if window is not None:
        mask = torch.where(kp <= qp - window, NEG_INF, mask)
    if kv_len is not None:
        mask = torch.where(kp >= kv_len[:, None, None], NEG_INF, mask)
    p = torch.softmax(s + mask[:, None, None], dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p.to(v_buf.dtype).to(f32),
                       v_buf.to(f32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attn_apply(params, x, cfg: ModelConfig, *, kind: str, positions,
               cache=None, cache_index=None, block_tables=None,
               chunk_lens=None, decode_lengths=None, head_mask=None,
               causal: bool = True, kv_x=None):
    """Attention sublayer for one layer; returns (out [B, S, d] in x.dtype,
    new_kv).

    Train and prefill (``cache is None``): x [B, S, d] attends to itself,
    ``positions`` [1, S]; new_kv is the layer's (k, v) [B, S, KH, D].
    Dense decode (``cache`` a (k_buf, v_buf) [B, S_max, KH, D] pair,
    ``block_tables`` None): x [B, 1, d] at position ``cache_index`` (an int
    or 0-dim tensor); the buffers are written in place and returned.  Paged
    step: x [B, C, d] chunk activations; ``cache`` is this layer's
    (k_pages, v_pages) [P, psize, KH, D] pair, or the int8 4-tuple
    (k_pages, v_pages, k_scale, v_scale) with [P, KH] f32 scales, written
    in place and returned; ``cache_index`` [B] counts KV tokens already in
    pages per slot and ``chunk_lens`` [B] the valid tokens of each slot's
    chunk (decode slots 1, prompt chunks up to C, idle slots 0 at any
    ``cache_index``).  A C == 1 step runs the decode kernel over
    ``decode_lengths`` [B] keys a slot: ``cache_index + chunk_lens``, and 0
    for an idle slot, so that it emits zeros as the chunk kernel does;
    ``lm_forward`` computes it once a tick, and it is computed here when
    not given.  ``head_mask`` ([B, 1, H, 1] or None) is Horn's per-group
    head dropout.  ``causal`` (train and prefill only) masks keys after the
    query; an encoder passes False.

    Cross-attention (``kv_x`` given, ``params`` an ``Attention(cross=
    True)``): x [B, S, d] attends to all of ``kv_x`` [B, S_kv, d] (the
    encoder output) in any mode, through the plain softmax, with no cache
    and no RoPE; ``cache`` must be None and new_kv is None."""
    window = cfg.sliding_window if kind == LOCAL else None
    theta = 10_000.0 if (kind == LOCAL and cfg.rope_theta > 1e5) \
        else cfg.rope_theta
    # gemma2 scales queries by query_pre_attn_scalar instead of head_dim
    scale = cfg.query_scale if cfg.query_scale else cfg.head_dim ** -0.5
    cross = kv_x is not None
    q, k, v = _project_qkv(params, x, kv_x if cross else x, cfg, positions,
                           use_rope=cfg.use_rope and not cross,
                           rope_theta=theta)
    if cross:
        if cache is not None:
            raise ValueError("cross-attention keeps no cache")
        out = decode_attention(q, k, v, scale=scale, window=None,
                               softcap=cfg.attn_logit_softcap, kv_len=None,
                               q_positions=positions)
        new_kv = None
    elif cache is None:
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale, causal=causal, window=window,
            softcap=cfg.attn_logit_softcap).transpose(1, 2)
        new_kv = (k, v)
    elif block_tables is None:
        k_buf = cache_update(cache[0], k, cache_index)
        v_buf = cache_update(cache[1], v, cache_index)
        kv_len = torch.full((x.shape[0],), int(cache_index) + x.shape[1],
                            device=x.device)
        out = decode_attention(q, k_buf, v_buf, scale=scale, window=window,
                               softcap=cfg.attn_logit_softcap, kv_len=kv_len,
                               q_positions=positions)
        new_kv = (k_buf, v_buf)
    else:
        k_pages, v_pages = cache[:2]
        k_scale, v_scale = cache[2:] if len(cache) == 4 else (None, None)
        for pool, sc, new in ((k_pages, k_scale, k), (v_pages, v_scale, v)):
            if sc is None:
                paged_pool_append(pool, new, block_tables, cache_index,
                                  chunk_lens)
            else:
                paged_pool_append_quant(pool, sc, new, block_tables,
                                        cache_index, chunk_lens)
        kw = dict(scale=scale, window=window, softcap=cfg.attn_logit_softcap,
                  k_scale=k_scale, v_scale=v_scale)
        if x.shape[1] == 1:          # a decode-only tick: the decode kernel
            if decode_lengths is None:
                decode_lengths = paged_decode_lengths(cache_index, chunk_lens)
            out = paged_attention(
                q[:, 0].contiguous(), k_pages, v_pages, block_tables,
                decode_lengths, **kw)[:, None]
        else:
            out = paged_chunk_attention(
                q.contiguous(), k_pages, v_pages, block_tables, cache_index,
                chunk_lens, **kw)
        new_kv = cache
    if head_mask is not None:
        out = out * head_mask.to(out.dtype)
    return mm("bshk,hkd->bsd", out, params.wo, x.dtype), new_kv
