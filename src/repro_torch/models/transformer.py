"""Decoder LM assembly: the train forward and the paged serving step.

The JAX package scans a stacked ``[R, ...]`` superblock; here the stack is
a ``ModuleList`` of per-layer ``Block``s run by a Python loop, layer ``i``
having kind ``cfg.layer_kinds()[i]``.  Training rematerialises each block
in the backward (``torch.utils.checkpoint``) where the JAX package
checkpoints the superblock scan body; the gradients are the same.  The
paged KV cache is one ``(k_pages, v_pages)`` pair per layer, written in
place by every step.
"""
from __future__ import annotations

from functools import partial
from typing import List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, LOCAL, ModelConfig
from repro_torch.core import parallel_dropout as pdrop
from repro_torch.models import layers as L
from repro_torch.models.attention import Attention, attn_apply


class Block(nn.Module):
    """One decoder layer: ``pre_norm``, ``attn``, ``ffn_norm``, ``mlp`` and,
    for gemma, ``post_mixer_norm``/``post_ffn_norm``."""

    def __init__(self, cfg: ModelConfig, kind: str, make):
        super().__init__()
        if kind not in (ATTN, LOCAL):
            raise ValueError(f"the port runs attention layers only, got "
                             f"{kind!r}")
        self.pre_norm = L.Norm(cfg, cfg.d_model, make)
        self.attn = Attention(cfg, make)
        if cfg.post_sublayer_norm:
            self.post_mixer_norm = L.Norm(cfg, cfg.d_model, make)
        if cfg.d_ff > 0:
            self.ffn_norm = L.Norm(cfg, cfg.d_model, make)
            self.mlp = L.MLP(cfg, make)
            if cfg.post_sublayer_norm:
                self.post_ffn_norm = L.Norm(cfg, cfg.d_model, make)


class LM(nn.Module):
    """``embed``, ``layers`` (one ``Block`` per layer), ``final_norm``."""

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        if cfg.is_encoder_decoder or cfg.num_patches or cfg.learned_pos:
            raise ValueError(f"{cfg.name}: the port runs decoder-only LMs")
        if any(cfg.layer_is_moe(i) for i in range(cfg.num_layers)):
            raise ValueError(f"{cfg.name}: MoE layers are not ported yet")
        self.embed = L.Embed(cfg, make)
        self.layers = nn.ModuleList(
            Block(cfg, kind, make) for kind in cfg.layer_kinds())
        self.final_norm = L.Norm(cfg, cfg.d_model, make)


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     dtype=torch.bfloat16, device="cuda"
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """One ``(k_pages, v_pages)`` pool pair [P, psize, KH, D] per layer,
    zero-filled.  Page ids are layer-agnostic (page j of every layer belongs
    to the same sequence); page 0 is the reserved null page."""
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_layers)]


def _block_apply(bp, x, cfg: ModelConfig, *, kind: str, layer_idx: int,
                 horn=None, positions, cache=None, cache_index=None,
                 block_tables=None, chunk_lens=None):
    """One decoder layer.  ``horn`` (train only) draws this layer's head
    and FFN masks with the JAX package's layer index and salts (13 and
    5)."""
    B = x.shape[0]
    h = L.norm_apply(bp.pre_norm, x, cfg)
    out = attn_apply(bp.attn, h, cfg, kind=kind, positions=positions,
                     cache=cache, cache_index=cache_index,
                     block_tables=block_tables, chunk_lens=chunk_lens,
                     head_mask=pdrop.head_mask(horn, layer_idx, B,
                                               cfg.num_heads))
    if cfg.post_sublayer_norm:
        out = L.norm_apply(bp.post_mixer_norm, out, cfg)
    x = x + out.to(x.dtype)
    if cfg.d_ff > 0:
        h = L.norm_apply(bp.ffn_norm, x, cfg)
        fm = pdrop.unit_mask(horn, layer_idx, B, cfg.d_ff, salt=5)
        out = L.mlp_apply(bp.mlp, h, cfg, hidden_mask=fm)
        if cfg.post_sublayer_norm:
            out = L.norm_apply(bp.post_ffn_norm, out, cfg)
        x = x + out.to(x.dtype)
    return x


def lm_forward(params, tokens, cfg: ModelConfig, *, mode: str = "train",
               horn=None, remat: bool = True, cache=None, cache_index=None,
               block_tables=None, chunk_lens=None, logit_index=None):
    """Returns hidden [B, S, d] (final-normed), or [B, n, d] with
    ``logit_index``.

    mode "train": tokens [B, S] attend causally to themselves at positions
    ``arange(S)``; ``horn`` (a ``HornState`` or None) masks the embedding
    channels, each layer's FFN units and, optionally, heads; with
    ``remat`` every block is recomputed in the backward instead of keeping
    its activations.

    mode "decode" (the paged serving step): tokens [B, C] right-padded
    chunks; cache_index: [B] KV tokens already in pages (token j of slot b
    sits at ``cache_index[b] + j``); chunk_lens: [B]; block_tables:
    [B, maxp]; ``cache`` from ``init_paged_cache``, appended to in place.
    ``logit_index`` ([B, n]) gathers n chunk rows from the residual stream
    before the final norm, so the norm runs on those rows only (bitwise the
    same as gathering after it: the norm is row-wise); None keeps all C
    rows."""
    if mode not in ("train", "decode"):
        raise ValueError(f"lm_forward: mode {mode!r} is not ported")
    x = L.embed_apply(params.embed, tokens, cfg)
    B, S = x.shape[:2]
    if mode == "train":
        im = pdrop.input_mask(horn, B, cfg.d_model)
        if im is not None:
            x = x * im.to(x.dtype)
        positions = torch.arange(S, device=x.device)[None, :]
        for li, (bp, kind) in enumerate(zip(params.layers,
                                            cfg.layer_kinds())):
            fn = partial(_block_apply, bp, cfg=cfg, kind=kind, layer_idx=li,
                         horn=horn, positions=positions)
            x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    else:
        positions = cache_index.long()[:, None] \
            + torch.arange(S, device=x.device)[None, :]
        for li, (bp, kind, layer_cache) in enumerate(
                zip(params.layers, cfg.layer_kinds(), cache)):
            x = _block_apply(bp, x, cfg, kind=kind, layer_idx=li,
                             positions=positions, cache=layer_cache,
                             cache_index=cache_index,
                             block_tables=block_tables,
                             chunk_lens=chunk_lens)
    if logit_index is not None:
        idx = logit_index.long()[..., None].expand(-1, -1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    return L.norm_apply(params.final_norm, x, cfg)


def lm_logits(params, hidden, cfg: ModelConfig):
    return L.unembed_apply(params.embed, hidden, cfg)


def _xent_chunk(embed, cfg: ModelConfig, h, labels):
    logits = L.unembed_apply(embed, h, cfg).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - gold).sum()


def chunked_xent(hidden, params, labels, cfg: ModelConfig, *,
                 chunk: int = 512):
    """Mean cross-entropy without materialising the full [B, S, V] logits:
    sequence chunks of ``chunk`` (halved until it divides S), each
    computing its f32 logits and log-sum-exp and rematerialised in the
    backward, so one chunk's logits live at a time."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    labels = labels.long()
    total = hidden.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        total = total + checkpoint(
            _xent_chunk, params.embed, cfg, hidden[:, c0:c0 + chunk],
            labels[:, c0:c0 + chunk], use_reentrant=False)
    return total / float(B * S)
