"""Decoder LM assembly: the train forward, prefill, dense-cache decode and
the paged serving step.

The JAX package scans a stacked ``[R, ...]`` superblock; here the stack is
a ``ModuleList`` of per-layer ``Block``s run by a Python loop, layer ``i``
having kind ``cfg.layer_kinds()[i]`` (attention, local attention or
Mamba2) and an MoE FFN where ``layer_moe_flags`` says so.  A multimodal
config's stub frontend hands ``patch_embeds`` [B, num_patches, d], which
go in front of the text embeddings.  An encoder-decoder's decoder
(``LM(cross=True)``) adds learned positions (``pos_embed``) and a
cross-attention sublayer to each block, which attends to the
``encoder_out`` it is given (``models/encdec.py``).  Training rematerialises each block
in the backward (``torch.utils.checkpoint``) where the JAX package
checkpoints the superblock scan body; the gradients are the same.  Caches
are lists with one entry per layer: a dense ``(k_buf, v_buf)`` or
``(conv_state, ssm_state)`` pair (``init_cache``), or a paged ``(k_pages,
v_pages)`` pair or int8 ``(k_pages, v_pages, k_scale, v_scale)`` 4-tuple
(``init_paged_cache``).  Attention buffers and pools are written in place
by every step; Mamba states are replaced.
"""
from __future__ import annotations

from functools import partial
from typing import List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, LOCAL, MAMBA, ModelConfig
from repro_torch.core import parallel_dropout as pdrop
from repro_torch.models import layers as L
from repro_torch.models.attention import (Attention, attn_apply,
                                         paged_decode_lengths)
from repro_torch.models.ssm import Mamba, mamba_apply, ssm_dims


def layer_moe_flags(cfg: ModelConfig) -> List[bool]:
    """Which layers hold an MoE FFN, by the JAX package's rule: a layer of
    the scanned superblocks by its index inside the pattern
    (``cfg.layer_is_moe(i)``, i < len(pattern)), a remainder layer by its
    absolute index.  So llama4-maverick's pattern ``(ATTN,)`` with MoE
    period 2, offset 1 has no MoE layer: ``load_jax_flat`` needs the same
    leaves as the JAX spec tree."""
    P, R = len(cfg.layer_pattern), cfg.pattern_repeats
    return [cfg.layer_is_moe(li % P if li < R * P else li)
            for li in range(cfg.num_layers)]


class Block(nn.Module):
    """One decoder layer: ``pre_norm``, the mixer (``attn`` or ``mamba``),
    ``cross_norm`` and ``cross_attn`` with ``cross``, ``ffn_norm`` and
    ``moe`` on an MoE layer, else ``mlp`` when ``d_ff > 0``, and, for
    gemma, ``post_mixer_norm``/``post_ffn_norm``."""

    def __init__(self, cfg: ModelConfig, kind: str, make, *,
                 is_moe: bool = False, cross: bool = False):
        super().__init__()
        self.pre_norm = L.Norm(cfg, cfg.d_model, make)
        if kind in (ATTN, LOCAL):
            self.attn = Attention(cfg, make)
        elif kind == MAMBA:
            self.mamba = Mamba(cfg, make)
        else:
            raise ValueError(f"the port runs attention and mamba layers, "
                             f"got {kind!r}")
        if cfg.post_sublayer_norm:
            self.post_mixer_norm = L.Norm(cfg, cfg.d_model, make)
        if cross:
            self.cross_norm = L.Norm(cfg, cfg.d_model, make)
            self.cross_attn = Attention(cfg, make, cross=True)
        if is_moe or cfg.d_ff > 0:
            self.ffn_norm = L.Norm(cfg, cfg.d_model, make)
            if is_moe:
                self.moe = L.MoE(cfg, make)
            else:
                self.mlp = L.MLP(cfg, make)
            if cfg.post_sublayer_norm:
                self.post_ffn_norm = L.Norm(cfg, cfg.d_model, make)


class LM(nn.Module):
    """``embed``, ``layers`` (one ``Block`` per layer, each with a
    cross-attention sublayer when ``cross``), ``final_norm``, and
    ``pos_embed`` [max_pos, d] with learned positions."""

    AXES = {"pos_embed": ("noshard", "embed")}

    def __init__(self, cfg: ModelConfig, make, *, cross: bool = False):
        super().__init__()
        self.embed = L.Embed(cfg, make)
        self.layers = nn.ModuleList(
            Block(cfg, kind, make, is_moe=moe, cross=cross)
            for kind, moe in zip(cfg.layer_kinds(), layer_moe_flags(cfg)))
        self.final_norm = L.Norm(cfg, cfg.d_model, make)
        if cfg.learned_pos:
            self.pos_embed = make((cfg.max_pos, cfg.d_model), "normal", 0.02)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype=torch.bfloat16, device="cuda"
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Dense decode caches, one zero-filled pair per layer: attention
    ``(k, v)`` [B, max_len, KH, D] in ``dtype``; mamba ``(conv_state
    [B, W-1, d_in + 2N]`` in ``dtype``, ``ssm_state [B, H, P, N]`` f32).
    ``device="meta"`` gives the shapes and dtypes without memory."""
    dev = resolve_device(device)

    def mix_cache(kind):
        if kind in (ATTN, LOCAL):
            shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
            return (torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, device=dev))
        d_in, H, P, N = ssm_dims(cfg)
        return (torch.zeros(batch, cfg.ssm_conv_width - 1, d_in + 2 * N,
                            dtype=dtype, device=dev),
                torch.zeros(batch, H, P, N, dtype=torch.float32, device=dev))

    return [mix_cache(kind) for kind in cfg.layer_kinds()]


def decode_cache_of_prefill(cfg: ModelConfig, cache, max_len: int):
    """A prefill's per-layer cache, laid out for dense decode: each
    attention layer's (k, v) [B, S, KH, D] is copied into the front of
    zero buffers [B, max_len, KH, D] of the same dtype, so decode
    continues at position S; mamba entries are kept as they are."""
    out = []
    for kind, entry in zip(cfg.layer_kinds(), cache):
        if kind in (ATTN, LOCAL):
            S = entry[0].shape[1]
            if S > max_len:
                raise ValueError(f"a prompt of {S} tokens does not fit a "
                                 f"decode cache of {max_len}")
            bufs = []
            for t in entry:
                buf = t.new_zeros((t.shape[0], max_len, *t.shape[2:]))
                buf[:, :S] = t
                bufs.append(buf)
            entry = tuple(bufs)
        out.append(entry)
    return out


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     dtype=torch.bfloat16, device="cuda"
                     ) -> List[Tuple[torch.Tensor, ...]]:
    """One ``(k_pages, v_pages)`` pool pair [P, psize, KH, D] per layer,
    zero-filled.  Page ids are layer-agnostic (page j of every layer belongs
    to the same sequence); page 0 is the reserved null page.

    ``dtype=torch.int8`` selects the quantized pools: each layer holds
    ``(k_pages, v_pages, k_scale, v_scale)``, int8 pools and one f32 scale
    per (page, kv head) [P, KH], zero-filled, so a page costs about half
    the bytes of bf16 and its scales follow it through every page copy (the
    same page ids index both)."""
    KH = cfg.num_kv_heads
    shape = (num_pages, page_size, KH, cfg.head_dim)

    def layer():
        pools = (torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
        if dtype == torch.int8:
            pools += tuple(torch.zeros(num_pages, KH, dtype=torch.float32,
                                       device=device) for _ in range(2))
        return pools

    return [layer() for _ in range(cfg.num_layers)]


def _mix_mask(a, b):
    """Compose two optional multiplicative masks (either may be None)."""
    if a is None:
        return b
    return a if b is None else a * b


def _serve_slice(serve_masks, key: str, layer_idx: int):
    """Layer ``layer_idx``'s per-slot sub-model mask [B, units] from a
    serve-mask dict, or None."""
    if serve_masks is None or key not in serve_masks:
        return None
    return serve_masks[key][:, layer_idx]


def _block_apply(bp, x, cfg: ModelConfig, *, kind: str, layer_idx: int,
                 is_moe: bool = False, with_aux: bool = False, horn=None,
                 positions, cache=None, cache_index=None, block_tables=None,
                 chunk_lens=None, decode_lengths=None, serve_masks=None,
                 encoder_out=None, causal: bool = True):
    """One decoder layer; returns (x, the mixer's new cache, the MoE aux
    dict: empty on a dense layer or without ``with_aux``).  ``horn``
    (train only) draws this layer's head, channel and FFN (or expert
    hidden) masks with the JAX package's layer index and salts (13, 3 and
    5); ``serve_masks`` (serving) multiplies this layer's rows of the
    slots' circuit masks into the head and FFN (``"ffn"``) or expert
    (``"moe"``) hidden masks.  A block with ``cross_attn`` attends to
    ``encoder_out`` after its mixer (no head mask there, as in the JAX
    package); ``causal`` is the self-attention's mask."""
    B = x.shape[0]
    aux = {}
    h = L.norm_apply(bp.pre_norm, x, cfg)
    if kind in (ATTN, LOCAL):
        hm = pdrop.head_mask(horn, layer_idx, B, cfg.num_heads)
        sh = _serve_slice(serve_masks, "heads", layer_idx)
        if sh is not None:
            hm = _mix_mask(hm, sh[:, None, :, None])       # [B, 1, H, 1]
        out, new_cache = attn_apply(
            bp.attn, h, cfg, kind=kind, positions=positions, cache=cache,
            cache_index=cache_index, block_tables=block_tables,
            chunk_lens=chunk_lens, decode_lengths=decode_lengths,
            head_mask=hm, causal=causal)
    else:
        cm = pdrop.unit_mask(horn, layer_idx, B, ssm_dims(cfg)[0], salt=3)
        out, new_cache = mamba_apply(bp.mamba, h, cfg, cache=cache,
                                     channel_mask=cm)
    if cfg.post_sublayer_norm:
        out = L.norm_apply(bp.post_mixer_norm, out, cfg)
    x = x + out.to(x.dtype)
    if hasattr(bp, "cross_attn") and encoder_out is not None:
        h = L.norm_apply(bp.cross_norm, x, cfg)
        out, _ = attn_apply(bp.cross_attn, h, cfg, kind=ATTN,
                            positions=positions, kv_x=encoder_out)
        x = x + out.to(x.dtype)
    if hasattr(bp, "ffn_norm"):     # mamba2-style blocks have no FFN
        h = L.norm_apply(bp.ffn_norm, x, cfg)
        if is_moe:
            mm = pdrop.unit_mask(horn, layer_idx, B, cfg.moe_ff, salt=5)
            mm = None if mm is None else mm[:, None]       # [B, 1, 1, ff]
            sm = _serve_slice(serve_masks, "moe", layer_idx)
            if sm is not None:
                mm = _mix_mask(mm, sm[:, None, None, :])
            out, aux = L.moe_apply(bp.moe, h, cfg, hidden_mask=mm,
                                   with_aux=with_aux)
        else:
            fm = pdrop.unit_mask(horn, layer_idx, B, cfg.d_ff, salt=5)
            sf = _serve_slice(serve_masks, "ffn", layer_idx)
            if sf is not None:
                fm = _mix_mask(fm, sf[:, None, :])           # [B, 1, ff]
            out = L.mlp_apply(bp.mlp, h, cfg, hidden_mask=fm)
        if cfg.post_sublayer_norm:
            out = L.norm_apply(bp.post_ffn_norm, out, cfg)
        x = x + out.to(x.dtype)
    return x, new_cache, aux


def _remat_block(fn, x):
    """A train-mode block for ``checkpoint``: (x, its MoE aux)."""
    x, _, aux = fn(x)
    return x, aux


def lm_forward(params, tokens, cfg: ModelConfig, *, mode: str = "train",
               horn=None, remat: bool = True, cache=None, cache_index=None,
               block_tables=None, chunk_lens=None, logit_index=None,
               serve_masks=None, patch_embeds=None, encoder_out=None):
    """Returns (hidden [B, S, d] final-normed, or [B, n, d] with
    ``logit_index``; in prefill and decode the new per-layer cache, in
    train mode the MoE aux instead: each of ``load_balance_loss``,
    ``router_z_loss`` and ``dropped_frac`` summed over the MoE layers and
    divided by ``num_layers``, f32 zeros for a dense model).  Serving
    computes no aux.

    ``patch_embeds`` ([B, num_patches, d], a multimodal config's stub
    frontend) are cast to the embeddings' dtype and put in front of the
    text embeddings, before the Horn and serve input masks; positions run
    over the whole sequence, so the hidden state holds the patches first.
    With learned positions each token adds its position's row of
    ``pos_embed`` (in the embeddings' dtype) before those masks.
    ``encoder_out`` ([B, S_enc, d], an encoder-decoder's) is what every
    block's cross-attention attends to, in every mode.

    mode "train": tokens [B, S] attend causally to themselves at positions
    ``arange(S)``; ``horn`` (a ``HornState`` or None) masks the embedding
    channels, each layer's FFN units and mamba channels and, optionally,
    heads; with ``remat`` every block is recomputed in the backward
    instead of keeping its activations.

    mode "prefill": the same forward without masks; the cache holds each
    layer's (k, v) [B, S, KH, D] or (raw conv tail, final SSM state).

    mode "decode" with a dense ``cache`` (``init_cache``, or
    ``decode_cache_of_prefill`` of a prefill's) and no ``block_tables``:
    tokens [B, 1] at position ``cache_index`` (an int or 0-dim tensor),
    which must lie inside the attention buffers; they are written in
    place.

    mode "decode" with ``block_tables`` (the paged serving step): tokens
    [B, C] right-padded chunks; cache_index: [B] KV tokens already in pages
    (token j of slot b sits at ``cache_index[b] + j``); chunk_lens: [B];
    block_tables: [B, maxp]; ``cache`` from ``init_paged_cache``, appended
    to in place.  ``logit_index`` ([B, n]) gathers n chunk rows from the
    residual stream before the final norm, so the norm runs on those rows
    only (bitwise the same as gathering after it: the norm is row-wise);
    None keeps all C rows.

    ``serve_masks`` (multi-submodel serving, any mode) is a dict of fixed
    per-slot circuit masks, already gathered by submodel id: "input"
    [B, d_model] multiplies the embeddings, "heads" [B, L, H] the
    attention heads and "ffn" [B, L, d_ff] the MLP's hidden units, all
    binary {0, 1}, so each slot runs its own Horn circuit of the shared
    weights; "moe" [B, L, moe_ff] masks the experts' hidden units of the
    MoE layers."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"lm_forward: mode {mode!r} is not ported")
    x = L.embed_apply(params.embed, tokens, cfg)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(device=x.device, dtype=x.dtype), x],
                      dim=1)
    B, S = x.shape[:2]
    steps = torch.arange(S, device=x.device)[None, :]
    decode_lengths = None
    if mode != "decode":
        positions = steps
    elif block_tables is None:
        cache_index = int(cache_index)
        positions = (cache_index + steps).expand(B, S)
    else:
        positions = cache_index.long()[:, None] + steps
        if S == 1:                   # once a tick, not once a layer
            decode_lengths = paged_decode_lengths(cache_index, chunk_lens)
    if cfg.learned_pos:
        if block_tables is not None:
            raise ValueError("learned positions are not served from pages "
                             "(the engine refuses such configs)")
        start = cache_index if mode == "decode" else 0
        if start + S > cfg.max_pos:
            raise ValueError(f"positions {start}..{start + S - 1} run past "
                             f"the {cfg.max_pos} learned positions")
        x = x + params.pos_embed[start:start + S].to(x.dtype)
    if mode == "train":
        im = pdrop.input_mask(horn, B, cfg.d_model)
        if im is not None:
            x = x * im.to(x.dtype)
    if serve_masks is not None and "input" in serve_masks:
        x = x * serve_masks["input"][:, None, :].to(x.dtype)
    new_cache = None if mode == "train" else []
    aux = {}
    for li, (bp, kind, moe) in enumerate(zip(
            params.layers, cfg.layer_kinds(), layer_moe_flags(cfg))):
        fn = partial(_block_apply, bp, cfg=cfg, kind=kind, layer_idx=li,
                     is_moe=moe, with_aux=mode == "train", horn=horn,
                     positions=positions,
                     cache=cache[li] if mode == "decode" else None,
                     cache_index=cache_index, block_tables=block_tables,
                     chunk_lens=chunk_lens, decode_lengths=decode_lengths,
                     serve_masks=serve_masks, encoder_out=encoder_out)
        if mode == "train" and remat:
            x, layer_aux = checkpoint(_remat_block, fn, x,
                                      use_reentrant=False)
        else:
            x, layer_cache, layer_aux = fn(x)
            if mode != "train":
                new_cache.append(layer_cache)
        for k, v in layer_aux.items():
            aux[k] = aux[k] + v if k in aux else v
    if logit_index is not None:
        idx = logit_index.long()[..., None].expand(-1, -1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    hidden = L.norm_apply(params.final_norm, x, cfg)
    if mode != "train":
        return hidden, new_cache
    zero = x.new_zeros((), dtype=torch.float32)
    return hidden, {k: aux[k] / max(1, cfg.num_layers) if k in aux else zero
                    for k in L.MOE_AUX}


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
