"""Encoder-decoder (whisper-style), the port of ``repro/models/encdec.py``.

The audio frontend is a stub, as in the JAX package: callers hand
precomputed frame embeddings [B, encoder_seq, d_model].  The encoder adds
its learned positions to them, runs ``num_encoder_layers`` non-causal
attention blocks and a final norm; the decoder is ``transformer.LM`` with
a cross-attention sublayer in every block, attending to the encoder's
output.  The encoder's self-attention goes through ``flash_attention``
(non-causal), the decoder's through it too (causal); cross-attention
takes the plain softmax (``attention.attn_apply(kv_x=...)``).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: ``num_encoder_layers`` attention layers,
    no MoE, ``encoder_seq`` learned positions."""
    return dataclasses.replace(
        cfg, num_layers=cfg.num_encoder_layers, layer_pattern=(ATTN,),
        is_encoder_decoder=False, moe_period=0, max_pos=cfg.encoder_seq)


class Encoder(nn.Module):
    """``pos_embed`` [encoder_seq, d], ``layers`` (one attention ``Block``
    per encoder layer), ``final_norm``."""

    AXES = {"pos_embed": ("noshard", "embed")}

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        ecfg = encoder_cfg(cfg)
        self.pos_embed = make((ecfg.max_pos, cfg.d_model), "normal", 0.02)
        self.layers = nn.ModuleList(T.Block(ecfg, ATTN, make)
                                    for _ in range(ecfg.num_layers))
        self.final_norm = L.Norm(cfg, cfg.d_model, make)


class EncDec(nn.Module):
    """``encoder`` and ``decoder`` (an ``LM`` whose blocks cross-attend)."""

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        self.encoder = Encoder(cfg, make)
        self.decoder = T.LM(cfg, make, cross=True)


def encode(params: Encoder, frames, cfg: ModelConfig, *,
           remat: bool = True, train: bool = False):
    """frames [B, S_enc, d] -> the encoder's hidden states [B, S_enc, d],
    final-normed.  The stream keeps the frames' dtype (the positions are
    cast to it), whatever the parameters' dtype.  Each block is
    recomputed in the backward only when ``remat`` and ``train``; no Horn
    mask reaches the encoder."""
    ecfg = encoder_cfg(cfg)
    S = frames.shape[1]
    if S > ecfg.max_pos:
        raise ValueError(f"{S} frames run past the encoder's {ecfg.max_pos} "
                         f"learned positions")
    x = frames + params.pos_embed[:S].to(frames.dtype)
    positions = torch.arange(S, device=x.device)[None, :]
    for bp in params.layers:
        fn = partial(T._block_apply, bp, cfg=ecfg, kind=ATTN, layer_idx=0,
                     positions=positions, causal=False)
        if remat and train:
            x, _ = checkpoint(T._remat_block, fn, x, use_reentrant=False)
        else:
            x = fn(x)[0]
    return L.norm_apply(params.final_norm, x, cfg)


def encdec_forward(params: EncDec, frames, tokens, cfg: ModelConfig, *,
                   mode: str = "train", horn=None, remat: bool = True,
                   cache=None, cache_index=None, encoder_out=None,
                   logit_index=None):
    """The whole model: (hidden, ``lm_forward``'s second output (the MoE
    aux in train mode, else the decoder's cache), encoder_out).  The
    encoder runs on ``frames`` unless ``encoder_out`` is given (decode
    passes the prefill's); ``horn`` masks the decoder only."""
    if encoder_out is None:
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs frames "
                             f"or encoder_out")
        encoder_out = encode(params.encoder, frames, cfg, remat=remat,
                             train=mode == "train")
    hidden, second = T.lm_forward(
        params.decoder, tokens, cfg, mode=mode, horn=horn, remat=remat,
        cache=cache, cache_index=cache_index, logit_index=logit_index,
        encoder_out=encoder_out)
    return hidden, second, encoder_out
