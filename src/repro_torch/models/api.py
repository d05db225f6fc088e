"""Model API of the port: the train loss, prefill and one-token decode
over a dense cache, and the unified paged serving step (decoder-only
LMs).

``batch`` holds "tokens" [B, S_text] (and "labels" [B, S_text] for the
loss); a multimodal config's stub frontend adds "patch_embeds"
[B, num_patches, d_model], fused in front of the text; an
encoder-decoder's stub audio frontend adds "frames"
[B, encoder_seq, d_model], which the encoder reads (``models/encdec.py``)
and the decoder cross-attends to."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.models.params import param_axes


def model_axes(cfg: ModelConfig):
    """{JAX keystr: logical axes} of every parameter of ``cfg``'s model,
    the layout the JAX spec tree declares (``params.param_axes``)."""
    return param_axes(cfg)


def _decoder(params, cfg: ModelConfig):
    return params.decoder if cfg.is_encoder_decoder else params


def _refuse_enc_dec(cfg: ModelConfig, what: str):
    if cfg.is_encoder_decoder:
        raise ValueError(f"{what}: decoder-LM-only")


def paged_step(params, cache, tokens, starts, chunk_lens, block_tables,
               cfg: ModelConfig, *, logit_index=None, serve_masks=None):
    """One unified serving tick over paged KV pools: every slot advances by
    a chunk of up to C tokens (decode slots exactly 1, admitting prompts a
    prompt chunk, idle slots 0).  The chunk K/V is appended to ``cache`` in
    place.

    tokens: [B, C]; starts: [B] KV tokens already in pages per slot;
    chunk_lens: [B]; block_tables: [B, maxp] (empty slots: null-page rows).
    Returns (logits [B, vocab] at each slot's last valid chunk position,
    cache); idle slots return logits the caller must ignore.  With
    ``logit_index`` ([B, n]) the logits are [B, n, vocab] at those chunk
    positions instead.  The lm head only ever runs on the selected rows.
    ``serve_masks`` selects each slot's circuit (``lm_forward``)."""
    _refuse_enc_dec(cfg, "paged decode")
    if logit_index is not None:
        hidden, _ = T.lm_forward(params, tokens, cfg, mode="decode",
                                 cache=cache, cache_index=starts,
                                 block_tables=block_tables,
                                 chunk_lens=chunk_lens,
                                 logit_index=logit_index,
                                 serve_masks=serve_masks)
        return T.lm_logits(params, hidden, cfg), cache
    last = torch.clamp(chunk_lens.long() - 1, min=0)[:, None]
    hidden, _ = T.lm_forward(params, tokens, cfg, mode="decode",
                             cache=cache, cache_index=starts,
                             block_tables=block_tables,
                             chunk_lens=chunk_lens, logit_index=last,
                             serve_masks=serve_masks)
    return T.lm_logits(params, hidden, cfg)[:, 0], cache


def prefill(params, batch, cfg: ModelConfig, *, serve_masks=None):
    """Full-sequence forward for serving: (logits [B, vocab] at the last
    position, the per-layer cache: attention (k, v) [B, S, KH, D], mamba
    (raw conv tail, final SSM state)).  With ``batch["patch_embeds"]`` the
    sequence is the patches then the text: the logits are the last text
    token's and the cache covers patches plus text.  The last position is
    gathered before the final norm (bitwise the same: the norm is
    row-wise), so the norm and the lm head run on one row per sequence.
    An encoder-decoder encodes ``batch["frames"]`` and returns (logits,
    the decoder's cache, the encoder output [B, S_enc, d]), which
    ``decode_step`` takes.  The JAX function also takes right-padded
    prompts' ``last_index``; the port's callers pass whole prompts.
    ``serve_masks`` selects a fixed circuit per sequence (``lm_forward``;
    decoder-only)."""
    if serve_masks is not None:
        _refuse_enc_dec(cfg, "sub-model serving masks")
    tokens = torch.as_tensor(batch["tokens"])
    patches = batch.get("patch_embeds")
    B, S = tokens.shape
    if patches is not None:
        S += patches.shape[1]
    idx = torch.full((B, 1), S - 1, device=tokens.device)
    if cfg.is_encoder_decoder:
        hidden, cache, enc = ED.encdec_forward(
            params, batch["frames"], tokens, cfg, mode="prefill",
            remat=False, logit_index=idx)
        return T.lm_logits(params.decoder, hidden, cfg)[:, 0], cache, enc
    hidden, cache = T.lm_forward(params, tokens, cfg, mode="prefill",
                                 remat=False, logit_index=idx,
                                 serve_masks=serve_masks,
                                 patch_embeds=patches)
    return T.lm_logits(params, hidden, cfg)[:, 0], cache


def decode_step(params, cache, tokens, cache_index, cfg: ModelConfig, *,
                encoder_out=None, serve_masks=None):
    """One-token decode over a dense cache.  tokens: [B, 1]; cache_index:
    the position of that token (an int or 0-dim tensor), the same for
    every sequence (after a prefill with patches, their count plus the
    text's).  Returns (logits [B, vocab], the new cache); attention
    buffers are written in place.  ``serve_masks`` as in ``prefill``.  An
    encoder-decoder needs ``encoder_out`` (``prefill``'s), which every
    step's cross-attention reads again."""
    if serve_masks is not None:
        _refuse_enc_dec(cfg, "sub-model serving masks")
    if cfg.is_encoder_decoder:
        if encoder_out is None:
            raise ValueError("enc-dec decode requires encoder_out")
        hidden, new_cache, _ = ED.encdec_forward(
            params, None, tokens, cfg, mode="decode", remat=False,
            cache=cache, cache_index=cache_index, encoder_out=encoder_out)
    else:
        hidden, new_cache = T.lm_forward(params, tokens, cfg, mode="decode",
                                         remat=False, cache=cache,
                                         cache_index=cache_index,
                                         serve_masks=serve_masks)
    return T.lm_logits(_decoder(params, cfg), hidden, cfg)[:, 0], new_cache


def forward_hidden(params, batch, cfg: ModelConfig, *, horn=None,
                   remat: bool = True):
    """Train-mode (hidden states [B, S, d], final-normed, of
    ``batch["tokens"]`` [B, S] behind any ``batch["patch_embeds"]``; the
    MoE aux dict); ``horn`` as in ``lm_forward``.  An encoder-decoder
    encodes ``batch["frames"]`` first; its decoder gives the hidden
    states."""
    if cfg.is_encoder_decoder:
        hidden, aux, _ = ED.encdec_forward(
            params, batch["frames"], batch["tokens"], cfg, mode="train",
            horn=horn, remat=remat)
        return hidden, aux
    return T.lm_forward(params, batch["tokens"], cfg, mode="train",
                        horn=horn, remat=remat,
                        patch_embeds=batch.get("patch_embeds"))


LB_COEF, Z_COEF = 0.01, 1e-3     # the router losses' weights in the loss


def model_loss(params, batch, cfg: ModelConfig, *, horn=None,
               remat: bool = True):
    """(scalar loss, metrics) of next-token prediction on ``batch``
    ({"tokens", "labels"} [B, S_text], and "patch_embeds" for a multimodal
    config, whose positions are dropped from the hidden state before the
    cross-entropy: labels cover the text only; "frames" for an
    encoder-decoder, whose decoder predicts the labels).  The loss is the mean
    cross-entropy, plus ``LB_COEF * load_balance_loss + Z_COEF *
    router_z_loss`` (the JAX defaults) when the config has experts.
    metrics: "loss", "xent" and the three MoE aux values (zeros for a
    dense model)."""
    hidden, aux = forward_hidden(params, batch, cfg, horn=horn, remat=remat)
    if cfg.num_patches and batch.get("patch_embeds") is not None:
        hidden = hidden[:, batch["patch_embeds"].shape[1]:]
    xent = T.chunked_xent(hidden, _decoder(params, cfg), batch["labels"],
                          cfg)
    loss = xent
    if cfg.num_experts:
        loss = loss + LB_COEF * aux["load_balance_loss"] \
            + Z_COEF * aux["router_z_loss"]
    return loss, {"loss": loss, "xent": xent, **aux}
