"""Model API of the port: the train loss and the unified paged serving
step (decoder-only LMs)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def paged_step(params, cache, tokens, starts, chunk_lens, block_tables,
               cfg: ModelConfig, *, logit_index=None):
    """One unified serving tick over paged KV pools: every slot advances by
    a chunk of up to C tokens (decode slots exactly 1, admitting prompts a
    prompt chunk, idle slots 0).  The chunk K/V is appended to ``cache`` in
    place.

    tokens: [B, C]; starts: [B] KV tokens already in pages per slot;
    chunk_lens: [B]; block_tables: [B, maxp] (empty slots: null-page rows).
    Returns (logits [B, vocab] at each slot's last valid chunk position,
    cache); idle slots return logits the caller must ignore.  With
    ``logit_index`` ([B, n]) the logits are [B, n, vocab] at those chunk
    positions instead.  The lm head only ever runs on the selected rows."""
    if logit_index is not None:
        hidden = T.lm_forward(params, tokens, cfg, mode="decode",
                              cache=cache, cache_index=starts,
                              block_tables=block_tables,
                              chunk_lens=chunk_lens, logit_index=logit_index)
        return T.lm_logits(params, hidden, cfg), cache
    last = torch.clamp(chunk_lens.long() - 1, min=0)[:, None]
    hidden = T.lm_forward(params, tokens, cfg, mode="decode", cache=cache,
                          cache_index=starts, block_tables=block_tables,
                          chunk_lens=chunk_lens, logit_index=last)
    return T.lm_logits(params, hidden, cfg)[:, 0], cache


def forward_hidden(params, batch, cfg: ModelConfig, *, horn=None,
                   remat: bool = True):
    """Train-mode hidden states [B, S, d] (final-normed) of
    ``batch["tokens"]`` [B, S]; ``horn`` as in ``lm_forward``."""
    return T.lm_forward(params, batch["tokens"], cfg, mode="train",
                        horn=horn, remat=remat)


def model_loss(params, batch, cfg: ModelConfig, *, horn=None,
               remat: bool = True):
    """(scalar loss, {"loss", "xent"}) of next-token prediction on
    ``batch`` ({"tokens", "labels"}, [B, S] each); the loss is the mean
    cross-entropy (dense models add no auxiliary terms)."""
    hidden = forward_hidden(params, batch, cfg, horn=horn, remat=remat)
    xent = T.chunked_xent(hidden, params, batch["labels"], cfg)
    return xent, {"loss": xent, "xent": xent}
