"""Step factories of the serving path: the unified paged step (greedy) and
the device-side KV page copy.

PyTorch runs eagerly, so a "step" is a plain function; nothing is traced
or compiled per chunk width.  Parameters are cast to the compute dtype
once, when the engine is built (``models/params.py::cast_params``), not on
every tick.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def make_unified_paged_step(cfg: ModelConfig):
    """THE serving step, greedy: one call per engine tick, whatever the tick
    holds (decode tokens and prompt chunks packed into [B, C]).  Appends
    every token's K/V to the pools in place, runs paged attention over
    them and returns the argmax token of each slot's last valid chunk
    position (the verify window of width S_v == 1; ties go to the first
    index).  Idle slots and mid-prompt chunks produce tokens the engine
    discards.

    step(params, cache, tokens [B, C], starts [B], chunk_lens [B],
         block_tables [B, maxp]) -> sampled [B] int32
    """

    @torch.inference_mode()
    def step(params, cache, tokens, starts, chunk_lens, block_tables):
        C = tokens.shape[1]
        widx = torch.clamp(chunk_lens.long() - 1, 0, C - 1)[:, None]
        logits, _ = api.paged_step(params, cache, tokens, starts, chunk_lens,
                                   block_tables, cfg, logit_index=widx)
        return torch.argmax(logits[:, 0], dim=-1).to(torch.int32)

    return step


def make_page_copy_step():
    """Device-side KV page copy for copy-on-write: ``copy(cache, src, dst)``
    duplicates page ``src[i]`` into page ``dst[i]`` in every layer's K and
    V pool, in place.  Pools are [P, ...] per layer, so the page axis is
    always 0."""

    @torch.inference_mode()
    def copy(cache, src, dst):
        for pools in cache:
            for pool in pools:
                pool[dst] = pool[src]
        return cache

    return copy
