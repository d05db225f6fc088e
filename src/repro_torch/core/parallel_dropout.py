"""Collective & Parallel Dropout: Horn's core technique (paper §2).

A copy of ``repro/core/parallel_dropout.py``.  Each worker group g draws an
independent structured dropout over hidden units per step (a different
sparse sub-model of the parent); the mask's leading axis is the group axis,
expanded onto the group's samples.  Inverted dropout (scale 1/keep at train
time), drawn per block of ``block_size`` contiguous units.

Randomness: ``HornState.uniform(layer_idx, salt, shape)`` is the only place
that draws numbers.  It seeds a fresh ``torch.Generator`` from
``(seed, seed_salt, step, layer_idx, salt)``, the counter chain that the
JAX package folds into its key (``fold_in`` of the salt, the step, the
layer and the salt).  So a mask depends on those counters alone and comes
out identical when ``torch.utils.checkpoint`` recomputes a block in the
backward, which a running generator would not give.  The numbers differ
from JAX's threefry; tests hand both packages the same uniforms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HornConfig

f32 = torch.float32


@dataclass(frozen=True)
class HornState:
    """Per-step dropout context threaded through a model apply."""

    seed: int                 # the run's seed
    step: int                 # the train step (masks change every step)
    cfg: HornConfig
    num_groups: int           # resolved group count (>= 1)
    device: torch.device
    # (first row, global batch) of a data-parallel rank's rows; None: the
    # rows a layer sees are the whole batch
    rows: Optional[Tuple[int, int]] = None

    def uniform(self, layer_idx: int, salt: int,
                shape: Tuple[int, ...]) -> torch.Tensor:
        """U[0, 1) f32 of ``shape`` on the device, a pure function of
        (seed, seed_salt, step, layer_idx, salt)."""
        entropy = [int(x) & 0xFFFFFFFF for x in (
            self.seed, self.cfg.seed_salt, self.step, layer_idx, salt)]
        seed = int(np.random.SeedSequence(entropy).generate_state(
            1, np.uint64)[0]) >> 1
        gen = torch.Generator(self.device).manual_seed(seed)
        return torch.rand(shape, generator=gen, device=self.device,
                          dtype=f32)


def make_horn_state(seed: int, cfg: HornConfig, step: int, device, *,
                    dp_size: int = 1,
                    rows: Optional[Tuple[int, int]] = None
                    ) -> Optional[HornState]:
    """The step's dropout context, or None with Horn off.
    ``num_groups=0`` means one group per data-parallel shard
    (``dp_size``), as in the JAX package.  ``rows``: (first row, global
    batch) when the layers see one data-parallel rank's rows of a global
    batch, so each row keeps its group by its global index."""
    if not cfg.enabled:
        return None
    groups = cfg.num_groups or max(1, dp_size)
    return HornState(seed=int(seed), step=int(step), cfg=cfg,
                     num_groups=groups, device=torch.device(device),
                     rows=rows)


def group_block_mask(u: torch.Tensor, keep: float) -> torch.Tensor:
    """[num_groups, n_blocks] mask with values in {0, 1/keep} (inverted
    dropout) from uniforms ``u`` of that shape: block live when u < keep.

    Guarantees at least one live block per group (a fully dropped layer
    would sever the sub-model): a group that drew all-dead keeps its
    argmax-u block."""
    nb = u.shape[-1]
    live = u < keep
    fallback = torch.nn.functional.one_hot(
        torch.argmax(u, dim=-1), nb).to(torch.bool)
    live = torch.where(live.any(dim=-1, keepdim=True), live, fallback)
    return live.to(f32) / keep


def expand_units(mask_blocks: torch.Tensor, units: int) -> torch.Tensor:
    """[G, nb] block mask -> [G, units] unit mask; the last block covers
    the remainder tail (the block->unit rule of the JAX package)."""
    G, nb = mask_blocks.shape
    per = units // nb
    m = torch.repeat_interleave(mask_blocks, per, dim=-1)     # [G, nb*per]
    if units % nb:
        m = torch.cat([m, m[:, -1:].expand(G, units % nb)], dim=-1)
    return m


def expand_mask(mask_blocks: torch.Tensor, units: int,
                batch: int) -> torch.Tensor:
    """[G, nb] -> [batch, 1, units]: group->sample expansion +
    block->unit."""
    G = mask_blocks.shape[0]
    m = expand_units(mask_blocks, units)                      # [G, units]
    reps = max(1, batch // G)
    m = torch.repeat_interleave(m, reps, dim=0)[:batch]       # [batch, units]
    return m[:, None, :]


def unit_mask(state: Optional[HornState], layer_idx: int, batch: int,
              units: int, *, keep: Optional[float] = None, salt: int = 0,
              block_size: Optional[int] = None):
    """The mask a layer multiplies its hidden units by, or None in eval
    mode."""
    if state is None:
        return None
    keep = state.cfg.keep_hidden if keep is None else keep
    if keep >= 1.0:
        return None
    bs = state.cfg.block_size if block_size is None else block_size
    nb = max(1, units // max(1, bs))
    u = state.uniform(layer_idx, salt, (state.num_groups, nb))
    mask = group_block_mask(u, keep)
    if state.rows is None:
        return expand_mask(mask, units, batch)
    start, total = state.rows        # rows map to groups by global index
    return expand_mask(mask, units, total)[start:start + batch]


def input_mask(state: Optional[HornState], batch: int, units: int):
    """Input-layer mask (paper: keep 0.8), applied to embedding channels."""
    if state is None:
        return None
    return unit_mask(state, 100_003, batch, units, keep=state.cfg.keep_input,
                     salt=7)


def head_mask(state: Optional[HornState], layer_idx: int, batch: int,
              heads: int):
    """Optional whole-attention-head dropout ([B, 1, H, 1]),
    beyond-paper."""
    if state is None or not state.cfg.mask_attention_heads:
        return None
    m = unit_mask(state, layer_idx, batch, heads, salt=13, block_size=1)
    if m is None:
        return None
    return m[..., None]                                       # [B, 1, H, 1]
