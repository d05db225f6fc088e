"""Irregular sub-model partitioning (paper §2, Fig. 2 right).

A copy of ``repro/core/submodel.py``.  Horn partitions the parent model
into disconnected sub-models that share the input and output layers and
the weights.  This module is the planner around the per-step masks in
``parallel_dropout``:

  * :func:`plan` — the per-layer unit axes that sub-models are drawn over,
    block-aligned for the ``dropout_matmul`` kernel;
  * :func:`draw` — a group's block membership from uniforms, as
    ``parallel_dropout.group_block_mask`` takes them;
  * :func:`materialize` / :func:`materialize_units` — group g's *actual
    smaller weights*: only the kept units' columns exist;
  * :func:`stats` — compute/memory savings of drawn sub-models.

The JAX package draws with threefry keys; the port's ``stats`` takes a
seed instead and tests hand both packages the same uniforms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import HornConfig, ModelConfig
from repro_torch.core import parallel_dropout as pdrop


@dataclass(frozen=True)
class SubmodelAxis:
    """One unit axis a sub-model is drawn over."""

    name: str            # e.g. "ffn_hidden", "ssm_channels", "moe_hidden"
    units: int
    keep: float
    block_size: int

    @property
    def n_blocks(self) -> int:
        return max(1, self.units // max(1, self.block_size))


def plan(cfg: ModelConfig, horn: HornConfig) -> List[SubmodelAxis]:
    """The sub-model axes for an architecture."""
    axes: List[SubmodelAxis] = []
    bs = horn.block_size
    if cfg.d_ff > 0:
        axes.append(SubmodelAxis("ffn_hidden", cfg.d_ff, horn.keep_hidden, bs))
    if cfg.num_experts:
        axes.append(SubmodelAxis("moe_hidden", cfg.moe_ff, horn.keep_hidden,
                                 bs))
    if cfg.ssm_state:
        d_in = cfg.ssm_expand * cfg.d_model
        axes.append(SubmodelAxis("ssm_channels", d_in, horn.keep_hidden, bs))
    if horn.mask_attention_heads and cfg.has_attention:
        axes.append(SubmodelAxis("attn_heads", cfg.num_heads,
                                 horn.keep_hidden, 1))
    axes.append(SubmodelAxis("input_embed", cfg.d_model, horn.keep_input, bs))
    return axes


def draw(u: torch.Tensor, axis: SubmodelAxis) -> torch.Tensor:
    """[G, n_blocks] sub-model membership (values {0, 1/keep}) from
    uniforms ``u`` of that shape."""
    if u.shape[-1] != axis.n_blocks:
        raise ValueError(f"draw: {u.shape[-1]} uniforms a group for axis "
                         f"{axis.name!r} of {axis.n_blocks} blocks")
    return pdrop.group_block_mask(u, axis.keep)


def _host(mask) -> np.ndarray:
    """A mask (numpy array or tensor on any device) as a numpy array."""
    return torch.as_tensor(mask).detach().cpu().numpy()


def materialize(wi: torch.Tensor, wo: torch.Tensor, mask_blocks,
                block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group g's *physically smaller* FFN weights.

    wi: [d, ff]; wo: [ff, d]; mask_blocks: [n_blocks] for ONE group.
    Returns (wi_kept [d, ff_kept], wo_kept [ff_kept, d]): only the kept
    neurons' weights exist."""
    keep_cols = np.repeat(_host(mask_blocks) > 0, block_size)
    keep_cols = keep_cols[: wi.shape[1]]
    idx = torch.from_numpy(np.nonzero(keep_cols)[0]).to(wi.device)
    return wi.index_select(1, idx), wo.index_select(0, idx)


def materialize_units(mlp: Dict[str, torch.Tensor], mask_units, *,
                      pad_to: int = 0) -> Dict[str, torch.Tensor]:
    """Per-unit sibling of :func:`materialize` for one MLP's weights
    ({"wi" [d, ff], "wo" [ff, d], optional "wg" [d, ff]}): gathers the live
    hidden units of a *fixed* sub-model mask row ([ff] in {0, 1}) and
    zero-pads the kept axis up to ``pad_to`` columns.

    Zero padding is exact: a zero ``wi`` column makes the unit's
    pre-activation 0, and silu/gelu/relu(0) == 0 (for gated MLPs the gate
    multiplies a 0 ``up``), so padded units contribute nothing."""
    idx = np.nonzero(_host(mask_units) > 0)[0]
    pad = max(0, pad_to - len(idx))
    out: Dict[str, torch.Tensor] = {}
    for name, w in mlp.items():
        axis = 0 if name == "wo" else 1
        kept = w.index_select(axis, torch.from_numpy(idx).to(w.device))
        if pad:
            shape = list(kept.shape)
            shape[axis] = pad
            kept = torch.cat([kept, kept.new_zeros(shape)], dim=axis)
        out[name] = kept
    return out


def stats(cfg: ModelConfig, horn: HornConfig, seed: int = 0,
          num_groups: int = 8) -> Dict[str, float]:
    """Measured (not nominal) compute/memory savings of drawn sub-models;
    axis i draws its uniforms from a generator seeded with (seed, i)."""
    out: Dict[str, float] = {}
    for i, axis in enumerate(plan(cfg, horn)):
        gen = torch.Generator().manual_seed(
            int(np.random.SeedSequence([seed, i]).generate_state(1)[0]))
        u = torch.rand((num_groups, axis.n_blocks), generator=gen)
        dropped = float((draw(u, axis) == 0).float().mean())
        out[f"{axis.name}_dropped_frac"] = dropped
        out[f"{axis.name}_flops_saved"] = dropped     # tiles skipped by kernel
        out[f"{axis.name}_weights_saved"] = dropped   # via materialize()
    return out
