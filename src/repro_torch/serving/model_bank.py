"""ModelBank: G fixed Horn sub-models ("parallel circuits") of one parent.

The port of ``repro/serving/model_bank.py``.  Horn trains disconnected
sub-models that share the parent's weights (paper §2); this module is the
serving-side registry of those circuits.  Each sub-model is a fixed draw
of per-layer block masks over the axes ``core/submodel.plan`` names (FFN
hidden units, MoE expert hidden units, optional attention heads, optional
embedding channels), drawn once per bank from its seed.  All G circuits
share one parent parameter set and one page pool: the unified serving
step gathers each slot's mask rows by ``submodel_id`` on the device, so
tokens of different circuits co-batch in one tick.

The draw is the JAX package's, bit for bit: the keys are threefry keys
(``core/prng.py``), ``fold_in(fold_in(key(seed), seed_salt), axis)`` and
then the layer for the per-layer axes, the uniforms ``uniform(key, (G,
n_blocks))`` and the block rule ``parallel_dropout.group_block_mask``.

Masks are stored as {0., 1.}, not the train-time 1/keep: a served circuit
is the paper's materializable sub-model, and ``materialize`` gives the
same logits from physically smaller FFN weights.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import HornConfig, ModelConfig
from repro_torch.core import prng
from repro_torch.core import submodel as SM
from repro_torch.core.parallel_dropout import expand_units, group_block_mask

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DraftModel:
    """A materialized circuit packaged as a speculative-decoding draft:
    standalone weights, physically smaller, whose forward gives the masked
    parent forward of ``circuit``."""
    cfg: ModelConfig
    params: nn.Module
    circuit: int                        # bank circuit id it was cut from
    kept_frac: float                    # mean FFN keep fraction (reporting)


# plan() axis name -> serve-mask key that transformer.lm_forward reads
_AXIS_KEY = {"ffn_hidden": "ffn", "moe_hidden": "moe",
             "attn_heads": "heads", "input_embed": "input"}
# mask keys drawn per layer (the others once for the bank)
_PER_LAYER = {"ffn", "moe", "heads"}


def _draw(k: torch.Tensor, G: int, axis: SM.SubmodelAxis) -> np.ndarray:
    """[G, units] {0, 1} unit mask of one key: the block mask of
    ``uniform(k, (G, n_blocks))``, live where it is > 0, expanded to units
    by the train-time rule."""
    u = prng.uniform(k, (G, axis.n_blocks))
    live = (group_block_mask(u, axis.keep) > 0).to(f32)
    return expand_units(live, axis.units).numpy()


class ModelBank:
    """G sub-models of one parent, addressable by ``submodel_id`` in
    ``[0, num_submodels)``.  ``masks`` maps serve-mask keys to binary f32
    arrays: "input" [G, d_model]; "ffn" [G, L, d_ff]; "moe" [G, L, moe_ff];
    "heads" [G, L, H]; only the axes the Horn config masks exist."""

    def __init__(self, cfg: ModelConfig, horn: HornConfig,
                 num_submodels: int, *, seed: int = 0):
        if num_submodels < 1:
            raise ValueError("need at least one submodel")
        if cfg.ssm_state:
            raise ValueError(
                "ModelBank serves attention LMs (SSM channel masks are "
                "train-only; paged serving rejects SSM mixers anyway)")
        self.cfg, self.horn, self.seed = cfg, horn, seed
        self.num_submodels = num_submodels
        self.masks: Dict[str, np.ndarray] = {}
        self._device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

        G, L = num_submodels, cfg.num_layers
        base = prng.fold_in(prng.key(seed), horn.seed_salt)
        for ai, axis in enumerate(SM.plan(cfg, horn)):
            name = _AXIS_KEY.get(axis.name)
            if name is None or axis.keep >= 1.0:
                continue
            k_ax = prng.fold_in(base, ai)
            if name in _PER_LAYER:
                self.masks[name] = np.stack(
                    [_draw(prng.fold_in(k_ax, li), G, axis)
                     for li in range(L)], axis=1)
            else:
                self.masks[name] = _draw(k_ax, G, axis)
        if not self.masks:
            raise ValueError(
                "bank has no masked axes (every keep rate >= 1.0) — G "
                "identical dense circuits; lower keep_hidden/keep_input")

    # -- serving ------------------------------------------------------------
    def device_masks(self, device="cuda") -> Dict[str, torch.Tensor]:
        """The mask tensors the unified step gathers per slot: f32 on
        ``device``, cached per device.  Row ``num_submodels`` (one past the
        last circuit) is the all-ones *dense sentinel*: gathering it runs
        the unmasked parent, which encodes an ensemble's shared prompt
        context once for all G members."""
        dev = resolve_device(device)
        if dev not in self._device:
            self._device[dev] = {
                k: torch.cat([torch.from_numpy(v),
                              torch.ones((1,) + v.shape[1:], dtype=f32)]
                             ).to(dev)
                for k, v in self.masks.items()}
        return self._device[dev]

    def device_bytes(self) -> int:
        """Bytes of ``device_masks`` (G + 1 rows of every mask, f32)."""
        return sum((self.num_submodels + 1) * v[0].size * 4
                   for v in self.masks.values())

    def subset(self, ids: Sequence[int]) -> "ModelBank":
        """A bank view holding only ``ids`` (same mask rows, re-indexed from
        0): ``bank.subset([g])`` is the dedicated one-circuit bank."""
        sub = object.__new__(ModelBank)
        sub.cfg, sub.horn, sub.seed = self.cfg, self.horn, self.seed
        sub.num_submodels = len(ids)
        sub.masks = {k: v[np.asarray(ids)] for k, v in self.masks.items()}
        sub._device = {}
        return sub

    # -- export (the paper's memory-reduction claim) ------------------------
    def materialize(self, g: int, params) -> Tuple[ModelConfig, nn.Module]:
        """Circuit ``g`` as a standalone model with physically smaller FFN
        weights: (small_cfg, small_params) whose forward gives the masked
        parent forward of submodel ``g``.  FFN-only: a bank that also masks
        embedding channels or heads keeps those tensors' shapes, so it is
        refused.  Every layer is zero-padded to the widest kept width
        (exact: see ``submodel.materialize_units``)."""
        if not 0 <= g < self.num_submodels:
            raise ValueError(f"submodel {g} not in bank of "
                             f"{self.num_submodels}")
        extra = set(self.masks) - {"ffn"}
        if extra:
            raise ValueError(
                f"materialize is FFN-only; bank also masks {sorted(extra)}")
        if "ffn" not in self.masks:
            raise ValueError("bank has no FFN masks (keep_hidden >= 1?)")
        cfg = self.cfg
        if any(cfg.layer_is_moe(i) for i in range(cfg.num_layers)):
            raise ValueError("materialize does not support MoE layers")

        rows = self.masks["ffn"][g]                     # [L, d_ff]
        ffk = int(max((row > 0).sum() for row in rows))
        small = copy.deepcopy(params)
        for blk, row in zip(small.layers, rows):
            mlp = blk.mlp
            names = [n for n in ("wi", "wg", "wo") if hasattr(mlp, n)]
            cut = SM.materialize_units({n: getattr(mlp, n) for n in names},
                                       row, pad_to=ffk)
            for n in names:
                setattr(mlp, n, nn.Parameter(cut[n], requires_grad=False))
        small_cfg = dataclasses.replace(cfg, d_ff=ffk,
                                        name=f"{cfg.name}-sub{g}")
        return small_cfg, small

    def draft_model(self, g: int, params) -> DraftModel:
        """Circuit ``g`` packaged as a speculative-decoding draft (its
        acceptance tracks how often it agrees with the verifier, so prefer
        the highest-keep circuit you can afford)."""
        cfg, p = self.materialize(g, params)
        return DraftModel(cfg, p, g,
                          float((self.masks["ffn"][g] > 0).mean()))

    # -- reporting ----------------------------------------------------------
    def kept_fractions(self) -> Dict[str, List[float]]:
        """Per-submodel mean kept fraction per masked axis."""
        return {k: [float((v[g] > 0).mean())
                    for g in range(self.num_submodels)]
                for k, v in self.masks.items()}
