"""Shared layers: norms, RoPE, the gated MLP (dense and block-sparse), the
sort-based mixture of experts, embeddings.

Parameters live in ``nn.Module`` containers whose attributes keep the JAX
package's names and shapes (``scale``, ``wi``/``wg``/``wo``, ``router``,
``embedding``); the math is plain functions ``<name>_apply(params, x, cfg)``
as in ``repro.models.layers``.  Each container is built from a ``make``
callable, ``make(shape, init) -> nn.Parameter``, so one declaration serves
both random init and the weight bridge (``models/params.py``).  Each
container's ``AXES`` names the logical sharding axes of its leaves, the
ones the JAX ``ParamSpec``s declare (``launch/mesh.py`` maps them to mesh
dims; ``params.param_axes`` collects them).

Dtypes follow the JAX package: where jnp promotes a bf16 activation times
an f32 weight to f32, ``mm`` casts both to the promoted type explicitly
(``torch.matmul`` refuses mixed dtypes).
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dropout_matmul.ops import dropout_matmul

f32 = torch.float32

ACTS = {
    "silu": F.silu,
    "gelu": partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def mm(eq: str, a, b, out_dtype=None):
    """``einsum`` in the promoted dtype of ``a`` and ``b`` (jnp's rule),
    cast to ``out_dtype`` when given (jnp's ``preferred_element_type``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    y = torch.einsum(eq, a.to(dt), b.to(dt))
    return y if out_dtype is None else y.to(out_dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    """RMSNorm weight ``scale`` (applied as ``1 + scale``, zeros at init) or
    LayerNorm ``scale``/``bias``."""

    AXES = {"scale": ("noshard",), "bias": ("noshard",)}

    def __init__(self, cfg: ModelConfig, dim: int, make):
        super().__init__()
        self.scale = make((dim,), "zeros" if cfg.norm == "rmsnorm" else "ones")
        if cfg.norm == "layernorm":
            self.bias = make((dim,), "zeros")


def norm_apply(params, x, cfg: ModelConfig):
    """RMSNorm/LayerNorm: statistics in f32, elementwise math in x.dtype."""
    # the (D,) weights at x's rank, as the JAX package writes them (rank
    # clean under --sanitize's strict rank promotion; same numbers)
    def wide(w):
        return w.to(x.dtype).view((1,) * (x.dim() - 1) + (-1,))

    if cfg.norm == "rmsnorm":
        var = x.to(f32).square().mean(-1, keepdim=True)
        mult = torch.rsqrt(var + cfg.norm_eps).to(x.dtype)
        y = x * mult * wide(1.0 + params.scale)
    else:
        xf = x.to(f32)
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        mult = torch.rsqrt(var + cfg.norm_eps)
        y = ((x - mu.to(x.dtype)) * mult.to(x.dtype)
             * wide(params.scale) + wide(params.bias))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=f32, device=device)
                     / head_dim)


def apply_rope(x, positions, theta: float):
    """Rotate-half RoPE in f32.  x: [..., S, H, D]; positions: [..., S]."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                # [D/2]
    pos = positions[..., :, None].to(f32)               # [..., S, 1]
    ang = pos * inv.view((1,) * (pos.dim() - 1) + (-1,))  # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU): dense path and Horn's block-sparse path
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    AXES = {"wi": ("embed", "ffn"), "wo": ("ffn", "embed"),
            "wg": ("embed", "ffn")}

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.wi = make((d, ff))
        self.wo = make((ff, d))
        if cfg.mlp_gated:
            self.wg = make((d, ff))


def mlp_apply(params, x, cfg: ModelConfig, *, hidden_mask=None,
              mask_blocks=None):
    """x: [B, S, d] -> [B, S, d], in x.dtype on the dense path (the down
    projection keeps the activation dtype, as
    ``preferred_element_type=x.dtype`` does).

    ``hidden_mask`` ([B, 1, ff]-broadcastable, or None) is Horn's per-group
    structured neuron mask, already scaled by 1/keep; it multiplies the
    hidden units before the down projection.

    ``mask_blocks`` ([G, ff / block] in {0, 1/keep}) takes the block-sparse
    path instead (and wins over ``hidden_mask``): the up and gate products
    run through ``dropout_matmul``, whose dropped blocks skip their work.
    Same semantics as the masked dense path, forward-only."""
    act = ACTS[cfg.act]
    if mask_blocks is not None:
        return _mlp_blocks(params, x, cfg, act, mask_blocks)
    up = mm("...d,df->...f", x, params.wi)
    if cfg.mlp_gated:
        h = act(mm("...d,df->...f", x, params.wg)) * up
    else:
        h = act(up)
    if hidden_mask is not None:
        h = h * hidden_mask.to(h.dtype)
    return mm("...f,fd->...d", h, params.wo, x.dtype)


def _mlp_blocks(params, x, cfg: ModelConfig, act, mask_blocks):
    """The block branch of the JAX ``mlp_apply``, rule for rule.  Sample b
    belongs to group ``b // (B // G)`` (``expand_mask``'s rule).  The
    activation runs on the kernel's f32 output; ``h`` is then cast to
    x.dtype and the down projection keeps the promoted dtype (f32 weights
    give f32 out, unlike the dense path)."""
    B, S, d = x.shape
    G, nb = mask_blocks.shape
    if B % G:
        raise ValueError(f"mlp_apply: batch {B} does not split into {G} "
                         f"groups of mask_blocks")
    block_n = cfg.d_ff // nb
    xg = x.reshape(G, (B // G) * S, d)
    mask_blocks = mask_blocks.to(f32).contiguous()
    # gate uses a {0, 1} mask (masking inside the activation is wrong);
    # the 1/keep scale rides on the up projection
    blocks01 = (mask_blocks > 0).to(f32)

    def product(w, mask):
        dt = torch.promote_types(x.dtype, w.dtype)
        return dropout_matmul(xg.to(dt).contiguous(), w.to(dt).contiguous(),
                              mask, block_n=block_n)

    if cfg.mlp_gated:
        h = act(product(params.wg, blocks01)) * product(params.wi,
                                                        mask_blocks)
    else:
        # act(up * s) != act(up) * s, so mask {0, 1} first, scale after
        mask = torch.repeat_interleave(mask_blocks, block_n, dim=-1)
        h = act(product(params.wi, blocks01)) * mask[:, None, :]
    h = h.to(x.dtype).reshape(B, S, cfg.d_ff)
    return mm("...f,fd->...d", h, params.wo)


# ---------------------------------------------------------------------------
# Mixture of experts (sort-based, static-capacity dispatch)
# ---------------------------------------------------------------------------
MOE_AUX = ("load_balance_loss", "router_z_loss", "dropped_frac")


class MoE(nn.Module):
    """``router`` [d, E] and the experts' ``wi``/``wg``/``wo`` [E, d, ff]
    / [E, ff, d] (``wg`` when the MLP is gated)."""

    AXES = {"router": ("embed", "experts"),
            "wi": ("experts", "embed", "moe_ffn"),
            "wo": ("experts", "moe_ffn", "embed"),
            "wg": ("experts", "embed", "moe_ffn")}

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.moe_ff, cfg.num_experts
        self.router = make((d, e))
        self.wi = make((e, d, ff))
        self.wo = make((e, ff, d))
        if cfg.mlp_gated:
            self.wg = make((e, d, ff))


def _positions_in_segment(sorted_ids, length: int):
    """Rank of each element of the (last-axis) sorted expert ids within its
    run of equal ids."""
    # the positions at the ids' rank, as the JAX package's per-row (vmap)
    # code has them (rank clean under --sanitize)
    idx = torch.arange(length, device=sorted_ids.device).expand(
        sorted_ids.shape)
    is_start = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_start[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    starts = torch.where(is_start, idx, torch.zeros_like(idx))
    return idx - torch.cummax(starts, dim=-1).values


def _route_row(flat_e, num_experts: int):
    """Routing bookkeeping of rows of expert ids ``flat_e`` [..., S*K]:
    (each choice's position within its expert [..., S*K], counts per expert
    [..., E], the stable sort order by expert [..., S*K]).  Choices of one
    expert keep their flat order, so a row's right padding sorts after its
    valid tokens."""
    n = flat_e.shape[-1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    pos_sorted = _positions_in_segment(torch.gather(flat_e, -1, order), n)
    pos = torch.empty_like(order).scatter_(-1, order, pos_sorted)
    counts = torch.zeros(flat_e.shape[:-1] + (num_experts,),
                         dtype=torch.long, device=flat_e.device)
    counts.scatter_add_(-1, flat_e.long(), torch.ones_like(flat_e,
                                                           dtype=torch.long))
    return pos, counts, order


def moe_capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert in a row of ``S`` tokens: ceil(S K cf / E) in
    floats, at least 4 and at most S K (the JAX package's rule, so the
    expert drops of a prompt depend on the chunk it arrives in)."""
    E, K = cfg.num_experts, cfg.experts_per_tok
    C = -(-S * K * cfg.capacity_factor // E) if E else S
    return max(4, min(int(C), S * K))


class MoERouting(NamedTuple):
    """One call's routing: router ``logits`` (f32) and ``probs`` [R, S, E],
    the top-K ``gate_w`` (renormalised) and ``gate_e`` [R, S, K], each
    choice's ``pos`` within its expert, the expert ``counts`` [R, E], the
    stable sort ``order`` and ``keep`` (pos < capacity) [R, S*K], and the
    capacity ``C``."""
    logits: torch.Tensor
    probs: torch.Tensor
    gate_w: torch.Tensor
    gate_e: torch.Tensor
    pos: torch.Tensor
    counts: torch.Tensor
    order: torch.Tensor
    keep: torch.Tensor
    C: int


def moe_route(params, xr, cfg: ModelConfig) -> MoERouting:
    """The routing of rows ``xr`` [R, S, d]: the router's logits (in x's
    dtype, then f32) give softmax probabilities, each token takes its top
    ``experts_per_tok`` (ties to the lower expert, as ``lax.top_k``) with
    gates renormalised over them, and the choices are ranked within their
    expert in the stable sort order; a choice past ``moe_capacity`` is
    dropped."""
    R, S, _ = xr.shape
    K = cfg.experts_per_tok
    logits = mm("rsd,de->rse", xr, params.router).to(f32)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = gate_w[..., :K], gate_e[..., :K]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    pos, counts, order = _route_row(gate_e.reshape(R, S * K),
                                    cfg.num_experts)
    C = moe_capacity(cfg, S)
    return MoERouting(logits, probs, gate_w, gate_e, pos, counts, order,
                      pos < C, C)


def moe_apply(params, x, cfg: ModelConfig, *, hidden_mask=None,
              with_aux: bool = True):
    """x [..., S, d] -> (out [..., S, d], aux dict, empty without
    ``with_aux``), the JAX package's ``moe_apply`` rule for rule.

    Routing is per row (one sequence, GShard's group = sequence;
    ``moe_route``); the choices are gathered in their sort order into a
    static [R, E, C, d] buffer, the expert FFN runs as batched products
    over all E x C slots (under the profiler scope ``moe_ffn``), and each
    kept choice reads its slot back, weighted by its gate.  Choices past
    an expert's capacity are dropped (the residual carries the token).
    ``hidden_mask`` ([B, 1, 1, ff]-broadcastable) multiplies the experts'
    hidden units.  aux: ``load_balance_loss`` (E times the routed
    fractions dotted with the mean router mass), ``router_z_loss`` (mean
    squared logsumexp of the logits) and ``dropped_frac``, all f32
    scalars; serving, which reads none of them, passes ``with_aux=False``."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xr = x.reshape((-1,) + tuple(orig_shape[-2:]))      # [R, S, d] rows
    R, S, _ = xr.shape
    E, K = cfg.num_experts, cfg.experts_per_tok
    act = ACTS[cfg.act]
    rt = moe_route(params, xr, cfg)
    C, counts, order, keep = rt.C, rt.counts, rt.order, rt.keep
    flat_e = rt.gate_e.reshape(R, S * K)

    # dispatch: [R, E, C] source tokens from the sort order
    slots = torch.arange(C, device=x.device)
    starts = torch.cumsum(counts, dim=-1) - counts              # [R, E]
    slot_idx = torch.clamp(starts[:, :, None] + slots[None, None, :], 0,
                           S * K - 1)
    slot_valid = slots[None, None, :] < torch.clamp(counts, max=C)[:, :, None]
    src_tok = torch.gather(order, 1, slot_idx.reshape(R, E * C)) // K
    disp = torch.gather(xr, 1, src_tok[..., None].expand(-1, -1, d))
    disp = disp.reshape(R, E, C, d) * slot_valid[..., None].to(x.dtype)

    with torch.profiler.record_function("moe_ffn"):
        up = mm("recd,edf->recf", disp, params.wi)
        if cfg.mlp_gated:
            h = act(mm("recd,edf->recf", disp, params.wg)) * up
        else:
            h = act(up)
        if hidden_mask is not None:
            h = h * hidden_mask.to(h.dtype)
        eout = mm("recf,efd->recd", h, params.wo)

    # combine: each (token, k) reads its slot (e, pos) if kept
    slot_of_choice = flat_e * C + torch.clamp(rt.pos, 0, C - 1)  # [R, S*K]
    gathered = torch.gather(eout.reshape(R, E * C, d), 1,
                            slot_of_choice[..., None].expand(-1, -1, d))
    gathered = gathered.reshape(R, S, K, d) * keep.reshape(
        R, S, K, 1).to(x.dtype)
    out = mm("rskd,rsk->rsd", gathered, rt.gate_w.to(x.dtype))
    if not with_aux:
        return out.reshape(orig_shape), {}

    me = F.one_hot(rt.gate_e, E).to(f32).mean(dim=(0, 1, 2))  # frac routed
    ce = rt.probs.mean(dim=(0, 1))                             # router mass
    aux = {"load_balance_loss": E * (me * ce).sum(),
           "router_z_loss": (torch.logsumexp(rt.logits, dim=-1) ** 2).mean(),
           "dropped_frac": 1.0 - keep.to(f32).mean()}
    return out.reshape(orig_shape), aux


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
class Embed(nn.Module):
    AXES = {"embedding": ("vocab", "embed"), "unembed": ("embed", "vocab")}

    def __init__(self, cfg: ModelConfig, make):
        super().__init__()
        self.embedding = make((cfg.vocab_size, cfg.d_model))
        if not cfg.tie_embeddings:
            self.unembed = make((cfg.d_model, cfg.vocab_size))


def embed_apply(params, tokens, cfg: ModelConfig):
    """Rows of the embedding in ``cfg.dtype`` (bf16 unless the config says
    otherwise, whatever the compute dtype); gemma scales by sqrt(d)."""
    x = params.embedding[tokens].to(dtype_of(cfg.dtype))
    if cfg.post_sublayer_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=f32).to(x.dtype)
    return x


def unembed_apply(params, x, cfg: ModelConfig):
    w = params.unembed if hasattr(params, "unembed") else params.embedding.T
    logits = mm("...d,dv->...v", x, w.to(x.dtype))
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits
