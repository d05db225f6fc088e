"""Parameter init and the weight bridge from the JAX package.

``init_params`` builds the model with the JAX package's per-leaf rule
(``repro/models/params.py::_init_leaf``): normal with std
``scale / sqrt(fan_in)``, fan-in being the leaf's first dimension (the
unstacked one, so E for an expert leaf [E, d, ff]: std 0.25 at 16
experts), ``ones * scale``, and zeros for RMSNorm scales and biases
(``scale`` is the spec's: 0.5 for mamba's ``A_log`` and convs, else 1).  The numbers come
from a ``torch.Generator``, so they differ from JAX's for the same seed;
tests that compare the two packages carry weights over with
``load_jax_flat`` instead.

``load_jax_flat`` reads the flat ``{keystr: array}`` mapping that
``repro/checkpoint/checkpointer.py`` writes to ``shard_0.npz`` (or the path
of such a file), unstacks the ``[R, ...]`` superblock leaves into the
per-layer blocks and keeps every other shape as it is; ``to_jax_flat`` is
its inverse.  An encoder-decoder's leaves sit under ``['encoder']`` (its
``['blocks']['l0']`` stacked over ``num_encoder_layers``) and
``['decoder']`` (an LM's layout), the port's under ``encoder.`` and
``decoder.``.  ``load_jax_cache``/``to_jax_cache`` carry a cache pytree
(numpy leaves) to and from the port's per-layer list the same way: a dense
decode cache (``repro/models/transformer.py::init_cache``) or a paged one
(``init_paged_cache``), whose int8 layers are 4-tuples of int8 pools and
f32 [P, KH] scales, bit for bit.

A train step differentiates a ``cast_params`` copy of the f32 masters (the
JAX step differentiates ``cast_tree(params, compute_dtype)``), refreshed
from them by ``copy_into`` each step.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDec, encoder_cfg
from repro_torch.models.transformer import LM

Model = Union[LM, EncDec]


def _maker(fill, device, dtype):
    def make(shape, init: str = "normal", scale: float = 1.0):
        return nn.Parameter(fill(tuple(shape), init, scale, device, dtype),
                            requires_grad=False)
    return make


def model_class(cfg: ModelConfig):
    """``EncDec`` for an encoder-decoder config, else ``LM``."""
    return EncDec if cfg.is_encoder_decoder else LM


def init_params(cfg: ModelConfig, generator, *, device="cuda",
                dtype=torch.float32) -> Model:
    """A randomly initialized model (``model_class(cfg)``) on ``device`` in
    ``dtype``.  ``generator`` is a ``torch.Generator`` on ``device``, or an
    int seed for one."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(dev).manual_seed(generator)

    def fill(shape, init, scale, device, dtype):
        if init == "zeros":
            return torch.zeros(shape, device=device, dtype=dtype)
        if init == "ones":
            return torch.full(shape, scale, device=device, dtype=dtype)
        std = scale / np.sqrt(max(1, shape[0]))
        # in place: one f32 temporary a leaf (an expert leaf of jamba is
        # 3.2 B values)
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32).mul_(std).to(dtype)

    return model_class(cfg)(cfg, _maker(fill, dev, dtype))


def empty_params(cfg: ModelConfig, device, dtype=torch.float32) -> Model:
    """``model_class(cfg)`` with uninitialized parameters on ``device``
    (``"meta"``: shapes only)."""
    return model_class(cfg)(cfg, _maker(
        lambda shape, init, scale, device, dtype: torch.empty(
            shape, device=device, dtype=dtype), torch.device(device), dtype))


_KEY = re.compile(r"\['([^'\]]*)'\]")


def _stacks(cfg: ModelConfig):
    """[(torch name prefix, JAX key, the config of that layer stack)]: the
    LM alone, or an encoder-decoder's encoder and decoder."""
    if cfg.is_encoder_decoder:
        return [("encoder.", "encoder", encoder_cfg(cfg)),
                ("decoder.", "decoder", cfg)]
    return [("", None, cfg)]


def _torch_names(key: str, cfg: ModelConfig):
    """JAX keystr -> [(torch parameter name, superblock index or None)]."""
    path = _KEY.findall(key)
    if not path or "".join(f"['{p}']" for p in path) != key:
        raise KeyError(f"not a keystr of dict keys: {key!r}")
    for prefix, jkey, scfg in _stacks(cfg):
        if jkey is None or path[0] == jkey:
            break
    else:
        raise KeyError(f"{key}: not under {[s[1] for s in _stacks(cfg)]}")
    if jkey is not None:
        path = path[1:]
    P, R = len(scfg.layer_pattern), scfg.pattern_repeats
    head, rest = path[0], ".".join(path[2:])
    if head == "blocks":
        i = int(path[1][1:])
        return [(f"{prefix}layers.{r * P + i}.{rest}", r) for r in range(R)]
    if head == "rem":
        return [(f"{prefix}layers.{R * P + int(path[1][1:])}.{rest}", None)]
    return [(prefix + ".".join(path), None)]


def load_jax_flat(flat: Union[Mapping[str, np.ndarray], str, os.PathLike],
                  cfg: ModelConfig, *, device="cuda", dtype=torch.float32,
                  prefix: str = "",
                  into: Optional[Mapping[str, torch.Tensor]] = None):
    """The model (``model_class(cfg)``) holding the JAX parameters in
    ``flat``: a ``{keystr: array}``
    mapping or the path of a ``shard_0.npz``.  Only keys starting with
    ``prefix`` are read (``"['params']"`` for a train-state checkpoint),
    with the prefix stripped.  Missing, extra or mis-shaped leaves raise.

    ``into``: a mapping of the model's parameter names to tensors (an
    optimizer moment a parameter, ``"['opt']['mom']"`` as the prefix) is
    filled in place and returned instead of a new model."""
    dev = resolve_device(device)
    if isinstance(flat, (str, os.PathLike)):
        with np.load(flat) as npz:
            flat = {k: npz[k] for k in npz.files}
    if into is None:
        model = empty_params(cfg, dev, dtype)
        want: Mapping[str, torch.Tensor] = dict(model.named_parameters())
    else:
        model = want = into
    seen = set()
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        arr = np.asarray(arr)
        names = _torch_names(key[len(prefix):], cfg)
        for name, r in names:
            if name not in want:
                raise KeyError(f"{key}: no parameter {name!r} in the port's "
                               f"{cfg.name} model")
            if r is not None and arr.shape[:1] != (len(names),):
                raise ValueError(f"{key}: leading dim {arr.shape[:1]}, "
                                 f"expected {len(names)} superblocks")
            leaf = arr if r is None else arr[r]
            p = want[name]
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{key} -> {name}: shape {leaf.shape}, "
                                 f"expected {tuple(p.shape)}")
            p.data.copy_(torch.tensor(leaf))
            seen.add(name)
    missing = sorted(set(want) - seen)
    if missing:
        raise KeyError(f"{cfg.name}: no value for {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}")
    return model


def _jax_key(name: str, cfg: ModelConfig
             ) -> Tuple[str, Optional[int], int]:
    """A torch parameter name -> (its JAX keystr, its superblock index r
    when it is one of the ``[R, ...]`` stacked leaves, else None, and the
    R of its stack)."""
    for prefix, jkey, scfg in _stacks(cfg):
        if name.startswith(prefix):
            break
    else:
        raise KeyError(f"{name}: not a parameter of a {cfg.name} model")
    P, R = len(scfg.layer_pattern), scfg.pattern_repeats
    parts = name[len(prefix):].split(".")
    head = [] if jkey is None else [jkey]
    r = None
    if parts[0] == "layers":
        idx, rest = int(parts[1]), parts[2:]
        if idx < R * P:
            r, i = divmod(idx, P)
            parts = ["blocks", f"l{i}", *rest]
        else:
            parts = ["rem", f"r{idx - R * P}", *rest]
    return "".join(f"['{s}']" for s in [*head, *parts]), r, R


def to_jax_flat(model: Union[Model, Mapping[str, torch.Tensor]],
                cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The JAX package's flat ``{keystr: array}`` layout of ``model``: the
    per-layer blocks restacked into ``[R, ...]`` superblock leaves
    (``['blocks']['l{i}']``) and remainder layers (``['rem']['r{i}']``),
    under ``['encoder']`` / ``['decoder']`` for an encoder-decoder; bf16
    leaves come out as f32 arrays.  ``model`` may also be a mapping of the
    model's parameter names to tensors (an optimizer moment a parameter),
    laid out by the same paths.  A DTensor leaf is gathered whole first
    (``full_tensor``: every rank of its mesh must call this)."""
    stacks: Dict[str, list] = {}
    flat: Dict[str, np.ndarray] = {}
    named = (model.named_parameters() if isinstance(model, nn.Module)
             else model.items())
    for name, p in named:
        t = p.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        key, r, R = _jax_key(name, cfg)
        if r is None:
            flat[key] = arr
        else:
            stacks.setdefault(key, [None] * R)[r] = arr
    for key, leaves in stacks.items():
        flat[key] = np.stack(leaves)
    return flat


def layer_axes(model: nn.Module) -> Dict[str, Tuple]:
    """{parameter name: its logical axes}, from the ``AXES`` of the module
    that owns each parameter (``models/layers.py``)."""
    out = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        out[name] = type(model.get_submodule(owner)).AXES[leaf]
    return out


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """{JAX keystr: logical axes}: the axes JAX's spec tree declares for
    every leaf of ``cfg``'s model (``repro/models/params.py::param_axes``
    flattened by keystr), stacked leaves with their leading "layers".  The
    model is built on the meta device: no memory at any width."""
    out = {}
    for name, axes in layer_axes(empty_params(cfg, "meta")).items():
        key, r, _ = _jax_key(name, cfg)
        out[key] = axes if r is None else ("layers",) + axes
    return out


def load_jax_cache(tree: Mapping, cfg: ModelConfig, *, device="cuda"
                   ) -> List[Tuple[torch.Tensor, ...]]:
    """The port's per-layer cache holding the JAX cache ``tree``:
    ``{"blocks": {"l{i}": (a, b, ...)}}`` with ``[R, ...]`` stacked leaves,
    and ``{"rem": {"r{i}": (a, b, ...)}}`` for remainder layers.  Each
    layer gets its tuple as it is: ``(k, v)``, ``(conv_state,
    ssm_state)``, paged ``(k_pages, v_pages)`` or the int8 paged
    ``(k_pages, v_pages, k_scale, v_scale)``, in the leaves' dtypes (bf16
    arrives as f32 numpy and stays f32; cast after loading where it
    matters)."""
    dev = resolve_device(device)
    P, R = len(cfg.layer_pattern), cfg.pattern_repeats
    cache: List = [None] * cfg.num_layers
    for r in range(R):
        for i in range(P):
            cache[r * P + i] = tuple(
                torch.tensor(np.asarray(leaf)[r], device=dev)
                for leaf in tree["blocks"][f"l{i}"])
    for i in range(cfg.pattern_remainder):
        cache[R * P + i] = tuple(torch.tensor(np.asarray(leaf), device=dev)
                                 for leaf in tree["rem"][f"r{i}"])
    return cache


def to_jax_cache(cache, cfg: ModelConfig) -> Dict[str, Dict]:
    """The JAX package's cache pytree of the port's per-layer ``cache``
    (tuples of any length, as ``load_jax_cache`` takes them): numpy leaves,
    superblock layers restacked into ``[R, ...]``; bf16 leaves come out as
    f32 arrays, int8 and f32 leaves as they are."""
    P, R = len(cfg.layer_pattern), cfg.pattern_repeats

    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    tree: Dict[str, Dict] = {}
    if R:
        tree["blocks"] = {
            f"l{i}": tuple(np.stack([arr(cache[r * P + i][k])
                                     for r in range(R)])
                           for k in range(len(cache[i])))
            for i in range(P)}
    if cfg.pattern_remainder:
        tree["rem"] = {f"r{i}": tuple(arr(t) for t in cache[R * P + i])
                       for i in range(cfg.pattern_remainder)}
    return tree


@torch.no_grad()
def copy_into(dst: Model, src: Model) -> Model:
    """Cast ``src``'s parameters into ``dst``'s, in place (a no-op when they
    are the same LM)."""
    if dst is not src:
        for d, s in zip(dst.parameters(), src.parameters()):
            d.copy_(s)
    return dst


@torch.no_grad()
def cast_params(model: Model, dtype) -> Model:
    """``model`` with floating parameters in ``dtype``: itself when they
    already are, else a cast copy (the caller's model is left alone).  The
    copy is a ``deepcopy`` whose memo maps each parameter to its cast, so
    every shape comes from ``model`` itself (a materialized draft's
    narrowed FFN included), no module is ``_apply``-ed (that cannot swap a
    fake tensor), and it holds for meta and fake tensors as for real ones,
    rounded as ``Tensor.to`` rounds."""
    if all(p.dtype == dtype for p in model.parameters()):
        return model
    memo = {id(p): nn.Parameter(
        p.detach().to(dtype) if p.is_floating_point() else p.detach().clone(),
        requires_grad=p.requires_grad) for p in model.parameters()}
    return copy.deepcopy(model, memo)
