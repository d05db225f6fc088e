"""Meshes and logical-axis sharding rules on ``torch.distributed``.

The port of ``repro/launch/mesh.py``.  The production mesh is
``(data=16, model=16)`` per pod and ``(pod=2, data=16, model=16)`` for
two pods.  Model code never names mesh axes: it annotates tensors with
*logical* axes ("batch", "heads", "ffn", ...), and ``sharding_rules``
maps logical to physical with the reference's divisibility-aware
fallbacks (8 kv heads cannot shard over a 16-way model axis: replicate;
56 q heads cannot: shard head_dim instead), line for line.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
over the ranks of the default process group, one device a rank, where
the JAX package builds a ``jax.sharding.Mesh`` over devices.  A
``PartitionSpec`` entry becomes ``ShardingCtx.spec``'s tuple entry; a
``NamedSharding`` becomes this module's ``NamedSharding``, the mesh and
one DTensor placement a mesh dim (``Shard(tensor dim)`` or
``Replicate()``); ``with_sharding_constraint`` becomes ``redistribute``.

JAX's ``shard_map`` has no counterpart here.  It runs one program per
device inside a traced function, with collectives named by mesh axis;
PyTorch runs one program per process eagerly, so a per-rank function is
plain code and its collectives name a process group
(``mesh.get_group("data")``), which ``core/group_sync.py`` and
``runtime/pipeline.py`` take directly.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def ensure_process_group(device_type: str) -> None:
    """Join or start the default process group, with the backend of
    ``device_type``: NCCL on a card, gloo on the CPU.  A group that exists
    is kept as it is; under ``torchrun`` (``WORLD_SIZE`` in the
    environment) the group is the job's (``env://``, each rank on the card
    ``LOCAL_RANK``); otherwise a one-rank group of this process on an
    in-process store (no file, no network).  A backend that cannot start
    raises: nothing falls back to another backend or device."""
    if dist.is_initialized():
        return
    if device_type == "cuda":
        resolve_device("cuda")          # raises without a card
        if "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(BACKENDS[device_type], init_method="env://")
    else:
        dist.init_process_group(BACKENDS[device_type],
                                store=dist.HashStore(), rank=0, world_size=1)


def default_device_type() -> str:
    """The device type of the default group's backend: "cuda" for NCCL,
    "cpu" for gloo."""
    backend = dist.get_backend()
    for device_type, name in BACKENDS.items():
        if name in backend:
            return device_type
    raise ValueError(f"no device type for the backend {backend!r}")


def _mesh(shape, names, device_type) -> DeviceMesh:
    """A mesh of ``shape`` over the first ranks of the default group."""
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type or default_device_type(),
                      torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The target deployment mesh, over a default group of exactly its
    size (raises otherwise)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = 1
    for n in shape:
        need *= n
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks, "
                         f"the process group has {world}")
    return _mesh(shape, axes, device_type)


def make_test_mesh(data: int = 1, model: int = 1,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks there are, clamped as the
    JAX function clamps it to the devices there are: ``data`` at most the
    world size, ``model`` at most what the world holds beside it, the
    first ``data * model`` ranks.  Without a process group it is a 1 x 1
    mesh over a one-rank group of this process (``ensure_process_group``;
    ``device_type`` "cuda" unless asked for "cpu")."""
    if not dist.is_initialized():
        ensure_process_group(device_type or "cuda")
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return _mesh((data, model), ("data", "model"), device_type)


def axis_sizes(mesh) -> dict:
    """{mesh dim name: size}; {} off-mesh.  Takes anything with
    ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def sharding_rules(cfg: ModelConfig, mesh, shape=None) -> dict:
    """Logical-axis -> mesh-axis mapping for one architecture on one mesh.

    ``shape`` (a ShapeConfig) enables shape-aware fallbacks: a decode cell
    with global_batch=1 cannot shard batch over `data`, so the KV-cache
    sequence axis takes the data axis instead (sequence-parallel decode).
    """
    sizes = axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)
    has_pod = "pod" in sizes

    def on_model(dim: int):
        return "model" if model_n > 1 and dim > 0 and dim % model_n == 0 \
            else None

    def on_data(dim: int):
        return "data" if data_n > 1 and dim > 0 and dim % data_n == 0 \
            else None

    heads = on_model(cfg.num_heads)
    kv_heads = on_model(cfg.num_kv_heads)
    # GQA fallback: if q-heads don't shard, shard head_dim (llama4: 40H, llava: 56H)
    head_dim = on_model(cfg.head_dim) if heads is None else None
    if heads is None and head_dim is not None:
        kv_heads = None  # k/v share the head_dim sharding instead

    d_in = cfg.ssm_expand * cfg.d_model
    rules = {
        # activations
        "batch": ("pod", "data") if has_pod else ("data",),
        "seq": None,
        "seq_model": on_model(1 << 30),   # opt-in KV-sequence sharding (decode)
        "act_embed": None,
        "act_ffn": on_model(cfg.d_ff),
        "heads": heads,
        "kv_heads": kv_heads,
        "head_dim": head_dim,
        "kv_head_dim": head_dim if kv_heads is None else None,
        # weights (FSDP on the d_model dim over `data`; TP on the wide dim)
        "embed": on_data(cfg.d_model),
        "ffn": on_model(cfg.d_ff),
        "moe_ffn": on_model(cfg.moe_ff) if cfg.num_experts else None,
        "vocab": on_model(cfg.vocab_size),
        "experts": on_model(cfg.num_experts) if cfg.num_experts else None,
        "ssm_inner": on_model(d_in) if cfg.ssm_state else None,
        "ssm_heads": (on_model(d_in // cfg.ssm_head_dim)
                      if cfg.ssm_state else None),
        "ssm_state": None,
        "layers": None,
        "conv": None,
        "noshard": None,
    }
    # KV-cache sequence axis: prefer kv-head sharding; when kv heads do not
    # divide the model axis (qwen1.5: 20, llava/jamba: 8 on 16), shard the
    # cache's *sequence* dim over model instead (flash-decode style), so
    # the whole cache is never gathered.
    rules["kv_seq"] = None
    if shape is not None:
        if (shape.kind == "decode" and rules["kv_heads"] is None
                and shape.seq_len % max(model_n, 1) == 0):
            rules["kv_seq"] = on_model(shape.seq_len)
        # Serving shapes: weights are read-only, so FSDP's per-layer
        # all-gathers buy nothing: replicate over `data`.
        if shape.kind != "train":
            rules["embed"] = None
        # Prefill/train with unshardable heads: sequence-parallel attention
        # (shard q-sequence over model; no score psum needed) instead of
        # head_dim sharding, which gathers or sums huge score tensors.
        rules["sp_seq"] = None
        if (shape.kind in ("prefill", "train") and rules["heads"] is None
                and shape.seq_len % max(model_n, 1) == 0):
            rules["sp_seq"] = on_model(shape.seq_len)
            rules["head_dim"] = None
            rules["kv_head_dim"] = None
            # Megatron-style sequence parallelism: keep the residual stream
            # seq-sharded everywhere (norms/elementwise local; K/V gathered
            # in bf16).  Gated to dense archs: expert dispatch wants
            # token-replicated rows.
            if cfg.num_experts == 0:
                rules["seq"] = rules["sp_seq"]
        dp = data_n * sizes.get("pod", 1)
        if dp > 1 and shape.global_batch % dp != 0:
            rules["batch"] = None
            # sequence-parallel fallback (long-context decode, batch 1)
            if shape.kind == "decode" and shape.seq_len % data_n == 0:
                rules["seq"] = "data"
    return rules


class NamedSharding(NamedTuple):
    """A layout on a mesh: one DTensor placement a mesh dim, in the mesh's
    dim order (JAX's ``NamedSharding(mesh, spec)``)."""
    mesh: DeviceMesh
    placements: Tuple[Placement, ...]


def local_range(size: int, mesh: DeviceMesh,
                placements: Tuple[Placement, ...], dim: int
                ) -> Tuple[int, int]:
    """[start, stop) of this rank's slice of a tensor dim of ``size``
    laid out by ``placements``: each mesh dim that shards ``dim`` splits
    what the dims before it left, in mesh-dim order (a ``("pod", "data")``
    entry: pod major).  The rules shard only dims they divide; an uneven
    split raises."""
    coord = mesh.get_coordinate()
    start, n = 0, size
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            k = mesh.size(i)
            if n % k:
                raise ValueError(f"dim {dim} of {size} does not split "
                                 f"{k} ways on mesh dim {i}")
            n //= k
            start += coord[i] * n
    return start, start + n


def local_shard(full: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's slice of ``full`` under ``sharding`` (a view; no
    communication): what ``distribute_tensor`` would hand this rank."""
    out = full
    for d in range(full.ndim):
        lo, hi = local_range(full.shape[d], sharding.mesh,
                             sharding.placements, d)
        if (lo, hi) != (0, full.shape[d]):
            out = out.narrow(d, lo, hi - lo)
    return out


@dataclass
class ShardingCtx:
    """Logical-axis layouts on a mesh (None: off-mesh, every layout
    None)."""

    mesh: Optional[DeviceMesh] = None
    rules: dict = field(default_factory=dict)

    def spec(self, *axes) -> tuple:
        """The ``PartitionSpec`` of ``axes`` as a tuple: per tensor dim the
        mesh axis (a name, a tuple of names, or None); a mesh axis an
        earlier dim took is not used again."""
        entries, used = [], set()
        for a in axes:
            m = self.rules.get(a) if a is not None else None
            if m is None:
                entries.append(None)
                continue
            ms = m if isinstance(m, tuple) else (m,)
            ms = tuple(x for x in ms if x not in used)
            used.update(ms)
            entries.append(ms if len(ms) != 1 else ms[0])
            if not ms:
                entries[-1] = None
        return tuple(entries)

    def placements(self, *axes) -> Tuple[Placement, ...]:
        """One placement a mesh dim: ``Shard(d)`` where tensor dim ``d``'s
        spec entry names the mesh dim, else ``Replicate()``."""
        on = {}
        for d, entry in enumerate(self.spec(*axes)):
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                if name is not None:
                    on[name] = d
        return tuple(Shard(on[n]) if n in on else Replicate()
                     for n in self.mesh.mesh_dim_names)

    def sharding(self, *axes) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.placements(*axes))

    def constrain(self, x, *axes):
        """``x`` laid out by ``axes`` (a DTensor redistributed, a full
        tensor distributed); ``x`` itself off-mesh."""
        if self.mesh is None:
            return x
        pl = self.placements(*axes)
        if isinstance(x, DTensor):
            return x.redistribute(self.mesh, pl)
        return distribute_tensor(x, self.mesh, pl)

    @property
    def dp_size(self) -> int:
        s = axis_sizes(self.mesh)
        return s.get("data", 1) * s.get("pod", 1)

    @property
    def dp_groups(self) -> tuple:
        """The process groups of the data-parallel mesh dims ("pod",
        "data"), for ``group_sync``'s sums over them."""
        names = self.mesh.mesh_dim_names if self.mesh is not None else ()
        return tuple(self.mesh.get_group(n) for n in ("pod", "data")
                     if n in names)


def null_ctx() -> ShardingCtx:
    return ShardingCtx(mesh=None, rules={})


def is_axes_leaf(x) -> bool:
    """An axes annotation: a (possibly empty) tuple of axis names / None.
    (A (k, v) cache pair is a tuple of tuples, NOT a leaf.)"""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def tree_shardings(axes_tree, ctx: ShardingCtx):
    """The tree of ``axes_tree`` (dicts and lists around axes leaves)
    with each leaf's ``NamedSharding``, or None off-mesh."""
    if is_axes_leaf(axes_tree):
        return ctx.sharding(*axes_tree)
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(v, ctx) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_shardings(v, ctx) for v in axes_tree)
    raise TypeError(f"not an axes tree: {axes_tree!r}")
