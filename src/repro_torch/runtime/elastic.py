"""Elastic scaling: continue a run on a different mesh.

The port of ``repro/runtime/elastic.py``.  A job that loses ranks
restarts on a smaller mesh, e.g. (14, 16) or a half-pod (8, 16).  Because
all layouts are *logical*, remeshing is:

    new_mesh  = make_test_mesh(data, model)          # launch/mesh.py
    new_ctx   = ShardingCtx(new_mesh, sharding_rules(cfg, new_mesh))
    state     = remesh_state(state, state_axes(run), new_ctx)

The divisibility fallbacks in ``sharding_rules`` mean a dimension that no
longer divides (16 kv heads on a 12-way model axis) degrades to
replication instead of failing: the run continues, less sharded.  A
restart from a checkpoint lays the saved arrays out the same way
(``Checkpointer.restore(shardings=)``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.launch.mesh import ShardingCtx, tree_shardings


def place(x, sharding):
    """One leaf on ``sharding`` (a ``NamedSharding``): a tensor or DTensor
    distributed by its placements (a DTensor is gathered whole first:
    every rank of its mesh must call this); with ``sharding`` None the
    full plain tensor, on the device it is on.  Anything that is not a
    tensor (a Python step count) comes back as it is."""
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach()
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if sharding is None:
        return x
    return distribute_tensor(x.to(sharding.mesh.device_type),
                             sharding.mesh, sharding.placements)


def reshard(state, shardings):
    """``state`` laid out leaf by leaf on ``shardings`` (the same tree,
    ``NamedSharding`` or None leaves; a model's parameters, an
    ``nn.Module``, against a {name: sharding} dict, replaced in place)."""
    if isinstance(state, nn.Module):
        for name, p in list(state.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(state.get_submodule(owner), leaf,
                    nn.Parameter(place(p, shardings[name]),
                                 requires_grad=p.requires_grad))
        return state
    if isinstance(state, dict):
        return {k: reshard(v, shardings[k]) for k, v in state.items()}
    if isinstance(state, list):
        return [reshard(v, s) for v, s in zip(state, shardings)]
    return place(state, shardings)


def remesh_state(state, state_axes, new_ctx: ShardingCtx):
    """``state`` (dicts and lists of tensors or DTensors; a model's
    parameters, an ``nn.Module``, are replaced in place) laid out on
    ``new_ctx``'s mesh by ``state_axes`` (``core/steps.py::state_axes``,
    the same tree).  Off-mesh (``null_ctx()``) every leaf comes back as
    a full plain tensor on its device."""
    return reshard(state, tree_shardings(state_axes, new_ctx))


def valid_meshes(n_devices: int):
    """Factorizations (data, model) usable after losing nodes."""
    out = []
    for model in (1, 2, 4, 8, 16):
        if n_devices % model == 0:
            out.append((n_devices // model, model))
    return out
