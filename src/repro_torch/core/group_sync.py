"""Group synchronization: Horn's topologies (paper §2, Fig. 1).

The port of ``repro/core/group_sync.py``.  In one process
(``replicate_for_groups``, ``merge_groups_mean``, ``broadcast_merged``,
``maybe_merge_local_sgd``, ``group_drift``) worker groups are a leading
``[G]`` dim of every tensor of a dict (the JAX package vmaps over the same
axis), so the merges are reductions over dim 0:

  allreduce   every step, the groups' gradients are batch-averaged.
  local_sgd   each group keeps its own parameters for H steps, then all
              groups average parameters and momentum (Downpour's stand-in).

Across processes (``psum_mean``, ``merge_grads``) a group is a
``torch.distributed`` process group where the JAX functions name mesh
axes inside ``shard_map``: one group (``mesh.get_group("data")``), a
tuple of groups (the JAX tuple of axis names: the sum runs over each in
turn, so over their product), or None for the default group.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs.base import TopologyConfig
from repro_torch.optim import compression as C

f32 = torch.float32
Tree = Dict[str, torch.Tensor]
Groups = Union[None, dist.ProcessGroup, Sequence[dist.ProcessGroup]]


def as_groups(group: Groups) -> Tuple:
    """``group`` as a tuple of process groups (None: the default one)."""
    return tuple(group) if isinstance(group, (tuple, list)) else (group,)


def group_size(group: Groups) -> int:
    """The ranks the sum over ``group`` covers: the product of the sizes."""
    n = 1
    for g in as_groups(group):
        n *= dist.get_world_size(g)
    return n


def all_reduce_sum(x: torch.Tensor, group: Groups) -> torch.Tensor:
    """``x`` summed over every rank of ``group``: in place when ``x`` is
    contiguous, else in a contiguous copy (NCCL reduces contiguous tensors
    only, and autograd hands out strided gradients); returns the sum."""
    x = x.contiguous()
    for g in as_groups(group):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x


def psum_mean(tree: Tree, group: Groups) -> Tree:
    """Each leaf cast to f32, summed over the ranks of ``group`` and divided
    by their count: the mean every rank then holds (JAX's ``psum(x.astype(
    f32), axis_names) / n``).  The leaves of ``tree`` are left as they
    are."""
    n = float(group_size(group))
    return {k: all_reduce_sum(x.to(f32, copy=True), group) / n
            for k, x in tree.items()}


def merge_grads(grads: Tree, group: Groups, topology: TopologyConfig,
                residuals: Optional[Tree] = None
                ) -> Tuple[Tree, Optional[Tree]]:
    """The explicit gradient merge across ``group``, with int8 error
    feedback when ``topology.grad_compression == "int8"`` (each rank
    compresses its own gradients with its residuals, then the dequantized
    values are averaged).  Returns (merged, new residuals); without
    compression the residuals pass through."""
    if topology.grad_compression == "int8":
        q, s, new_res = C.ef_compress_tree(grads, residuals)
        return C.psum_mean_compressed(q, s, group), new_res
    return psum_mean(grads, group), residuals


def replicate_for_groups(tree: Tree, num_groups: int) -> Tree:
    """params -> per-group copies with a leading [G] dim: broadcast views
    (as ``jnp.broadcast_to``), so write into a ``clone`` of them."""
    return {k: x[None].expand((num_groups,) + tuple(x.shape))
            for k, x in tree.items()}


def merge_groups_mean(tree: Tree) -> Tree:
    """Batch averaging (paper): the mean over the leading group dim."""
    return {k: x.mean(dim=0) for k, x in tree.items()}


def broadcast_merged(tree: Tree, num_groups: int = 0) -> Tree:
    if not num_groups:
        num_groups = next(iter(tree.values())).shape[0]
    return replicate_for_groups(merge_groups_mean(tree), num_groups)


def maybe_merge_local_sgd(params_g: Tree, step: int,
                          topology: TopologyConfig, *,
                          momentum_g: Optional[Tree] = None
                          ) -> Tuple[Tree, Optional[Tree]]:
    """Every H steps (``step % H == H - 1``, ``step`` 0-based), average the
    per-group parameters and momentum and re-broadcast them; otherwise pass
    them through."""
    H = max(1, topology.local_sgd_period)
    if step % H != H - 1:
        return params_g, momentum_g

    def merge(tree):
        return {k: x.mean(dim=0, keepdim=True).expand_as(x)
                for k, x in tree.items()}

    return merge(params_g), (None if momentum_g is None
                             else merge(momentum_g))


def group_drift(params_g: Tree) -> torch.Tensor:
    """The L2 distance of the groups' parameters from their average, over
    every leaf: the diversity Horn's sub-models induce (a metric only)."""
    total = sum(torch.sum(torch.square(
        x.to(f32) - x.mean(dim=0, keepdim=True).to(f32)))
        for x in params_g.values())
    return torch.sqrt(total)
