"""Group synchronization: Horn's topologies (paper §2, Fig. 1), the
single-process half.

The port of ``repro/core/group_sync.py``'s ``replicate_for_groups``,
``merge_groups_mean``, ``broadcast_merged``, ``maybe_merge_local_sgd`` and
``group_drift``.  Worker groups are a leading ``[G]`` dim of every tensor
of a dict (the JAX package vmaps over the same axis), so the merges are
reductions over dim 0:

  allreduce   every step, the groups' gradients are batch-averaged.
  local_sgd   each group keeps its own parameters for H steps, then all
              groups average parameters and momentum (Downpour's stand-in).

``psum_mean`` and ``merge_grads``, the merges across processes, wait for
the group topologies on ``torch.distributed`` (ROADMAP slice 5, item 10).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import TopologyConfig

f32 = torch.float32
Tree = Dict[str, torch.Tensor]


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
