"""Pipeline parallelism: the GPipe schedule on ``torch.distributed``.

The port of ``repro/runtime/pipeline.py``.  Each rank of a process group
is one stage and owns a contiguous slice of layers; microbatches flow
stage to stage through point-to-point sends (JAX's ``ppermute``).

The forward is the reference's explicit tick loop, T = M + S - 1 ticks:
stage 0 injects microbatch t at tick t, every stage applies its layers to
what it holds, the last stage records the microbatch that finished, and
every stage hands its output to the next.  The hop is an autograd
function (``_Permute``) whose backward is the reverse hop, so autograd
through ``pipelined_apply`` runs the reverse schedule, as ``jax.grad``
does through ``ppermute``: no hand-written 1F1B is needed for
correctness.  The result goes from the last stage to every rank by the
reference's masked sum, an all-reduce (``_ReplicatedSum``).

Bubble fraction is (S - 1) / (M + S - 1); callers pick M >= 4 S to keep
it under 20 %.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


class _Permute(torch.autograd.Function):
    """Stage s sends ``x`` to s + 1 and returns what s - 1 sent (zeros on
    stage 0).  Backward: the reverse hop, the gradient of what came in
    goes back to s - 1 and the gradient of what went out comes from
    s + 1 (zeros on the last stage)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _hop(x, group, +1)

    @staticmethod
    def backward(ctx, g):
        return _hop(g.contiguous(), ctx.group, -1), None


def _hop(x: torch.Tensor, group, direction: int) -> torch.Tensor:
    """Send ``x`` to the stage ``direction`` away and receive from the one
    on the other side; a stage with no such neighbour sends nothing or
    receives zeros."""
    idx, S = dist.get_rank(group), dist.get_world_size(group)
    to, frm = idx + direction, idx - direction
    got = torch.zeros_like(x)
    ops = []
    if 0 <= to < S:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, to), group))
    if 0 <= frm < S:
        ops.append(dist.P2POp(dist.irecv, got,
                              dist.get_global_rank(group, frm), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


class _ReplicatedSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``, which every rank then
    holds.  The result is replicated and so is the loss every rank
    computes from it: the gradient each rank receives is the gradient of
    the one loss, and each rank's input adds to the sum with weight 1,
    so the backward hands it on as it is (summing it over the ranks would
    count the loss S times)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipelined_apply(block_fn: Callable, stage_params, x_mb: torch.Tensor,
                    *, group) -> torch.Tensor:
    """Run ``block_fn`` over the pipeline stages of ``group``.

    block_fn(stage_params, x) -> x applies ONE stage's layers.
    stage_params: this rank's stage's parameters (the JAX function takes
    all stages stacked, sharded over the stage axis).  x_mb: [M, mb, ...]
    microbatches, the same on every rank.  Returns [M, mb, ...], the last
    stage's outputs, on every rank.  Every rank of ``group`` must call it
    (and the backward through it) together; None is the default group."""
    group = dist.group.WORLD if group is None else group
    S, idx = dist.get_world_size(group), dist.get_rank(group)
    M = x_mb.shape[0]
    T = M + S - 1

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=x_mb.device)

    # every select is a where(), never a branch, as in the reference: each
    # stage's outputs stay in its graph (with zero weight off the last
    # stage), so every stage runs each hop's backward beside its
    # neighbours
    act = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(M)]
    for t in range(T):
        mb_id = t - idx
        act_in = torch.where(flag(idx == 0), x_mb[min(max(t, 0), M - 1)],
                             act)
        out = block_fn(stage_params, act_in)
        valid = 0 <= mb_id < M
        out = torch.where(flag(valid), out, torch.zeros_like(out))
        rec = min(max(mb_id, 0), M - 1)
        outs[rec] = torch.where(flag(idx == S - 1 and valid), out, outs[rec])
        if t < T - 1:                   # the last tick's hop lands nowhere
            act = _Permute.apply(out, group) if S > 1 else out
    stacked = torch.stack(outs)
    stacked = torch.where(flag(idx == S - 1), stacked,
                          torch.zeros_like(stacked))
    return _ReplicatedSum.apply(stacked, group)


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
