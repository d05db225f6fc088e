"""Seeded HL503 violations: placements past the rank of a tensor built
with a literal shape."""
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)


def place(ctx, mesh):
    x = torch.zeros((8, 16))
    enc = torch.randn(4, 6)
    a = distribute_tensor(x, mesh, (Shard(2), Replicate()))       # HL503
    pl = ctx.placements("batch", None, None)
    b = DTensor.from_local(enc, mesh, ctx.placements("batch", None, None))  # HL503
    return a, b, pl
