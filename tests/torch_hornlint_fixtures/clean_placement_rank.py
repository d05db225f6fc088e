"""HL503's clean twin: placements within the tensor's rank."""
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)


def place(ctx, mesh):
    x = torch.zeros((8, 16))
    enc = torch.randn(4, 6)
    a = distribute_tensor(x, mesh, (Shard(1), Replicate()))
    pl = ctx.placements("batch", None, None)
    b = DTensor.from_local(enc, mesh, ctx.placements("batch", None))
    return a, b, pl
