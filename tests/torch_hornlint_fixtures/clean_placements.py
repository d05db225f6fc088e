"""HL501's clean twin: one placement a mesh dim."""
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import make_production_mesh


def place(local, full):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pod = make_production_mesh(multi_pod=True, device_type="cpu")
    a = DTensor.from_local(local, mesh, (Shard(0), Replicate()))
    b = distribute_tensor(full, pod, [Shard(0), Replicate(), Replicate()])
    c = a.redistribute(mesh, (Replicate(), Shard(1)))
    return a, b, c, torch.zeros(1)
