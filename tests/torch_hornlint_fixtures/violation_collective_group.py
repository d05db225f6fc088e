"""Seeded HL504 violations: collectives given a mesh-dim group name the
mesh does not have."""
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol


def merge(mesh, g, x):
    dist.all_reduce(g, group=mesh.get_group("date"))             # HL504
    dist.all_gather_into_tensor(x, g, group=mesh.get_group("mdl"))  # HL504
    return funcol.all_reduce(x, "sum", (mesh, "pods"))            # HL504
