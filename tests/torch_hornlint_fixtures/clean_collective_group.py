"""HL504's clean twin: every group names a dim of the mesh."""
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol


def merge(mesh, g, x):
    dist.all_reduce(g, group=mesh.get_group("data"))
    dist.all_gather_into_tensor(x, g, group=mesh.get_group("model"))
    return funcol.all_reduce(x, "sum", (mesh, "pod"))
