"""Seeded HL502 violations: mesh-dim and logical axis names the mesh and
its sharding rules do not have."""
from repro_torch.launch.mesh import make_test_mesh


def batch_rows(ctx, mesh, x):
    group = mesh.get_group("dta")                  # HL502
    sub = mesh["modle"]                            # HL502
    pl = ctx.placements("bacth", None)             # HL502
    y = ctx.constrain(x, "batch", "seqq")          # HL502
    return group, sub, pl, y


def layout():
    mesh = make_test_mesh(2, 2, "cpu")
    return mesh.get_group("data"), mesh["pod"]


def ctx_spec(ctx, name):
    return ctx.spec("heads", "kv_headz")           # HL502
