"""HL502's clean twin: every name is a mesh dim or a sharding rule."""
from repro_torch.launch.mesh import make_test_mesh


def batch_rows(ctx, mesh, x):
    group = mesh.get_group("data")
    sub = mesh["model"]
    pl = ctx.placements("batch", None)
    y = ctx.constrain(x, "batch", "seq")
    return group, sub, pl, y


def layout():
    mesh = make_test_mesh(2, 2, "cpu")
    return mesh.get_group("data"), mesh["pod"]


def ctx_spec(ctx, name):
    return ctx.spec("heads", "kv_heads")
