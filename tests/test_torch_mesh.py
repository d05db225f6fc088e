"""The port's sharding rules, logical axes and scale-out helpers against
the JAX package's, in one process (no process group).

``sharding_rules`` and ``ShardingCtx.spec`` read only a mesh's dim names
and sizes, so fake meshes stand in for the production ones, as in
``tests/test_distributed.py``: (data 16, model 16), (pod 2, data 16, model
16), the elastic (14, 12), and (4, 2), (2, 2), (1, 1).  Every arch but
horn-mnist, with no shape and with each of ``SHAPES``.
"""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

jax = pytest.importorskip("jax")

from repro.configs import base as jbase  # noqa: E402
from repro.core import neuron_centric as jnc  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro.runtime import pipeline as jpipeline  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import neuron_centric as tnc  # noqa: E402
from repro_torch.core import steps as TS  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.runtime import elastic as telastic  # noqa: E402
from repro_torch.runtime import pipeline as tpipeline  # noqa: E402

ARCHS = [a for a in jbase.list_archs() if a != "horn-mnist"]
MESHES = {"16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
          "14x12": {"data": 14, "model": 12},
          "4x2": {"data": 4, "model": 2},
          "2x2": {"data": 2, "model": 2},
          "1x1": {"data": 1, "model": 1}}
SHAPES = [None] + list(jbase.SHAPES)


class JaxFakeMesh:
    """What ``repro.launch.mesh`` reads of a mesh: its axis names and the
    shape of its device array."""
    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


class FakeMesh:
    """What the port reads of a ``DeviceMesh``: dim names, shape, and for
    ``local_range`` this rank's coordinate and each dim's size."""
    def __init__(self, sizes, coordinate=None):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._coord = coordinate

    def get_coordinate(self):
        return self._coord

    def size(self, i):
        return self.shape[i]


def configs(arch, red=False):
    j, t = jbase.get_model_config(arch), tbase.get_model_config(arch)
    return (jbase.reduced(j), tbase.reduced(t)) if red else (j, t)


def shapes(name):
    return ((None, None) if name is None
            else (jbase.SHAPES[name], tbase.SHAPES[name]))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_rules_match_jax(arch, mesh):
    """The rule dicts are equal, with no shape and at each shape cell."""
    jcfg, tcfg = configs(arch)
    for name in SHAPES:
        jshape, tshape = shapes(name)
        want = jmesh.sharding_rules(jcfg, JaxFakeMesh(MESHES[mesh]), jshape)
        got = tmesh.sharding_rules(tcfg, FakeMesh(MESHES[mesh]), tshape)
        assert got == want, (arch, mesh, name)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_matches_partition_spec(arch, mesh):
    """``ShardingCtx.spec`` of every parameter's axes equals the entries of
    JAX's ``PartitionSpec`` (the used-axis rule included), and
    ``placements`` puts ``Shard(d)`` on exactly the mesh dims that entry
    d names."""
    jcfg, tcfg = configs(arch)
    axes = api.model_axes(tcfg)
    for name in SHAPES:
        jshape, tshape = shapes(name)
        jctx = jmesh.ShardingCtx(
            mesh=None, rules=jmesh.sharding_rules(
                jcfg, JaxFakeMesh(MESHES[mesh]), jshape))
        fake = FakeMesh(MESHES[mesh])
        tctx = tmesh.ShardingCtx(
            mesh=fake, rules=tmesh.sharding_rules(tcfg, fake, tshape))
        for key, ax in list(axes.items()) + [("batch", ("batch", "seq"))]:
            spec = tctx.spec(*ax)
            assert spec == tuple(jctx.spec(*ax)), (key, name)
            for dim_name, pl in zip(fake.mesh_dim_names,
                                    tctx.placements(*ax)):
                on = [d for d, e in enumerate(spec) if e == dim_name or (
                    isinstance(e, tuple) and dim_name in e)]
                assert pl == (Shard(on[0]) if on else Replicate()), key


@pytest.mark.parametrize("red", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax_model_axes(arch, red):
    """{keystr: axes} of the port's model equals JAX's ``model_axes``
    flattened by keystr: every leaf, its axes and its stacked "layers"."""
    jcfg, tcfg = configs(arch, red)
    want = {jax.tree_util.keystr(p): ax
            for p, ax in jax.tree_util.tree_leaves_with_path(
                japi.model_axes(jcfg), is_leaf=jmesh.is_axes_leaf)}
    assert api.model_axes(tcfg) == want


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_state_axes_follow_the_parameters(optimizer):
    """Each moment of the train state has its parameter's axes, in the
    state's own tree (parameter order), and the rest is JAX's."""
    cfg = tbase.reduced(tbase.get_model_config("qwen3-1.7b"))
    run = tbase.RunConfig(model=cfg, shape=tbase.ShapeConfig(
        "t", "train", 32, 8), optimizer=optimizer)
    ax = TS.state_axes(run)
    state = TS.init_state(run, "cpu")
    names = [n for n, _ in state["params"].named_parameters()]
    assert list(ax["params"]) == names
    moments = ["mom"] if optimizer == "sgdm" else ["m", "v"]
    for m in moments:
        assert ax["opt"][m] == [ax["params"][n] for n in names]
    assert (ax["step"], ax["rng"]) == ((), (None,))
    assert set(ax["opt"]) == set(state["opt"])


def test_mesh_step_refuses_moe_on_data_ranks():
    """The MoE router losses are not means over rows, so the mesh step
    refuses an MoE config split over data ranks (naming its ROADMAP
    item) and takes it on one data rank."""
    mesh = FakeMesh({"data": 2, "model": 1})
    mesh.device_type = "cpu"
    run = tbase.RunConfig(
        model=tbase.reduced(tbase.get_model_config("phi3.5-moe-42b")),
        shape=tbase.ShapeConfig("t", "train", 32, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP item 32"):
        TS.make_train_step(run, "cpu", mesh=mesh)
    one = FakeMesh({"data": 1, "model": 2})
    one.device_type = "cpu"
    assert callable(TS.make_train_step(run, "cpu", mesh=one))


def test_tree_shardings_off_mesh_and_axes_leaves():
    assert tmesh.is_axes_leaf(("embed", None)) and tmesh.is_axes_leaf(())
    assert not tmesh.is_axes_leaf((("batch",), ("batch",)))
    tree = {"a": ("embed", "ffn"), "b": [("vocab",), ()]}
    assert tmesh.tree_shardings(tree, tmesh.null_ctx()) == \
        {"a": None, "b": [None, None]}
    assert tmesh.null_ctx().constrain("x", "embed") == "x"


@pytest.mark.parametrize("sizes,coord,placements,rows,cols", [
    ({"data": 2, "model": 2}, (1, 0), (Shard(0), Replicate()), (4, 8),
     (0, 16)),
    ({"data": 2, "model": 2}, (1, 1), (Shard(1), Shard(0)), (4, 8),
     (8, 16)),
    ({"pod": 2, "data": 2, "model": 1}, (1, 0, 0),
     (Shard(0), Shard(0), Replicate()), (4, 6), (0, 16)),
    ({"pod": 2, "data": 2, "model": 1}, (0, 1, 0),
     (Shard(0), Shard(0), Replicate()), (2, 4), (0, 16)),
    ({"data": 4, "model": 2}, (3, 1), (Replicate(), Shard(1)), (0, 8),
     (8, 16)),
])
def test_local_range_nests_in_mesh_order(sizes, coord, placements, rows,
                                         cols):
    """A ("pod", "data") dim splits pod-major, as JAX lays out a tuple
    entry and DTensor nests placements; ``local_shard`` is that slice of
    every dim; an uneven split raises."""
    mesh = FakeMesh(sizes, coord)
    assert tmesh.local_range(8, mesh, placements, 0) == rows
    assert tmesh.local_range(16, mesh, placements, 1) == cols
    full = torch.arange(8 * 16).reshape(8, 16)
    got = tmesh.local_shard(full, tmesh.NamedSharding(mesh, placements))
    assert torch.equal(got, full[rows[0]:rows[1], cols[0]:cols[1]])
    with pytest.raises(ValueError):
        tmesh.local_range(7, FakeMesh({"data": 2}, (0,)), (Shard(0),), 0)


def test_neuron_network_axes_match_jax():
    def build(mod):
        return (mod.NeuronNetwork(784, input_neuron="dropout")
                .add_layer(512, neuron="dropout")
                .add_layer(512, neuron="dropout")
                .add_layer(10, activation="identity"))
    assert build(tnc).axes() == build(jnc).axes()


@pytest.mark.parametrize("n", [1, 4, 8, 14, 224, 256])
def test_valid_meshes_match_jax(n):
    assert telastic.valid_meshes(n) == jelastic.valid_meshes(n)


@pytest.mark.parametrize("S,M", [(1, 8), (4, 8), (4, 16), (2, 3)])
def test_bubble_fraction_matches_jax(S, M):
    assert tpipeline.bubble_fraction(S, M) == \
        jpipeline.bubble_fraction(S, M)


@pytest.mark.parametrize("kind,period,comp", [
    ("allreduce", 1, "none"), ("zero1", 1, "none"), ("local_sgd", 8, "none"),
    ("local_sgd", 4, "int8"), ("allreduce", 1, "int8")])
def test_topology_describe_and_validate_match_jax(kind, period, comp):
    t = tbase.TopologyConfig(kind, period, comp)
    j = jbase.TopologyConfig(kind, period, comp)
    assert ttopo.describe(t) == jtopo.describe(j)
    assert ttopo.validate(t) is t and jtopo.validate(j) is j
    assert ttopo.DESCRIPTIONS == jtopo.DESCRIPTIONS


@pytest.mark.parametrize("bad", [dict(kind="ring"),
                                 dict(local_sgd_period=0),
                                 dict(grad_compression="fp8")])
def test_topology_validate_refuses_what_jax_refuses(bad):
    with pytest.raises(AssertionError):
        jtopo.validate(jbase.TopologyConfig(**bad))
    with pytest.raises(ValueError):
        ttopo.validate(tbase.TopologyConfig(**bad))
