"""The port of the paper's MNIST experiment against the JAX package's.

Data, batches, int8 error feedback, the group merges, the neuron-centric
network and the collective trainer's step, each held against its JAX
counterpart on the same inputs: parameters drawn by JAX and carried over
with ``from_jax_params``, and, with Horn on, JAX's own uniforms
(``jax_group_uniforms``: row g of every draw is JAX's draw for group g).
A small network (hidden 32, depth 2, 4 groups) runs on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import collective_trainer as JCT  # noqa: E402
from repro.core import group_sync as jgs  # noqa: E402
from repro.core import neuron_centric as jnc  # noqa: E402
from repro.core.parallel_dropout import HornState as JHornState  # noqa
from repro.data import mnist as jmnist  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import collective_trainer as CT  # noqa: E402
from repro_torch.core import group_sync as gs  # noqa: E402
from repro_torch.core import neuron_centric as nc  # noqa: E402
from repro_torch.core import parallel_dropout as pd  # noqa: E402
from repro_torch.data import mnist as tmnist  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402

HIDDEN, DEPTH, G, PER = 32, 2, 4, 6


@dataclasses.dataclass(frozen=True)
class JaxUniforms(pd.HornState):
    """A port ``HornState`` whose row g of every draw is
    ``jax.random.uniform`` of JAX key ``keys[g]``'s (layer, salt) key,
    shaped (1, nb): what JAX's ``unit_mask`` draws for a one-group state
    keyed ``keys[g]``.  With one key and ``num_groups`` rows it is JAX's
    draw for a state of that many groups."""
    keys: tuple = ()

    def uniform(self, layer_idx, salt, shape):
        rows = len(self.keys) == 1 and shape[0] or 1
        draws = [np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(k, layer_idx), salt),
            (rows,) + tuple(shape[1:]))) for k in self.keys]
        return torch.tensor(np.concatenate(draws), device=self.device)


def jax_group_uniforms(hcfg, step, num_groups, device="cpu"):
    """What ``collective_trainer.horn_state`` returns, drawing JAX's
    uniforms: group g's key is ``fold_in(fold_in(key(seed_salt), step),
    g)``, as in JAX's ``make_step_fn``."""
    if not hcfg.enabled:
        return None
    base = jax.random.fold_in(jax.random.key(hcfg.seed_salt), step)
    keys = tuple(jax.random.fold_in(base, g) for g in range(num_groups))
    return JaxUniforms(0, int(step), hcfg, num_groups, torch.device(device),
                       keys=keys)


def hcfgs(**kw):
    kw.setdefault("block_size", 1)
    return jbase.HornConfig(**kw), tbase.HornConfig(**kw)


def np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def data(n=64, seed=0):
    d = jmnist.synthetic_mnist(n_train=n, n_test=16, seed=seed)
    return d


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_mnist_is_byte_identical(seed):
    a = jmnist.synthetic_mnist(n_train=200, n_test=50, seed=seed)
    b = tmnist.synthetic_mnist(n_train=200, n_test=50, seed=seed)
    assert a.keys() == b.keys() and b["source"] == "synthetic-7seg"
    for k in ("x_train", "y_train", "x_test", "y_test"):
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


def test_load_mnist_reads_an_npz_as_jax_does(tmp_path, monkeypatch):
    """With ``MNIST_PATH`` naming an npz both read the same arrays; without
    one both fall back to the 7-segment data."""
    rng = np.random.default_rng(0)
    path = tmp_path / "mnist.npz"
    np.savez(path, x_train=rng.integers(0, 256, (30, 28, 28), np.uint8),
             y_train=rng.integers(0, 10, 30, np.uint8),
             x_test=rng.integers(0, 256, (10, 28, 28), np.uint8),
             y_test=rng.integers(0, 10, 10, np.uint8))
    monkeypatch.setenv("MNIST_PATH", str(path))
    a, b = jmnist.load_mnist(), tmnist.load_mnist()
    assert a["source"] == b["source"] == f"mnist:{path}"
    for k in ("x_train", "y_train", "x_test", "y_test"):
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    monkeypatch.setenv("MNIST_PATH", str(tmp_path / "absent.npz"))
    a = jmnist.load_mnist(n_train=20, n_test=5)
    b = tmnist.load_mnist(n_train=20, n_test=5)
    assert b["source"] == "synthetic-7seg"
    assert a["x_train"].tobytes() == b["x_train"].tobytes()


@pytest.mark.parametrize("groups,batch,seed", [(1, 100, 0), (20, 100, 0),
                                               (4, 24, 5)])
def test_mnist_batcher_is_byte_identical(groups, batch, seed):
    d = data(128)
    jb = jpipe.MnistBatcher(d["x_train"], d["y_train"], batch, seed=seed)
    tb = tpipe.MnistBatcher(d["x_train"], d["y_train"], batch, seed=seed)
    for step in (0, 1, 17):
        for a, b in ((jb.batch_at(step), tb.batch_at(step)),
                     (jb.group_batch_at(step, groups),
                      tb.group_batch_at(step, groups))):
            for k in ("x", "y"):
                assert a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes()


def test_mnist_batcher_group_split():
    """Port of ``test_substrate.py::test_mnist_batcher_group_split``."""
    x = np.arange(200, dtype=np.float32).reshape(100, 2)
    y = np.arange(100, dtype=np.int32)
    b = tpipe.MnistBatcher(x, y, batch=20).group_batch_at(0, num_groups=4)
    assert b["x"].shape == (4, 5, 2)
    assert b["y"].shape == (4, 5)


# ---------------------------------------------------------------------------
# int8 error feedback
# ---------------------------------------------------------------------------
def grads_tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"w0": (rng.standard_normal(lead + (12, 7)) * 0.3
                   ).astype(np.float32),
            "b0": (rng.standard_normal(lead + (7,)) * 1e-3
                   ).astype(np.float32)}


def test_compress_tree_matches_jax():
    g = grads_tree(0)
    want = jcomp.compress_tree({k: jnp.asarray(v) for k, v in g.items()})
    got = comp.compress_tree({k: torch.tensor(v) for k, v in g.items()})
    for k in g:
        assert np.array_equal(got[k][0].numpy(), np.asarray(want[k][0]))
        assert got[k][1].item() == float(want[k][1])


@pytest.mark.parametrize("grouped", [False, True])
def test_ef_compress_tree_is_exact(grouped):
    """q, the scales and the residual carried over three steps equal JAX's
    element for element: one scale a leaf, or (``groups=True``) one a
    group and leaf as ``jax.vmap(ef_compress_tree)`` gives."""
    lead = (G,) if grouped else ()
    jfn = jax.vmap(jcomp.ef_compress_tree) if grouped else \
        jcomp.ef_compress_tree
    jres = (jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32),
                         {k: jnp.asarray(v) for k, v in
                          grads_tree(0, lead).items()})
            if grouped else None)
    tres = None
    for step in range(3):
        g = grads_tree(step, lead)
        jq, js, jres = jfn({k: jnp.asarray(v) for k, v in g.items()}, jres)
        tq, ts, tres = comp.ef_compress_tree(
            {k: torch.tensor(v) for k, v in g.items()}, tres, groups=grouped)
        for k in g:
            assert tq[k].dtype == torch.int8
            assert np.array_equal(tq[k].numpy(), np.asarray(jq[k])), k
            assert np.array_equal(ts[k].numpy().reshape(-1),
                                  np.asarray(js[k]).reshape(-1)), k
            assert np.array_equal(tres[k].numpy(), np.asarray(jres[k])), k


# ---------------------------------------------------------------------------
# group merges
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["replicate", "merge_mean", "broadcast",
                                "drift"])
def test_group_sync_ops_match_jax(op):
    tree = grads_tree(1, (G,))
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.tensor(v) for k, v in tree.items()}
    if op == "replicate":
        want = np_tree(jgs.replicate_for_groups(
            {k: v[0] for k, v in jt.items()}, 3))
        got = gs.replicate_for_groups({k: v[0] for k, v in tt.items()}, 3)
    elif op == "merge_mean":
        want, got = np_tree(jgs.merge_groups_mean(jt)), \
            gs.merge_groups_mean(tt)
    elif op == "broadcast":
        want, got = np_tree(jgs.broadcast_merged(jt)), \
            gs.broadcast_merged(tt)
    else:
        np.testing.assert_allclose(gs.group_drift(tt).item(),
                                   float(jgs.group_drift(jt)), rtol=1e-6)
        return
    for k in tree:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_local_sgd_merge_matches_jax(step):
    """Every H = 3 steps (step % 3 == 2) parameters and momentum are
    averaged over the groups; otherwise both pass through."""
    topo = dict(kind="local_sgd", local_sgd_period=3)
    p, m = grads_tree(2, (G,)), grads_tree(3, (G,))
    jp, jm = jgs.maybe_merge_local_sgd(
        {k: jnp.asarray(v) for k, v in p.items()}, step,
        jbase.TopologyConfig(**topo),
        momentum_g={k: jnp.asarray(v) for k, v in m.items()})
    tp, tm = gs.maybe_merge_local_sgd(
        {k: torch.tensor(v) for k, v in p.items()}, step,
        tbase.TopologyConfig(**topo),
        momentum_g={k: torch.tensor(v) for k, v in m.items()})
    merged = step % 3 == 2
    for want, got, src in ((jp, tp, p), (jm, tm, m)):
        for k in src:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
            assert np.array_equal(got[k].numpy(), src[k]) != merged


# ---------------------------------------------------------------------------
# the neuron-centric network
# ---------------------------------------------------------------------------
def networks(kind):
    """(JAX network, port network) of one kind: the paper's MNIST MLP at
    hidden 32, or a small net with both interlayers and every activation."""
    if kind == "paper":
        return (jnc.paper_mnist_network(HIDDEN, DEPTH),
                nc.paper_mnist_network(HIDDEN, DEPTH))
    out = []
    for m in (jnc, nc):
        n = m.NeuronNetwork(input_units=784, input_neuron="dropout",
                            input_keep=0.8)
        n.add_layer(24, "tanh", neuron="dropout", keep=0.5,
                    interlayer=m.divide_by_sum_interlayer)
        n.add_layer(16, "sigmoid", neuron="dropout", keep=0.7,
                    interlayer=m.softmax_interlayer)
        n.add_layer(12, "relu", neuron="dropout")
        n.add_layer(10, "identity", neuron="dropout")
        out.append(n)
    return tuple(out)


@pytest.mark.parametrize("horn", ["off", "on"])
@pytest.mark.parametrize("kind", ["paper", "interlayers"])
def test_apply_loss_and_grads_match_jax(kind, horn):
    """One network, x [8, 784], with JAX's uniforms for a 2-group state:
    output within 1e-5, loss within rtol 1e-6, every gradient within atol
    1e-6 / rtol 1e-5 (f32, matmuls summed in other orders)."""
    jnet, tnet = networks(kind)
    params = jnet.init(jax.random.key(1))
    d = data(8)
    x, y = d["x_train"][:8], d["y_train"][:8]
    jh = th = None
    if horn == "on":
        jcfg, tcfg = hcfgs()
        jh = JHornState(key=jax.random.key(9), cfg=jcfg, num_groups=2)
        th = JaxUniforms(0, 0, tcfg, 2, torch.device("cpu"),
                         keys=(jh.key,))
    tparams = {k: v.requires_grad_(True) for k, v in
               nc.from_jax_params(np_tree(params), "cpu").items()}
    jout = jnet.apply(params, jnp.asarray(x), jh)
    tout = tnet.apply(tparams, torch.tensor(x), th)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jloss, jgrads = jax.value_and_grad(jnet.loss)(params, jb, jh)
    tloss = tnet.loss(tparams, {"x": torch.tensor(x), "y": torch.tensor(y)},
                      th)
    tgrads = dict(zip(tparams, torch.autograd.grad(tloss,
                                                   list(tparams.values()))))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("horn", ["off", "on"])
def test_grouped_loss_and_grads_match_jax_vmap(horn):
    """The batched path (params [G, ...], x [G, b, 784], one baddbmm a
    layer) against JAX's per-group loss under ``vmap``, with group g's
    masks from JAX's key for group g: losses within rtol 1e-6, each
    group's gradient (of the sum of the group losses) within atol 1e-6 /
    rtol 1e-5, masks equal."""
    jnet, tnet = networks("paper")
    jcfg, tcfg = hcfgs(enabled=horn == "on")
    params = jnet.init(jax.random.key(2))
    params_g = jgs.replicate_for_groups(params, G)
    params_g = jax.tree.map(
        lambda p: p + 0.01 * jax.random.normal(jax.random.key(5), p.shape),
        params_g)
    d = data(G * PER)
    xb = d["x_train"].reshape(G, PER, 784)
    yb = d["y_train"].reshape(G, PER)
    step = 3

    def group_loss(p, batch, gid):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.key(jcfg.seed_salt), step), gid)
        h = JHornState(key=key, cfg=jcfg, num_groups=1) \
            if jcfg.enabled else None
        return jnet.loss(p, batch, h)

    jl, jg = jax.vmap(jax.value_and_grad(group_loss))(
        params_g, {"x": jnp.asarray(xb), "y": jnp.asarray(yb)},
        jnp.arange(G))
    tp = {k: v.requires_grad_(True) for k, v in
          nc.from_jax_params(np_tree(params_g), "cpu").items()}
    th = jax_group_uniforms(tcfg, step, G)
    tl = tnet.loss(tp, {"x": torch.tensor(xb), "y": torch.tensor(yb)}, th)
    tg = dict(zip(tp, torch.autograd.grad(tl.sum(), list(tp.values()))))
    assert tl.shape == (G,)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


def test_params_bridge_round_trips():
    jnet, tnet = networks("paper")
    params = np_tree(jnet.init(jax.random.key(0)))
    back = nc.to_jax_params(nc.from_jax_params(params, "cpu"))
    assert back.keys() == params.keys()
    for k in params:
        assert back[k].dtype == np.float32
        assert back[k].tobytes() == params[k].tobytes()
    specs = {k: (s.shape, s.init, s.scale) for k, s in tnet.specs().items()}
    jspecs = {k: (s.shape, s.init, s.scale) for k, s in jnet.specs().items()}
    assert specs == jspecs


def test_init_draws_the_specs_scale():
    """Weights normal with std 2 / sqrt(fan_in), zero biases, on the
    generator's device, in f32."""
    net = nc.paper_mnist_network(hidden=256, depth=2)
    p = net.init(torch.Generator().manual_seed(0), "cpu")
    for i, fan in enumerate((784, 256, 256)):
        w = p[f"w{i}"]
        assert w.dtype == torch.float32
        assert abs(w.std().item() * np.sqrt(fan) / 2.0 - 1.0) < 0.05
        assert not p[f"b{i}"].any()


# ---------------------------------------------------------------------------
# the collective trainer's step
# ---------------------------------------------------------------------------
TOPOLOGIES = {
    "allreduce": dict(kind="allreduce"),
    "local_sgd": dict(kind="local_sgd", local_sgd_period=3),
    "int8": dict(kind="allreduce", grad_compression="int8"),
}


def int8_flips(want, got, scales, lr):
    """Hold one int8 step of the port against JAX's from the same state:
    (params, momentum, residuals) dicts of numpy ``want`` and ``got``, the
    port's scales [G, 1, ...].  Gradients computed in other orders differ
    at f32 rounding, so a value near a rounding tie of ``q`` may land one
    step apart: the residual then differs by exactly one scale, and the
    merged gradient by the groups' mean of that.  So every residual
    differs by 0 or 1 scales (within 1e-3 of one), and momentum and
    parameters differ by the groups' mean of the residuals' differences
    (times -lr for the parameters), within 1e-5: the f32 rounding of
    gradients up to ~1 summed in other orders.  Returns the count of
    flipped values."""
    (wp, wm, wr), (gp, gm, gr) = want, got
    flips = 0
    for k in wr:
        dr = gr[k] - wr[k]
        steps = np.abs(dr) / scales[k]
        assert np.all(np.abs(steps - np.round(steps)) < 1e-3), k
        assert np.round(steps).max() <= 1, k
        flips += int(np.round(steps).sum())
        dg = -dr.mean(axis=0)
        np.testing.assert_allclose(gm[k] - wm[k], np.broadcast_to(
            dg, wm[k].shape), atol=1e-5, err_msg=k)
        np.testing.assert_allclose(gp[k] - wp[k], np.broadcast_to(
            -lr * dg, wp[k].shape), atol=1e-5, err_msg=k)
    return flips


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_ten_steps_match_jax_step_fn(topology, monkeypatch):
    """Ten steps of ``make_step_fn`` (G 4 x b 6, Horn on, lr 0.05, mu 0.9)
    from JAX's parameters on JAX's batches and uniforms: every step's loss
    within rtol 1e-5.  allreduce and local SGD (H 3) run ten steps on each
    side; parameters and momentum within atol 2e-5 / rtol 1e-4 after the
    tenth (f32 matmuls in other orders, carried through ten momentum steps
    of lr 0.05).  int8: each step starts the port from JAX's state and is
    held by ``int8_flips`` (a chained int8 run drifts apart wherever a
    rounding tie flips one value of ``q``); fewer than 0.1 % of the values
    flip."""
    jnet, tnet = networks("paper")
    jcfg, tcfg = hcfgs()
    topo = TOPOLOGIES[topology]
    lr, mu = 0.05, 0.9
    jstep = JCT.make_step_fn(jnet, jcfg, jbase.TopologyConfig(**topo), lr,
                             mu, G)
    params = jnet.init(jax.random.key(0))
    jp = jgs.replicate_for_groups(params, G)
    jm = jax.tree.map(jnp.zeros_like, jp)
    jr = jax.tree.map(jnp.zeros_like, jp)
    monkeypatch.setattr(CT, "horn_state", jax_group_uniforms)
    scales = {}
    compress = comp.ef_compress_tree

    def recording(*a, **kw):
        q, s, r = compress(*a, **kw)
        scales.update({k: v.numpy() for k, v in s.items()})
        return q, s, r

    monkeypatch.setattr(comp, "ef_compress_tree", recording)
    tstep = CT.make_step_fn(tnet, tcfg, tbase.TopologyConfig(**topo), lr,
                            mu, G, "cpu")
    as_port = lambda tree: nc.from_jax_params(np_tree(tree), "cpu")  # noqa
    tp, tm, tr = as_port(jp), as_port(jm), as_port(jr)
    d = data(256)
    batcher = tpipe.MnistBatcher(d["x_train"], d["y_train"], G * PER, seed=1)
    flips = 0
    for step in range(10):
        b = batcher.group_batch_at(step, G)
        if topology == "int8":
            tp, tm, tr = as_port(jp), as_port(jm), as_port(jr)
        jp, jm, jr, jl = jstep(jp, jm, jr, {k: jnp.asarray(v)
                                            for k, v in b.items()}, step)
        tp, tm, tr, tl = tstep(tp, tm, tr, b, step)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5,
                                   err_msg=f"step {step}")
        if topology == "int8":
            flips += int8_flips(
                [np_tree(t) for t in (jp, jm, jr)],
                [nc.to_jax_params(t) for t in (tp, tm, tr)], scales, lr)
    if topology == "int8":
        assert flips < 1e-3 * 10 * sum(v.numel() for v in tr.values()), flips
    else:
        for want, got in ((jp, tp), (jm, tm)):
            for k in params:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), atol=2e-5,
                                           rtol=1e-4, err_msg=k)
    # allreduce and int8 merge every step; local SGD last merged at step 8
    same = all(bool((v == v[:1]).all()) for v in tp.values())
    assert same == (topology != "local_sgd")


@pytest.mark.parametrize("topology", ["allreduce", "local_sgd"])
def test_groups_draw_different_sub_models(topology):
    """With the port's own draws the groups' masks differ, the step is a
    pure function of its inputs, and local SGD's groups drift apart
    between merges (they stay equal under allreduce)."""
    net = nc.paper_mnist_network(HIDDEN, DEPTH)
    hcfg = tbase.HornConfig(enabled=True, num_groups=G, block_size=1)
    topo = tbase.TopologyConfig(**TOPOLOGIES[topology])
    h = CT.horn_state(hcfg, 4, G, "cpu")
    m = pd.unit_mask(h, 0, G, HIDDEN, keep=0.5, salt=5, block_size=1)
    assert m.shape == (G, 1, HIDDEN)
    assert len({tuple(r) for r in m[:, 0].tolist()}) == G
    step = CT.make_step_fn(net, hcfg, topo, 0.05, 0.9, G, "cpu")
    state = CT.init_groups(net, G, 0, "cpu")
    b = tpipe.MnistBatcher(*(lambda d: (d["x_train"], d["y_train"]))(
        data(64)), G * PER).group_batch_at(0, G)
    once = step(*state, b, 0)
    again = step(*state, b, 0)
    for a, c in zip(once[0].values(), again[0].values()):
        assert torch.equal(a, c)
    drift = gs.group_drift(once[0]).item()
    assert (drift > 0) == (topology == "local_sgd")


# ---------------------------------------------------------------------------
# ports of the JAX package's tests
# ---------------------------------------------------------------------------
def test_batch_averaging_equals_large_batch_sgd():
    """Port of ``test_parallel_dropout.py::test_batch_averaging_equals_
    large_batch_sgd``: averaging G groups' gradients on B/G samples each
    equals the full batch's gradient (one shared model, no dropout)."""
    net = nc.paper_mnist_network(hidden=16, depth=1)
    net.input_neuron = "standard"
    params = {k: v.requires_grad_(True) for k, v in net.init(
        torch.Generator().manual_seed(0), "cpu").items()}
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(16, 784, generator=gen)
    y = torch.randint(0, 10, (16,), generator=gen)
    leaves = list(params.values())
    full = torch.autograd.grad(net.loss(params, {"x": x, "y": y}), leaves)
    parts = [torch.autograd.grad(
        net.loss(params, {"x": x[i::4], "y": y[i::4]}), leaves)
        for i in range(4)]
    for j, a in enumerate(full):
        avg = sum(p[j] for p in parts) / 4
        np.testing.assert_allclose(a.numpy(), avg.numpy(), atol=1e-5,
                                   rtol=1e-4)


def test_dropout_neuron_masks_only_in_training():
    """Port of ``test_substrate.py::test_dropout_neuron_masks_only_in_
    training``."""
    net = nc.paper_mnist_network(hidden=32, depth=1)
    params = net.init(torch.Generator().manual_seed(0), "cpu")
    x = torch.ones(4, 784)
    eval_out = net.apply(params, x, horn=None)
    assert torch.equal(eval_out, net.apply(params, x, horn=None))
    horn = pd.HornState(seed=1, step=0, cfg=tbase.HornConfig(
        enabled=True, block_size=1), num_groups=2,
        device=torch.device("cpu"))
    train_out = net.apply(params, x, horn=horn)
    assert not torch.equal(eval_out, train_out)


def test_interlayer_normalization():
    """Port of ``test_substrate.py::test_interlayer_normalization``: the
    paper's interlayer() example normalizes positive (ReLU) activations."""
    net = nc.NeuronNetwork(input_units=4)
    net.add_layer(8, "relu", interlayer=nc.divide_by_sum_interlayer)
    params = net.init(torch.Generator().manual_seed(3), "cpu")
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(1)).abs()
    out = net.apply(params, x).numpy()
    np.testing.assert_allclose(out.sum(-1), [1.0, 1.0], atol=1e-5)
    assert (out >= 0).all()

    net2 = nc.NeuronNetwork(input_units=4)
    net2.add_layer(4, "identity", interlayer=nc.softmax_interlayer)
    p2 = net2.init(torch.Generator().manual_seed(0), "cpu")
    out2 = net2.apply(p2, torch.ones(2, 4)).numpy()
    np.testing.assert_allclose(out2.sum(-1), [1.0, 1.0], atol=1e-5)


def test_mnist_parallel_beats_chance_quickly():
    """Port of ``test_substrate.py::test_mnist_parallel_beats_chance_
    quickly``."""
    res = CT.train_mnist(num_groups=4, batch_per_group=16, num_steps=200,
                         eval_every=200, n_train=2000, hidden=64, lr=0.005,
                         device="cpu")
    assert res.final_accuracy > 0.3, res.final_accuracy
    assert res.data_source == "synthetic-7seg" and res.steps == [200]


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def test_train_cli_runs_horn_mnist_on_the_cpu(capsys):
    """``--arch horn-mnist`` with the JAX launcher's arithmetic: 20 groups
    of ``--batch // 20`` samples, evaluated every max(50, steps // 5)
    steps, its row printed as JSON."""
    from repro_torch.launch import train

    row = train.main(["--arch", "horn-mnist", "--device", "cpu", "--steps",
                      "100", "--batch", "40", "--lr", "0.005"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(row))
    assert row["data_source"] == "synthetic-7seg"
    assert row["steps"] == [50, 100]
    assert row["final_accuracy"] > 0.2, row
    assert row["name"] == "run"


def test_serve_cli_refuses_horn_mnist():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="classifier; use launch.train"):
        serve.main(["--arch", "horn-mnist", "--device", "cpu"])


def test_horn_mnist_config_matches_the_jax_package():
    ours = tbase.get_model_config("horn-mnist")
    theirs = jbase.get_model_config("horn-mnist")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert "horn-mnist" in tbase.list_archs()
    from repro_torch.configs import horn_mnist
    net = horn_mnist.network(hidden=16, depth=3)
    assert [l.units for l in net.layers] == [16, 16, 16, 10]


def test_mnist_repro_benchmark_rows():
    """The benchmark's three CSV rows and its detail, at 20 steps on the
    CPU."""
    from repro_torch.benchmarks import mnist_repro

    rows, detail = mnist_repro.run(num_steps=20, eval_every=10,
                                   device="cpu")
    assert [r[0] for r in rows] == [
        "mnist_nonparallel_dropout", "mnist_parallel_dropout_20x5",
        "mnist_parallel_minus_nonparallel"]
    assert rows[0][1] > 0 and rows[1][1] > 0 and rows[2][1] == 0.0
    assert "(paper: +0.0178)" in rows[2][2]
    assert set(detail) == {"non_parallel", "parallel"}
    for d in detail.values():
        assert d["steps"] == [10, 20]
        assert d["data_source"] == "synthetic-7seg"


def test_mnist_entry_points_refuse_missing_cuda():
    """``device`` defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA"):
        CT.train_mnist(num_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        CT.make_step_fn(nc.paper_mnist_network(), tbase.HornConfig(),
                        tbase.TopologyConfig(), 0.1, 0.9, 1)
    with pytest.raises(RuntimeError, match="no CUDA"):
        nc.paper_mnist_network().init(torch.Generator())
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA"):
        train.main(["--arch", "horn-mnist", "--steps", "1"])
