"""The port's scale-out on ``torch.distributed`` against the JAX package's
SPMD programs, on the CPU: gloo ranks under ``torch.multiprocessing``
(spawn), one process group each job from a ``file://`` store in
``tmp_path``.

Job A (4 ranks) runs the cross-process merges (``psum_mean``,
``merge_grads`` plain and int8 with error feedback, over the default
group and over a 2 x 2 mesh's two dims), the 4-stage GPipe schedule
(``pipelined_apply``, S 4, M 8: forward and the gradient of a scalar),
the sharded train step at 2 x 2 and 4 x 1 on reduced qwen3-1.7b (d_model
64, d_ff 128, f32 stream and compute, AdamW) with Horn off and on (4
groups), and saves the 2 x 2 run's state after step 2 before taking step
3.  Job B (2 ranks) restores that checkpoint onto a 2 x 1 mesh and takes
step 3, then runs the train CLI on its group.  The JAX side: its ``shard_map`` merges and ``pipelined_apply`` in
one subprocess with 4 forced host devices (as
``tests/test_elastic_and_analysis.py`` runs them), and its 1 x 1 train
step in this process.  Module-scoped fixtures run each job once; the
cases read their results.  Each job is joined under its own timeout, so
a hang fails the test instead of eating the suite's time.
"""
import contextlib
import dataclasses
import io
import os
import pickle
import subprocess
import sys
import textwrap
import time
from functools import partial

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import base as tbase
from repro_torch.core import group_sync as gs
from repro_torch.core import parallel_dropout as pd
from repro_torch.core import steps as TS
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import TrainStateCheckpointer
from repro_torch.models.params import to_jax_flat
from repro_torch.runtime.elastic import remesh_state
from repro_torch.runtime.pipeline import pipelined_apply

JOIN_TIMEOUT = 120
B, S = 8, 32
STEPS = 2
HORN = dict(num_groups=4, block_size=16)
MESHES = [(2, 2), (4, 1)]
RUNS = [f"{d}x{m}-{h}" for d, m in MESHES for h in ("off", "on")]
PIPE = dict(S=4, L=2, M=8, mb=4, d=16)


def run_config(horn: str) -> tbase.RunConfig:
    cfg = dataclasses.replace(tbase.reduced(
        tbase.get_model_config("qwen3-1.7b"), d_model=64, d_ff=128),
        dtype="float32")
    return tbase.RunConfig(
        model=cfg, shape=tbase.ShapeConfig("t", "train", S, B),
        horn=tbase.HornConfig(**HORN) if horn == "on"
        else tbase.HornConfig(enabled=False),
        optimizer="adamw", learning_rate=1e-3, compute_dtype="float32",
        seed=0)


def batch_at(step: int):
    return tpipe.SyntheticTokenPipeline(tpipe.TokenPipelineConfig(
        vocab_size=run_config("off").model.vocab_size, seq_len=S,
        global_batch=B, seed=0)).batch_at(step)


@dataclasses.dataclass(frozen=True)
class TableHorn(pd.HornState):
    """A HornState drawing its uniforms from ``table`` {(step, layer,
    salt, shape): array}: JAX's own draws, so every side applies JAX's
    masks."""
    table: object = None

    def uniform(self, layer_idx, salt, shape):
        return torch.tensor(
            self.table[(self.step, layer_idx, salt, tuple(shape))],
            device=self.device)


def table_horn(table, seed, hcfg, step, device, **kw):
    st = pd.make_horn_state(seed, hcfg, step, device, **kw)
    return TableHorn(st.seed, st.step, st.cfg, st.num_groups, st.device,
                     st.rows, table=table)


def params_of(state, run):
    """The parameters in JAX's layout, copied: on the CPU ``to_jax_flat``
    hands out views of the masters, which later steps update in place."""
    return {k: v.copy() for k, v in to_jax_flat(state["params"],
                                                 run.model).items()}


def block_fn(w, h):
    for i in range(w.shape[0]):
        h = torch.tanh(h @ w[i])
    return h


# ---------------------------------------------------------------------------
# the spawned jobs (module level: spawn pickles them by name)
# ---------------------------------------------------------------------------
def _init(rank, world, tmp, tag):
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{tag}.store",
                            rank=rank, world_size=world)


def _dump(tmp, name, obj):
    with open(os.path.join(tmp, name + ".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(os.path.join(tmp, name + ".tmp"), os.path.join(tmp, name))


def _merges(rank, inputs):
    from repro_torch.configs.base import TopologyConfig
    tree = {"w": torch.tensor(inputs["g_w"][rank]),
            "b": torch.tensor(inputs["g_b"][rank])}
    res = {"w": torch.tensor(inputs["r_w"][rank]),
           "b": torch.tensor(inputs["r_b"][rank])}
    mesh = make_test_mesh(2, 2, "cpu")
    int8 = TopologyConfig(grad_compression="int8")
    out = {"psum_mean": gs.psum_mean(tree, None),
           "psum_mean_mesh": gs.psum_mean(
               tree, (mesh.get_group("data"), mesh.get_group("model"))),
           "none": gs.merge_grads(tree, None, TopologyConfig())[0]}
    out["int8"], out["int8_res"] = gs.merge_grads(tree, None, int8)
    out["int8_with_res"], out["int8_with_res_res"] = gs.merge_grads(
        tree, None, int8, res)
    return {k: {n: t.numpy() for n, t in v.items()} for k, v in out.items()}


def _pipeline(rank, inputs):
    w = torch.tensor(inputs["ws"][rank]).requires_grad_(True)
    out = pipelined_apply(block_fn, w, torch.tensor(inputs["x"]), group=None)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "grad": w.grad.numpy()}


def _train(rank, tmp, flat, table):
    orig = TS.make_horn_state
    out = {}
    for (data, model) in MESHES:
        for horn in ("off", "on"):
            run = run_config(horn)
            TS.make_horn_state = (partial(table_horn, table) if horn == "on"
                                  else orig)
            mesh = make_test_mesh(data, model, "cpu")
            state = remesh_state(TS.state_from_jax_flat(flat, run, "cpu"),
                                 TS.state_axes(run),
                                 TS.make_ctx(run.model, mesh, run.shape))
            step = TS.make_train_step(run, "cpu", mesh=mesh)
            metrics = []
            for i in range(STEPS):
                state, m = step(state, batch_at(i))
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
            name = f"{data}x{model}-{horn}"
            out[name] = {"metrics": metrics,
                         "params": params_of(state, run),
                         "placements": sorted({str(p.placements) for p in
                                               state["params"].parameters()})}
            if name == "2x2-off":
                ck = TrainStateCheckpointer(os.path.join(tmp, "ckpt"), run)
                ck.save(STEPS, state)
                state, m = step(state, batch_at(STEPS))
                out["unbroken_step3"] = m["loss"].item()
    TS.make_horn_state = orig
    return out


def job_a(rank, world, tmp):
    _init(rank, world, tmp, "a")
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {"merges": _merges(rank, inputs),
           "pipeline": _pipeline(rank, inputs),
           "train": _train(rank, tmp, inputs["flat"], inputs["table"])}
    _dump(tmp, f"a{rank}.pkl", res)
    dist.barrier()
    dist.destroy_process_group()


def job_b(rank, world, tmp):
    _init(rank, world, tmp, "b")
    run = run_config("off")
    mesh = make_test_mesh(2, 1, "cpu")
    ck = TrainStateCheckpointer(os.path.join(tmp, "ckpt"), run)
    like = TS.init_state(run, "cpu")
    state, at = ck.restore(like, shardings=TS.state_shardings(run, mesh))
    step = TS.make_train_step(run, "cpu", mesh=mesh)
    state, m = step(state, batch_at(at))
    res = {"at": at, "step": state["step"], "loss": m["loss"].item(),
           "placements": sorted({str(p.placements)
                                 for p in state["params"].parameters()})}
    buf = io.StringIO()                 # the train CLI on this group
    with contextlib.redirect_stdout(buf):
        cli = train.main(["--arch", "qwen3-1.7b", "--device", "cpu",
                          "--mesh-data", "2", "--mesh-model", "2",
                          "--topology", "zero1", "--steps", "2", "--batch",
                          "4", "--seq", "16", "--log-every", "1"])
    res["cli"] = {"text": buf.getvalue(), "mesh": cli["mesh"],
                  "losses": [r["loss"] for r in cli["steps"]]}
    _dump(tmp, f"b{rank}.pkl", res)
    dist.barrier()
    dist.destroy_process_group()


def spawn(fn, nprocs, tmp):
    """Run ``fn(rank, nprocs, tmp)`` on ``nprocs`` spawned ranks; kill them
    and fail when they have not all ended after ``JOIN_TIMEOUT`` s."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=(nprocs, str(tmp)), nprocs=nprocs, join=False,
        start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: ranks still running "
                                   f"after {JOIN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(nprocs):
        with open(os.path.join(tmp, f"{fn.__name__[-1]}{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
JAX_PROG = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs.base import TopologyConfig
    from repro.core.group_sync import merge_grads, psum_mean
    from repro.launch.mesh import shard_map
    from repro.runtime.pipeline import pipelined_apply

    tmp = sys.argv[1]
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    int8 = TopologyConfig(grad_compression="int8")

    def per_rank(fn, *trees):
        spec = P("data")
        sm = shard_map(lambda *t: fn(*[jax.tree.map(lambda x: x[0], a)
                                       for a in t]),
                       mesh=mesh, in_specs=(spec,) * len(trees),
                       out_specs=spec, check_vma=False)
        out = sm(*trees)
        return jax.tree.map(np.asarray, out)

    g = {"w": jnp.asarray(inp["g_w"]), "b": jnp.asarray(inp["g_b"])}
    r = {"w": jnp.asarray(inp["r_w"]), "b": jnp.asarray(inp["r_b"])}
    lead = lambda t: jax.tree.map(lambda x: x[None], t)
    out = {
        "psum_mean": per_rank(lambda t: lead(psum_mean(t, "data")), g),
        "none": per_rank(lambda t: lead(
            merge_grads(t, "data", TopologyConfig())[0]), g),
        "int8": per_rank(lambda t: lead(merge_grads(t, "data", int8)[0]), g),
        "int8_res": per_rank(lambda t: lead(
            merge_grads(t, "data", int8)[1]), g),
        "int8_with_res": per_rank(lambda t, q: lead(
            merge_grads(t, "data", int8, q)[0]), g, r),
        "int8_with_res_res": per_rank(lambda t, q: lead(
            merge_grads(t, "data", int8, q)[1]), g, r),
    }

    smesh = Mesh(np.array(jax.devices()), ("stage",))
    ws, x = jnp.asarray(inp["ws"]), jnp.asarray(inp["x"])

    def block_fn(w, h):
        for i in range(w.shape[0]):
            h = jnp.tanh(h @ w[i])
        return h

    def loss(ws):
        return jnp.sum(pipelined_apply(block_fn, ws, x, mesh=smesh) ** 2)

    out["pipe_out"] = np.asarray(pipelined_apply(block_fn, ws, x,
                                                 mesh=smesh))
    out["pipe_grad"] = np.asarray(jax.grad(loss)(ws))
    with open(os.path.join(tmp, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)
    print("JAX_OK")
""")


class JaxTable(dict):
    """{(step, layer, salt, shape): JAX's uniforms}, each drawn from the
    JAX step's key chain the first time it is asked for."""

    def __missing__(self, key):
        import jax
        step, layer, salt, shape = key
        hcfg = tbase.HornConfig(**HORN)
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(0), hcfg.seed_salt), step)
        k = jax.random.fold_in(jax.random.fold_in(k, layer), salt)
        self[key] = np.asarray(jax.random.uniform(k, shape))
        return self[key]


def jax_runs(flat):
    """JAX's 1 x 1 train step, Horn off and on: {name: (metrics, params)}."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.core import steps as JS
    from repro.launch.mesh import make_test_mesh as jax_mesh

    out = {}
    for horn in ("off", "on"):
        t = run_config(horn)
        jrun = jbase.RunConfig(
            model=jbase.ModelConfig(**dataclasses.asdict(t.model)),
            shape=jbase.ShapeConfig(*dataclasses.astuple(t.shape)),
            horn=jbase.HornConfig(**dataclasses.asdict(t.horn)),
            optimizer=t.optimizer, learning_rate=t.learning_rate,
            compute_dtype=t.compute_dtype, seed=t.seed)
        step_fn, _ = JS.make_train_step(jrun, jax_mesh(1, 1))
        state = JS.init_state(jax.random.key(0), jrun)
        metrics = []
        for i in range(STEPS):
            state, m = step_fn(state, {k: jnp.asarray(v)
                                       for k, v in batch_at(i).items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[horn] = (metrics, {
            jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_leaves_with_path(state["params"])})
        if horn == "off":
            flat.update({jax.tree_util.keystr(p): np.asarray(x) for p, x in
                         jax.tree_util.tree_leaves_with_path(
                             JS.init_state(jax.random.key(0), jrun))})
    return out


def port_runs(flat, table):
    """The one-process port step, Horn off and on (``table``'s uniforms):
    {name: (metrics, params)}, plus step 3's loss Horn off."""
    out = {}
    orig = TS.make_horn_state
    try:
        for horn in ("off", "on"):
            run = run_config(horn)
            TS.make_horn_state = (partial(table_horn, table) if horn == "on"
                                  else orig)
            state = TS.state_from_jax_flat(flat, run, "cpu")
            step = TS.make_train_step(run, "cpu")
            metrics = []
            for i in range(STEPS + (horn == "off")):
                state, m = step(state, batch_at(i))
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
                if i == STEPS - 1:
                    params = params_of(state, run)
            out[horn] = (metrics[:STEPS], params)
            if horn == "off":
                out["step3"] = metrics[STEPS][0]
    finally:
        TS.make_horn_state = orig
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every job's results: the JAX subprocess runs beside job A."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    flat = {}
    jax_ref = jax_runs(flat)            # fills flat with JAX's init state
    table = JaxTable()
    port = port_runs(flat, table)       # fills table with every draw
    p = PIPE
    inputs = {
        "g_w": rng.normal(size=(4, 8, 16)).astype(np.float32),
        "g_b": rng.normal(size=(4, 16)).astype(np.float32),
        "r_w": (rng.normal(size=(4, 8, 16)) * 0.01).astype(np.float32),
        "r_b": (rng.normal(size=(4, 16)) * 0.01).astype(np.float32),
        "ws": (rng.normal(size=(p["S"], p["L"], p["d"], p["d"]))
               * p["d"] ** -0.5).astype(np.float32),
        "x": rng.normal(size=(p["M"], p["mb"], p["d"])).astype(np.float32),
        "flat": flat, "table": dict(table)}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_PROG, str(tmp)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src"})
    try:
        a = spawn(job_a, 4, tmp)
        b = spawn(job_b, 2, tmp)
        stdout, stderr = jax_proc.communicate(timeout=JOIN_TIMEOUT)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert "JAX_OK" in stdout, stderr[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        jx = pickle.load(f)
    return {"a": a, "b": b, "jax": jx, "jax_train": jax_ref, "port": port,
            "inputs": inputs, "tmp": tmp}


MERGES = ["psum_mean", "psum_mean_mesh", "none", "int8", "int8_res",
          "int8_with_res", "int8_with_res_res"]


@pytest.mark.parametrize("name", MERGES)
def test_merges_match_jax_shard_map(results, name):
    """Each rank's merge (and its new error-feedback residuals) equals
    JAX's ``shard_map`` merge on 4 host devices within 1e-6 (f32); the
    sum over the 2 x 2 mesh's two groups is the sum over all 4 ranks."""
    want = results["jax"][name.replace("_mesh", "")]
    for rank, res in enumerate(results["a"]):
        got = res["merges"][name]
        for leaf in ("w", "b"):
            np.testing.assert_allclose(got[leaf], want[leaf][rank],
                                       atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name} {leaf} rank {rank}")


def unpipelined(inputs):
    ws = torch.tensor(inputs["ws"]).requires_grad_(True)
    h = torch.tensor(inputs["x"])
    for s in range(ws.shape[0]):
        h = block_fn(ws[s], h)
    (h ** 2).sum().backward()
    return h.detach().numpy(), ws.grad.numpy()


@pytest.mark.parametrize("against", ["jax", "unpipelined"])
@pytest.mark.parametrize("what", ["forward", "grad"])
def test_pipeline_matches(results, what, against):
    """S 4, M 8: every rank's output and its stage's gradient of
    sum(out^2) equal JAX's ``pipelined_apply`` on a 4-device host mesh and
    the port's unpipelined stack within 1e-5."""
    if against == "jax":
        out, grad = results["jax"]["pipe_out"], results["jax"]["pipe_grad"]
    else:
        out, grad = unpipelined(results["inputs"])
    for rank, res in enumerate(results["a"]):
        got = res["pipeline"]
        if what == "forward":
            np.testing.assert_allclose(got["out"], out, atol=1e-5, rtol=1e-5)
        else:
            np.testing.assert_allclose(got["grad"], grad[rank], atol=1e-5,
                                       rtol=1e-5, err_msg=f"stage {rank}")


@pytest.mark.parametrize("against", ["port", "jax"])
@pytest.mark.parametrize("name", RUNS)
def test_sharded_step_matches_one_process(results, name, against):
    """Two AdamW steps on the mesh: every rank's loss and grad norm equal
    the one-process port step's and JAX's 1 x 1 step's within rtol 1e-5
    (f32; the ranks' gradients are summed in another order), and so do
    the parameters after step 2 (gathered) against the port's, within
    1e-5.  Against JAX's parameters the tolerance is atol 1e-4, a tenth
    of one step of lr 1e-3, as ``test_torch_train.py`` holds the
    one-process port step: AdamW divides each element's step by its own
    gradient scale, so an element whose gradient sits at the rounding
    noise moves by a visible fraction of lr (one element of 16,384 in
    ``mlp.wi`` parts by 1.7e-5 at Horn off, at the port's own 1e-5
    agreement with the one-process step).  The state is really laid out:
    FSDP on "embed" over data (d_model 64 divides 2 and 4), the wide dims
    over model at 2 x 2."""
    horn = name.split("-")[1]
    metrics, params = results["jax_train" if against == "jax" else
                              "port"][horn]
    atol = 1e-4 if against == "jax" else 1e-5
    for rank, res in enumerate(results["a"]):
        got = res["train"][name]
        np.testing.assert_allclose(got["metrics"], metrics, rtol=1e-5,
                                   err_msg=f"{name} rank {rank}")
        assert set(got["params"]) == set(params)
        for key in params:
            np.testing.assert_allclose(got["params"][key], params[key],
                                       atol=atol, rtol=1e-5,
                                       err_msg=f"{name} {key}")
        placements = " ".join(got["placements"])
        assert "Shard(dim=0)" in placements or "Shard(dim=1)" in placements


def test_elastic_restart_takes_the_unbroken_step(results):
    """4 ranks at 2 x 2 save after step 2; 2 ranks at 2 x 1 restore the
    checkpoint onto their mesh and take step 3: its loss equals the
    unbroken 2 x 2 run's bit for bit (both split the batch over 2 data
    ranks; the model ranks only store) and the one-process run's within
    1e-5."""
    unbroken = results["a"][0]["train"]["unbroken_step3"]
    assert all(r["train"]["unbroken_step3"] == unbroken
               for r in results["a"])
    for r in results["b"]:
        assert r["at"] == STEPS and r["step"] == STEPS + 1
        assert r["loss"] == unbroken
        assert "Shard(dim=0)" in " ".join(r["placements"])
    np.testing.assert_allclose(unbroken, results["port"]["step3"],
                               rtol=1e-5)


def test_train_cli_on_two_ranks(results):
    """The train CLI in a job's process group (2 gloo ranks) takes
    ``--mesh-data 2 --mesh-model 2``, clamped to (2, 1) as the JAX
    launcher clamps to the devices there are: rank 0 alone prints, the
    topology first and the mesh line second, and both ranks hold the same
    finite losses."""
    ranks = [r["cli"] for r in results["b"]]
    assert all(r["mesh"] == {"data": 2, "model": 1} for r in ranks)
    lines = ranks[0]["text"].splitlines()
    assert lines[0].startswith("topology: zero1: sharded parameter-server")
    assert lines[1].startswith("mesh: {'data': 2, 'model': 1}  arch: "
                               "qwen3-1.7b-reduced")
    assert "ranks: 2" in lines[2] and ranks[1]["text"] == ""
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert len(ranks[0]["losses"]) == 2
    assert all(np.isfinite(x) for x in ranks[0]["losses"])
