"""The port's dry run and its steps on a mesh, on the CPU.

* ``launch/dryrun.py::applicable`` and ``core/steps.py``'s
  ``input_specs``/``decode_input_specs`` and
  ``models/transformer.py::cache_logical_axes`` against the JAX
  package's, every arch x shape (JAX on its CPU backend).
* ``run_cell`` on a reduced config of every arch, for each shape kind,
  on fake worlds of 2 x 2 and 2 x 2 x 2 ranks: one subprocess a world (a
  fake default group left in a pytest worker would break its later
  tests), the two in parallel.
* A spawned 2 x 2 gloo job (f32): the mesh prefill step and 2 decode
  steps of reduced qwen3-1.7b, mamba2-2.7b and whisper-base against the
  one-process steps; reduced phi3.5-moe's loss, router losses and
  gradients through ``model_loss(dp_groups=)``, and its train step,
  against the one-process ones; llama4-maverick (experts in its config,
  no MoE layer) steps on the mesh.  Tolerance 1e-5 throughout.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import base as tbase
from repro_torch.core import steps as TS
from repro_torch.launch import dryrun as D
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.models.params import copy_into, empty_params

ARCHS = [a for a in tbase.list_archs() if a != "horn-mnist"]
KINDS = ["train", "prefill", "decode"]
SHAPE_OF = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}
WORLDS = {"2x2": 4, "2x2x2": 8}
JOIN_TIMEOUT = 300
TOL = 1e-5


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(tbase.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_matches_reference(arch, shape):
    pytest.importorskip("jax")
    from repro.launch import dryrun as jdry
    assert D.applicable(arch, shape) == jdry.applicable(arch, shape)
    assert D.LONG_OK == jdry.LONG_OK


def jax_run(run):
    from repro.configs import base as jbase
    return jbase.RunConfig(
        model=jbase.ModelConfig(**dataclasses.asdict(run.model)),
        shape=jbase.ShapeConfig(*dataclasses.astuple(run.shape)))


@pytest.mark.parametrize("shape", list(tbase.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import steps as JS
    run = D.make_run(arch, shape, False)
    jrun = jax_run(run)

    def same(got, want):
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert str(got[k].dtype).split(".")[-1] == \
                jnp.dtype(want[k].dtype).name, k
            assert got[k].device.type == "meta", k

    same(TS.input_specs(run), JS.input_specs(jrun))
    if run.shape.kind == "decode":
        same(TS.decode_input_specs(run), JS.decode_input_specs(jrun))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_axes_match_reference(arch):
    jax = pytest.importorskip("jax")
    from repro.configs import base as jbase
    from repro.models import transformer as JT
    cfg = tbase.get_model_config(arch)
    jcfg = jbase.get_model_config(arch)
    got = T.cache_logical_axes(cfg, T.init_cache(cfg, 2, 8, device="meta"))
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 8))
    want = JT.cache_logical_axes(jcfg, jcache)
    P, R = len(cfg.layer_pattern), cfg.pattern_repeats
    for li, entry in enumerate(got):
        if li < R * P:
            ref = [("layers",) + tuple(a)[1:] for a in want["blocks"][
                f"l{li % P}"]]
            assert [("layers",) + a for a in entry] == ref, li
        else:
            assert list(entry) == [tuple(a) for a in want["rem"][
                f"r{li - R * P}"]], li


# ---------------------------------------------------------------------------
# run_cell on fake worlds
# ---------------------------------------------------------------------------
CELLS_PROG = textwrap.dedent("""
    import json, sys
    from repro_torch.configs.base import (HornConfig, RunConfig, ShapeConfig,
                                          get_model_config, list_archs,
                                          reduced)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import _mesh

    n = int(sys.argv[1])
    dims = (2, 2) if n == 4 else (2, 2, 2)
    names = ("data", "model") if n == 4 else ("pod", "data", "model")
    shape_of = {"train": "train_4k", "prefill": "prefill_32k",
                "decode": "decode_32k"}
    rows = []
    with D.fake_world(n):
        mesh = _mesh(dims, names, "cpu")
        for arch in sys.argv[2].split(","):
            cfg = get_model_config(arch)
            cfg = reduced(cfg, num_layers=len(cfg.layer_pattern))
            for kind, name in shape_of.items():
                run = RunConfig(model=cfg, shape=ShapeConfig(name, kind, 32, 8),
                                horn=HornConfig(enabled=kind == "train"),
                                optimizer="adamw")
                rows.append(D.run_cell(arch, name, n == 8, verbose=False,
                                       run=run, mesh=mesh))
    print("ROWS" + json.dumps(rows, default=str))
""")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_run_cell_on_fake_world(jobs, world, arch, kind):
    row = jobs["cells"][world][(arch, kind)]
    assert row["status"] == "ok", row.get("error")
    assert row["mesh"] == world and row["chips"] == WORLDS[world]
    for k in ("hlo_flops", "hlo_bytes", "coll_bytes", "per_device_mem_bytes",
              "model_flops"):
        assert row[k] > 0, k
    kinds = set(row["coll_by_kind"])
    assert "all-gather" in kinds        # the parameters, gathered whole
    if kind == "train":                 # the gradients' means
        assert "all-reduce" in kinds
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["raw_cost_flops"] is None


# ---------------------------------------------------------------------------
# the steps on a 2 x 2 gloo mesh against the one-process steps
# ---------------------------------------------------------------------------
SERVE_ARCHS = ["qwen3-1.7b", "mamba2-2.7b", "whisper-base"]
B, PROMPT, MAX_LEN, DECODES = 4, 16, 32, 2


def serve_runs(arch):
    cfg = dataclasses.replace(tbase.reduced(tbase.get_model_config(arch)),
                              dtype="float32")
    return [tbase.RunConfig(model=cfg, shape=tbase.ShapeConfig(
        kind, kind, MAX_LEN, B), compute_dtype="float32", seed=0)
        for kind in ("prefill", "decode")]


def serve_inputs(arch, seed=0):
    cfg = serve_runs(arch)[0].model
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT),
                                    dtype=np.int64)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)
                                     ).astype(np.float32)
    nxt = rng.integers(0, cfg.vocab_size, (DECODES, B, 1), dtype=np.int64)
    return batch, nxt


def serve(arch, mesh=None):
    """(prefill logits, each decode's logits, the cache after) as numpy;
    on a mesh the cache gathered whole."""
    from torch.distributed.tensor import DTensor
    from repro_torch.runtime.elastic import reshard
    prun, drun = serve_runs(arch)
    params = TS.init_state(prun, "cpu")["params"]
    if mesh is not None:
        params = reshard(params, TS.state_shardings(prun, mesh)["params"])
    batch, nxt = serve_inputs(arch)
    logits, cache, *enc = TS.make_prefill_step(prun, "cpu", mesh=mesh)(
        params, {k: torch.as_tensor(v) for k, v in batch.items()})
    out = {"prefill": logits.numpy().copy()}
    decode = TS.make_decode_step(drun, "cpu", mesh=mesh)
    for i in range(DECODES):
        logits, cache = decode(params, cache, torch.as_tensor(nxt[i]),
                               PROMPT + i, *enc)
        out[f"decode{i}"] = logits.numpy().copy()

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()

    out["cache"] = [[whole(t) for t in entry] for entry in cache]
    if enc:
        out["encoder_out"] = whole(enc[0])
    return out


def moe_run(arch):
    cfg = dataclasses.replace(tbase.reduced(tbase.get_model_config(arch)),
                              dtype="float32")
    return tbase.RunConfig(model=cfg, shape=tbase.ShapeConfig("t", "train",
                                                              16, 8),
                           horn=tbase.HornConfig(enabled=False),
                           optimizer="adamw", learning_rate=1e-3,
                           compute_dtype="float32", seed=0)


def moe_batch(run):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, run.model.vocab_size, (8, 17), dtype=np.int64)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train(arch, mesh=None):
    """(the loss, the router losses and the gradients of ``model_loss``,
    then one train step's metrics and parameters), numpy."""
    from repro_torch.core.group_sync import psum_mean
    from repro_torch.runtime.elastic import remesh_state
    run = moe_run(arch)
    state = TS.init_state(run, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in moe_batch(run).items()}
    cparams = copy_into(empty_params(run.model, "cpu"), state["params"])
    names = [n for n, _ in cparams.named_parameters()]
    leaves = [p.requires_grad_(True) for p in cparams.parameters()]
    rows, groups = batch, None
    if mesh is not None:
        ctx = TS.make_ctx(run.model, mesh, run.shape)
        rows = {k: TS.rank_rows(v, ctx) for k, v in batch.items()}
        groups = ctx.dp_groups
    loss, metrics = api.model_loss(cparams, rows, run.model,
                                   dp_groups=groups)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves,
                                                allow_unused=True,
                                                materialize_grads=True)))
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is not None:
        grads = psum_mean(grads, groups)
        metrics = psum_mean(metrics, groups)
        state = remesh_state(state, TS.state_axes(run), ctx)
    out = {"metrics": {k: v.item() for k, v in metrics.items()},
           "grads": {k: v.numpy() for k, v in grads.items()}}
    state, m = TS.make_train_step(run, "cpu", mesh=mesh)(state,
                                                         moe_batch(run))
    out["step"] = {k: v.item() for k, v in m.items()}
    from repro_torch.runtime.elastic import place
    out["params"] = {n: place(p, None).numpy().copy()
                     for n, p in state["params"].named_parameters()}
    return out


def job(rank, world, tmp):
    from repro_torch.launch.mesh import make_test_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    mesh = make_test_mesh(2, 2, "cpu")
    res = {a: serve(a, mesh) for a in SERVE_ARCHS}
    res.update({a: train(a, mesh) for a in ("phi3.5-moe-42b",
                                            "llama4-maverick-400b")})
    with open(os.path.join(tmp, f"r{rank}.tmp"), "wb") as f:
        pickle.dump(res, f)
    os.replace(os.path.join(tmp, f"r{rank}.tmp"),
               os.path.join(tmp, f"r{rank}.pkl"))
    dist.barrier()
    dist.destroy_process_group()


def start_cells():
    """Two subprocesses a world, each on half of the archs."""
    halves = [",".join(ARCHS[i::2]) for i in range(2)]
    return [(w, subprocess.Popen(
        [sys.executable, "-c", CELLS_PROG, str(n), archs],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src"}))
        for w, n in WORLDS.items() for archs in halves]


def read_cells(procs):
    out, kind_of = {w: {} for w in WORLDS}, {v: k for k, v in
                                             SHAPE_OF.items()}
    for w, p in procs:
        stdout, stderr = p.communicate(timeout=JOIN_TIMEOUT)
        assert p.returncode == 0, stderr[-3000:]
        line = [ln for ln in stdout.splitlines() if ln.startswith("ROWS")]
        out[w].update({(r["arch"], kind_of[r["shape"]]): r
                       for r in json.loads(line[0][4:])})
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Everything that runs beside this process, started together: the
    two fake worlds' cells ({world: {(arch, kind): row}}), the 4 gloo
    ranks' results of ``job``, and the one-process results, computed
    while they run."""
    tmp = tmp_path_factory.mktemp("mesh_steps")
    procs = start_cells()
    ctx = torch.multiprocessing.start_processes(
        job, args=(4, str(tmp)), nprocs=4, join=False, start_method="spawn")
    try:
        one = {a: serve(a) for a in SERVE_ARCHS}
        one.update({a: train(a) for a in ("phi3.5-moe-42b",
                                          "llama4-maverick-400b")})
        cells = read_cells(procs)
        deadline = time.monotonic() + JOIN_TIMEOUT
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{JOIN_TIMEOUT} s")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = []
    for r in range(4):
        with open(tmp / f"r{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"cells": cells, "ranks": ranks, "one": one}


def close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_mesh_prefill_and_decode_match_one_process(jobs, arch):
    ranks, one = jobs["ranks"], jobs["one"]
    want = one[arch]
    for r, res in enumerate(ranks):
        got = res[arch]
        for k in ["prefill"] + [f"decode{i}" for i in range(DECODES)]:
            close(got[k], want[k], f"rank {r} {k}")
        for li, (ge, we) in enumerate(zip(got["cache"], want["cache"])):
            for g, w in zip(ge, we):
                close(g, w, f"rank {r} cache layer {li}")
        if "encoder_out" in want:
            close(got["encoder_out"], want["encoder_out"], "encoder_out")


def test_moe_router_losses_over_data_ranks(jobs):
    """The load-balance loss of the 2 x 2 mesh is the whole batch's (its
    two means all-reduced over the data ranks), and so are its
    gradients."""
    ranks, one = jobs["ranks"], jobs["one"]
    want = one["phi3.5-moe-42b"]
    assert want["metrics"]["load_balance_loss"] > 0
    for r, res in enumerate(ranks):
        got = res["phi3.5-moe-42b"]
        for k, v in want["metrics"].items():
            close(got["metrics"][k], v, f"rank {r} {k}")
        for k, v in want["grads"].items():
            close(got["grads"][k], v, f"rank {r} grad {k}")


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "llama4-maverick-400b"])
def test_mesh_train_step_with_experts(jobs, arch):
    """The MoE refusal is gone: phi3.5-moe's and llama4-maverick's (128
    experts in its config, no MoE layer) mesh train steps equal the
    one-process step."""
    ranks, one = jobs["ranks"], jobs["one"]
    want = one[arch]
    for r, res in enumerate(ranks):
        got = res[arch]
        for k, v in want["step"].items():
            close(got["step"][k], v, f"rank {r} {k}")
        for k, v in want["params"].items():
            close(got["params"][k], v, f"rank {r} param {k}")
