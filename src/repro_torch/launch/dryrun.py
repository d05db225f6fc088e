"""Multi-pod dry run: trace every (architecture x input-shape) cell on the
production mesh and count its roofline terms, with no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k [--multi-pod | --both-meshes] [--out results.json]

The port of ``repro/launch/dryrun.py``.  The reference forces 512 host
devices and lowers and compiles each cell's jitted step on its ``ref``
backend.  Here the CLI starts a fake world of 256 (or 512) ranks in this
one process (``torch.distributed``'s "fake" backend: collectives return at
once and move nothing), builds rank 0's shard of the state as DTensors of
fake tensors (``FakeTensorMode``: shapes and dtypes, no memory), and runs
one step of the cell on the CPU's plain path under
``analysis.CostCounter``, which counts that rank's FLOPs, bytes,
collectives and peak live storage.  Every rank runs the same program on
its own rows, so rank 0's counts are any rank's.

A sharding mismatch, an unsupported collective or a shape error fails the
cell here, as it fails the reference's compile.  Exit 1 when any cell
fails; a skipped cell is documented, not failed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (MAMBA, SHAPES, HornConfig, RunConfig,
                                      get_model_config, list_archs)
from repro_torch.core import steps
from repro_torch.launch import analysis
from repro_torch.launch.mesh import local_range, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.layers import dtype_of
from repro_torch.models.params import empty_params
from repro_torch.optim.sgd import make_optimizer

# long_500k applicability (DESIGN.md §Arch-applicability): run only for archs
# with sub-quadratic / windowed sequence structure.
LONG_OK = {"mamba2-2.7b", "jamba-1.5-large-398b", "gemma2-27b", "gemma3-4b"}


def applicable(arch: str, shape_name: str):
    """The reference's rule, plus the port's one gap: a train cell of an
    arch with Mamba layers needs an SSD backward neither package has."""
    if shape_name == "long_500k" and arch not in LONG_OK:
        return False, "pure full-attention arch: 500k ctx skipped (DESIGN.md)"
    if arch == "whisper-base" and shape_name == "long_500k":
        return False, "enc-dec audio: 500k decoder ctx is architecturally moot"
    if (SHAPES[shape_name].kind == "train"
            and MAMBA in get_model_config(arch).layer_kinds()):
        return False, ("SSM training: the SSD chunk scan has no backward "
                       "(ROADMAP §1 item 18)")
    return True, ""


def make_run(arch: str, shape_name: str, multi_pod: bool) -> RunConfig:
    cfg = get_model_config(arch)
    shape = SHAPES[shape_name]
    # Horn parallel dropout is a training-time feature; serving cells run eval.
    horn = HornConfig(enabled=shape.kind == "train")
    return RunConfig(model=cfg, shape=shape, horn=horn, optimizer="adamw",
                     learning_rate=3e-4, momentum=0.9, multi_pod=multi_pod)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks on the "fake"
    backend, this process rank 0, destroyed on exit.  Raises when a group
    exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists: the dry run starts its "
                           "own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_params(run: RunConfig, mesh):
    """The model's parameters in ``run.param_dtype``, each a DTensor of
    this rank's shard (a fresh fake tensor of the shard's shape: no
    storage of the whole leaf) laid out by ``state_shardings``; plain
    tensors with ``mesh`` None.  Call under ``FakeTensorMode``."""
    dtype = dtype_of(run.param_dtype)
    if mesh is None:
        return empty_params(run.model, "cpu", dtype)
    shardings = steps.state_shardings(run, mesh)["params"]
    params = empty_params(run.model, "meta")
    for name, p in list(params.named_parameters()):
        pl = shardings[name].placements
        shape = [hi - lo for lo, hi in (local_range(n, mesh, pl, d)
                                        for d, n in enumerate(p.shape))]
        local = torch.empty(shape, dtype=dtype)
        owner, _, leaf = name.rpartition(".")
        setattr(params.get_submodule(owner), leaf, nn.Parameter(
            DTensor.from_local(local, mesh, pl, run_check=False),
            requires_grad=False))
    return params


def _zeros(spec: torch.Tensor) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype)


def trace_cell(run: RunConfig, mesh=None,
               record: bool = False) -> analysis.CostCounter:
    """One step of the cell on ``mesh`` (a CPU ``DeviceMesh`` of the
    current, fake, world; None: the mesh-free step) traced under fake
    tensors: the counter of this rank's FLOPs, bytes, collectives and
    peak (the counterpart of the reference's ``lower_cell``).  A train
    cell takes one train step from the state; prefill a prompt of the
    shape's length; decode one token at the last position of a cache of
    the shape's length.  ``record``: the counter keeps its per-op
    records."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kind = run.shape.kind
    with FakeTensorMode():
        params = _fake_params(run, mesh)
        if kind == "train":
            opt_init, _ = make_optimizer(run.optimizer)
            state = {"params": params,
                     "opt": opt_init(list(params.parameters())),
                     "step": 0, "rng": run.seed}
            batch = {k: _zeros(v) for k, v in steps.input_specs(run).items()}
            step = steps.make_train_step(run, "cpu", mesh=mesh)
            counter = analysis.CostCounter(hold=(state, batch),
                                           record=record)
            with counter:
                step(state, batch)
        elif kind == "prefill":
            batch = {k: _zeros(v) for k, v in steps.input_specs(run).items()}
            step = steps.make_prefill_step(run, "cpu", mesh=mesh)
            counter = analysis.CostCounter(hold=(params, batch),
                                           record=record)
            with counter:
                step(params, batch)
        else:
            dspec = steps.decode_input_specs(run)
            B, S = run.shape.global_batch, run.shape.seq_len
            lo, hi = 0, B
            if mesh is not None:
                ctx = steps.make_ctx(run.model, mesh, run.shape)
                lo, hi = local_range(B, mesh, ctx.placements("batch"), 0)
            cache = T.init_cache(run.model, hi - lo, S, device="cpu")
            tokens = _zeros(dspec["tokens"])
            enc = None
            if "encoder_out" in dspec:
                enc = _zeros(dspec["encoder_out"])[lo:hi].clone()
            if mesh is not None:
                cache = steps.cache_on_mesh(
                    cache, steps.decode_cache_shardings(run, mesh))
                if enc is not None:
                    enc = DTensor.from_local(
                        enc, mesh, ctx.placements("batch", None, None),
                        run_check=False)
            step = steps.make_decode_step(run, "cpu", mesh=mesh)
            counter = analysis.CostCounter(hold=(params, cache, tokens, enc),
                                           record=record)
            with counter:
                step(params, cache, tokens, S - 1, enc)
    return counter


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, *, run: RunConfig = None, mesh=None):
    """One cell's row: ``status`` "ok" with the roofline row, "skipped"
    with the reason, or "error" with the exception.  ``run`` and ``mesh``
    stand in for ``make_run``'s and the production mesh (a reduced config
    on a small fake world, in tests)."""
    ok, why = applicable(arch, shape_name)
    mesh_name = ("2x16x16" if multi_pod else "16x16") if mesh is None \
        else "x".join(str(n) for n in mesh.shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    t0 = time.time()
    try:
        run = run or make_run(arch, shape_name, multi_pod)
        mesh = mesh or make_production_mesh(multi_pod=multi_pod,
                                            device_type="cpu")
        chips = mesh.size()
        counter = trace_cell(run, mesh)
        mf = analysis.model_flops_estimate(run.model, run.shape)
        roof = analysis.analyze(arch, shape_name, mesh_name, chips, counter,
                                mf)
        row = roof.row()
        row["status"] = "ok"
        row["compile_s"] = time.time() - t0
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] OK "
                  f"trace={row['compile_s']:.1f}s "
                  f"flops={row['hlo_flops']:.3e} bytes={row['hlo_bytes']:.3e} "
                  f"(unfused {row['unfused_bytes']:.3e}) "
                  f"coll={row['coll_bytes']:.3e} ({row['coll_count']} ops) "
                  f"peak={counter.peak_bytes / 1e9:.1f}GB/rank "
                  f"dominant={row['dominant']}", flush=True)
        return row
    except Exception as e:
        if verbose:
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "compile_s": time.time() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ([a for a in list_archs() if a != "horn-mnist"]
             if args.arch == "all" else [args.arch])
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t0 = time.time()
    rows = []
    for mp in meshes:                   # one fake world a mesh
        with fake_world(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    rows.append(run_cell(arch, shape, mp))
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_err = sum(r["status"] == "error" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    print(f"\ndry-run cells: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors in {time.time() - t0:.0f} s")
    for r in rows:
        if r["status"] != "ok":
            print(f"  {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r['status']}: {r.get('reason') or r.get('error')}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
        print("wrote", args.out)
    sys.exit(1 if n_err else 0)


if __name__ == "__main__":
    main()
