"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --full-config --steps 4 --batch 8 --seq 1024 --horn-groups 4 \\
        [--topology allreduce|zero1|local_sgd] [--mesh-data 1 --mesh-model 1] \\
        [--checkpoint-dir ckpt/ --checkpoint-every 50]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-1.7b --device cpu --mesh-data 2 --mesh-model 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch horn-mnist

Mirrors ``repro/launch/train.py``: the train step of ``core/steps.py``
(Horn parallel dropout, f32 masters, bf16 compute, AdamW or momentum SGD)
over the deterministic synthetic token pipeline.  Runs on the card by
default; ``--device cpu`` runs the plain versions (use the reduced config
there).  The run's first line describes ``--topology`` (validated; the LM
step does not read it, as the JAX step does not), the second is the JAX
launcher's ``mesh: {...}  arch: ...  params: ...`` (``params`` the
config's ``param_count``).  Each logged step prints loss, grad norm and
tokens per second; the run ends with the first and last loss and each
kernel's launch count.  With ``--checkpoint-dir`` the steps run in
``runtime/fault_tolerance.py``'s loop: the run resumes from the newest
checkpoint there (laid out onto this run's mesh: an elastic restart),
saves every ``--checkpoint-every`` steps and at the end, in the JAX
package's layout (``TrainStateCheckpointer``), and stops at step
``--steps``.

Several ranks: under ``torchrun`` every rank joins the job's process group
(NCCL on cards, one card a rank; gloo with ``--device cpu``) and the step
runs on ``make_test_mesh(--mesh-data, --mesh-model)``, clamped to the
ranks there are, with the state laid out by the sharding rules
(``core/steps.py::make_train_step(mesh=)``); rank 0 prints.  A process
that already belongs to a process group does the same on it.  One process
without a group is the 1 x 1 mesh, and runs the mesh-free step, which
computes the same bits.  When NCCL cannot start on a card the run fails:
it never switches to gloo or the CPU by itself.

``--arch horn-mnist`` runs the paper's MNIST experiment through the
collective trainer instead, with the JAX launcher's arithmetic (20 groups
unless ``--horn-groups``, ``--batch // 20`` samples a group, ``--lr`` or
0.005 when it is 0), and prints its result row as JSON; it ignores
``--topology``, ``--optimizer``, ``--no-horn`` and ``--checkpoint-dir``,
as the JAX launcher does.

A multimodal arch (llava-next-34b, llama4-maverick-400b) trains on zero
``patch_embeds`` in front of ``--seq`` minus its patch count of text
tokens, as the JAX launcher feeds it; an encoder-decoder (whisper-base)
on zero f32 ``frames`` [batch, encoder_seq, d_model] beside ``--seq``
decoder tokens, as the JAX launcher feeds it; an MoE arch adds its router
losses to the loss and logs them with the dropped fraction each step.

An arch with Mamba layers (mamba2-2.7b, jamba-1.5-large-398b) trains
through the same step: on the card each layer's SSD runs the chunk-scan
kernel forward (twice a step: remat recomputes the block) and its
backward kernel once.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import (HornConfig, RunConfig,
                                      ShapeConfig, TopologyConfig,
                                      get_model_config, list_archs, reduced)
from repro_torch.checkpoint.checkpointer import (Checkpointer, flatten,
                                                 unflatten)
from repro_torch.core import steps as S
from repro_torch.core import topology
from repro_torch.core.collective_trainer import train_mnist
from repro_torch.data.pipeline import (SyntheticTokenPipeline,
                                       TokenPipelineConfig)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.ssd import kernel as ssd
from repro_torch.launch.mesh import ensure_process_group, make_test_mesh
from repro_torch.models.layers import MOE_AUX
from repro_torch.runtime.elastic import remesh_state, reshard
from repro_torch.runtime.fault_tolerance import fault_tolerant_loop

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgdm"])
    ap.add_argument("--full-config", action="store_true",
                    help="use the full arch config (default: reduced)")
    ap.add_argument("--no-horn", action="store_true",
                    help="disable parallel dropout")
    ap.add_argument("--horn-groups", type=int, default=0)
    ap.add_argument("--topology", default="allreduce",
                    choices=["allreduce", "zero1", "local_sgd"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


@dataclass
class Session:
    """What a training run holds: its config, device, mesh (None: one
    process, no group), state, step and batches."""
    args: argparse.Namespace
    run: RunConfig
    device: torch.device
    mesh: object
    state: Dict
    step_fn: Callable
    batch_at: Callable[[int], Dict]

    @property
    def mesh_shape(self) -> Dict[str, int]:
        """{"data": n, "model": m} of the mesh the run uses."""
        if self.mesh is None:
            return {"data": 1, "model": 1}
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.mesh is not None else 0


def setup(argv=None) -> Session:
    """Parse ``argv``, refuse what is not ported, join the job's process
    group when there is one (``torchrun``, or one this process belongs
    to), build the mesh, the state (f32 masters from ``--seed``, laid out
    on the mesh), the train step and the pipeline."""
    args = parse_args(argv)
    if args.arch == "horn-mnist":
        raise ValueError("horn-mnist is a classifier: main() trains it "
                         "through core/collective_trainer.py")
    topo = topology.validate(TopologyConfig(kind=args.topology))
    dev = torch.device(args.device)
    mesh = None
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        ensure_process_group(dev.type)
        mesh = make_test_mesh(args.mesh_data, args.mesh_model, dev.type)
    dev = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg)
    run = RunConfig(
        model=cfg, shape=ShapeConfig("cli", "train", args.seq, args.batch),
        horn=HornConfig(enabled=not args.no_horn,
                        num_groups=args.horn_groups),
        topology=topo, optimizer=args.optimizer, learning_rate=args.lr,
        seed=args.seed)
    state = S.init_state(run, dev)
    if mesh is not None:
        state = remesh_state(state, S.state_axes(run),
                             S.make_ctx(cfg, mesh, run.shape))
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))

    def batch_at(step: int) -> Dict:
        b = pipe.batch_at(step)
        if cfg.is_encoder_decoder:  # the stub audio frontend's output
            b["frames"] = np.zeros((args.batch, cfg.encoder_seq,
                                    cfg.d_model), np.float32)
        if cfg.num_patches:         # the stub vision frontend's output
            b = {k: v[:, :args.seq - cfg.num_patches] for k, v in b.items()}
            b["patch_embeds"] = np.zeros(
                (args.batch, cfg.num_patches, cfg.d_model), np.float32)
        return b

    return Session(args, run, dev, mesh, state,
                   S.make_train_step(run, dev, mesh=mesh), batch_at)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_step(sess: Session) -> Callable:
    """``sess.step_fn`` with float metrics and its host wall, ``step_s``,
    from a sync before the step to a sync after it."""
    def step(state, batch):
        sync(sess.device)
        t0 = time.perf_counter()
        state, metrics = sess.step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        sync(sess.device)
        metrics["step_s"] = time.perf_counter() - t0
        return state, metrics
    return step


def record(sess: Session, step: int, metrics: Dict,
           log: Optional[Callable[[str], None]]) -> Dict:
    """The run's record of one step, printed every ``--log-every``-th
    step and at step 1."""
    a, dt = sess.args, metrics["step_s"]
    rec = {"step": step, "loss": metrics["loss"],
           "grad_norm": metrics["grad_norm"], "step_s": dt,
           "tok_s": a.batch * a.seq / dt}
    moe = ""
    if sess.run.model.num_experts:
        rec.update((k, metrics[k]) for k in MOE_AUX)
        moe = (f" lb {rec['load_balance_loss']:.4f} z "
               f"{rec['router_z_loss']:.3f} dropped "
               f"{rec['dropped_frac']:.4f}")
    if log and (step % a.log_every == 0 or step == 1):
        log(f"step {step:5d} loss {rec['loss']:.4f} grad_norm "
            f"{rec['grad_norm']:.3f}{moe} {rec['tok_s']:,.0f} tok/s "
            f"({dt * 1e3:.1f} ms)")
    return rec


def run_steps(sess: Session, n: int,
              log: Optional[Callable[[str], None]] = print) -> List[Dict]:
    """Take ``n`` train steps; returns one record a step (loss, grad_norm,
    wall seconds, tokens per second)."""
    step = timed_step(sess)
    out = []
    for _ in range(n):
        sess.state, metrics = step(sess.state,
                                   sess.batch_at(sess.state["step"]))
        out.append(record(sess, sess.state["step"], metrics, log))
    return out


class TrainStateCheckpointer(Checkpointer):
    """A ``Checkpointer`` of the LM train state in the JAX package's
    layout (``core/steps.py::state_to_jax_flat``): a checkpoint of either
    package restores in the other.  ``restore`` returns a train state of
    ``run`` on ``device`` (by default the masters' own), laid out on
    ``shardings`` (``core/steps.py::state_shardings`` of the run's mesh,
    by default the one given here; None: plain tensors).  A state on a
    mesh is gathered whole to save it (every rank calls ``save``)."""

    def __init__(self, directory: str, run: RunConfig, *, keep: int = 3,
                 shardings=None):
        super().__init__(directory, keep=keep)
        self.run = run
        self.shardings = shardings

    def save(self, step: int, state, *, blocking: bool = True) -> str:
        return super().save(step,
                            unflatten(S.state_to_jax_flat(state, self.run)),
                            blocking=blocking)

    def restore(self, like_state, *, step=None, device=None,
                shardings=None, verify=True):
        like = unflatten(S.state_to_jax_flat(like_state, self.run))
        tree, at = super().restore(like, step=step, verify=verify)
        device = device or next(like_state["params"].parameters()).device
        state = S.state_from_jax_flat(flatten(tree), self.run, device)
        shardings = shardings or self.shardings
        return (state if shardings is None
                else reshard(state, shardings)), at


def run_checkpointed(sess: Session,
                     log: Optional[Callable[[str], None]] = print
                     ) -> List[Dict]:
    """Resume from the newest checkpoint in ``--checkpoint-dir`` (if any)
    and train to step ``--steps`` in the fault-tolerant loop; returns one
    record a step taken."""
    a = sess.args
    ck = TrainStateCheckpointer(a.checkpoint_dir, sess.run,
                                shardings=S.state_shardings(sess.run,
                                                            sess.mesh))
    if ck.latest_step() is not None:
        sess.state, at = ck.restore(sess.state, device=sess.device)
        if log:
            log(f"resumed from step {at}")
    out = []
    sess.state, last, reason = fault_tolerant_loop(
        state=sess.state, step_fn=timed_step(sess), batch_at=sess.batch_at,
        checkpointer=ck, num_steps=a.steps,
        checkpoint_every=a.checkpoint_every, device=sess.device,
        on_metrics=lambda step, m: out.append(record(sess, step, m, log)))
    if log:
        log(f"exit: {reason} at step {last}")
    return out


def run_horn_mnist(args: argparse.Namespace) -> Dict:
    """The paper's MNIST experiment with the JAX launcher's arithmetic;
    prints and returns its result row."""
    res = train_mnist(num_groups=args.horn_groups or 20,
                      batch_per_group=max(1, args.batch // 20),
                      num_steps=args.steps, lr=args.lr or 0.005,
                      eval_every=max(50, args.steps // 5), seed=args.seed,
                      device=args.device)
    print(json.dumps(res.row(), indent=1))
    return res.row()


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if args.arch == "horn-mnist":
        return run_horn_mnist(args)
    sess = setup(argv)
    cfg = sess.run.model
    say = print if sess.rank == 0 else None
    n_params = sum(p.numel() for p in sess.state["params"].parameters())
    lines = [
        f"topology: {args.topology}: {topology.describe(sess.run.topology)}",
        f"mesh: {sess.mesh_shape}  arch: {cfg.name}  params: "
        f"{cfg.param_count():,}",
        f"device: {sess.device}  ranks: "
        f"{dist.get_world_size() if sess.mesh is not None else 1}  "
        f"parameters: {n_params:,}  horn: "
        f"{'off' if sess.args.no_horn else 'on'}  optimizer: "
        f"{sess.run.optimizer}"]
    build.reset_launches()
    if say:
        say("\n".join(lines))
    recs = (run_checkpointed(sess, log=say) if args.checkpoint_dir
            else run_steps(sess, args.steps, log=say))
    if recs and say:
        first, last = recs[0]["loss"], recs[-1]["loss"]
        say(f"loss: first={first:.4f} last={last:.4f} "
            f"({'improved' if last < first else 'NOT improved'})")
    if say:
        for name in (flash.FWD, flash.BWD, ssd.NAME, ssd.NAME_BWD):
            say(f"{name} launches: {build.LAUNCHES[name]}")
    return {"steps": recs, "launches": dict(build.LAUNCHES),
            "mesh": sess.mesh_shape}


if __name__ == "__main__":
    main()
