"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --full-config --steps 4 --batch 8 --seq 1024 --horn-groups 4 \\
        [--checkpoint-dir ckpt/ --checkpoint-every 50]
    PYTHONPATH=src python -m repro_torch.launch.train --arch horn-mnist

Mirrors ``repro/launch/train.py`` on one device: the train step of
``core/steps.py`` (Horn parallel dropout, f32 masters, bf16 compute,
AdamW or momentum SGD) over the deterministic synthetic token pipeline.
Runs on the card by default; ``--device cpu`` runs the plain versions (use
the reduced config there).  Each logged step prints loss, grad norm and
tokens per second; the run ends with the first and last loss and each
kernel's launch count.  With ``--checkpoint-dir`` the steps run in
``runtime/fault_tolerance.py``'s loop: the run resumes from the newest
checkpoint there, saves every ``--checkpoint-every`` steps and at the end,
in the JAX package's layout (``TrainStateCheckpointer``), and stops at
step ``--steps``.

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

Not ported yet, and refused with the ROADMAP item that ports them: archs
with Mamba layers (mamba2-2.7b, jamba-1.5-large-398b), ``--topology``
other than allreduce and a mesh larger than 1 x 1.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (MAMBA, HornConfig, RunConfig,
                                      ShapeConfig, TopologyConfig,
                                      get_model_config, list_archs, reduced)
from repro_torch.checkpoint.checkpointer import (Checkpointer, flatten,
                                                 unflatten)
from repro_torch.core import steps as S
from repro_torch.core.collective_trainer import train_mnist
from repro_torch.data.pipeline import (SyntheticTokenPipeline,
                                       TokenPipelineConfig)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.models.layers import MOE_AUX
from repro_torch.runtime.fault_tolerance import fault_tolerant_loop

NOT_PORTED = {
    "topology": "ROADMAP slice 5, item 10: group topologies",
    "mesh": "ROADMAP slice 5: scale-out",
    "mamba": "ROADMAP slice 4, item 18: training through SSM layers needs "
             "an SSD backward kernel; the ported ssd_chunk_scan is "
             "forward-only, for prefill",
}


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


def refuse_unported(args: argparse.Namespace) -> None:
    if MAMBA in get_model_config(args.arch).layer_pattern:
        what = "mamba"
    elif args.topology != "allreduce":
        what = "topology"
    elif args.mesh_data != 1 or args.mesh_model != 1:
        what = "mesh"
    else:
        return
    raise NotImplementedError(f"{what} is not ported yet ({NOT_PORTED[what]})")


@dataclass
class Session:
    """What a training run holds: its config, device, state, step and
    batches."""
    args: argparse.Namespace
    run: RunConfig
    device: torch.device
    state: Dict
    step_fn: Callable
    batch_at: Callable[[int], Dict]


def setup(argv=None) -> Session:
    """Parse ``argv``, refuse what is not ported, build the state (f32
    masters from ``--seed``), the train step and the pipeline."""
    args = parse_args(argv)
    if args.arch == "horn-mnist":
        raise ValueError("horn-mnist is a classifier: main() trains it "
                         "through core/collective_trainer.py")
    refuse_unported(args)
    dev = resolve_device(args.device)
    cfg = get_model_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg)
    run = RunConfig(
        model=cfg, shape=ShapeConfig("cli", "train", args.seq, args.batch),
        horn=HornConfig(enabled=not args.no_horn,
                        num_groups=args.horn_groups),
        topology=TopologyConfig(kind=args.topology),
        optimizer=args.optimizer, learning_rate=args.lr, seed=args.seed)
    state = S.init_state(run, dev)
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

    return Session(args, run, dev, state, S.make_train_step(run, dev),
                   batch_at)


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
    ``run`` on ``device`` (by default the masters' own)."""

    def __init__(self, directory: str, run: RunConfig, *, keep: int = 3):
        super().__init__(directory, keep=keep)
        self.run = run

    def save(self, step: int, state, *, blocking: bool = True) -> str:
        return super().save(step,
                            unflatten(S.state_to_jax_flat(state, self.run)),
                            blocking=blocking)

    def restore(self, like_state, *, step=None, device=None, verify=True):
        like = unflatten(S.state_to_jax_flat(like_state, self.run))
        tree, at = super().restore(like, step=step, verify=verify)
        device = device or next(like_state["params"].parameters()).device
        return S.state_from_jax_flat(flatten(tree), self.run, device), at


def run_checkpointed(sess: Session,
                     log: Optional[Callable[[str], None]] = print
                     ) -> List[Dict]:
    """Resume from the newest checkpoint in ``--checkpoint-dir`` (if any)
    and train to step ``--steps`` in the fault-tolerant loop; returns one
    record a step taken."""
    a = sess.args
    ck = TrainStateCheckpointer(a.checkpoint_dir, sess.run)
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
    n_params = sum(p.numel() for p in sess.state["params"].parameters())
    print(f"device: {sess.device}  arch: {cfg.name}  params: {n_params:,}  "
          f"horn: {'off' if sess.args.no_horn else 'on'}  "
          f"optimizer: {sess.run.optimizer}")
    build.reset_launches()
    recs = (run_checkpointed(sess) if args.checkpoint_dir
            else run_steps(sess, args.steps))
    if recs:
        first, last = recs[0]["loss"], recs[-1]["loss"]
        print(f"loss: first={first:.4f} last={last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    for name in (flash.FWD, flash.BWD):
        print(f"{name} launches: {build.LAUNCHES[name]}")
    return {"steps": recs, "launches": dict(build.LAUNCHES)}


if __name__ == "__main__":
    main()
