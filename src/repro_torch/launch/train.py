"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --full-config --steps 4 --batch 8 --seq 1024 --horn-groups 4

Mirrors ``repro/launch/train.py`` on one device: the train step of
``core/steps.py`` (Horn parallel dropout, f32 masters, bf16 compute,
AdamW or momentum SGD) over the deterministic synthetic token pipeline.
Runs on the card by default; ``--device cpu`` runs the plain versions (use
the reduced config there).  Each logged step prints loss, grad norm and
tokens per second; the run ends with the first and last loss and each
kernel's launch count.

Not ported yet, and refused with the ROADMAP item that ports them:
``--arch horn-mnist``, archs with Mamba layers (mamba2-2.7b), ``--topology``
other than allreduce, ``--checkpoint-dir`` and a mesh larger than 1 x 1.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (MAMBA, HornConfig, RunConfig,
                                      ShapeConfig, TopologyConfig,
                                      get_model_config, list_archs, reduced)
from repro_torch.core import steps as S
from repro_torch.data.pipeline import (SyntheticTokenPipeline,
                                       TokenPipelineConfig)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as flash

NOT_PORTED = {
    "horn-mnist": "ROADMAP slice 2, item 9: the paper's experiment",
    "topology": "ROADMAP slice 2, item 10: group topologies",
    "checkpoint": "ROADMAP slice 2, item 9: checkpoint/checkpointer.py",
    "mesh": "ROADMAP slice 5: scale-out",
    "mamba": "ROADMAP slice 4, item 18: training through SSM layers needs "
             "an SSD backward kernel; the ported ssd_chunk_scan is "
             "forward-only, for prefill",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True,
                    choices=list_archs() + ["horn-mnist"])
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
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    if args.arch == "horn-mnist":
        what = "horn-mnist"
    elif MAMBA in get_model_config(args.arch).layer_pattern:
        what = "mamba"
    elif args.topology != "allreduce":
        what = "topology"
    elif args.checkpoint_dir:
        what = "checkpoint"
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
    return Session(args, run, dev, state, S.make_train_step(run, dev),
                   pipe.batch_at)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(sess: Session, n: int,
              log: Optional[Callable[[str], None]] = print) -> List[Dict]:
    """Take ``n`` train steps; returns one record a step (loss, grad_norm,
    wall seconds, tokens per second), printing every ``--log-every``-th."""
    a = sess.args
    out = []
    for _ in range(n):
        batch = sess.batch_at(sess.state["step"])
        sync(sess.device)
        t0 = time.perf_counter()
        sess.state, metrics = sess.step_fn(sess.state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        sync(sess.device)
        dt = time.perf_counter() - t0
        rec = {"step": sess.state["step"], "loss": loss, "grad_norm": gnorm,
               "step_s": dt, "tok_s": a.batch * a.seq / dt}
        out.append(rec)
        if log and (rec["step"] % a.log_every == 0 or rec["step"] == 1):
            log(f"step {rec['step']:5d} loss {loss:.4f} grad_norm "
                f"{gnorm:.3f} {rec['tok_s']:,.0f} tok/s "
                f"({dt * 1e3:.1f} ms)")
    return out


def main(argv=None) -> Dict:
    sess = setup(argv)
    cfg = sess.run.model
    n_params = sum(p.numel() for p in sess.state["params"].parameters())
    print(f"device: {sess.device}  arch: {cfg.name}  params: {n_params:,}  "
          f"horn: {'off' if sess.args.no_horn else 'on'}  "
          f"optimizer: {sess.run.optimizer}")
    build.reset_launches()
    recs = run_steps(sess, sess.args.steps)
    if recs:
        first, last = recs[0]["loss"], recs[-1]["loss"]
        print(f"loss: first={first:.4f} last={last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    for name in (flash.FWD, flash.BWD):
        print(f"{name} launches: {build.LAUNCHES[name]}")
    return {"steps": recs, "launches": dict(build.LAUNCHES)}


if __name__ == "__main__":
    main()
