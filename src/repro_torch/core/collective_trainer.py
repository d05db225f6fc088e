"""Collective & Parallel Dropout training: the paper's §3 experiment engine.

The port of ``repro/core/collective_trainer.py``.  Trains the
neuron-centric MNIST network with G worker groups: each group draws its
own sub-model (dropout draw) per step and computes gradients on its own
micro-batch; updates are batch-averaged (AllReduce) or merged every H
steps (local SGD).  The G groups are one batched computation, as JAX's
``vmap``: parameters, momentum and residuals are ``[G, ...]``, the batch
``[G, b, 784]``, each layer one ``torch.baddbmm``, and one
``torch.autograd.grad`` of the sum of the groups' mean losses gives each
group exactly its own gradient.

Masks: JAX keys group g at step t by ``fold_in(fold_in(key(seed_salt), t),
g)``, independent of the run's seed; the port draws every group's row at
once from one ``HornState`` with ``num_groups`` G (``horn_state``, the one
place a step's masks come from, which tests replace to hand the port
JAX's uniforms).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import HornConfig, TopologyConfig
from repro_torch.core import group_sync as gs
from repro_torch.core.neuron_centric import (NeuronNetwork, Params,
                                             paper_mnist_network)
from repro_torch.core.parallel_dropout import HornState
from repro_torch.data.mnist import load_mnist
from repro_torch.data.pipeline import MnistBatcher
from repro_torch.optim import compression as C

f32 = torch.float32


@dataclass
class MnistResult:
    name: str
    accuracy: List[float] = field(default_factory=list)
    steps: List[int] = field(default_factory=list)
    final_accuracy: float = 0.0
    loss: List[float] = field(default_factory=list)
    data_source: str = ""
    wall_s: float = 0.0          # host wall of the run's loop, after a sync

    def row(self):
        return {"name": self.name, "final_accuracy": self.final_accuracy,
                "steps": self.steps, "accuracy": self.accuracy,
                "data_source": self.data_source}


def horn_state(horn_cfg: HornConfig, step: int, num_groups: int,
               device) -> Optional[HornState]:
    """The step's masks for all groups: row g of every draw is group g's
    sub-model.  None with Horn off."""
    if not horn_cfg.enabled:
        return None
    return HornState(seed=0, step=int(step), cfg=horn_cfg,
                     num_groups=num_groups, device=torch.device(device))


def init_groups(nn: NeuronNetwork, num_groups: int, seed: int, device
                ) -> Tuple[Params, Params, Params]:
    """(params_g, mom_g, residual_g): the network drawn from ``seed``,
    copied to every group, with zero momentum and zero int8 residuals."""
    dev = resolve_device(device)
    params = nn.init(torch.Generator(dev).manual_seed(seed), dev)
    params_g = {k: v.clone() for k, v in
                gs.replicate_for_groups(params, num_groups).items()}
    zeros = {k: torch.zeros_like(v) for k, v in params_g.items()}
    return params_g, zeros, {k: v.clone() for k, v in zeros.items()}


def make_step_fn(nn: NeuronNetwork, horn_cfg: HornConfig,
                 topology: TopologyConfig, lr: float, momentum: float,
                 num_groups: int, device="cuda"):
    """(params_g, mom_g, residual_g, batch_g, step) -> (params_g, mom_g,
    residual_g, loss): one step of all groups, ``batch_g`` {"x" [G, b,
    784], "y" [G, b]} (numpy or tensors), ``step`` an int.  The loss is the
    mean of the groups' losses, a 0-dim tensor.  New tensors come out;
    nothing is written in place."""
    dev = resolve_device(device)

    def step_fn(params_g, mom_g, residual_g, batch_g, step):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 batch_g.items()}
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params_g.items()}
        horn = horn_state(horn_cfg, step, num_groups, dev)
        loss_g = nn.loss(leaves, batch, horn)                       # [G]
        grads_g = dict(zip(leaves, torch.autograd.grad(
            loss_g.sum(), list(leaves.values()))))

        if topology.grad_compression == "int8":
            # compress each group's contribution (error feedback per group)
            q, s, residual_g = C.ef_compress_tree(grads_g, residual_g,
                                                  groups=True)
            grads_g = {k: C.dequantize_int8(q[k], s[k]) for k in q}

        if topology.kind in ("allreduce", "zero1"):
            # batch averaging every step (paper's synchronous mode)
            grads_g = gs.broadcast_merged(grads_g)

        # momentum SGD per group (paper: w += -lr * v; v = mu*v + g)
        with torch.no_grad():
            mom_g = {k: momentum * mom_g[k] + grads_g[k] for k in mom_g}
            params_g = {k: params_g[k] - lr * mom_g[k] for k in params_g}

        if topology.kind == "local_sgd":
            params_g, mom_g = gs.maybe_merge_local_sgd(
                params_g, step, topology, momentum_g=mom_g)
        return params_g, mom_g, residual_g, loss_g.detach().mean()

    return step_fn


def train_mnist(*, num_groups: int = 1, batch_per_group: int = 100,
                num_steps: int = 2000, lr: float = 0.3, momentum: float = 0.98,
                horn_cfg: Optional[HornConfig] = None,
                topology: Optional[TopologyConfig] = None,
                hidden: int = 512, depth: int = 2, seed: int = 0,
                eval_every: int = 500, n_train: int = 20000,
                data: Optional[dict] = None, name: str = "run",
                device="cuda") -> MnistResult:
    """Train ``num_groups`` x ``batch_per_group`` for ``num_steps``; every
    ``eval_every`` steps and at the end, the accuracy of the groups'
    average network (Horn off) over the whole test set."""
    dev = resolve_device(device)
    horn_cfg = horn_cfg or HornConfig(enabled=True, num_groups=num_groups,
                                      block_size=1)
    topology = topology or TopologyConfig(kind="allreduce")
    nn = paper_mnist_network(hidden=hidden, depth=depth)
    data = data or load_mnist(n_train=n_train)
    batcher = MnistBatcher(data["x_train"], data["y_train"],
                           batch_per_group * num_groups, seed=seed)
    test = {"x": torch.as_tensor(data["x_test"], device=dev),
            "y": torch.as_tensor(data["y_test"], device=dev)}

    params_g, mom_g, residual_g = init_groups(nn, num_groups, seed, dev)
    step_fn = make_step_fn(nn, horn_cfg, topology, lr, momentum, num_groups,
                           dev)

    res = MnistResult(name=name, data_source=data.get("source", "?"))
    t0 = time.perf_counter()
    for step in range(num_steps):
        batch_g = batcher.group_batch_at(step, num_groups)
        params_g, mom_g, residual_g, loss = step_fn(
            params_g, mom_g, residual_g, batch_g, step)
        if (step + 1) % eval_every == 0 or step == num_steps - 1:
            with torch.no_grad():
                merged = gs.merge_groups_mean(params_g)
                acc = float(nn.accuracy(merged, test))
            res.steps.append(step + 1)
            res.accuracy.append(acc)
            res.loss.append(float(loss))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res.wall_s = time.perf_counter() - t0
    res.final_accuracy = res.accuracy[-1] if res.accuracy else 0.0
    return res


def paper_comparison(*, num_steps: int = 2000, eval_every: int = 500,
                     lr: float = 0.3, momentum: float = 0.98,
                     seed: int = 0, n_train: int = 20000,
                     device="cuda") -> Dict[str, MnistResult]:
    """The paper's Fig. 3: non-parallel (1 x batch 100) vs parallel
    (20 workers x batch 5, AllReduce) dropout training."""
    data = load_mnist(n_train=n_train)
    common = dict(num_steps=num_steps, lr=lr, momentum=momentum, seed=seed,
                  eval_every=eval_every, data=data, device=device)
    non_parallel = train_mnist(num_groups=1, batch_per_group=100,
                               name="non-parallel dropout (1x100)", **common)
    parallel = train_mnist(num_groups=20, batch_per_group=5,
                           name="parallel dropout (20x5, AllReduce)",
                           **common)
    return {"non_parallel": non_parallel, "parallel": parallel}
