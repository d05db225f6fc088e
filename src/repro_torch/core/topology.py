"""Topology selection: the paper's cluster-configuration knob (§2).

A copy of ``repro/core/topology.py``.  "By configuring the cluster
topology, it also allows the user to use different synchronous and
asynchronous training techniques, such as AllReduce and Downpour SGD."
The mapping to execution lives in ``group_sync`` and ``steps``; this
module is the declarative surface:

    topo = TopologyConfig(kind="local_sgd", local_sgd_period=8,
                          grad_compression="int8")
"""
from __future__ import annotations

from repro_torch.configs.base import TopologyConfig

DESCRIPTIONS = {
    "allreduce": "synchronous batch averaging every step (paper's MNIST mode)",
    "zero1": "sharded parameter-server: optimizer state sharded with params "
             "(reduce-scatter grads, shard-local update, all-gather params)",
    "local_sgd": "Downpour-SGD analogue: groups step independently for H "
                 "steps, then merge+broadcast (straggler-tolerant)",
}


def describe(topo: TopologyConfig) -> str:
    base = DESCRIPTIONS[topo.kind]
    if topo.kind == "local_sgd":
        base += f" (H={topo.local_sgd_period})"
    if topo.grad_compression != "none":
        base += f" + {topo.grad_compression} compressed merges w/ error feedback"
    return base


def validate(topo: TopologyConfig) -> TopologyConfig:
    """``topo`` itself; raises ValueError on a kind, period or compression
    the topologies do not know (the JAX function asserts)."""
    if topo.kind not in DESCRIPTIONS:
        raise ValueError(f"unknown topology kind {topo.kind!r}")
    if topo.local_sgd_period < 1:
        raise ValueError(f"local_sgd_period {topo.local_sgd_period} < 1")
    if topo.grad_compression not in ("none", "int8"):
        raise ValueError(f"unknown grad_compression "
                         f"{topo.grad_compression!r}")
    return topo
