"""Neuron-centric programming model (paper §2), compiled to tensor ops.

The port of ``repro/core/neuron_centric.py``.  The paper's API::

    nn.addLayer(512, ReLU.class, DropoutNeuron.class);

declares layers of neurons with per-neuron ``forward()``/``backward()``
handlers and an optional ``interlayer()`` normalization.  As in the JAX
package, the declaration is compiled, not run neuron by neuron:

  * ``forward``'s weighted sum of messages  ->  one matmul a layer
  * ``DropoutNeuron``'s per-neuron Bernoulli ->  Horn group masks
    (``core/parallel_dropout.py``), one elementwise multiply
  * ``interlayer`` normalization            ->  a vector->vector function
  * ``backward``'s gradient messages        ->  autograd, then the
    topology's merge (``core/collective_trainer.py``)

Parameters are a dict ``{"w0", "b0", ...}`` of f32 tensors with the JAX
names.  ``apply`` takes one network, ``x [B, units]``, or G of them at
once: parameters stacked ``[G, ...]`` and ``x [G, b, units]``, each layer
one ``torch.baddbmm`` over the groups, with one mask row per group.
``from_jax_params``/``to_jax_params`` carry weights between the packages.
``axes()`` gives the logical sharding axes of each parameter, as the JAX
``NeuronNetwork.axes()`` does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import parallel_dropout as pdrop

f32 = torch.float32
Params = Dict[str, torch.Tensor]

ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


def softmax_interlayer(v):
    """The paper's canonical interlayer(): normalized (softmax) units."""
    return torch.softmax(v, dim=-1)


def divide_by_sum_interlayer(v):
    """Literal paper example: output.divide(output.sum())."""
    return v / torch.clamp(v.sum(dim=-1, keepdim=True), min=1e-9)


@dataclass(frozen=True)
class LayerSpec:
    units: int
    activation: str = "relu"
    neuron: str = "standard"        # standard | dropout (DropoutNeuron.class)
    keep: Optional[float] = None    # dropout keep-rate; None -> Horn default
    interlayer: Optional[Callable] = None


@dataclass(frozen=True)
class ParamSpec:
    """Shape, initializer and logical sharding axes of one parameter (the
    JAX package's ``ParamSpec``)."""
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | zeros
    scale: float = 1.0
    axes: Tuple[Optional[str], ...] = ()


@dataclass
class NeuronNetwork:
    """Builder mirroring the paper's ``nn.addLayer(...)`` API."""

    input_units: int
    input_neuron: str = "standard"  # "dropout" drops input units (paper: 0.8)
    input_keep: Optional[float] = None
    layers: List[LayerSpec] = field(default_factory=list)

    def add_layer(self, units: int, activation: str = "relu",
                  neuron: str = "standard", keep: Optional[float] = None,
                  interlayer: Optional[Callable] = None) -> "NeuronNetwork":
        self.layers.append(LayerSpec(units, activation, neuron, keep,
                                     interlayer))
        return self

    # -- compiled artifacts ---------------------------------------------------
    def specs(self) -> Dict[str, ParamSpec]:
        specs = {}
        prev = self.input_units
        for i, l in enumerate(self.layers):
            specs[f"w{i}"] = ParamSpec((prev, l.units), "normal", 2.0,
                                       ("embed", "ffn"))
            specs[f"b{i}"] = ParamSpec((l.units,), "zeros", axes=("ffn",))
            prev = l.units
        return specs

    def axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """{name: logical axes}: the partition plan ``launch/mesh.py``'s
        rules map onto a mesh (units over "ffn")."""
        return {name: s.axes for name, s in self.specs().items()}

    def init(self, generator: torch.Generator, device="cuda") -> Params:
        """f32 parameters on ``device``: weights normal with std
        ``scale / sqrt(fan_in)`` drawn from ``generator`` (a generator on
        ``device``), biases zero.  The draws differ from JAX's; tests carry
        JAX's parameters over with ``from_jax_params``."""
        dev = resolve_device(device)
        out = {}
        for name, s in self.specs().items():
            if s.init == "zeros":
                out[name] = torch.zeros(s.shape, dtype=f32, device=dev)
            else:
                std = s.scale / math.sqrt(max(1, s.shape[0]))
                out[name] = torch.randn(s.shape, generator=generator,
                                        dtype=f32, device=dev) * std
        return out

    def apply(self, params: Params, x: torch.Tensor,
              horn: Optional[pdrop.HornState] = None) -> torch.Tensor:
        """x [B, input_units] -> the last layer's output [B, units]; or G
        networks at once: ``params`` [G, ...], x [G, b, input_units] ->
        [G, b, units], with ``horn.num_groups`` G.

        DropoutNeuron layers multiply by the group's sub-model mask (the
        paper's ``m2 = getBinomial(1, 0.5)`` neuron code), one unit at a
        time (block_size 1), after the activation; the last layer is never
        masked, and an interlayer runs after the mask."""
        grouped = x.dim() == 3
        lead = x.shape[0]       # B samples of one group, or G groups

        def masked(x, m):
            if m is None:
                return x
            return x * (m if grouped else m[:, 0])

        if self.input_neuron == "dropout":
            keep = self.input_keep or (horn.cfg.keep_input if horn else None)
            x = masked(x, pdrop.unit_mask(horn, 100_003, lead,
                                          self.input_units, keep=keep,
                                          salt=7, block_size=1))
        for i, l in enumerate(self.layers):
            w, b = params[f"w{i}"], params[f"b{i}"]
            x = (torch.baddbmm(b[:, None, :], x, w) if grouped
                 else x @ w + b)                            # sum of messages
            x = ACTIVATIONS[l.activation](x)                # apply(sum)
            last = i == len(self.layers) - 1
            if l.neuron == "dropout" and not last:
                x = masked(x, pdrop.unit_mask(horn, i, lead, l.units,
                                              keep=l.keep, salt=5,
                                              block_size=1))
            if l.interlayer is not None:
                x = l.interlayer(x)
        return x

    def loss(self, params: Params, batch: Mapping[str, torch.Tensor],
             horn: Optional[pdrop.HornState] = None) -> torch.Tensor:
        """Softmax cross-entropy (the paper's Softmax + Cross Entropy head),
        the mean over the samples: a scalar, or one per group [G] when the
        batch is grouped (x [G, b, 784], y [G, b])."""
        logits = self.apply(params, batch["x"], horn)
        logp = torch.log_softmax(logits.to(f32), dim=-1)
        nll = -torch.gather(logp, -1, batch["y"].long()[..., None])[..., 0]
        return nll.mean(dim=-1)

    def accuracy(self, params: Params, batch: Mapping[str, torch.Tensor]
                 ) -> torch.Tensor:
        logits = self.apply(params, batch["x"], horn=None)
        return (torch.argmax(logits, -1) == batch["y"]).to(f32).mean()


def paper_mnist_network(hidden: int = 512, depth: int = 2) -> NeuronNetwork:
    """The MNIST MLP of paper §3: ReLU hiddens (DropoutNeuron), softmax
    head."""
    nn = NeuronNetwork(input_units=784, input_neuron="dropout",
                       input_keep=0.8)
    for _ in range(depth):
        nn.add_layer(hidden, "relu", neuron="dropout", keep=0.5)
    nn.add_layer(10, "identity", neuron="standard")
    return nn


def from_jax_params(params: Mapping[str, np.ndarray], device="cuda"
                    ) -> Params:
    """JAX parameters (a dict of arrays, one network or ``[G, ...]``
    stacked copies) as f32 tensors on ``device``, same names and shapes."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=f32, device=dev)
            for k, v in params.items()}


def to_jax_params(params: Params) -> Dict[str, np.ndarray]:
    """The port's parameters (or ``[G, ...]`` copies) as the dict of numpy
    arrays the JAX package's network takes."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
