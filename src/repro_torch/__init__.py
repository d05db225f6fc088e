"""PyTorch/CUDA port of the Horn serving path (``src/repro`` is the JAX
reference it is held against).

Layout mirrors ``repro`` file for file: ``configs``, ``kernels`` (the
hand-written CUDA kernels beside their plain PyTorch versions), ``models``,
``core``, ``serving``, ``launch``.  Entry points take ``device=`` and
default to ``"cuda"``; asking for CUDA where there is none raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` (a CUDA device with its index);
    raises when it names CUDA and no card is visible: the port never
    carries on on the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch sees no CUDA card; "
                f"pass device='cpu' to run the plain versions on the CPU")
        if dev.index is None:            # compare equal to tensor.device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
