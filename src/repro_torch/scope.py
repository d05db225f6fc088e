"""Named scopes: where the cost counter and the profiler attribute work.

The port's counterpart of the reference's ``jax.named_scope`` tags.  The
models mark five regions with ``Scope(tag)``:

    flash_attn   the flash attention call (``models/attention.py``)
    ssd_chunk    the SSD chunk scan (``models/ssm.py``)
    mlp_block    the dense branch of the gated MLP (``models/layers.py``)
    xent_chunk   one chunk of the chunked cross-entropy
                 (``models/transformer.py``)
    moe_ffn      the experts' products (``models/layers.py``)

and the kernel wrappers' plain versions mark their kernel's boundary with
``Scope(None, boundary=...)``: the bytes the card's kernel reads and
writes, forward and backward, where the plain version moves far more
(``launch/analysis.py::CostCounter`` charges the boundary and leaves out
what the plain version moves inside it).

A scope does nothing unless something listens: ``listen()`` (entered by
the cost counter and by ``benchmarks/hlo_profile.py``) keeps a stack of
the open scopes and records the autograd sequence numbers each scope's
forward took, so that the backward of a tagged region, which autograd
runs outside the scope, is found by the node it runs
(``node_scopes``); and under ``torch.profiler`` a tagged scope is also a
``record_function`` range of its tag.  With neither, entering and leaving
a scope reads two globals.

``remat_contexts`` is the ``context_fn`` of the port's
``torch.utils.checkpoint`` calls: the recompute runs inside the backward
of whatever node needed it, so it opens an untagged frame, and what it
recomputes goes to the scopes it re-enters, as in the forward.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

TAGS = ("flash_attn", "ssd_chunk", "moe_ffn", "xent_chunk", "mlp_block")
RECOMPUTE = "remat_recompute"   # the profiler range of a recompute

_listening = 0
_stack: List["Scope"] = []      # the open scopes, innermost last
_closed: List["Scope"] = []     # scopes whose forward took sequence numbers
_los: List[int] = []            # their first numbers, ascending
_found: dict = {}               # sequence number -> node_scopes' answer
_enter_hooks: list = []         # called with each scope entered


def _seq() -> int:
    """The sequence number the next autograd node will take."""
    return torch._C._autograd._get_sequence_nr()


@dataclass
class Boundary:
    """What a kernel reads and writes: ``fwd_bytes`` for its forward call,
    ``bwd_bytes`` for its backward (charged once, by the first backward op
    seen inside it)."""
    fwd_bytes: int
    bwd_bytes: int = 0
    bwd_charged: bool = False


class Scope:
    """``with Scope(tag):`` marks a region (``tag`` one of ``TAGS``; None
    for a frame that only carries a ``boundary``; "" for a frame that
    hides the tags around it)."""

    __slots__ = ("tag", "boundary", "lo", "hi", "parent", "_rf", "_open",
                 "_forward")

    def __init__(self, tag: Optional[str],
                 boundary: Optional[Boundary] = None):
        self.tag, self.boundary = tag, boundary
        self.lo = self.hi = self.parent = self._rf = None
        self._open = self._forward = False

    def __enter__(self):
        if _listening:
            self.lo, self.hi = _seq(), None
            self.parent = _stack[-1] if _stack else None
            _stack.append(self)
            self._open = True
            # a scope re-entered by a recompute runs inside a backward, on
            # whichever thread runs it, and makes nodes no backward runs:
            # only a forward's numbers are kept
            self._forward = torch._C._current_autograd_node() is None
            for hook in _enter_hooks:
                hook(self)
        if self.tag is not None and torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.tag or RECOMPUTE)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._open:
            self._open = False
            _stack.remove(self)
            self.hi = _seq()
            if self._forward and self.hi > self.lo and self.tag != "":
                # by lo; at an equal lo the enclosing scope (which closes
                # later) goes first, so the last at or before a number is
                # the innermost
                i = bisect.bisect_left(_los, self.lo)
                _los.insert(i, self.lo)
                _closed.insert(i, self)
                _found.clear()
        return False


def listening() -> bool:
    return _listening > 0


@contextlib.contextmanager
def listen(on_enter=None):
    """Keep the scope stack and the sequence numbers while entered;
    ``on_enter(scope)`` is called as each scope opens.  Nests."""
    global _listening
    _listening += 1
    if on_enter is not None:
        _enter_hooks.append(on_enter)
    try:
        yield
    finally:
        if on_enter is not None:
            _enter_hooks.remove(on_enter)
        _listening -= 1
        if not _listening:
            _closed.clear()
            _los.clear()
            _found.clear()


def _frames(frames) -> Tuple[Optional[str], Optional[Boundary]]:
    """The innermost tag and boundary of ``frames`` (innermost last); an
    untagged frame ("") hides everything outside it."""
    tag = boundary = None
    for f in reversed(frames):
        if f.tag == "":
            break
        if boundary is None and f.boundary is not None:
            boundary = f.boundary
        if f.tag is not None:
            tag = f.tag
            break
    return tag, boundary


def node_scopes(seq: int) -> Tuple[Optional[str], Optional[Boundary]]:
    """The innermost tag and boundary whose forward made the autograd node
    of sequence number ``seq``.  Scopes nest, so those around ``seq`` are
    the last one to open at or before it and its enclosing ones."""
    if seq not in _found:
        i = bisect.bisect_right(_los, seq) - 1
        sc = _closed[i] if i >= 0 else None
        inside = []
        while sc is not None:
            if sc.lo <= seq and (sc.hi is None or seq < sc.hi):
                inside.append(sc)
            sc = sc.parent
        _found[seq] = _frames(inside[::-1])
    return _found[seq]


def current() -> Tuple[Optional[str], Optional[Boundary], bool]:
    """The innermost tag and boundary of the op being dispatched now, and
    whether it runs in a backward: the open scopes, or in a backward the
    scopes of the node it runs."""
    if _stack:
        return (*_frames(_stack), False)
    if _closed:
        node = torch._C._current_autograd_node()
        if node is not None:
            return (*node_scopes(node._sequence_nr()), True)
    return None, None, False


def remat_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: nothing around the
    forward, an untagged frame around the recompute."""
    return contextlib.nullcontext(), Scope("")
