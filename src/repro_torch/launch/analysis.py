"""Roofline analysis of a traced step: the cost model behind the dry run.

The port of ``repro/launch/analysis.py``.  Three terms per (arch x shape x
mesh), as in the reference:

    compute    = FLOPs / (chips * PEAK_FLOPS)
    memory     = bytes / (chips * HBM_BW)
    collective = collective bytes / (chips * link bandwidth)

The reference reads the compiled per-device SPMD module's HLO text
(``HloCost``: trip-count-aware, fusion internals free).  PyTorch compiles
nothing: a step is eager, so the port counts what one rank's step
dispatches.  ``CostCounter`` is a ``TorchDispatchMode`` that sees every
aten op and every collective once per execution (a Python loop runs its
body once an iteration, so there is no trip count to recover):

  * FLOPs of the matmul family, from ``torch.utils.flop_counter``'s
    formulas (2 * M * N * K for a product; the attention and convolution
    ops by theirs).  Elementwise ops count none: the reference's
    ``HloCost`` counts one FLOP an element of every elementwise op, so the
    two totals part by that much (``PERF.md`` names the products);
  * an HBM-traffic proxy, ``bytes``: the bytes of the operands plus the
    outputs of every op other than views, metadata and allocations, where
    a kernel of the card's path counts at its boundary instead.  The CPU
    runs a kernel's plain version, whose intermediates (flash's S^2 f32
    scores, the SSD's per-chunk decays) the card's kernel never writes:
    inside a ``scope.Boundary`` (the flash call, forward and backward; the
    SSD chunk scan) the counter charges the bytes the kernel reads and
    writes, once a call, and leaves the plain version's traffic out.
    Elsewhere it is an *unfused eager* count: each op reads its inputs
    from memory and writes its outputs back, where XLA's count charges a
    fusion only its own operands.  ``unfused_bytes`` keeps the eager
    count of every op, boundaries included (the count before boundaries
    were charged);
  * cast bytes: the traffic of dtype casts (``_to_copy``, a ``copy_``
    across dtypes) outside a kernel's boundary, counted in the bytes (a
    cast runs on the card) and also reported apart as ``cast_bytes``;
  * ``by_tag``: FLOPs and bytes by the innermost ``scope.TAGS`` tag an op
    runs in (``repro_torch/scope.py``), the backward of a tagged region
    included (found by the autograd node it runs), as the reference's
    ``HloCost.by_tag`` reads XLA's ``op_name``;
  * collectives by kind: output bytes (``bytes_simple``, the reference's
    formula), ring bytes at the group's size (all-reduce twice), a count,
    and the simple bytes of groups that stay inside one node;
  * the peak of live storage bytes, the counterpart of the compiled
    module's ``memory_analysis``: the storages held when the count starts
    (``hold``: the state, the batch, a cache) plus every storage an op
    makes, each until it is freed.

A rank's counts are per device; the ``Roofline`` row multiplies them by
the chips, as the reference does, so every term divides by per-chip
peaks.  ``by_tag`` serves ``benchmarks/hlo_profile.py``.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import scope

# --- NVIDIA H100 SXM (data sheet: dense bf16, HBM3) --------------------------
PEAK_FLOPS = 989.4e12      # bf16 FLOP/s per card, dense
HBM_BW = 3.35e12           # bytes/s per card
HBM_BYTES = 80e9           # bytes of HBM per card
NODE_RANKS = 8             # cards a node, joined by NVLink 4
LINK_BW_NVLINK = 450e9     # bytes/s a direction, a group inside one node
LINK_BW = 50e9             # bytes/s, one 400 Gb/s NDR port a card: a group
                           # that spans nodes (every group of the production
                           # meshes does)

_KINDS = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}
_NO_WIRE = {"wait_tensor", "barrier", "monitored_barrier_",
            "_wrap_tensor_autograd"}
# allocations, and a view whose schema does not say so: nothing moves
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view"}
_METADATA = {torch.ops.prim.layout.default, torch.ops.prim.device.default}


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` spans: a broadcast (stride 0) dim counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(x):
    """The tensors of a tree (an ``nn.Module`` leaf: its parameters)."""
    out = []
    for t in tree_leaves(x):
        if isinstance(t, nn.Module):
            out.extend(t.parameters())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _group_ranks(args) -> Optional[list]:
    """The global ranks of the process group a collective names (an object
    or a ``_c10d_functional`` group name)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            return dist.get_process_group_ranks(_resolve_process_group(a))
        if isinstance(a, torch.ScriptObject):     # a c10d op's argument
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    return None


@dataclass
class CollectiveStats:
    bytes_simple: int = 0              # sum of output bytes (the formula)
    bytes_ring: float = 0.0            # ring-model wire bytes
    count: int = 0
    by_kind: Dict[str, int] = field(default_factory=dict)
    by_kind_count: Dict[str, int] = field(default_factory=dict)
    bytes_nvlink: int = 0              # simple bytes of groups in one node

    def add(self, kind: str, nbytes: int, ranks) -> None:
        n = max(len(ranks), 2)
        if kind == "all-reduce":
            ring = 2 * nbytes * (n - 1) / n
        elif kind == "collective-permute":
            ring = nbytes
        else:
            ring = nbytes * (n - 1) / n
        self.bytes_simple += nbytes
        self.bytes_ring += ring
        self.count += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + nbytes
        self.by_kind_count[kind] = self.by_kind_count.get(kind, 0) + 1
        if len({r // NODE_RANKS for r in ranks}) == 1:
            self.bytes_nvlink += nbytes


class CostCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, cast bytes, collectives and peak
    live storage over the ops dispatched while it is entered (module
    docstring).  Composite ops that reach the mode whole (``matmul`` and
    ``einsum`` under inference mode) are decomposed first, as
    ``FlopCounterMode`` does, so a product counts the same with and
    without autograd.  A DTensor op is counted by the local ops and the
    collectives its redistribution issues; the op itself only where it
    reaches the mode on a DTensor (none of the port's steps computes on
    DTensors)."""

    LINGER_EVERY = 256      # ops between checks of storages held from C++

    def __init__(self, hold=(), record: bool = False):
        """``hold``: storages live for the whole count; ``record``: also
        keep ``records``, {("op" or "coll", name, shape, tag): [bytes,
        count]}, each op's charged traffic (a kernel's boundary as
        "<tag> kernel") and each collective's bytes, summed over its
        repeats (``benchmarks/hlo_profile.py`` ranks them)."""
        super().__init__()
        self.records = {} if record else None
        self.flops = 0.0
        self.bytes = 0.0                # kernels at their boundary
        self.unfused_bytes = 0.0        # every op, eagerly
        self.cast_bytes = 0.0
        # tag (None: untagged) -> {"flops": x, "bytes": y}
        self._tags: Dict[Optional[str], Dict[str, float]] = {}
        self.coll = CollectiveStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        # storage -> [weak ref, bytes, live Python holders seen]
        self._live: Dict[int, list] = {}
        self._held = set()
        self._orphans = []      # storages whose last seen holder died
        self._lingering = set()  # orphans something unseen still holds
        self._ops = 0
        self._depth = 0
        self.hold(hold)

    # -- live storage --------------------------------------------------
    def _track(self, t: torch.Tensor, holder=None) -> None:
        """Count ``t``'s storage live from now; ``holder`` (``t`` itself
        unless given) is watched, and when the last watched holder of a
        storage dies the storage is checked (``_collect``)."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        s = t.untyped_storage()
        key = s._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [StorageWeakRef(s), s.nbytes(), 0]
            self.live_bytes += entry[1]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        if key in self._held:
            return
        entry[2] += 1
        weakref.finalize(t if holder is None else holder, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is not None:
            entry[2] -= 1
            if entry[2] == 0:
                self._orphans.append(key)

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (the state, the batch;
        a model's parameters) as live for the whole count."""
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            self._held.add(t.untyped_storage()._cdata)
            self._track(t)

    def _free_if_expired(self, key) -> bool:
        entry = self._live.get(key)
        if entry is None or entry[2] > 0:
            return True                 # gone, or watched again
        if entry[0].expired():
            del self._live[key]
            self.live_bytes -= entry[1]
            return True
        return False

    def _collect(self) -> None:
        """Free what died since the last op: an orphaned storage is free
        when it has expired; one still held from C++ (a tensor aliased by
        an ``nn.Parameter``, say) is checked again every ``LINGER_EVERY``
        ops."""
        orphans, self._orphans = self._orphans, []
        for key in orphans:
            if not self._free_if_expired(key):
                self._lingering.add(key)
        self._ops += 1
        if self._ops % self.LINGER_EVERY == 0:
            self._lingering = {k for k in self._lingering
                               if not self._free_if_expired(k)}

    # autograd's saved tensors are held from C++: watch a box of each
    def _pack(self, t):
        box = _Saved(t)
        self._track(t, holder=box)
        return box

    @staticmethod
    def _unpack(box):
        return box.t

    def __enter__(self):
        if self._depth == 0:
            self._saved_hooks = torch.autograd.graph.saved_tensors_hooks(
                self._pack, self._unpack)
            self._saved_hooks.__enter__()
            self._scopes = scope.listen(self._on_scope)
            self._scopes.__enter__()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._depth -= 1
        if self._depth == 0:
            self._scopes.__exit__(*exc)
            self._saved_hooks.__exit__(*exc)

    # -- scopes ----------------------------------------------------------
    def _add(self, tag, flops=0.0, nbytes=0.0) -> None:
        t = self._tags.setdefault(tag, {"flops": 0.0, "bytes": 0.0})
        t["flops"] += flops
        t["bytes"] += nbytes

    def _record(self, key, nbytes) -> None:
        if self.records is not None:
            r = self.records.setdefault(key, [0.0, 0])
            r[0] += nbytes
            r[1] += 1

    def _charge_boundary(self, tag, nbytes, what) -> None:
        self.bytes += nbytes
        self._add(tag, nbytes=nbytes)
        self._record(("op", f"{tag} kernel {what}", "", tag), nbytes)

    def _on_scope(self, sc) -> None:
        """A kernel's forward call: its boundary's bytes, once."""
        if sc.boundary is not None:
            self._charge_boundary(scope.current()[0], sc.boundary.fwd_bytes,
                                  "forward")

    def by_tag(self) -> Dict[str, Dict[str, float]]:
        """{tag: {"flops": x, "bytes": y}} of the tags seen, as the
        reference's ``HloCost.by_tag``; ``untagged`` holds the rest."""
        return {k: dict(v) for k, v in self._tags.items() if k is not None}

    @property
    def untagged(self) -> Dict[str, float]:
        return dict(self._tags.get(None, {"flops": 0.0, "bytes": 0.0}))

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._collect()
        name = packet.__name__
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional"):
            self._collective(name, args, out)
        elif any(isinstance(t, DTensor) for t in _tensors((args, kwargs))):
            raise NotImplementedError(f"{func} on a DTensor: the counter "
                                      f"counts local ops")
        else:
            self._count(func, name, args, kwargs, out)
        for t in _tensors(out):
            self._track(t)
        return out

    def _count(self, func, name, args, kwargs, out) -> None:
        tag, boundary, backward = scope.current()
        if packet_flops := flop_registry.get(func._overloadpacket):
            flops = float(packet_flops(*args, **kwargs, out_val=out))
            self.flops += flops
            self._add(tag, flops=flops)
        if backward and boundary is not None and not boundary.bwd_charged:
            boundary.bwd_charged = True     # the kernel's backward call
            self._charge_boundary(tag, boundary.bwd_bytes, "backward")
        if name in _NO_TRAFFIC or func.is_view:
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        writes = any(r.alias_info is not None and r.alias_info.is_write
                     for r in func._schema.returns)
        if outs and not writes and all(
                r.alias_info is not None for r in func._schema.returns):
            return                      # a view by its schema
        traffic = sum(map(tensor_bytes, ins))
        if not writes:                  # in place: the output is an input
            traffic += sum(map(tensor_bytes, outs))
        self.unfused_bytes += traffic
        if boundary is not None:        # inside a kernel: not on the card
            return
        self.bytes += traffic
        self._add(tag, nbytes=traffic)
        if self.records is not None:
            self._record(("op", name, _shape_of(outs or ins), tag), traffic)
        if (name == "_to_copy" and outs and ins
                and outs[0].dtype != ins[0].dtype) or (
                name == "copy_" and len(ins) > 1
                and ins[0].dtype != ins[1].dtype):
            self.cast_bytes += traffic

    def _collective(self, name, args, out) -> None:
        if name in _NO_WIRE:
            return
        kind = _KINDS.get(name)
        if kind is None:
            raise NotImplementedError(f"no cost model for the collective "
                                      f"{name}")
        ranks = _group_ranks(args)
        if ranks is None:
            raise ValueError(f"{name}: no process group among its arguments")
        if name.endswith("_"):          # c10d in place: the first argument
            moved = _tensors(args[0])
        else:
            moved = _tensors(out)
        nbytes = sum(map(tensor_bytes, moved))
        self.coll.add(kind, nbytes, ranks)
        if self.records is not None:
            self._record(("coll", f"{kind} x{len(ranks)}", _shape_of(moved),
                          scope.current()[0]), nbytes)


def _shape_of(tensors) -> str:
    """"bf16[8,1024,2048]": the first tensor's dtype and shape."""
    if not tensors:
        return ""
    t = tensors[0]
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}".replace(
        " ", "")


class _Saved:
    """A tensor autograd saved for the backward, boxed so that its life
    can be watched."""
    __slots__ = ("t", "__weakref__")

    def __init__(self, t):
        self.t = t


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_ring: float
    coll_count: int
    coll_by_kind: Dict[str, int]
    model_flops: float
    per_device_mem: Optional[float]
    raw_cost_flops: Optional[float] = None   # no compiler estimate here
    raw_cost_bytes: Optional[float] = None
    cast_bytes: float = 0.0           # cast traffic, inside hlo_bytes
    coll_nvlink_bytes: float = 0.0    # coll_bytes of groups inside a node
    unfused_bytes: float = 0.0        # every op's eager traffic, kernels'
                                      # plain versions included

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_memory_unfused(self) -> float:
        return self.unfused_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        net = self.coll_bytes - self.coll_nvlink_bytes
        return (net / (self.chips * LINK_BW)
                + self.coll_nvlink_bytes / (self.chips * LINK_BW_NVLINK))

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """How close the step is to the compute roofline: time the chips
        are doing model math vs total bound time (higher is better)."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_time if self.bound_time else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "unfused_bytes": self.unfused_bytes,
            "coll_bytes": self.coll_bytes, "coll_ring": self.coll_ring,
            "coll_count": self.coll_count, "coll_by_kind": self.coll_by_kind,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_memory_unfused_s": self.t_memory_unfused,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "per_device_mem_bytes": self.per_device_mem,
            "raw_cost_flops": self.raw_cost_flops,
            "raw_cost_bytes": self.raw_cost_bytes,
            "cast_bytes": self.cast_bytes,
            "coll_nvlink_bytes": self.coll_nvlink_bytes,
        }


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            counter: CostCounter, model_flops: float) -> Roofline:
    """Roofline terms from one rank's ``CostCounter`` (every rank runs the
    same program on its own rows, so a rank's counts times ``chips`` are
    the job's, as the reference multiplies its per-device module's)."""
    st = counter.coll
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    hlo_flops=counter.flops * chips,
                    hlo_bytes=counter.bytes * chips,
                    coll_bytes=st.bytes_simple * chips,
                    coll_ring=st.bytes_ring * chips,
                    coll_count=st.count, coll_by_kind=st.by_kind,
                    model_flops=model_flops,
                    per_device_mem=float(counter.peak_bytes),
                    cast_bytes=counter.cast_bytes * chips,
                    coll_nvlink_bytes=st.bytes_nvlink * chips,
                    unfused_bytes=counter.unfused_bytes * chips)


def model_flops_estimate(cfg, shape) -> float:
    """6*N*D train / 2*N*D inference with N = active params, D = tokens."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: one token/seq
