"""The CUDA paged-attention kernels: build, ctypes bindings, wrappers.

Two kernels, one source each:
  ``paged_chunk_attention`` (``csrc/paged_chunk_attention.cu``) replaces
  the TPU kernel ``src/repro/kernels/paged_attention/kernel.py:264``;
  ``paged_attention`` (``csrc/paged_attention.cu``), its decode special
  case, replaces ``kernel.py:349``.
Both take f32 or bf16 pools of q's dtype, or int8 pools with their
``[P, KH]`` f32 scales.  The chunk source holds two kernels, chosen by
``chunk_route``: bf16 q on the tensor cores (over bf16 or int8 pools), the
rest on the CUDA cores.  The decode kernel splits each slot's pages over
``decode_splits`` blocks (one thread-block cluster) and merges them by
log-sum-exp in the same launch.  Both rules are pure functions of the
shapes: the wrappers never read a length on the host.  The wrappers take
CUDA tensors only: they check them, allocate the output, launch the kernel
on the current stream and raise when the launch is refused.  CPU tensors go
to the plain versions through ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

NAME = "paged_chunk_attention"
NAME_DECODE = "paged_attention"
CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / f"{NAME}.cu"
SOURCE_DECODE = CSRC / f"{NAME_DECODE}.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the chunk source's kernels, by the number its C entry point takes
CHUNK_ROUTES = ("cuda_core", "wgmma", "wgmma_int8")
TC_HEAD_DIMS = (32, 64, 96, 128)
TC_PAGE_SIZES = (8, 16, 32, 64)
TC_ROWS = 64                    # query rows of the tensor-core kernel's tile
# the decode kernel's split: blocks for about DECODE_WAVES waves of the
# card's SMs, at most DECODE_MAX_SPLITS blocks (one cluster, of the
# portable size) a unit of work
DECODE_WAVES = 2
DECODE_MAX_SPLITS = 8

build.LAUNCHES.setdefault(NAME, 0)
build.LAUNCHES.setdefault(NAME_DECODE, 0)

_fns: Dict[str, object] = {}


def _entry(name: str, source: Path, n_ptrs: int, n_ints: int):
    """The bound C entry point ``<name>_launch`` (built from ``source`` at
    first use): ``n_ptrs`` pointers, ``n_ints`` ints, then scale, window,
    softcap, dtype, kv_int8 and the stream."""
    if name not in _fns:
        fn = getattr(build.load(source), f"{name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(name, q, k_pages, v_pages, block_tables, per_slot, k_scale,
           v_scale, q_dims: int) -> int:
    """Validate one launch's operands; returns 1 for int8 pools, else 0.
    ``per_slot`` maps names to the [B] int32 operands; q has ``q_dims``
    dims, [B, (C,) H, D]."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: k_scale and v_scale must be passed "
                         f"together")
    quant = k_scale is not None
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, **per_slot}
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for what, t in tensors.items():
        if t.device != q.device or not t.is_cuda:
            raise ValueError(f"{name}: {what} is on {t.device}, expected "
                             f"the CUDA device of q ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: q is {q.dtype}; the kernel takes "
                        f"float32 or bfloat16")
    pool_dtype = torch.int8 if quant else q.dtype
    if k_pages.dtype != pool_dtype or v_pages.dtype != pool_dtype:
        raise TypeError(
            f"{name}: pools are {k_pages.dtype}/{v_pages.dtype} with q "
            f"{q.dtype} and {'' if quant else 'no '}scales; expected "
            f"{pool_dtype} (int8 pools need k_scale and v_scale)")
    for what, t in (("block_tables", block_tables), *per_slot.items()):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} is {t.dtype}, expected int32")
    if q.dim() != q_dims or k_pages.dim() != 4 \
            or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: q must have {q_dims} dims and both pools "
                         f"be [P, psize, KH, D]; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    P, KH = k_pages.shape[0], k_pages.shape[2]
    if k_pages.shape[3] != D or H % KH:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)} (head dim, H % KH)")
    if D % 32 or not 32 <= D <= 256:
        raise ValueError(f"{name}: head dim {D} must be a multiple of 32 "
                         f"up to 256")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: pools must start on a 16-byte boundary "
                         f"(the kernel copies them in 16-byte pieces)")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or any(
            t.shape != (B,) for t in per_slot.values()):
        raise ValueError(f"{name}: block_tables must be [B, maxp] and "
                         f"{'/'.join(per_slot)} [B] with B = {B}")
    if quant:
        for what, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or t.shape != (P, KH):
                raise ValueError(f"{name}: {what} must be float32 "
                                 f"[P, KH] = {(P, KH)}; got {t.dtype} "
                                 f"{tuple(t.shape)}")
    return int(quant)


def _launch(name, fn, ptrs, ints, q, scale, window, softcap, quant):
    err = fn(*ptrs, *ints, float(scale), int(window or 0),
             float(softcap or 0.0), DTYPES[q.dtype], quant,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def chunk_route(dtype: torch.dtype, quant: bool, D: int, psize: int,
                G: int) -> str:
    """Which kernel of the chunk source takes a launch: the tensor-core
    kernel for bf16 q with a head dim of 32, 64, 96 or 128, pages of 8,
    16, 32 or 64 tokens (a page is then a whole number of swizzle atoms and
    a 64-key tile a whole number of pages) and G = H / KH dividing the 64
    rows of its q tile, as ``"wgmma"`` on bf16 pools and ``"wgmma_int8"``
    on int8 pools; ``"cuda_core"`` for every other launch (f32 q, other
    shapes).  A pure function of the shapes: nothing is tried and
    retried."""
    if dtype == torch.bfloat16 and D in TC_HEAD_DIMS \
            and psize in TC_PAGE_SIZES and G >= 1 and TC_ROWS % G == 0:
        return "wgmma_int8" if quant else "wgmma"
    return "cuda_core"


def decode_rows(G: int) -> int:
    """Query heads of one decode block: the largest of 8, 4, 2, 1 that
    divides G (a compile-time count of the kernel)."""
    return next(r for r in (8, 4, 2, 1) if G % r == 0)


def decode_splits(B: int, KH: int, G: int, maxp: int, sm_count: int) -> int:
    """Blocks that share one (slot, kv head, row group) unit of the decode
    kernel, each taking an equal range of the slot's live pages: enough
    for about ``DECODE_WAVES`` blocks an SM over the B * KH * G /
    decode_rows(G) units, at most ``DECODE_MAX_SPLITS`` (one cluster) and
    at most the block table's width ``maxp``, at least 1.  A pure function
    of shapes the host knows, so the launch needs no host sync."""
    units = B * KH * (G // decode_rows(G))
    want = -(-DECODE_WAVES * sm_count // max(units, 1))
    return max(1, min(DECODE_MAX_SPLITS, maxp, want))


def decode_route(splits: int) -> str:
    """The launch count's route of a decode launch: ``"split"`` when a
    unit's pages are split over several blocks, else ``"single"``."""
    return "split" if splits > 1 else "single"


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _ptr(t):
    return None if t is None else t.data_ptr()


def paged_chunk_attention(q, k_pages, v_pages, block_tables, starts,
                          chunk_lens, *, scale: float,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None, k_scale=None,
                          v_scale=None, logit_index=None):
    """Launch the chunk kernel; same contract as
    ``ref.paged_chunk_attention_ref``.  Every block-table entry of a live
    page (index < ceil((start + chunk_len) / psize)) must be a valid page
    id; entries past it are never read.  With ``logit_index`` ([B, S_w]
    int32 chunk positions in [0, C)) returns ``(out, out_win [B, S_w, H,
    D])``, the window rows written by the kernel's epilogue; a position
    outside [0, C) gives zero rows."""
    quant = _check(NAME, q, k_pages, v_pages, block_tables,
                   {"starts": starts, "chunk_lens": chunk_lens}, k_scale,
                   v_scale, 4)
    B, C, H, D = q.shape
    P, psize, KH = k_pages.shape[:3]
    S_w = 0
    out_win = None
    if logit_index is not None:
        if logit_index.device != q.device or logit_index.dtype != \
                torch.int32 or logit_index.dim() != 2 or \
                logit_index.shape[0] != B or not logit_index.is_contiguous():
            raise ValueError(f"{NAME}: logit_index must be a contiguous "
                             f"int32 [B, S_w] tensor on {q.device} with B = "
                             f"{B}; got {logit_index.dtype} "
                             f"{tuple(logit_index.shape)} on "
                             f"{logit_index.device}")
        S_w = logit_index.shape[1]
        out_win = torch.zeros((B, S_w, H, D), dtype=q.dtype,
                              device=q.device)
    how = chunk_route(q.dtype, bool(quant), D, psize, H // KH)
    out = torch.empty_like(q)
    _launch(NAME, _entry(NAME, SOURCE, 11, 10),
            [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
             starts.data_ptr(), chunk_lens.data_ptr(), out.data_ptr(),
             _ptr(logit_index), _ptr(out_win)],
            [B, C, H, KH, D, psize, block_tables.shape[1], P, S_w,
             CHUNK_ROUTES.index(how)],
            q, scale, window, softcap, quant)
    build.count_launch(NAME, how)
    return out if logit_index is None else (out, out_win)


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    scale: float, window: Optional[int] = None,
                    softcap: Optional[float] = None, k_scale=None,
                    v_scale=None):
    """Launch the decode kernel; same contract as
    ``ref.paged_attention_ref``.  Only block-table entries of live pages
    (from the window's first visible key to ceil(length / psize)) are read.
    Each (slot, kv head, row group) is split over ``decode_splits`` blocks
    of one cluster, whose partial states the kernel merges itself."""
    quant = _check(NAME_DECODE, q, k_pages, v_pages, block_tables,
                   {"lengths": lengths}, k_scale, v_scale, 3)
    B, H, D = q.shape
    psize, KH = k_pages.shape[1], k_pages.shape[2]
    maxp = block_tables.shape[1]
    splits = decode_splits(B, KH, H // KH, maxp, sm_count(q.device.index))
    out = torch.empty_like(q)
    _launch(NAME_DECODE, _entry(NAME_DECODE, SOURCE_DECODE, 8, 7),
            [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
             lengths.data_ptr(), out.data_ptr()],
            [B, H, KH, D, psize, maxp, splits],
            q, scale, window, softcap, quant)
    build.count_launch(NAME_DECODE, decode_route(splits))
    return out
