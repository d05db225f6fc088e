"""The CUDA SSD chunk scan: ctypes bindings, wrappers, autograd.

The forward kernels are ``csrc/ssd_chunk_scan.cu`` (they replace the TPU
kernel ``src/repro/kernels/ssd/kernel.py:65``); the backward's are
``csrc/ssd_chunk_scan_bwd.cu``, which the TPU kernel lacks (the JAX
package differentiates its plain chunked form).  Each direction has two
routes, picked by a rule of the shapes (``route``, ``route_bwd``).
``ssd_chunk_scan`` and ``ssd_chunk_scan_bwd`` take CUDA tensors only:
they check them, pick a kernel, allocate outputs and scratch, launch on
the current stream and raise when a launch is refused.  ``SSDChunkScan`` is the
``torch.autograd.Function`` whose forward and backward are the two.  CPU
tensors go to the plain version through ``ops.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.analysis.launch_geometry import cu_constants
from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import chunk_len

NAME = "ssd_chunk_scan"
NAME_BWD = "ssd_chunk_scan_bwd"
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk_scan.cu"
SOURCE_BWD = SOURCE.with_name("ssd_chunk_scan_bwd.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
P_MAX, N_MAX, Q_MAX = 64, 128, 8192     # the kernel's PMAX, NMAX, QMAX
BLOCK = 64                              # tokens of the wgmma kernel's block
# the kernels of the source, by the number the C entry point takes
ROUTES = ("cuda_core", "wgmma")

# the backward's routes, by the number the C entry point takes: the
# CUDA-core kernel (f32, ragged P or N) and the wgmma kernels (two sweeps);
# their 64-token block, the most blocks of the head reduction and that
# reduction's threads a block, and the wgmma route's kept-state stride
# (read from the source, which launches with them)
ROUTES_BWD = ("cuda_core", "wgmma")
BLOCK_BWD = 64
REDUCE_BLOCKS = 1024
RTHREADS, CKPT = cu_constants(SOURCE_BWD, "RTHREADS", "CKPT")

build.LAUNCHES.setdefault(NAME, 0)
build.LAUNCHES.setdefault(NAME_BWD, 0)

_fn = None
_fn_bwd = None


def _entry():
    """The bound C entry point (built from ``SOURCE`` at first use)."""
    global _fn
    if _fn is None:
        fn = build.load(SOURCE).ssd_chunk_scan
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _entry_bwd():
    """The bound C entry point of the backward (built from ``SOURCE_BWD``
    at first use)."""
    global _fn_bwd
    if _fn_bwd is None:
        fn = build.load(SOURCE_BWD).ssd_chunk_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_bwd = fn
    return _fn_bwd


def _check(x, dt, A, Bm, Cm, Q, name=NAME, **more):
    for tname, t in dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, **more).items():
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"the CUDA device of x ({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"{name}: x, Bm and Cm are {x.dtype}, {Bm.dtype} "
                        f"and {Cm.dtype}; the kernel takes float32 or "
                        f"bfloat16, all three of one type")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{name}: dt and A must be float32, got {dt.dtype} "
                        f"and {A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, S, H, P], got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if (dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != (B, S, N)
            or Cm.shape != (B, S, N)):
        raise ValueError(f"{name}: with x {tuple(x.shape)} expected dt "
                         f"[B, S, H], A [H], Bm and Cm [B, S, N]; got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if not (1 <= P <= P_MAX and 1 <= N <= N_MAX and Q <= Q_MAX):
        raise ValueError(f"{name}: the kernel takes P <= {P_MAX}, N <= "
                         f"{N_MAX} and chunks of up to {Q_MAX} tokens; got "
                         f"P {P}, N {N}, Q {Q}")


def route(dtype: torch.dtype, P: int, N: int, Q: int) -> str:
    """Which kernel takes a scan of head dim ``P``, state ``N`` and chunk
    ``Q`` in ``dtype``: bf16 with Q a multiple of the 64-token block, P a
    multiple of 16 up to 64 and N a multiple of 16 up to 128 goes to the
    wgmma kernel; everything else (f32, Q = 1, ragged P or N) to the
    CUDA-core kernel.  A pure function of the shape: nothing is tried and
    retried."""
    if dtype not in DTYPES:
        raise TypeError(f"{NAME}: no kernel for {dtype}")
    if (dtype == torch.bfloat16 and Q % BLOCK == 0 and P % 16 == 0
            and P <= P_MAX and N % 16 == 0 and N <= N_MAX):
        return "wgmma"
    return "cuda_core"


def _launch(x, dt, A, Bm, Cm, Q: int, how: str):
    """Launch the kernel of route ``how`` on checked inputs and count the
    launch.  ``ssd_chunk_scan`` passes ``route(...)``; callers go through
    it, and only a timing harness names a route itself."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if how == "wgmma":
        for tname, t in dict(x=x, Bm=Bm, Cm=Cm).items():
            if t.data_ptr() % 16:
                raise ValueError(f"{NAME}: {tname} must start on a 16-byte "
                                 f"boundary (the wgmma kernel copies its "
                                 f"tiles by TMA)")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    err = _entry()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                   Cm.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H,
                   P, N, Q, DTYPES[x.dtype], ROUTES.index(how),
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: kernel launch ({how}) failed with CUDA "
                           f"error {err}")
    build.count_launch(NAME, how)
    return y, state


def ssd_chunk_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """Launch the kernel: x [B, S, H, P], Bm/Cm [B, S, N] (f32 or bf16, one
    type), dt [B, S, H] and A [H] f32 -> (y [B, S, H, P] f32, the
    [B, H, P, N] f32 state after the last chunk).  Same contract as
    ``ref.ssd_chunk_scan_ref``; the kernel is ``route``'s."""
    S, P = x.shape[1], x.shape[-1]
    Q = chunk_len(chunk, S)
    _check(x, dt, A, Bm, Cm, Q)
    return _launch(x, dt, A, Bm, Cm, Q, route(x.dtype, P, Bm.shape[-1], Q))


def route_bwd(dtype: torch.dtype, P: int, N: int) -> str:
    """Which backward takes head dim ``P`` and state ``N`` in ``dtype``:
    bf16 with P a multiple of 16 up to 64 and N a multiple of 16 up to 128
    goes to the wgmma kernels; f32 and ragged P or N to the CUDA-core
    kernel.  Any S: the last block may be short.  A pure function of the
    shape, as ``route`` is: nothing is tried and retried."""
    if dtype not in DTYPES:
        raise TypeError(f"{NAME_BWD}: no kernel for {dtype}")
    if (dtype == torch.bfloat16 and P % 16 == 0 and P <= P_MAX
            and N % 16 == 0 and N <= N_MAX):
        return "wgmma"
    return "cuda_core"


def cluster_bwd(H: int) -> int:
    """Heads a cluster of the wgmma backward sums dB and dC over in
    distributed shared memory: the largest of 8, 4, 2, 1 that divides H
    (8 for mamba2-2.7b's 80 heads and jamba's 256)."""
    return next(c for c in (8, 4, 2, 1) if H % c == 0)


def bwd_scratch(B: int, S: int, H: int, P: int, N: int, how: str) -> dict:
    """The f32 scratch of one backward call on route ``how``, by name:
    shape.  cuda_core: the state entering every block and per-head
    partials of dBm and dCm.  wgmma: the state entering every CKPT-th
    block (from block CKPT to the last but one, in the state warpgroup's
    register order: 64 rows x N rounded up to 64), carrE per token, delta
    per (b, h), and partials a cluster of ``cluster_bwd(H)`` heads."""
    nblk = -(-S // BLOCK_BWD)
    if how == "cuda_core":
        return {"states": (B, H, nblk, P, N), "dBp": (B, H, S, N),
                "dCp": (B, H, S, N), "dAp": (B, H)}
    NP = 64 if N <= 64 else 128
    nck = (nblk - 2) // CKPT if nblk >= 2 else 0
    HC = H // cluster_bwd(H)
    return {"states": (B, H, nck, 64 * NP), "dBp": (B, HC, S, N),
            "dCp": (B, HC, S, N), "dAp": (B, H), "carrE": (B, H, S),
            "delta": (B, H)}


def _launch_bwd(x, dt, A, Bm, Cm, dy, dstate, how: str):
    """Launch the backward of route ``how`` on checked inputs and count
    the launch.  ``ssd_chunk_scan_bwd`` passes ``route_bwd(...)``; callers
    go through it, and only a timing harness names a route itself."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if how == "wgmma":
        if route_bwd(x.dtype, P, N) != "wgmma":
            raise ValueError(f"{NAME_BWD}: the wgmma route takes bf16 with "
                             f"P and N multiples of 16; got {x.dtype}, P "
                             f"{P}, N {N}")
        for tname, t in dict(x=x, Bm=Bm, Cm=Cm).items():
            if t.data_ptr() % 16:
                raise ValueError(f"{NAME_BWD}: {tname} must start on a "
                                 f"16-byte boundary (the wgmma kernels copy "
                                 f"its tiles by TMA)")
    dev = x.device
    dx, dBm, dCm = (torch.empty_like(t) for t in (x, Bm, Cm))
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    scratch = {k: torch.empty(v, dtype=torch.float32, device=dev)
               for k, v in bwd_scratch(B, S, H, P, N, how).items()}
    ptr = {k: v.data_ptr() for k, v in scratch.items()}
    err = _entry_bwd()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
        ptr["states"], ptr["dBp"], ptr["dCp"], ptr["dAp"],
        ptr.get("carrE"), ptr.get("delta"), B, S, H, P, N,
        DTYPES[x.dtype], ROUTES_BWD.index(how), cluster_bwd(H),
        reduce_blocks(B, S, N), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME_BWD}: kernel launch ({how}) failed with "
                           f"CUDA error {err}")
    build.count_launch(NAME_BWD, how)
    return dx, ddt, dA, dBm, dCm


def ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, dy, dstate=None):
    """Launch the backward: the forward's inputs, dy [B, S, H, P] f32 (the
    cotangent of y) and dstate [B, H, P, N] f32 (of the final state, or
    None for zero) -> (dx, ddt, dA, dBm, dCm), dx/dBm/dCm in x's type and
    ddt/dA f32.  Same contract as ``ref.ssd_chunk_scan_bwd_ref``; the
    result does not depend on the forward's chunk.  Deterministic: the
    partials of dBm and dCm are summed in a fixed order.  The kernels are
    ``route_bwd``'s."""
    more = dict(dy=dy) if dstate is None else dict(dy=dy, dstate=dstate)
    _check(x, dt, A, Bm, Cm, 1, NAME_BWD, **more)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if dy.shape != x.shape or dy.dtype != torch.float32 or (
            dstate is not None and (dstate.shape != (B, H, P, N)
                                    or dstate.dtype != torch.float32)):
        raise ValueError(f"{NAME_BWD}: dy must be f32 {tuple(x.shape)} and "
                         f"dstate f32 {(B, H, P, N)} or None")
    return _launch_bwd(x, dt, A, Bm, Cm, dy, dstate,
                       route_bwd(x.dtype, P, N))


def reduce_blocks(B: int, S: int, N: int) -> int:
    """The grid of the backward's reduction over heads: one thread an
    element of dBm (and dCm), up to ``REDUCE_BLOCKS`` blocks that stride
    over the rest."""
    return max(1, min(REDUCE_BLOCKS, -(-B * S * N // RTHREADS)))


class SSDChunkScan(torch.autograd.Function):
    """The chunk scan whose forward and backward are the CUDA kernels:
    returns (y, final state); saves the inputs (the backward recomputes
    the block-start states itself)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        y, state = ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_chunk_scan_bwd(
            x, dt, A, Bm, Cm, dy.contiguous(),
            None if dstate is None else dstate.contiguous())
        return (*grads, None)
