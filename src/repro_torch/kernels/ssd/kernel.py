"""The CUDA SSD chunk scan: ctypes binding and wrapper.

The kernels are ``csrc/ssd_chunk_scan.cu`` (they replace the TPU kernel
``src/repro/kernels/ssd/kernel.py:65``).  ``ssd_chunk_scan`` takes CUDA
tensors only: it checks them, picks a kernel by ``route``, allocates the
f32 outputs, launches on the current stream and raises when a launch is
refused.  Like the TPU kernel it is forward-only.  CPU tensors go to the
plain version through ``ops.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import chunk_len, refuse_grad

NAME = "ssd_chunk_scan"
SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk_scan.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
P_MAX, N_MAX, Q_MAX = 64, 128, 8192     # the kernel's PMAX, NMAX, QMAX
BLOCK = 64                              # tokens of the wgmma kernel's block
# the kernels of the source, by the number the C entry point takes
ROUTES = ("cuda_core", "wgmma")

build.LAUNCHES.setdefault(NAME, 0)

_fn = None


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


def _check(x, dt, A, Bm, Cm, Q):
    refuse_grad(NAME, x, dt, A, Bm, Cm)
    for tname, t in dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm).items():
        if t.device != x.device or not t.is_cuda:
            raise ValueError(f"{NAME}: {tname} is on {t.device}, expected "
                             f"the CUDA device of x ({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {tname} must be contiguous")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"{NAME}: x, Bm and Cm are {x.dtype}, {Bm.dtype} "
                        f"and {Cm.dtype}; the kernel takes float32 or "
                        f"bfloat16, all three of one type")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"{NAME}: dt and A must be float32, got {dt.dtype} "
                        f"and {A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{NAME}: x must be [B, S, H, P], got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if (dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != (B, S, N)
            or Cm.shape != (B, S, N)):
        raise ValueError(f"{NAME}: with x {tuple(x.shape)} expected dt "
                         f"[B, S, H], A [H], Bm and Cm [B, S, N]; got "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if not (1 <= P <= P_MAX and 1 <= N <= N_MAX and Q <= Q_MAX):
        raise ValueError(f"{NAME}: the kernel takes P <= {P_MAX}, N <= "
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
