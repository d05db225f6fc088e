"""Plain PyTorch versions of the Mamba2 SSD chunk scan.

``ssd_ref`` is a copy of the JAX package's oracle
(``repro/kernels/ssd/ref.py::ssd_ref``): the token-by-token recurrence,
returning ``(y, final state)``.  ``ssd_chunk_scan_ref`` is the chunked
form of ``repro/models/ssm.py::ssd_chunked``, with its rule for the chunk
length Q: ``min(chunk, S)``, halved until it divides S.  It is what
``ops.py`` runs for CPU tensors and what tests and ``chip_smoke.py`` hold
the CUDA kernel against.

``ssd_split_ref`` is the wgmma kernel's arithmetic written plainly:
64-token blocks, and each product of an f32 value (T, the carried
state, w x) taken as two bf16 terms accumulated in f32.  The tests hold
it against the JAX functions and ``ssd_chunk_scan_ref`` on the CPU, so
that rounding is checked before any card runs the kernel.

One difference from ``ssd_chunked``: the causal mask is a select.
``ssd_chunked`` multiplies ``exp(cum_i - cum_j)`` by a 0/1 mask, and above
the diagonal that exponent is a positive sum of ``|dt * A|`` that
overflows f32 once a chunk is long (from Q ~ 64 at unit dt and A), so
inf * 0 gives NaN there; this version exponentiates ``-inf`` instead and
stays finite at the published chunk of 256.

Like the TPU kernel, both are forward-only: ``refuse_grad`` raises when
autograd would need their gradient, on either device.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and any input requires a gradient: the
    kernel has no backward (the TPU kernel has none either)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only, like the TPU kernel it ports: no "
            f"backward exists (ROADMAP section 2 item 5; training mamba2 "
            f"needs an SSD backward kernel).  Call it under torch.no_grad()")


def chunk_len(chunk: int, S: int) -> int:
    """The chunk length Q of ``ssd_chunked``: min(chunk, S), halved until
    it divides S."""
    Q = max(1, min(chunk, S))
    while S % Q:
        Q //= 2
    return Q


def ssd_ref(x, dt, A, Bm, Cm):
    """Token-by-token linear recurrence (exact, O(S) sequential).

    x: [B, S, H, P]; dt: [B, S, H]; A: [H]; Bm, Cm: [B, S, N] ->
    (y [B, S, H, P] f32, state [B, H, P, N] f32)."""
    refuse_grad("ssd_ref", x, dt, A, Bm, Cm)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.to(f32), dt.to(f32), A.to(f32)
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    state = torch.zeros(Bsz, H, P, N, dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]      # [B,H,1,1]
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * Bf[:, t, None, None, :])                       # [B,H,P,N]
        state = state * decay + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y, state


def ssd_chunk_scan_ref(x, dt, A, Bm, Cm, *, chunk: int):
    """Chunked state-space duality, the state starting at zero.

    x: [B, S, H, P]; dt: [B, S, H] (post-softplus, > 0); A: [H]
    (negative); Bm, Cm: [B, S, N] (one group) -> (y [B, S, H, P] f32, the
    [B, H, P, N] f32 state after the last chunk)."""
    refuse_grad("ssd_chunk_scan", x, dt, A, Bm, Cm)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(chunk, S)
    xf, dtf, Af = x.to(f32), dt.to(f32), A.to(f32)
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    state = torch.zeros(Bsz, H, P, N, dtype=f32, device=x.device)
    idx = torch.arange(Q, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]   # [1,Q,Q,1]
    ys = []
    for c0 in range(0, S, Q):
        xq, dtq = xf[:, c0:c0 + Q], dtf[:, c0:c0 + Q]
        Bq, Cq = Bf[:, c0:c0 + Q], Cf[:, c0:c0 + Q]
        cum = torch.cumsum(dtq * Af, dim=1)                      # [B,Q,H]
        # intra-chunk dual form; exp(-inf) = 0 above the diagonal
        CB = torch.einsum("bin,bjn->bij", Cq, Bq)                # [B,Q,Q]
        seg = cum[:, :, None] - cum[:, None, :]                  # [B,Q,Q,H]
        decay = torch.exp(torch.where(causal, seg, float("-inf")))
        T = CB[..., None] * decay * dtq[:, None]
        y = torch.einsum("bijh,bjhp->bihp", T, xq)
        # the carried state's contribution
        y = y + torch.einsum("bin,bhpn,bih->bihp", Cq, state,
                             torch.exp(cum))
        # state update
        w = torch.exp(cum[:, -1:] - cum) * dtq                   # [B,Q,H]
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjh,bjhp,bjn->bhpn", w, xq, Bq))
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y, state


def bf16_split(v):
    """v (f32) as hi = bf16(v) and lo = bf16(v - hi), both returned in f32:
    hi + lo holds v to about 2^-16 relative."""
    hi = v.to(torch.bfloat16).to(f32)
    return hi, (v - hi).to(torch.bfloat16).to(f32)


def ssd_split_ref(x, dt, A, Bm, Cm, *, block: int = 64):
    """The wgmma kernel's rounding, in plain PyTorch: the sequence in
    blocks of ``block`` tokens from a zero state, per block

        S  = C B^T                           (bf16 operands, f32 sums)
        T  = S exp(cum_i - cum_j) dt_j on j <= i, else 0
        y  = exp(cum_i) C (st_hi + st_lo) + (T_hi + T_lo) x
        st = st exp(cum_last) + B^T (wx_hi + wx_lo),  wx = w x

    where each ``*_hi``/``*_lo`` pair is ``bf16_split`` of the f32 value
    and every product of two bf16 terms is summed in f32.  x, Bm and Cm are
    taken as given (exact when they are bf16).  S must be a multiple of
    ``block``.  Returns (y [B, S, H, P] f32, state [B, H, P, N] f32)."""
    refuse_grad("ssd_split_ref", x, dt, A, Bm, Cm)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % block:
        raise ValueError(f"ssd_split_ref: S {S} is not a multiple of the "
                         f"block {block}")
    xf, dtf, Af = x.to(f32), dt.to(f32), A.to(f32)
    Bf, Cf = Bm.to(f32), Cm.to(f32)
    state = torch.zeros(Bsz, H, P, N, dtype=f32, device=x.device)
    idx = torch.arange(block, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]   # [1,L,L,1]
    ys = []
    for c0 in range(0, S, block):
        xq, dtq = xf[:, c0:c0 + block], dtf[:, c0:c0 + block]
        Bq, Cq = Bf[:, c0:c0 + block], Cf[:, c0:c0 + block]
        cum = torch.cumsum(dtq * Af, dim=1)                      # [B,L,H]
        CB = torch.einsum("bin,bjn->bij", Cq, Bq)                # [B,L,L]
        seg = cum[:, :, None] - cum[:, None, :]                  # [B,L,L,H]
        decay = torch.exp(torch.where(causal, seg, float("-inf")))
        t_hi, t_lo = bf16_split(CB[..., None] * (decay * dtq[:, None]))
        s_hi, s_lo = bf16_split(state)
        y = (torch.einsum("bin,bhpn->bihp", Cq, s_hi)
             + torch.einsum("bin,bhpn->bihp", Cq, s_lo))
        y = (y * torch.exp(cum)[..., None]
             + torch.einsum("bijh,bjhp->bihp", t_hi, xq)
             + torch.einsum("bijh,bjhp->bihp", t_lo, xq))
        w = torch.exp(cum[:, -1:] - cum) * dtq                   # [B,L,H]
        wx_hi, wx_lo = bf16_split(w[..., None] * xq)             # [B,L,H,P]
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjn,bjhp->bhpn", Bq, wx_hi)
                 + torch.einsum("bjn,bjhp->bhpn", Bq, wx_lo))
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y, state
