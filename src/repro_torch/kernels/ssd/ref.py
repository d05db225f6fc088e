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

``ssd_ref`` and ``ssd_chunk_scan_ref`` are differentiable: autograd runs
through the plain chunked form, and its gradient is finite at Q 256 for
the same reason its output is.  ``ssd_chunk_scan_bwd_ref`` is the CUDA
backward kernel's arithmetic and schedule written plainly (block-start
states, then a reverse walk over 64-token blocks); the tests hold it
against autograd through ``ssd_chunk_scan_ref``.  ``ssd_split_ref`` stays
forward-only (``refuse_grad``): it checks the wgmma kernel's rounding,
which has no backward of its own.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def _wide(t):
    """t in f32, or in f64 when it is f64 (for ``gradcheck``)."""
    return t if t.dtype == torch.float64 else t.to(f32)


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and any input requires a gradient: a
    check of the forward kernel's rounding, not a function to train
    through (the training path is ``ssd_chunk_scan_ref`` on the CPU and
    the backward kernel on a card)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: it restates the wgmma kernel's "
            f"rounding; differentiate ssd_chunk_scan_ref instead.  Call it "
            f"under torch.no_grad()")


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
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af, Bf, Cf = map(_wide, (x, dt, A, Bm, Cm))
    state = xf.new_zeros(Bsz, H, P, N)
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
    [B, H, P, N] f32 state after the last chunk; f64 for f64 inputs)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(chunk, S)
    xf, dtf, Af, Bf, Cf = map(_wide, (x, dt, A, Bm, Cm))
    state = xf.new_zeros(Bsz, H, P, N)
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


def _block_states(xf, dtf, Af, Bf, block):
    """The [B, H, P, N] f32 state entering each block of ``block`` tokens
    (the first is zero): the backward kernel's first sweep."""
    Bsz, S, H, P = xf.shape
    state = xf.new_zeros(Bsz, H, P, Bf.shape[-1])
    states = []
    for c0 in range(0, S, block):
        states.append(state)
        xq, dtq, Bq = (t[:, c0:c0 + block] for t in (xf, dtf, Bf))
        cum = torch.cumsum(dtq * Af, dim=1)                      # [B,L,H]
        w = torch.exp(cum[:, -1:] - cum) * dtq
        state = (state * torch.exp(cum[:, -1])[..., None, None]
                 + torch.einsum("bjh,bjhp,bjn->bhpn", w, xq, Bq))
    return states


def ssd_chunk_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dstate=None, *,
                           block: int = 64):
    """The gradient of ``ssd_chunk_scan_ref`` (at any chunk: the function
    does not depend on it) as the backward kernel computes it.  dy:
    [B, S, H, P], the cotangent of y; dstate: [B, H, P, N] of the final
    state, or None for zero.  Returns f32 (dx, ddt, dA, dBm, dCm).

    Per (b, h) the blocks of ``block`` tokens (the last may be short) are
    walked last to first.  In a block, with cum the in-block cumsum of
    a_t = dt_t A, s the state entering it, G the cotangent of the state
    leaving it, decay_ij = exp(cum_i - cum_j) on j <= i (else 0), w_j =
    exp(cum_L - cum_j) dt_j, e_ij = dy_i . x_j and M_ij = (C_i . B_j)
    decay_ij dt_j:

        dx_j   = sum_i M_ij dy_i + w_j G B_j
        dC_i   = sum_j D_ij B_j + exp(cum_i) s^T dy_i,  D_ij = decay_ij dt_j e_ij
        dB_j   = sum_i D_ij C_i + w_j G^T x_j
        ddt_j  = sum_i (C_i . B_j) decay_ij e_ij + exp(cum_L - cum_j) x_j^T G B_j
                 + A da_j
        G     <- exp(cum_L) G + sum_i exp(cum_i) dy_i C_i^T

    where da_k = sum_{i >= k} dcum_i, and dcum gathers the quadratic form
    (+sum_j M_ij e_ij at row i, -M_ij e_ij at column j), the carried state
    (+exp(cum_i) dy_i^T s C_i) and the state out (+exp(cum_L) <G, s> +
    sum_j h_j at the last token, -h_j at j, h_j = w_j x_j^T G B_j).  dA
    sums dt_k da_k over tokens and batch rows; dBm and dCm sum over
    heads (ngroups = 1).  f64 inputs are computed in f64."""
    xf, dtf, Af, Bf, Cf, dyf = map(_wide, (x, dt, A, Bm, Cm, dy))
    states = _block_states(xf, dtf, Af, Bf, block)
    G = (torch.zeros_like(states[0]) if dstate is None
         else _wide(dstate).clone()) if states else None
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(dtf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA = torch.zeros_like(Af)
    for k in reversed(range(len(states))):
        c0, s = k * block, states[k]
        xq, dtq, Bq, Cq, dyq = (t[:, c0:c0 + block]
                                for t in (xf, dtf, Bf, Cf, dyf))
        L = xq.shape[1]
        idx = torch.arange(L, device=x.device)
        causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
        cum = torch.cumsum(dtq * Af, dim=1)                      # [B,L,H]
        cum_l = cum[:, -1]                                       # [B,H]
        seg = cum[:, :, None] - cum[:, None, :]                  # [B,i,j,H]
        decay = torch.exp(torch.where(causal, seg, float("-inf")))
        CB = torch.einsum("bin,bjn->bij", Cq, Bq)
        e = torch.einsum("bihp,bjhp->bijh", dyq, xq)             # [B,i,j,H]
        K = CB[..., None] * decay
        M = K * dtq[:, None]
        D = decay * dtq[:, None] * e
        keep = torch.exp(cum_l[:, None] - cum)                   # [B,L,H]
        w = keep * dtq
        ecum = torch.exp(cum)
        GB = torch.einsum("bhpn,bjn->bjhp", G, Bq)               # [B,L,H,P]
        sdy = torch.einsum("bhpn,bihp->bihn", s, dyq)            # [B,L,H,N]
        Gx = torch.einsum("bhpn,bjhp->bjhn", G, xq)              # [B,L,H,N]
        gbx = (xq * GB).sum(-1)                                  # [B,L,H]
        dx[:, c0:c0 + L] = (torch.einsum("bijh,bihp->bjhp", M, dyq)
                            + w[..., None] * GB)
        dC[:, c0:c0 + L] = (torch.einsum("bijh,bjn->bin", D, Bq)
                            + torch.einsum("bih,bihn->bin", ecum, sdy))
        dB[:, c0:c0 + L] = (torch.einsum("bijh,bin->bjn", D, Cq)
                            + torch.einsum("bjh,bjhn->bjn", w, Gx))
        Z = M * e
        h = w * gbx
        dcum = (Z.sum(2) - Z.sum(1) - h
                + ecum * torch.einsum("bin,bihn->bih", Cq, sdy))
        dcum[:, -1] += torch.exp(cum_l) * (G * s).sum((-1, -2)) + h.sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,))
        ddt[:, c0:c0 + L] = ((K * e).sum(1) + keep * gbx
                             + Af * da)
        dA = dA + (dtq * da).sum((0, 1))
        G = (G * torch.exp(cum_l)[..., None, None]
             + torch.einsum("bih,bihp,bin->bhpn", ecum, dyq, Cq))
    return dx, ddt, dA, dB, dC


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
