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
    hi, lo = bf16_terms(v, 2)
    return hi, lo


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



# How many bf16 terms each f32 operand of the backward's wgmma route takes
# to the tensor cores: 3 (hi, mid, lo: about 2^-24 relative), 2 (hi, lo:
# 2^-16) or 1 (bf16 of the value).  ``ssd_chunk_scan_bwd_split_ref``
# decided it on the CPU: dA sums dt da over every token of a batch row and
# cancels to a few units out of terms in the thousands, so the products
# that reach it through the carried state, G and delta need f32's own
# precision (``SSD_BWD_TOL`` in ``chip_smoke.py``: 1e-4 of its scale).
#   s_carr  s in s C^T (carr_i = dy_i . (s C^T)_i: ddt, dA)
#   wx_s    w x in the update of s (s, above)
#   G_gb    G in G B^T (x^T G B: ddt, dA, delta)
#   E_G     exp(cum) dy in the update of G (G, above; in two terms dA
#           keeps to the tolerance against the f32 backward but drifts to
#           0.5-0.8 of it against the f64 one at S 2048 with a dstate,
#           where three terms keep it at 0.14)
#   dy_e    dy in e = dy x^T (ddt through K e and the quadratic form)
# The bf16 outputs dx, dBm and dCm are held to 1e-2 of their scale, about
# one bf16 step at their largest values, so what reaches them is taken to
# 2^-16 where one term would cost a step:
#   M, dy_dx  M and dy in M^T dy (dx);  D  in D B (dC) and D^T C (dB)
# and one term where it does not:
#   E_dC, s_dC  exp(cum) dy and s in dC's state term E s;
#   wx_dB, G_dB  w x and G in (w x) G (dB)
BWD_TERMS = {"s_carr": 3, "wx_s": 3, "G_gb": 3, "E_G": 3, "dy_e": 2,
             "M": 2, "dy_dx": 2, "D": 2, "E_dC": 1, "s_dC": 1, "wx_dB": 1,
             "G_dB": 1}
# the state entering every BWD_CKPT-th block is kept (f32) between the
# sweeps; the reverse sweep takes delta from it there (see below): against
# the f64 backward at S 2048 with a dstate, dA drifts to 0.6-0.7 of its
# tolerance when delta runs its recurrence over the whole row, 0.14 with
# a restart every 4 blocks
BWD_CKPT = 4


def bf16_terms(v, n: int):
    """v (f32) as n bf16 terms, each returned in f32: hi = bf16(v), then
    bf16 of what is left; their sum holds v to about 2^(-8 n)
    relative."""
    out = []
    for _ in range(n):
        t = v.to(torch.bfloat16).to(f32)
        out.append(t)
        v = v - t
    return out


def _mm(eq, a, b):
    """A product of an operand in ``len(a)`` terms by one in ``len(b)``:
    einsum(eq, a_i, b_j) summed in f32 over the term pairs with i + j <
    max(len(a), len(b)), the pairs whose scale is above the finer
    operand's last term (3 x 1: three products; 2 x 2: hi hi, lo hi, hi
    lo)."""
    n = max(len(a), len(b))
    return sum(torch.einsum(eq, u, v) for i, u in enumerate(a)
               for j, v in enumerate(b) if i + j < n)


def ssd_chunk_scan_bwd_split_ref(x, dt, A, Bm, Cm, dy, dstate=None, *,
                                 block: int = 64, terms=None,
                                 ckpt: int = BWD_CKPT):
    """The backward's wgmma route written plainly: its two sweeps, its
    rounding and its order of the gradient's terms.  Same contract and
    outputs as ``ssd_chunk_scan_bwd_ref`` (dx, dBm and dCm rounded to x's
    type, as the kernel stores them; ddt, dA f32).  ``terms`` overrides
    ``BWD_TERMS``, the number of bf16 terms of each f32 operand.

    Sweep F walks the blocks first to last with the carried state s in
    f32 and computes what does not depend on G: dC = D B + E s (E =
    exp(cum) dy) and carrE_i = exp(cum_i) dy_i . (s C^T)_i, and keeps the
    state entering every ``ckpt``-th block.  Sweep R walks last to first
    with G: dx = M^T dy + w G B, dB = D^T C + (w x) G, ddt and dA.  The
    state-out term of dcum at a block's last token, exp(cum_L) <G, s> +
    sum_j h_j, is the inner product delta_k of the state leaving block k
    with its cotangent, which obeys

        delta_{k-1} = delta_k - sum_j h_j + sum_i carrE_i,
        delta_last  = <dstate, final state>

    Sweep R runs that recurrence down from each block where it has the
    state (the last, block 0 and every ``ckpt``-th), taking delta there
    from the state directly: in f32 the recurrence compounds the rounding
    of h and carrE over the blocks it spans, and dA, a sum that cancels,
    feels it (``BWD_CKPT``).  x, Bm and Cm are taken as given (exact when they are
    bf16)."""
    refuse_grad("ssd_chunk_scan_bwd_split_ref", x, dt, A, Bm, Cm, dy)
    n_terms = dict(BWD_TERMS, **(terms or {}))
    if set(n_terms) != set(BWD_TERMS) or not all(
            v in (1, 2, 3) for v in n_terms.values()):
        raise ValueError(f"ssd_chunk_scan_bwd_split_ref: terms must map "
                         f"operands of {sorted(BWD_TERMS)} to 1, 2 or 3; "
                         f"got {terms}")

    def T(v, name):
        return bf16_terms(v, n_terms[name])

    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af, Bf, Cf, dyf = (t.to(f32) for t in (x, dt, A, Bm, Cm, dy))
    nblk = -(-S // block)

    def blk(k):
        c0 = k * block
        xq, dtq, Bq, Cq, dyq = (t[:, c0:c0 + block]
                                for t in (xf, dtf, Bf, Cf, dyf))
        L = xq.shape[1]
        idx = torch.arange(L, device=x.device)
        causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
        cum = torch.cumsum(dtq * Af, dim=1)                      # [B,L,H]
        seg = cum[:, :, None] - cum[:, None, :]                  # [B,i,j,H]
        decay = torch.exp(torch.where(causal, seg, float("-inf")))
        e = _mm("bihp,bjhp->bijh", T(dyq, "dy_e"), [xq])
        keep = torch.exp(cum[:, -1:] - cum)
        return dict(c0=c0, L=L, xq=xq, dtq=dtq, Bq=Bq, Cq=Cq, dyq=dyq,
                    cum_l=cum[:, -1], ecum=torch.exp(cum), decay=decay,
                    CB=torch.einsum("bin,bjn->bij", Cq, Bq), e=e,
                    keep=keep, w=keep * dtq, D=decay * dtq[:, None] * e)

    # sweep F: dC and carrE, the state in f32
    s = torch.zeros(Bsz, H, P, N, dtype=f32, device=x.device)
    kept = {}
    dC = torch.zeros_like(Cf)
    carrE = torch.zeros_like(dtf)
    for k in range(nblk):
        q = blk(k)
        c0, L = q["c0"], q["L"]
        if k % ckpt == 0:
            kept[k] = s
        E = q["ecum"][..., None] * q["dyq"]
        sc = _mm("bhpn,bin->bhpi", T(s, "s_carr"), [q["Cq"]])
        carrE[:, c0:c0 + L] = q["ecum"] * torch.einsum(
            "bihp,bhpi->bih", q["dyq"], sc)
        dC[:, c0:c0 + L] = (
            _mm("bihp,bhpn->bihn", T(E, "E_dC"), T(s, "s_dC"))
            + _mm("bijh,bjn->bihn", T(q["D"], "D"), [q["Bq"]])).sum(2)
        wx = q["w"][..., None] * q["xq"]
        s = (s * torch.exp(q["cum_l"])[..., None, None]
             + _mm("bjhp,bjn->bhpn", T(wx, "wx_s"), [q["Bq"]]))
    delta = (torch.zeros(Bsz, H, dtype=f32, device=x.device)
             if dstate is None else (dstate.to(f32) * s).sum((-1, -2)))

    # sweep R: G, dx, dB, ddt, dA
    G = (torch.zeros_like(s) if dstate is None
         else dstate.to(f32).clone())
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(dtf)
    dB = torch.zeros_like(Bf)
    dA = torch.zeros_like(Af)
    for k in reversed(range(nblk)):
        q = blk(k)
        c0, L = q["c0"], q["L"]
        K = q["CB"][..., None] * q["decay"]
        M = K * q["dtq"][:, None]
        Z = M * q["e"]
        GB = _mm("bjn,bhpn->bjhp", [q["Bq"]], T(G, "G_gb"))
        gbx = (q["xq"] * GB).sum(-1)                             # [B,L,H]
        h = q["w"] * gbx
        dx[:, c0:c0 + L] = (
            _mm("bijh,bihp->bjhp", T(M, "M"), T(q["dyq"], "dy_dx"))
            + q["w"][..., None] * GB)
        wx = q["w"][..., None] * q["xq"]
        dB[:, c0:c0 + L] = (
            _mm("bijh,bin->bjhn", T(q["D"], "D"), [q["Cq"]])
            + _mm("bjhp,bhpn->bjhn", T(wx, "wx_dB"), T(G, "G_dB"))).sum(2)
        cE = carrE[:, c0:c0 + L]
        dcum = Z.sum(2) - Z.sum(1) - h + cE
        if k % ckpt == 0 and k < nblk - 1:
            delta = (torch.exp(q["cum_l"]) * (G * kept[k]).sum((-1, -2))
                     + h.sum(1))
        dcum[:, -1] += delta
        da = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,))
        ddt[:, c0:c0 + L] = ((K * q["e"]).sum(1) + q["keep"] * gbx
                             + Af * da)
        dA = dA + (q["dtq"] * da).sum((0, 1))
        delta = delta - h.sum(1) + cE.sum(1)
        E = q["ecum"][..., None] * q["dyq"]
        G = (G * torch.exp(q["cum_l"])[..., None, None]
             + _mm("bihp,bin->bhpn", T(E, "E_G"), [q["Cq"]]))
    return (dx.to(x.dtype), ddt, dA, dB.to(Bm.dtype), dC.to(Cm.dtype))
