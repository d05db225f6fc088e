"""The redesigned paged kernels' arithmetic against the JAX package.

Two plain versions in ``ref.py`` spell out what the kernels now compute:
``paged_attention_split_ref`` (the decode kernel's split of each slot's
live pages over several blocks, merged by log-sum-exp) and
``paged_chunk_attention_int8_ref`` (the tensor-core chunk kernel on int8
pools: the int8 values as they are, the K scales on the columns of S, the
V scales on the copy of P that meets V, the row sum over the unscaled P).
Both get the same numpy inputs as JAX's ``paged_attention_ref`` and
``paged_chunk_attention_ref``.  The split rule is a pure function of the
shapes and is checked here too.  The ``cuda`` tests hold the split decode
kernel against its plain version on the card and skip elsewhere.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_paged_split.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import kernel, ref
from repro_torch.optim.compression import quantize_int8

PSIZE = 4


def split_case(seed, *, B=5, H=4, KH=2, D=16, maxp=7, pools="float32"):
    """Decode inputs: slot 0 empty (length 0), slot 1 one token, slot 2 the
    full table, the rest random; pages shuffled over the pool; the dead
    block-table entries poisoned far outside the pool (returned apart).
    ``pools``: float32, bfloat16 (the values rounded to bf16) or int8
    (quantized per page and kv head).  Returns numpy arrays (bf16 pools as
    f32 holding bf16 values), the scales or None, and the poisoned table."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp, vp = (torch.tensor(rng.normal(size=(P, PSIZE, KH, D)),
                           dtype=torch.float32) for _ in range(2))
    scales = None
    if pools == "int8":
        (kp, ks), (vp, vs) = (quantize_int8(x, axis=(1, 3)) for x in (kp, vp))
        scales = (ks[:, 0, :, 0].numpy(), vs[:, 0, :, 0].numpy())
    elif pools == "bfloat16":
        kp, vp = (x.to(torch.bfloat16).float() for x in (kp, vp))
    lengths = rng.integers(1, maxp * PSIZE + 1, size=B).astype(np.int32)
    lengths[0], lengths[1], lengths[2] = 0, 1, maxp * PSIZE
    order = 1 + rng.permutation(B * maxp)
    bt = np.zeros((B, maxp), np.int32)
    poisoned = np.full((B, maxp), 999_999, np.int32)
    for b in range(B):
        live = -(-int(lengths[b]) // PSIZE)
        bt[b, :live] = poisoned[b, :live] = order[b * maxp:b * maxp + live]
    return (q, kp.numpy(), vp.numpy(), bt, lengths), scales, poisoned


VARIANTS = {"plain": {}, "window": {"window": 6},
            "window_softcap": {"window": 9, "softcap": 20.0}}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("num_splits", [1, 2, 3, 7, 40])
@pytest.mark.parametrize("pools", ["bfloat16", "int8"])
def test_split_plain_matches_jax_ref(pools, num_splits, variant):
    """The split-and-merge against JAX's ``paged_attention_ref`` in f32:
    NS 1, 2, 3, 7 and 40 (more than the 7 pages of the widest slot, so
    most splits are empty), windows of 6 and 9 keys that leave whole page
    ranges and whole splits without a visible key, an empty slot and a
    one-token slot.  atol/rtol 1e-5: the merge adds the partials in
    another order than one softmax over all keys."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ref import \
        paged_attention_ref as jax_ref

    seed = (list(VARIANTS).index(variant), num_splits, len(pools))
    (q, kp, vp, bt, lengths), scales, poisoned = split_case(seed,
                                                            pools=pools)
    kw = dict(VARIANTS[variant], scale=16 ** -0.5)
    jpool = (lambda a: jnp.asarray(a)) if pools == "int8" else \
        (lambda a: jnp.asarray(a).astype(jnp.bfloat16))
    tpool = (lambda a: torch.tensor(a)) if pools == "int8" else \
        (lambda a: torch.tensor(a).to(torch.bfloat16))
    jsc = {} if scales is None else {"k_scale": jnp.asarray(scales[0]),
                                     "v_scale": jnp.asarray(scales[1])}
    tsc = {} if scales is None else {"k_scale": torch.tensor(scales[0]),
                                     "v_scale": torch.tensor(scales[1])}
    want = np.asarray(jax_ref(jnp.asarray(q), jpool(kp), jpool(vp),
                              jnp.asarray(bt), jnp.asarray(lengths), **kw,
                              **jsc))
    got = ref.paged_attention_split_ref(
        torch.tensor(q), tpool(kp), tpool(vp), torch.tensor(poisoned),
        torch.tensor(lengths), num_splits=num_splits, **kw, **tsc).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(got[0] == 0)                    # the empty slot


@pytest.mark.parametrize("window", [None, 6])
def test_split_ranges_partition_the_visible_keys(window):
    """Over NS 1-40 the splits' key ranges are disjoint, in order, and
    cover exactly the visible keys of every slot; their page ranges differ
    in size by at most one page."""
    (_, _, _, _, lengths), _, _ = split_case(3)
    lengths = torch.tensor(lengths)
    for ns in range(1, 41):
        first, end = ref.decode_split_ranges(lengths, PSIZE, ns, window)
        for b, n in enumerate(lengths.tolist()):
            lo = max(0, n - window) if window else 0
            keys = [k for j in range(ns)
                    for k in range(int(first[b, j]), int(end[b, j]))]
            assert keys == list(range(lo, n)), (ns, b)
            sizes = [-(-int(e) // PSIZE) - int(f) // PSIZE
                     for f, e in zip(first[b], end[b])]
            assert max(sizes) - min(sizes) <= 1, (ns, b, sizes)


@pytest.mark.parametrize("B,KH,G,maxp,sms,want", [
    (8, 8, 2, 18, 132, 5),         # the serve tick: 64 units -> 320 blocks
    (8, 8, 2, 256, 132, 5),        # a long context: the same split
    (64, 8, 2, 18, 132, 1),        # 512 units fill the card
    (8, 16, 2, 38, 132, 3),        # gemma2-27b's decode geometry
    (2, 1, 16, 100, 132, 8),       # two units: capped at 8 (a cluster)
    (2, 4, 16, 3, 132, 3),         # capped at the table's 3 pages
    (1, 1, 1, 0, 132, 1),          # no pages at all: one block
    (4, 8, 2, 40, 16, 1),          # a small card
])
def test_decode_splits_rule(B, KH, G, maxp, sms, want):
    """About two waves of blocks over the units (slot, kv head, row group
    of decode_rows(G) heads), at most 8 (the portable cluster size) and at
    most maxp, at least 1."""
    ns = kernel.decode_splits(B, KH, G, maxp, sms)
    assert ns == want
    assert kernel.decode_route(ns) == ("split" if want > 1 else "single")


@pytest.mark.parametrize("G,rows", [(1, 1), (2, 2), (3, 1), (4, 4), (6, 2),
                                    (8, 8), (16, 8), (12, 4)])
def test_decode_rows_rule(G, rows):
    """The decode kernel's rows a block: the largest of 8, 4, 2, 1 that
    divides G."""
    assert kernel.decode_rows(G) == rows


# ---------------------------------------------------------------------------
# int8 pools on the tensor-core chunk kernel: scales on the columns
# ---------------------------------------------------------------------------
INT8_VARIANTS = {"plain": {}, "window": {"window": 11},
                 "softcap": {"softcap": 30.0},
                 "window_softcap": {"window": 13, "softcap": 20.0}}


def int8_chunk_case(B, H, KH, D, maxp, C, seed, *, psize=8):
    """Chunk inputs on int8 pools: ragged starts, slot 0 a full chunk, slot
    2 idle, the rest partial; pools quantized per page and kv head; dead
    block-table entries poisoned (returned apart); a logit_index of 3
    chunk positions a slot."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    (kq, ks), (vq, vs) = (quantize_int8(torch.tensor(
        rng.normal(size=(P, psize, KH, D)), dtype=torch.float32),
        axis=(1, 3)) for _ in range(2))
    bt = np.zeros((B, maxp), np.int32)
    poisoned = np.full((B, maxp), 999_999, np.int32)
    starts = np.zeros(B, np.int32)
    clens = np.zeros(B, np.int32)
    for b in range(B):
        starts[b] = rng.integers(0, maxp * psize - C + 1)
        clens[b] = C if b == 0 else (0 if b == 2 else rng.integers(0, C + 1))
        live = max(1, -(-(int(starts[b]) + int(clens[b])) // psize))
        bt[b, :live] = poisoned[b, :live] = 1 + b * maxp + np.arange(live)
    widx = rng.integers(0, C, size=(B, 3)).astype(np.int32)
    return (q, kq.numpy(), vq.numpy(), bt, starts, clens,
            ks[:, 0, :, 0].numpy(), vs[:, 0, :, 0].numpy(), widx, poisoned)


@pytest.mark.parametrize("variant", list(INT8_VARIANTS))
@pytest.mark.parametrize("C", [1, 8, 23])
@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2)])
def test_int8_scaled_columns_match_jax_ref(H, KH, C, variant):
    """Scales on the columns of S and P, l over the unscaled P, against
    JAX's ``paged_chunk_attention_ref`` on the same int8 pools and scales
    (which dequantizes the pages first), with ``logit_index``: both
    outputs, f32, atol/rtol 1e-5 (the two orders of the same products);
    padding rows and the idle slot are exact zeros."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ref import paged_chunk_attention_ref

    D, B, maxp = 16, 4, 6
    seed = (H, C, list(INT8_VARIANTS).index(variant))
    q, kq, vq, bt, st, cl, ks, vs, widx, poisoned = int8_chunk_case(
        B, H, KH, D, maxp, C, seed)
    kw = dict(INT8_VARIANTS[variant], scale=D ** -0.5)
    want_out, want_win = paged_chunk_attention_ref(
        *(jnp.asarray(a) for a in (q, kq, vq, bt, st, cl)), **kw,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        logit_index=jnp.asarray(widx))
    got_out, got_win = ref.paged_chunk_attention_int8_ref(
        *(torch.tensor(a) for a in (q, kq, vq, poisoned, st, cl)), **kw,
        k_scale=torch.tensor(ks), v_scale=torch.tensor(vs),
        logit_index=torch.tensor(widx))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_win.numpy(), np.asarray(want_win),
                               atol=1e-5, rtol=1e-5)
    for b in range(B):
        assert np.all(got_out[b, cl[b]:].numpy() == 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


SPLIT_GEOMS = [
    # B, H, KH, D, psize, maxp, kw: NS on a 132-SM card in the comment
    (64, 16, 8, 128, 16, 18, {}),                          # 1
    (8, 16, 8, 128, 16, 18, {"window": 40}),               # 5
    (8, 32, 16, 128, 16, 38, {"window": 64, "softcap": 50.0}),  # 3
    (4, 8, 2, 64, 16, 9, {"window": 5}),                   # 8
    (3, 16, 1, 96, 8, 40, {"softcap": 30.0}),              # 8
    (2, 8, 1, 32, 4, 100, {"window": 7}),                  # 8
    (2, 8, 2, 256, 16, 6, {}),                             # 6
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pools", ["native", "int8"])
@pytest.mark.parametrize("geom", SPLIT_GEOMS)
def test_split_decode_kernel_matches_plain(cuda, dtype, pools, geom):
    """The decode kernel on geometries whose rule gives NS 1, several and
    8 (the cap), against ``paged_attention_ref`` and against the split
    plain version at the kernel's NS: dead entries poisoned, pages
    shuffled, slot 0 empty, windows shorter than one split's range.  f32
    q: atol/rtol 2e-5 (summation order only); bf16 q, compared in f32:
    2e-2 (one bf16 ulp at |x| ~ 1 is 7.8e-3).  Each launch is counted on
    the rule's route, and the ticket counters are 0 again after it (two
    launches in a row agree bit for bit)."""
    B, H, KH, D, psize, maxp, kw = geom
    rng = np.random.default_rng((B, H, D))
    P = B * maxp + 1
    dt = getattr(torch, dtype)
    q = torch.tensor(rng.normal(size=(B, H, D)), dtype=torch.float32,
                     device=cuda).to(dt)
    kp, vp = (torch.tensor(rng.normal(size=(P, psize, KH, D)),
                           dtype=torch.float32, device=cuda)
              for _ in range(2))
    scales = {}
    if pools == "int8":
        (kp, ks), (vp, vs) = (quantize_int8(x, axis=(1, 3)) for x in (kp, vp))
        scales = {"k_scale": ks[:, 0, :, 0].contiguous(),
                  "v_scale": vs[:, 0, :, 0].contiguous()}
    else:
        kp, vp = kp.to(dt), vp.to(dt)
    lengths = rng.integers(1, maxp * psize + 1, size=B).astype(np.int32)
    lengths[0], lengths[-1] = 0, maxp * psize
    order = 1 + rng.permutation(B * maxp)
    bt = np.full((B, maxp), 987_654, np.int32)
    for b in range(B):
        live = -(-int(lengths[b]) // psize)
        bt[b, :live] = order[b * maxp:b * maxp + live]
    args = (q, kp, vp, torch.tensor(bt, device=cuda),
            torch.tensor(lengths, device=cuda))
    kw = dict(kw, scale=D ** -0.5, **scales)
    ns = kernel.decode_splits(B, KH, H // KH, maxp,
                              kernel.sm_count(cuda.index or 0))
    build.reset_launches()
    got = kernel.paged_attention(*args, **kw)
    again = kernel.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    route = kernel.decode_route(ns)
    assert build.ROUTE_LAUNCHES[f"{kernel.NAME_DECODE}:{route}"] == 2
    want = ref.paged_attention_ref(*args, **kw)
    split = ref.paged_attention_split_ref(*args, num_splits=ns, **kw)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for w in (want, split):
        torch.testing.assert_close(got.float(), w.float(), atol=tol, rtol=tol)
    assert torch.equal(got, again)
    assert torch.all(got[0] == 0)
