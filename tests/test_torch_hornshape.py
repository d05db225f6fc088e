"""The port's hornshape (``repro_torch.analysis.hornshape``): launch-geometry
proofs of the five CUDA kernels.  Held against the JAX package: at each of
its hornshape cases its report is clean and the port's is, and the block-
table columns the port's paged launches read per slot are the pages JAX's
index maps gather.  Port-only: every case of the registry proves, each LG
rule rejects its seeded geometry with a counterexample, the runtime twin
is clean at serving geometries and catches a broken model, and the CLI's
exit codes hold.
"""
import importlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import hornshape as hs
from repro_torch.analysis.launch_geometry import (ENUM_BUDGET,
                                                  LaunchGeometry, Operand,
                                                  TableContract, box,
                                                  cu_constants, verify)
from repro_torch.kernels.paged_attention import geometry as pgeo

REPO = Path(__file__).resolve().parents[1]
REGISTRY = dict(hs.registry())

# the reference's hornshape cases and the port's counterparts (the same
# structure at shapes the port's wrappers accept), both dtypes where the
# route depends on it
JAX_CASES = {
    "decode/pps2-ragged": ["decode/ragged-f32", "decode/ragged-bf16"],
    "decode/pps1": ["decode/short-table-f32", "decode/short-table-bf16"],
    "decode/int8": ["decode/int8-f32", "decode/int8-bf16"],
    "chunk/pps2-ragged": ["chunk/ragged-f32", "chunk/ragged-bf16"],
    "chunk/verify-window": ["chunk/verify-window-f32",
                            "chunk/verify-window-bf16"],
    "flash/causal-gqa": ["flash/causal-gqa-f32", "flash/causal-gqa-bf16"],
    "flash/window-ragged-blocks": ["flash/window-ragged-f32",
                                   "flash/window-ragged-bf16"],
    "dropout/4d-grid": ["dropout/G3-M16-K32-N128-bn64-bf16"],
    "ssd/chunked": ["ssd/S24-chunk8-P4-N8"],
    "ssd/chunk-shrunk": ["ssd/S24-chunk7-P4-N8"],
}


def _jax_entries():
    from repro.analysis import hornshape as jhs
    return [(rel, e) for rel, entries in jhs.KERNEL_SPECS.items()
            for e in entries]


@pytest.mark.parametrize("label", sorted(JAX_CASES))
def test_jax_case_and_port_case_both_prove(label):
    from repro.analysis import hornshape as jhs
    rel, entry = next((r, e) for r, e in _jax_entries()
                      if e["label"] == label)
    path = REPO / rel
    reports = jhs.run_entry(str(path), path.read_text(), entry)
    assert reports and all(r.ok for r in reports), label
    for port_label in JAX_CASES[label]:
        for geom in REGISTRY[port_label]():
            rep = verify(geom)
            assert rep.ok, [f.render() for f in rep.findings]
            assert rep.blocks_checked == geom.blocks


def test_every_jax_case_has_a_port_case():
    assert {e["label"] for _, e in _jax_entries()} == set(JAX_CASES)


def _jax_gathers(kind, table, lengths_or_refs, psize, pps, KH):
    """slot -> page ids JAX's K index maps gather (NULL_PAGE dropped), over
    its whole grid (B, KH, ceil(maxp / pps)) and the pps page offsets."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention import kernel as jk
    B, maxp = table.shape
    refs = [jnp.asarray(table)] + [jnp.asarray(r) for r in lengths_or_refs]
    length_of = (lambda b, r: r[1][b]) if kind == "decode" else \
        (lambda b, r: r[1][b] + r[2][b])
    kv, _ = jk._kv_page_specs(pps=pps, psize=psize, maxp=maxp, D=32,
                              length_of=length_of, quantized=False)
    out = {}
    for b in range(B):
        for h in range(KH):
            for p in range(-(-maxp // pps)):
                for spec in kv:
                    page = int(spec.index_map(b, h, p, *refs)[0])
                    if page != jk.NULL_PAGE:
                        out.setdefault(b, set()).add(page)
    return out


def _port_pages(geom, table):
    return {b: {int(table[b, c]) for c in cols}
            for b, cols in hs.table_columns_read(geom).items()}


@pytest.mark.parametrize("pps", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("maxp", [3, 5])
def test_decode_reads_the_pages_jax_gathers(pps, dtype, maxp):
    B, psize, P = 2, 8, 24
    for lengths in hs.decode_patterns(B, maxp, psize):
        table = hs.paged_table(B, maxp, P, hs._live_pages(lengths, psize))
        geom = pgeo.decode_geometry(
            B=B, H=4, KH=2, D=32, psize=psize, maxp=maxp, P=P, dtype=dtype,
            quant=False, lengths=lengths, block_tables=table)
        want = _jax_gathers("decode", table, [np.int32(lengths)], psize,
                            pps, 2)
        assert _port_pages(geom, table) == want, lengths


@pytest.mark.parametrize("C,maxp", [(3, 5), (4, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_reads_the_pages_jax_gathers(C, maxp, dtype):
    B, psize, P = 2, 8, 30
    for starts, clens in hs.chunk_patterns(B, C, maxp, psize):
        ends = [s + c for s, c in zip(starts, clens)]
        table = hs.paged_table(B, maxp, P, hs._live_pages(ends, psize))
        geom = pgeo.chunk_geometry(
            B=B, C=C, H=4, KH=2, D=32, psize=psize, maxp=maxp, P=P,
            dtype=dtype, quant=False, starts=starts, chunk_lens=clens,
            block_tables=table)
        got = _port_pages(geom, table)
        want = _jax_gathers("chunk", table,
                            [np.int32(starts), np.int32(clens)], psize, 2, 2)
        for b in range(B):
            if clens[b]:
                assert got.get(b) == want.get(b), (starts, clens, b)
            else:
                # an idle slot: the port reads nothing; JAX's maps still
                # gather the pages below its start (its compute is skipped)
                assert b not in got
                assert want.get(b, set()) == {
                    int(table[b, c]) for c in range(-(-starts[b] // psize))}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label", sorted(REGISTRY))
def test_registry_case_proves(label):
    geoms = REGISTRY[label]()
    assert geoms
    for geom in geoms:
        rep = verify(geom)
        assert rep.ok, [f.render() for f in rep.findings]


def test_registry_covers_every_route():
    names = {g.name for build in REGISTRY.values() for g in build()}
    assert names == {
        "paged_chunk_attention:cuda_core", "paged_chunk_attention:wgmma",
        "paged_chunk_attention:wgmma_int8", "paged_attention:split",
        "paged_attention:single",
        *(f"flash_attention_{p}:{r}_d{d}" for p in ("fwd", "bwd")
          for r in ("wgmma", "cuda_core") for d in (32, 64, 256)),
        *(f"flash_attention_bwd:{r}_d{d}:{k}" for r in ("wgmma", "cuda_core")
          for d in (32, 64, 256) for k in ("dot", "dkdv", "dq")),
        "dropout_matmul:wgmma", "dropout_matmul:mma_sync",
        "dropout_matmul:f32", "ssd_chunk_scan:cuda_core",
        "ssd_chunk_scan:wgmma"} - {
        f"flash_attention_bwd:{r}_d{d}" for r in ("wgmma", "cuda_core")
        for d in (32, 64, 256)}


def test_decode_split_counts_one_to_eight():
    got = {g.grid[0] for n in range(1, 9)
           for g in REGISTRY[f"decode/ns{n}"]()}
    assert got == set(range(1, 9))
    for n in range(1, 9):
        for g in REGISTRY[f"decode/ns{n}"]():
            assert g.cluster == (n, 1, 1)


# ---------------------------------------------------------------------------
# each LG rule on a seeded geometry
# ---------------------------------------------------------------------------
def toy(touches=None, grid=(4, 1, 1), **kw):
    def rows(blk):
        x = blk[0]
        yield box("x", (16 * x, 16 * x + 16))
        yield box("out", (16 * x, 16 * x + 16), write=True)
    kw.setdefault("block", (128, 1, 1))
    kw.setdefault("dynamic_smem", 0)
    return LaunchGeometry(
        name="toy", kernel="toy_kernel", source="toy.cu:1", grid=grid,
        operands=[Operand("x", (64,)), Operand("out", (64,), True)],
        touches=touches or rows, **kw)


def rules(geom):
    return {f.rule for f in verify(geom).findings}


def test_toy_proves():
    rep = verify(toy())
    assert rep.ok and rep.blocks_checked == 4


def test_lg001_out_of_bounds_read_names_its_block():
    def touches(blk):
        yield box("x", (20 * blk[0], 20 * blk[0] + 20))
        yield box("out", (16 * blk[0], 16 * blk[0] + 16), write=True)
    (f,) = verify(toy(touches)).findings
    assert f.rule == "LG001" and f.block == (3, 0, 0)
    assert "(3, 0, 0)" in f.render() and "counterexample" in f.message


def test_lg002_hole():
    (f,) = verify(toy(grid=(3, 1, 1))).findings
    assert f.rule == "LG002" and "out[48]" in f.message
    assert "16 elements unwritten" in f.message


def test_lg003_double_write_names_both_blocks():
    def touches(blk):
        x = blk[0]
        lo = 16 * x - (8 if x == 2 else 0)
        yield box("out", (lo, 16 * x + 16), write=True)
    (f,) = verify(toy(touches)).findings
    assert f.rule == "LG003" and f.block == (2, 0, 0)
    assert "first by block (1, 0, 0)" in f.message


@pytest.mark.parametrize("kw,what", [
    (dict(block=(2048, 1, 1)), "threads"),
    (dict(block=(8, 1, 128)), "threads"),
    (dict(grid=(1, 70000, 1)), "gridDim.y"),
    (dict(grid=(1, 1, 70000)), "gridDim.z"),
    (dict(dynamic_smem=240000, smem_allowed=240000), "card's"),
    (dict(dynamic_smem=60000), "launcher allows"),
    (dict(dynamic_smem=60000, smem_allowed=50000), "launcher allows"),
    (dict(cluster=(3, 1, 1)), "cluster"),
    (dict(cluster=(16, 1, 1), grid=(16, 1, 1)), "cluster"),
])
def test_lg004_launch_limits(kw, what):
    def touches(blk):
        return iter(())
    geom = toy(touches, **kw)
    geom.operands[1].required = np.zeros((64,), bool)
    got = verify(geom).findings
    assert {f.rule for f in got} == {"LG004"}
    assert any(what in f.message for f in got)


def test_lg004_allows_opted_in_smem():
    assert verify(toy(dynamic_smem=200000, smem_allowed=200000)).ok


def _paged_toy(reads, live, splits=None):
    def touches(blk):
        for b, c in reads(blk):
            yield box("block_tables", b, c)
    return LaunchGeometry(
        name="paged-toy", kernel="k", source="p.cu:1", grid=(2, 1, 2),
        block=(128, 1, 1), dynamic_smem=0,
        operands=[Operand("block_tables", (2, 6))], touches=touches,
        table=TableContract("block_tables", live, splits))


def test_lg005_read_past_the_live_pages():
    f = verify(_paged_toy(lambda blk: [(blk[2], 2 + blk[0])],
                          [(0, 3), (0, 4)])).findings
    assert [x.rule for x in f] == ["LG005"] and f[0].block == (1, 0, 0)
    assert "slot 0's visible live pages are [0, 3)" in f[0].message


def test_lg005_read_before_the_window():
    f = verify(_paged_toy(lambda blk: [(blk[2], 1 + blk[0])],
                          [(2, 4), (1, 4)])).findings
    assert [x.rule for x in f] == ["LG005"] and f[0].block == (0, 0, 0)


@pytest.mark.parametrize("parts,ok", [
    ([(0, 2), (2, 4)], True), ([(0, 2), (3, 4)], False),
    ([(0, 3), (2, 4)], False), ([(0, 2), (2, 3)], False),
    ([(1, 2), (2, 4)], False)])
def test_lg005_splits_partition_the_live_range(parts, ok):
    geom = _paged_toy(lambda blk: [], [(0, 4), (0, 4)],
                      lambda b: [((s, 0, b), lo, hi)
                                 for s, (lo, hi) in enumerate(parts)])
    f = verify(geom).findings
    assert (f == []) == ok
    if not ok:
        assert {x.rule for x in f} == {"LG005"}
        assert all(x.block is not None for x in f)


def test_lg006_past_the_budget_is_not_proved():
    geom = toy(lambda blk: iter(()), grid=(ENUM_BUDGET + 1, 1, 1))
    (f,) = verify(geom).findings
    assert f.rule == "LG006" and "not proved" in f.message


CU = """\
namespace {
constexpr int A = 4, B = A * 32;   // two at once
constexpr int C = B / 3 + 1;
constexpr float F = 1.5f;          // not an int: not read
}
template <int D>
void f() {
  constexpr int A = 7;             // function scope: not read
}
"""


def test_cu_constants_reads_namespace_scope_ints(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text(CU)
    assert cu_constants(src, "A", "B", "C") == (4, 128, 43)
    with pytest.raises(KeyError, match="F"):
        cu_constants(src, "F")
    src.write_text(CU + "constexpr int A = 5;\n")
    with pytest.raises(ValueError, match="A declared twice"):
        cu_constants(src, "A")


@pytest.mark.parametrize("kernel,geometry,source,name,attr", [
    ("paged_attention", "paged_attention", "SOURCE", "KT", "KT"),
    ("paged_attention", "paged_attention", "SOURCE", "TC_STAGES",
     "TC_STAGES"),
    ("paged_attention", "paged_attention", "SOURCE_DECODE", "MAXG",
     "D_MAXG"),
    ("flash_attention", "flash_attention", "SOURCE", "FBM", "FBM"),
    ("dropout_matmul", "dropout_matmul", "SOURCE", "WG_ST", "WG_ST"),
    ("ssd", "ssd", "SOURCE", "NS", "NS")])
def test_geometry_model_follows_its_kernel_source(tmp_path, kernel,
                                                  geometry, source, name,
                                                  attr):
    """A tile, thread or stage count edited in the kernel's source moves
    the model with it: the model holds no copy of it."""
    K = importlib.import_module(f"repro_torch.kernels.{kernel}.kernel")
    G = importlib.import_module(f"repro_torch.kernels.{geometry}.geometry")
    real = getattr(K, source)
    (value,) = cu_constants(real, name)
    assert getattr(G, attr) == value
    edited = tmp_path / real.name
    text, n = re.subn(rf"^(constexpr int [^;]*?\b){name} = {value}\b",
                      rf"\g<1>{name} = {2 * value}", real.read_text(),
                      flags=re.M)
    assert n == 1
    edited.write_text(text)
    try:
        setattr(K, source, edited)
        importlib.reload(G)
        assert getattr(G, attr) == 2 * value
    finally:
        setattr(K, source, real)
        importlib.reload(G)
    assert getattr(G, attr) == value


def test_lg005_catches_the_tile_aligned_window_fetch():
    """The tensor-core chunk kernel once fetched every page of its first
    64-key tile, before the window's first visible key too
    (``paged_chunk_attention.cu``'s fetch condition); the model with that
    fetch is rejected, the kernel's present one proves."""
    caught = 0
    for geom in REGISTRY["chunk/window-bf16"]():
        assert geom.name.endswith(":wgmma") and verify(geom).ok
        inner = geom.touches

        def tile_aligned(blk, inner=inner, live=geom.table.live):
            yield from inner(blk)
            first = live[blk[2]][0]
            for c in range(first // (64 // 8) * (64 // 8), first):
                yield box("block_tables", blk[2], c)
        geom.touches = tile_aligned
        got = {f.rule for f in verify(geom).findings}
        assert got <= {"LG005"}
        caught += got == {"LG005"}
    assert caught


# ---------------------------------------------------------------------------
# the runtime twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(batch=8, kv_heads=8, num_heads=16, head_dim=128, page_size=16,
         num_pages=512, max_pages=5),
    dict(batch=8, kv_heads=8, num_heads=16, head_dim=128, page_size=16,
         num_pages=512, max_pages=5, quantized=True),
    dict(batch=4, kv_heads=2, num_heads=4, head_dim=32, page_size=8,
         num_pages=64, max_pages=4, dtype="float32"),
    dict(batch=3, kv_heads=2, num_heads=8, head_dim=64, page_size=8,
         num_pages=64, max_pages=6, window=11),
])
def test_crosscheck_is_clean_at_serving_geometries(kw):
    assert hs.crosscheck_paged_geometry(**kw) == []


@pytest.mark.parametrize("shift,rule", [(-1, "hornshape-divergence"),
                                        (1, "LG005")])
def test_crosscheck_catches_a_decode_split_off_by_one_page(monkeypatch,
                                                           shift, rule):
    real = pgeo.decode_key_range

    def broken(length, window, psize, split, NS):
        pa, pb, kb, ke = real(length, window, psize, split, NS)
        if split == NS - 1 and ke > kb:
            ke = min(ke + shift * psize, (length // psize + 2) * psize)
        return pa, pb, kb, ke
    monkeypatch.setattr(pgeo, "decode_key_range", broken)
    alerts = hs.crosscheck_paged_geometry(
        batch=2, kv_heads=2, num_heads=4, head_dim=32, page_size=8,
        num_pages=40, max_pages=5)
    assert any(rule in a for a in alerts), alerts


def test_crosscheck_reports_an_unmodelable_geometry():
    alerts = hs.crosscheck_paged_geometry(
        batch=2, kv_heads=3, num_heads=4, head_dim=32, page_size=8,
        num_pages=40, max_pages=5)
    assert alerts and all(a.startswith("hornshape") for a in alerts)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_exit_codes(capsys, monkeypatch):
    monkeypatch.setattr(hs, "registry", lambda: [
        (k, v) for k, v in REGISTRY.items() if k.startswith("ssd/")])
    assert hs.main([]) == 0
    assert "0 findings" in capsys.readouterr().out
    assert hs.main(["--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and {r["geometry"] for r in doc["results"]} == {
        "ssd_chunk_scan:cuda_core", "ssd_chunk_scan:wgmma"}


def test_cli_exits_1_on_a_finding(monkeypatch):
    monkeypatch.setattr(hs, "registry", lambda: [
        ("toy", lambda: [toy(grid=(3, 1, 1))])])
    assert hs.main([]) == 1


def test_cli_exits_2_on_a_broken_model(monkeypatch):
    def broken():
        raise ValueError("no such route")
    monkeypatch.setattr(hs, "registry", lambda: [("x", broken)])
    assert hs.main([]) == 2
