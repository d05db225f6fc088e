"""The port's cost model (``launch/analysis.py``) and its renderers, on the
CPU.

* ``CostCounter`` on known programs: 10 chained 128 x 128 products count
  exactly 10 * 2 * 128^3, nested 4 x 3 loops the product of the trips
  (the counterparts of the reference's ``HloCost`` trip-count tests); the
  peak of live storage on a hand-checked chain, with autograd's saved
  tensors held to the backward.
* Collectives on a fake 2 x 2 world (a subprocess: a fake default group
  left in a pytest worker would break its later tests): each kind's
  output bytes and ring bytes against a hand count, and the mesh train
  step's all-gathers against the compute-dtype sizes of the leaves it
  gathers.
* ``model_flops_estimate`` and the ``Roofline`` row against the
  reference's, every arch x shape.
* The FLOP gap against the reference's ``HloCost`` on reduced qwen3-1.7b
  and gemma2-27b, prefill and train (B 4, S 256): the products that make
  it up, named and counted, and the remainder within 1 %.
* ``benchmarks/roofline.py`` and ``final_table.py`` on a two-row JSON
  against the reference's output, its ``HBM_BW`` set to the H100's.
* ``cast_params`` on fake and meta parameters, and bit for bit on real
  ones, a bank's narrowed draft included.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import final_table, roofline
from repro_torch.configs import base as tbase
from repro_torch.core import steps as TS
from repro_torch.launch import analysis as A
from repro_torch.models.params import cast_params, init_params

ARCHS = [a for a in tbase.list_archs() if a != "horn-mnist"]


# ---------------------------------------------------------------------------
# known programs
# ---------------------------------------------------------------------------
def test_chained_matmuls_count_exactly():
    c = torch.randn(128, 128)
    with A.CostCounter() as counter:
        for _ in range(10):
            c = c @ c
    assert counter.flops == 10 * 2 * 128 ** 3


def test_nested_loops_multiply():
    x = torch.randn(64, 64)
    with A.CostCounter() as counter:
        for _ in range(4):
            d = x
            for _ in range(3):
                d = d @ d
            x = d
    assert counter.flops == 4 * 3 * 2 * 64 ** 3


def test_inference_mode_counts_the_same():
    """``matmul`` and ``einsum`` reach the mode whole under inference mode;
    they are decomposed and counted as with autograd on."""
    a, b = torch.randn(3, 8, 16), torch.randn(16, 4)
    counts = []
    for ctx in (torch.inference_mode, torch.enable_grad):
        with ctx(), A.CostCounter() as counter:
            torch.einsum("bij,jk->bik", a, b)
            a @ b
        counts.append(counter.flops)
    assert counts[0] == counts[1] == 2 * 2 * 3 * 8 * 16 * 4


def test_bytes_and_casts_by_hand():
    x = torch.zeros(256, dtype=torch.float32)           # 1 KiB
    with A.CostCounter(hold=x) as counter:
        y = x * 2                   # reads 1 KiB, writes 1 KiB
        z = y.to(torch.bfloat16)    # a cast: 1 KiB in, 512 B out
        z.view(16, 16).t()          # views: nothing moves
        x.add_(1)                   # in place: reads and writes x (1 KiB)
    assert counter.cast_bytes == 1024 + 512
    assert counter.bytes == 2048 + 1536 + 1024


def test_peak_of_live_storage_by_hand():
    x = torch.zeros(1024)                                  # 4 KiB, held
    with A.CostCounter(hold=x) as counter:
        a = x * 2                   # 8 KiB live
        b = a * 2                   # 12 KiB: the peak
        del a                       # 8 KiB
        c = b * 2                   # 12 KiB again
        del b, c
        d = x[:512] * 2             # 4 + 2 KiB
    assert counter.peak_bytes == 3 * 4096
    assert counter.live_bytes == 4096 + 2048
    del d


def test_hold_counts_a_models_parameters():
    model = init_params(reduced_cfg(), 0, device="cpu")
    counter = A.CostCounter(hold={"params": model, "x": torch.zeros(8)})
    want = sum(p.numel() * 4 for p in model.parameters()) + 32
    assert counter.live_bytes == counter.peak_bytes == want


def test_saved_tensors_live_to_the_backward():
    """A tensor autograd saves is live while the graph holds it, though no
    Python name does."""
    w = torch.zeros(1024, requires_grad=True)               # 4 KiB, held
    with A.CostCounter(hold=w) as counter:
        y = (w * 2).exp()           # w * 2 (dies: 4 KiB), exp saved 4 KiB
        loss = y.sum()
        del y
        assert counter.live_bytes == 4096 + 4096 + 4    # w, exp, loss
        loss.backward()             # frees exp; w.grad: 4 KiB
        del loss
        z = w.detach() * 1          # an op: the frees are collected
    assert counter.live_bytes == 3 * 4096           # w, w.grad, z
    del z


def test_collective_stats_ring_and_link():
    st = A.CollectiveStats()
    st.add("all-reduce", 400, [0, 1, 2, 3])            # one node
    st.add("all-gather", 256, [0, 8])                  # two nodes
    st.add("collective-permute", 64, [3, 11])
    assert st.bytes_simple == 720 and st.count == 3
    assert st.bytes_ring == 2 * 400 * 3 / 4 + 256 / 2 + 64
    assert st.bytes_nvlink == 400
    r = A.Roofline("a", "s", "m", 2, 0.0, 0.0, 720.0 * 2, 0.0, 3, {}, 0.0,
                   None, coll_nvlink_bytes=400.0 * 2)
    assert r.t_collective == 320 / A.LINK_BW + 400 / A.LINK_BW_NVLINK


# ---------------------------------------------------------------------------
# a fake 2 x 2 world
# ---------------------------------------------------------------------------
WORLD_PROG = textwrap.dedent("""
    import dataclasses, json
    import torch
    import torch.distributed as dist
    from repro_torch.configs import base as tbase
    from repro_torch.core import steps as TS
    from repro_torch.launch import analysis as A
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.layers import dtype_of

    out = {}
    with D.fake_world(4):
        mesh = make_test_mesh(2, 2, "cpu")
        data, model = mesh.get_group("data"), mesh.get_group("model")
        with A.CostCounter() as c:
            dist.all_gather_into_tensor(torch.zeros(8, 8),
                                        torch.zeros(4, 8), group=data)
            dist.all_reduce(torch.zeros(10), group=model)
            dist.all_reduce(torch.zeros(16, dtype=torch.bfloat16))
            dist.reduce_scatter_tensor(torch.zeros(4), torch.zeros(8),
                                       group=data)
        out["coll"] = dataclasses.asdict(c.coll)

        cfg = tbase.reduced(tbase.get_model_config("qwen3-1.7b"))
        run = tbase.RunConfig(model=cfg, shape=tbase.ShapeConfig(
            "train_4k", "train", 32, 8), horn=tbase.HornConfig(
            enabled=False), optimizer="adamw")
        counter = D.trace_cell(run, mesh)
        shardings = TS.state_shardings(run, mesh)["params"]
        meta = TS.empty_params(cfg, "meta")
        size = dtype_of(run.compute_dtype).itemsize
        want = 0
        for name, p in meta.named_parameters():
            factors = [mesh.size(i) for i, pl in
                       enumerate(shardings[name].placements)
                       if pl.is_shard()]
            n = p.numel() * size
            # one all-gather a sharding mesh dim, the last dim first: the
            # first leaves the other dim's shards, the second the whole
            for k in range(len(factors)):
                n_out = n
                for f in factors[:len(factors) - 1 - k]:
                    n_out //= f
                want += n_out
        out["train"] = {"all_gather": counter.coll.by_kind["all-gather"],
                        "want": want}
    print("OUT" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def world():
    p = subprocess.run([sys.executable, "-c", WORLD_PROG],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": "src"})
    assert p.returncode == 0, p.stderr[-3000:]
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("OUT")]
    return json.loads(line[0][3:])


def test_collective_bytes_on_fake_world(world):
    """Hand count: an all-gather of f32 [4, 8] over data (2) writes
    [8, 8] = 256 B, ring 256 * 1/2; an all-reduce of f32 [10] over model
    (2): 40 B, ring 2 * 40 * 1/2; of bf16 [16] over the world (4): 32 B,
    ring 2 * 32 * 3/4; a reduce-scatter of f32 [8] over data: [4] = 16 B,
    ring 16 * 1/2.  Every group lies inside one node."""
    c = world["coll"]
    assert c["by_kind"] == {"all-gather": 256, "all-reduce": 40 + 32,
                            "reduce-scatter": 16}
    assert c["by_kind_count"] == {"all-gather": 1, "all-reduce": 2,
                                  "reduce-scatter": 1}
    assert c["bytes_simple"] == 256 + 72 + 16 and c["count"] == 4
    assert c["bytes_ring"] == 128 + 40 + 48 + 8
    assert c["bytes_nvlink"] == c["bytes_simple"]


def test_mesh_train_step_gathers_the_compute_copy(world):
    """The mesh train step all-gathers each sharded parameter whole in the
    compute dtype, and nothing else (a leaf sharded over both dims goes
    through one gather a dim)."""
    t = world["train"]
    assert t["want"] > 0 and t["all_gather"] == t["want"]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(tbase.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_estimate_matches_reference(arch, shape):
    pytest.importorskip("jax")
    from repro.configs import base as jbase
    from repro.launch import analysis as JA
    got = A.model_flops_estimate(tbase.get_model_config(arch),
                                 tbase.SHAPES[shape])
    want = JA.model_flops_estimate(jbase.get_model_config(arch),
                                   jbase.SHAPES[shape])
    assert got == want


def test_roofline_row_keeps_the_reference_keys():
    pytest.importorskip("jax")
    from repro.launch import analysis as JA
    args = ("a", "s", "m", 4, 1e12, 1e9, 1e6, 2e6, 3, {"all-gather": 1},
            1e11, 1e9)
    got, want = A.Roofline(*args).row(), JA.Roofline(*args).row()
    assert set(want) <= set(got)
    assert got["raw_cost_flops"] is None and got["raw_cost_bytes"] is None
    for k in ("t_compute_s", "t_memory_s", "useful_flops_ratio"):
        assert got[k] > 0


GAP_CELLS = [(a, k) for a in ("qwen3-1.7b", "gemma2-27b")
             for k in ("prefill", "train")]


@functools.lru_cache(maxsize=None)
def gap_hlo(arch, kind):
    """The reference's compiled HLO text of a gap cell on a 1-device mesh,
    lowered once for this module's tests."""
    from repro.configs import base as jbase
    from repro.launch.dryrun import lower_cell
    from repro.launch.mesh import make_test_mesh as jax_mesh

    return lower_cell(gap_run(jbase, arch, kind), jax_mesh(1, 1))[1].as_text()


def gap_run(lib, arch, kind):
    cfg = lib.reduced(lib.get_model_config(arch))
    return lib.RunConfig(model=cfg, shape=lib.ShapeConfig("x", kind, 256, 4),
                         horn=lib.HornConfig(enabled=kind == "train"),
                         optimizer="adamw", learning_rate=3e-4)


@pytest.mark.parametrize("arch,kind", GAP_CELLS)
def test_flop_gap_against_hlocost(arch, kind, monkeypatch):
    """The reference's ``HloCost`` FLOPs of the cell on a 1-device mesh
    against the port's counter over its mesh-free step.  The gap is made
    of two named parts: (1) ``HloCost`` counts one FLOP an element of
    every elementwise op, the counter none (measured by ``HloCost`` with
    its elementwise set emptied); (2) in training the port computes the
    logits product of each cross-entropy chunk twice, in the forward and
    again in ``torch.utils.checkpoint``'s recompute, where XLA merges the
    forward with its rematerialisation: 2 * B * S * d * vocab.  What is
    left is within 1 %."""
    pytest.importorskip("jax")
    from repro.launch import analysis as JA

    text = gap_hlo(arch, kind)
    jax_total = JA.HloCost(text).flops
    monkeypatch.setattr(JA, "_ELEMWISE", set())
    jax_dots = JA.HloCost(text).flops
    elementwise = jax_total - jax_dots

    run = gap_run(tbase, arch, kind)
    state = TS.init_state(run, "cpu")
    B, S = run.shape.global_batch, run.shape.seq_len
    toks = np.zeros((B, S), np.int32)
    with A.CostCounter(hold=state) as counter:
        if kind == "train":
            TS.make_train_step(run, "cpu")(state, {"tokens": toks,
                                                   "labels": toks})
        else:
            TS.make_prefill_step(run, "cpu")(state["params"],
                                             {"tokens": toks})
    cfg = run.model
    xent_twice = (2.0 * B * S * cfg.d_model * cfg.vocab_size
                  if kind == "train" else 0.0)
    assert elementwise > 0
    remainder = jax_total - elementwise - (counter.flops - xent_twice)
    print(f"{arch} {kind}: HloCost {jax_total:.6e} = products "
          f"{jax_dots:.6e} + elementwise {elementwise:.6e}; port "
          f"{counter.flops:.6e} = products + xent logits again "
          f"{xent_twice:.6e}; remainder {remainder:.6e}")
    assert abs(remainder) <= 0.01 * jax_total, (jax_total, counter.flops,
                                                elementwise, xent_twice)


# ---------------------------------------------------------------------------
# kernel boundaries and by_tag
# ---------------------------------------------------------------------------
def _flash_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 16, 8, generator=g)          # 4 KiB
    k, v = (torch.randn(2, 2, 16, 8, generator=g) for _ in range(2))
    return [t.requires_grad_(requires_grad) for t in (q, k, v)]


def test_flash_boundary_bytes_by_hand():
    """Inference: q, k, v read and the output written, 4 + 2 + 2 + 4 KiB;
    the plain version's f32 scores and softmax are left out of ``bytes``
    and kept in ``unfused_bytes``, which equals the plain version's count
    without a boundary.  The FLOPs are the plain version's either way."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _flash_inputs(False)
    counts = []
    for fn in (flash_attention, attention_ref):
        with A.CostCounter(hold=(q, k, v)) as counter:
            fn(q, k, v, scale=0.35, causal=True)
        counts.append(counter)
    kernel, plain = counts
    assert kernel.bytes == 4096 + 2048 + 2048 + 4096
    assert kernel.unfused_bytes == plain.unfused_bytes == plain.bytes
    assert plain.bytes > 4 * kernel.bytes
    assert kernel.flops == plain.flops == 2 * (2 * 2 * 2 * 2 * 16 * 16 * 8)


def test_flash_boundary_bytes_in_training_by_hand():
    """Forward and backward: the forward also writes the f32 row
    log-sum-exp (2 x 4 x 16 x 4 B); the backward reads q, k, v, the
    output, its cotangent and the log-sum-exp and writes dq, dk, dv, each
    once, whatever the plain version's autograd moves.  The ``flash_attn``
    tag holds exactly those bytes and the six products (two forward, four
    backward)."""
    from repro_torch import scope
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q, k, v = _flash_inputs(True)
    qkv, out, lse = 4096 + 2048 + 2048, 4096, 2 * 4 * 16 * 4
    with A.CostCounter(hold=(q, k, v)) as counter:
        with scope.Scope("flash_attn"):
            o = flash_attention(q, k, v, scale=0.35, causal=True)
        o.sum().backward()
    got = counter.by_tag()["flash_attn"]
    assert got["bytes"] == (qkv + out + lse) + (2 * qkv + 2 * out + lse)
    assert got["flops"] == 6 * (2 * 2 * 2 * 2 * 16 * 16 * 8)
    assert q.grad is not None and k.grad is not None


def test_ssd_boundary_bytes_by_hand():
    """x, dt, A, Bm, Cm read, y and the final state (both f32) written."""
    from repro_torch.kernels.ssd.ops import ssd_chunk_scan

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 2, 4, generator=g)
    dt = torch.rand(1, 8, 2, generator=g) + 0.1
    A_ = -torch.rand(2, generator=g)
    Bm, Cm = (torch.randn(1, 8, 3, generator=g) for _ in range(2))
    with torch.no_grad(), A.CostCounter(hold=(x, dt, A_, Bm, Cm)) as counter:
        ssd_chunk_scan(x, dt, A_, Bm, Cm, chunk=4)
    ins = (64 + 16 + 2 + 24 + 24) * 4
    assert counter.bytes == ins + (64 + 2 * 4 * 3) * 4
    assert counter.unfused_bytes > counter.bytes


def test_unfused_bytes_keep_the_eager_count():
    """With no kernel in the program both counts are the eager one
    (``test_bytes_and_casts_by_hand``'s program)."""
    x = torch.zeros(256, dtype=torch.float32)
    with A.CostCounter(hold=x) as counter:
        y = x * 2
        y.to(torch.bfloat16)
        x.add_(1)
    assert counter.unfused_bytes == counter.bytes == 2048 + 1536 + 1024


def gap_counter(arch, kind):
    run = gap_run(tbase, arch, kind)
    state = TS.init_state(run, "cpu")
    B, S = run.shape.global_batch, run.shape.seq_len
    toks = np.zeros((B, S), np.int32)
    with A.CostCounter(hold=state) as counter:
        if kind == "train":
            TS.make_train_step(run, "cpu")(state, {"tokens": toks,
                                                   "labels": toks})
        else:
            TS.make_prefill_step(run, "cpu")(state["params"],
                                             {"tokens": toks})
    return run, counter


@pytest.mark.parametrize("arch,kind", GAP_CELLS)
def test_by_tag_against_hlocost(arch, kind):
    """Each tag's product FLOPs against the reference's
    ``HloCost.by_tag`` (which counts products only) within 1 %; in
    training ``xent_chunk`` also holds the named term of the flop gap,
    2 * B * S * d * vocab (the logits product again in the recompute).
    The tags and the untagged rest sum to the totals, FLOPs and bytes."""
    pytest.importorskip("jax")
    from repro.launch import analysis as JA

    want = JA.HloCost(gap_hlo(arch, kind)).by_tag()
    run, counter = gap_counter(arch, kind)
    got = counter.by_tag()
    assert set(got) == set(want)
    B, S, cfg = run.shape.global_batch, run.shape.seq_len, run.model
    for tag in want:
        extra = (2.0 * B * S * cfg.d_model * cfg.vocab_size
                 if tag == "xent_chunk" and kind == "train" else 0.0)
        print(f"{arch} {kind} {tag}: HloCost {want[tag]['flops']:.6e}, "
              f"port {got[tag]['flops']:.6e} (named term {extra:.6e})")
        assert abs(got[tag]["flops"] - extra - want[tag]["flops"]) <= \
            0.01 * want[tag]["flops"], (tag, got[tag], want[tag])
    for what in ("flops", "bytes"):
        total = sum(t[what] for t in got.values()) + counter.untagged[what]
        assert total == pytest.approx(getattr(counter, what), rel=1e-12)


def two_rows():
    rows = []
    for arch, shape, mesh, chips in (("qwen3-1.7b", "decode_32k", "16x16",
                                      256),
                                     ("gemma2-27b", "train_4k", "2x16x16",
                                      512)):
        r = A.Roofline(arch, shape, mesh, chips, 3e17, 4e15, 2e12, 3e12,
                       600, {"all-gather": 1e12}, 1e16, 6e10).row()
        r["status"] = "ok"
        rows.append(r)
    return rows


def test_renderers_match_reference(tmp_path, monkeypatch):
    pytest.importorskip("jax")
    sys.path.insert(0, os.path.join(os.getcwd(), "benchmarks"))
    try:
        import final_table as jfinal
        import roofline as jroof
    finally:
        sys.path.pop(0)
    from repro.launch import analysis as JA
    rows = two_rows()
    path = tmp_path / "dryrun_final.json"
    path.write_text(json.dumps(rows))
    got_rows = roofline.load_rows([str(path)])
    assert got_rows == jroof.load_rows([str(path)])
    for mesh in ("16x16", "2x16x16"):
        assert roofline.fmt_table(got_rows, mesh) == \
            jroof.fmt_table(got_rows, mesh)
    monkeypatch.setattr(JA, "HBM_BW", A.HBM_BW)    # the constants aside
    monkeypatch.chdir(tmp_path)
    jfinal.main()
    want = (tmp_path / "FINAL_TABLE.md").read_text()
    final_table.main(["--final", str(path), "--out", str(tmp_path / "t.md")])
    assert (tmp_path / "t.md").read_text() == want
    assert "mem:" in want               # the decode cell's memory fraction


# ---------------------------------------------------------------------------
# cast_params
# ---------------------------------------------------------------------------
def reduced_cfg(arch="qwen3-1.7b"):
    return dataclasses.replace(tbase.reduced(tbase.get_model_config(arch)),
                               dtype="float32")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-base"])
def test_cast_params_bit_for_bit(arch):
    model = init_params(reduced_cfg(arch), 0, device="cpu")
    got = cast_params(model, torch.bfloat16)
    want = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
    assert got is not model and type(got) is type(model)
    for n, p in got.named_parameters():
        assert p.dtype == torch.bfloat16 and not p.requires_grad
        assert torch.equal(p, want[n]), n
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert cast_params(got, torch.bfloat16) is got


def test_cast_params_of_a_narrowed_draft():
    """A keep-0.5 bank circuit materialized from f32 parameters has FFN
    weights narrower than its parent config's ``d_ff``: a bf16
    ``DraftRunner`` casts it, each parameter bit-equal to ``.to()``."""
    from repro_torch.configs.base import HornConfig
    from repro_torch.serving import EngineConfig, ModelBank
    from repro_torch.serving.speculative import DraftRunner
    cfg = reduced_cfg()
    horn = HornConfig(enabled=True, keep_hidden=0.5, keep_input=1.0,
                      block_size=16)
    draft = ModelBank(cfg, horn, 2, seed=1).draft_model(
        0, init_params(cfg, 0, device="cpu"))
    assert draft.params.layers[0].mlp.wi.shape[1] < cfg.d_ff
    runner = DraftRunner(draft, EngineConfig(
        num_slots=2, page_size=8, max_prompt_len=16, max_new_tokens=8,
        kv_dtype="float32", compute_dtype="bfloat16", speculate_k=2),
        torch.device("cpu"))
    want = dict(draft.params.named_parameters())
    for n, p in runner.params.named_parameters():
        assert p.dtype == torch.bfloat16 and p.shape == want[n].shape, n
        assert torch.equal(p, want[n].to(torch.bfloat16)), n
    assert {p.dtype for p in draft.params.parameters()} == {torch.float32}


def test_cast_params_on_fake_and_meta_parameters():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    cfg = reduced_cfg()
    with FakeTensorMode():
        fake = init_params(cfg, 0, device="cpu")
        got = cast_params(fake, torch.bfloat16)
    for p in got.parameters():
        assert isinstance(p, FakeTensor) and p.dtype == torch.bfloat16
    meta = cast_params(TS.empty_params(cfg, "meta"), torch.bfloat16)
    assert {p.device.type for p in meta.parameters()} == {"meta"}
    assert {p.dtype for p in meta.parameters()} == {torch.bfloat16}
