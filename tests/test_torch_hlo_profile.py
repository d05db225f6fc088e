"""The named scopes (``repro_torch/scope.py``) and the per-scope profile
(``benchmarks/hlo_profile.py``) on the CPU.

* A scope does nothing unless a counter listens; nested scopes and a
  kernel boundary that open at the same sequence number resolve to the
  innermost; a remat recompute triggered from a tagged node's backward
  leaves the untagged work it recomputes untagged.
* The counter's per-op records sum to its counts; the profile of a
  dry-run cell on its fake world prints the summary, ``by_tag`` and the
  top ops and collectives.
* ``card_scopes`` on the CPU (no device time there) returns every counted
  tag, the untagged rest and the total; the profiler-side attribution
  (``tag_of``: tagged ranges in the forward, the autograd node's scope in
  the backward) gives the counter's products for ``flash_attn`` and
  ``xent_chunk`` and for the untagged rest.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import scope
from repro_torch.benchmarks import hlo_profile as H
from repro_torch.configs import base as tbase
from repro_torch.core import steps as TS
from repro_torch.launch import analysis as A


def small_run(kind, layers=2):
    cfg = dataclasses.replace(tbase.reduced(
        tbase.get_model_config("qwen3-1.7b")), num_layers=layers)
    return tbase.RunConfig(model=cfg, shape=tbase.ShapeConfig("x", kind, 64,
                                                              2),
                           horn=tbase.HornConfig(enabled=kind == "train"),
                           optimizer="adamw", learning_rate=3e-4, seed=0)


def test_a_scope_does_nothing_unless_listened_to():
    with scope.Scope("mlp_block"):
        assert scope._stack == [] and not scope.listening()
    with scope.listen():
        with scope.Scope("mlp_block") as sc:
            assert scope._stack == [sc]
            assert scope.current() == ("mlp_block", None, False)
    assert scope._stack == [] and scope._closed == []


def test_boundary_inside_a_tag_at_one_sequence_number_is_innermost():
    w = torch.randn(8, 8, requires_grad=True)
    b = scope.Boundary(fwd_bytes=1, bwd_bytes=2)
    with scope.listen():
        with scope.Scope("flash_attn"), scope.Scope(None, b):
            y = (w @ w).relu()
        seq = y.grad_fn._sequence_nr()
        assert scope.node_scopes(seq) == ("flash_attn", b)
        assert scope.node_scopes(seq + 10) == (None, None)


def test_remat_recompute_keeps_untagged_work_untagged():
    """The recompute runs inside the backward of the tagged node that
    needed it; the untagged product it recomputes stays untagged."""
    w = torch.randn(16, 16, requires_grad=True)
    x = torch.randn(4, 16)
    prod = 2 * 4 * 16 * 16

    def block(h):
        h = (h @ w).relu()                  # untagged
        with scope.Scope("mlp_block"):
            return h @ w

    with A.CostCounter() as c:
        y = checkpoint(block, x, use_reentrant=False,
                       context_fn=scope.remat_contexts)
        y.sum().backward()
    # the recompute stops once the last saved tensor exists, before the
    # tagged product runs: mlp_block is forward 1 + backward 2 products;
    # the untagged product forward 1 + recompute 1 + backward 1 (x has no
    # gradient)
    assert c.by_tag()["mlp_block"]["flops"] == (1 + 2) * prod
    assert c.untagged["flops"] == (1 + 1 + 1) * prod


def test_records_sum_to_the_counts():
    run = small_run("train")
    state = TS.init_state(run, "cpu")
    toks = np.zeros((2, 64), np.int32)
    with A.CostCounter(hold=state, record=True) as c:
        TS.make_train_step(run, "cpu")(state, {"tokens": toks,
                                               "labels": toks})
    ops = [v for k, v in c.records.items() if k[0] == "op"]
    assert sum(b for b, _ in ops) == pytest.approx(c.bytes, rel=1e-12)
    kernels = {k[1]: v for k, v in c.records.items() if "kernel" in k[1]}
    assert kernels["flash_attn kernel forward"][1] == 2 * 2  # remat
    assert kernels["flash_attn kernel backward"][1] == 2
    prof = H.summarize(c, top=3)
    assert len(prof["top_traffic"]) == 3
    assert prof["top_traffic"][0][0] == max(b for b, _ in ops)
    assert set(prof["summary"]["by_tag"]) == {"flash_attn", "mlp_block",
                                              "xent_chunk"}


def test_profile_cli_on_the_fake_world(capsys):
    H.main(["--arch", "whisper-base", "--shape", "decode_32k", "--top",
            "4"])
    out = capsys.readouterr().out
    assert "per-dev: flops=" in out and "unfused" in out
    assert "by tag:" in out and "-- top traffic ops --" in out
    assert "-- top collectives (bytes over repeats) --" in out
    traffic = out.split("-- top traffic ops --")[1].strip().splitlines()
    assert len(traffic) == 4 + 1        # four ops and the wall time


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_card_scopes_rows_on_the_cpu(kind):
    run = small_run(kind)
    rows = H.card_scopes(run, "cpu")
    from repro_torch.launch.dryrun import trace_cell
    counted = H.counts(trace_cell(run))
    assert set(rows) == set(counted["by_tag"]) | {"", "total"}
    for tag, c in counted["by_tag"].items():
        assert rows[tag]["flops"] == c["flops"]
        assert rows[tag]["bound_ms"] == max(rows[tag]["t_compute_ms"],
                                            rows[tag]["t_memory_ms"])
    assert rows["total"]["flops"] == counted["flops"]
    assert all(r["device_ms"] == 0 for r in rows.values())   # no card


def test_profiler_attribution_matches_the_counter():
    """The products the CPU profiler sees under each tag (``tag_of``)
    against the counter's ``by_tag``: equal for ``flash_attn``,
    ``xent_chunk`` and the untagged rest.  ``mlp_block`` may see more: the
    remat recompute stops once the tensors the backward needs exist, and
    the profiler has already recorded the product it stopped in (its
    inputs are saved before it runs), which the counter never sees run."""
    from torch.profiler import ProfilerActivity, profile

    run = small_run("train")
    state = TS.init_state(run, "cpu")
    step = TS.make_train_step(run, "cpu")
    toks = np.zeros((2, 64), np.int32)
    batch = {"tokens": toks, "labels": toks}
    with A.CostCounter(hold=state) as c:
        state, _ = step(state, batch)
    with scope.listen():
        with profile(activities=[ProfilerActivity.CPU],
                     with_flops=True) as prof:
            state, _ = step(state, batch)
        got = {}
        for e in prof.events():
            if e.flops and e.name in ("aten::mm", "aten::bmm",
                                      "aten::addmm"):
                t = H.tag_of(e)
                got[t] = got.get(t, 0) + e.flops
    want = c.by_tag()
    for tag in ("flash_attn", "xent_chunk"):
        assert got[tag] == want[tag]["flops"], tag
    assert got[""] == c.untagged["flops"]
    assert got["mlp_block"] >= want["mlp_block"]["flops"]
