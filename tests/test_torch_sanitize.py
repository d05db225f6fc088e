"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``) and
``serve.py --sanitize``.  Held against the JAX package: a sanitized replay
of a pinned trace reports 0 alerts over as many checked ticks on the
port's engine as on the JAX engine, and the rank guard raises exactly
where ``jax_numpy_rank_promotion="raise"`` does.  Port-only: the pool,
draft-pool and block-table audits catch their seeded faults, the NaN guard
names the op (or kernel entry) that made a NaN, and the serve CLI exits 0
with the verdict, 3 after a seeded leak.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitize import (KERNEL_ENTRIES, NaNGuardError,
                                           RankPromotionError, Sanitizer,
                                           TorchGuards)
from repro_torch.configs.base import get_model_config, reduced
from repro_torch.models.params import init_params
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.kv_cache import PagePool

REPO = Path(__file__).resolve().parents[1]
TRACES = REPO / "benchmarks" / "traces"


@pytest.fixture(autouse=True)
def restore_kernel_entries():
    """Guards patch the kernel entries; put the originals back."""
    import importlib
    saved = [(importlib.import_module(m), a) for m, a in KERNEL_ENTRIES]
    saved = [(m, a, getattr(m, a)) for m, a in saved]
    yield
    for m, a, fn in saved:
        setattr(m, a, fn)


class _StubSched:
    def __init__(self):
        self.running = {}


class _StubEngine:
    def __init__(self, pool, spec=None):
        self.pool = pool
        self.spec = spec
        self._bt = None
        self.sched = _StubSched()
        self.steps = 0

    def step(self, now):
        self.steps += 1
        return []


# ---------------------------------------------------------------------------
# pool and block-table audits (the reference's sanitizer tests, on the port)
# ---------------------------------------------------------------------------
def test_sanitizer_quiet_on_healthy_pool():
    pool = PagePool(num_pages=9, page_size=4)
    pool.alloc(1, 10)
    eng = _StubEngine(pool)
    san = Sanitizer().attach(eng)
    for t in range(3):
        eng.step(float(t))
    assert san.ticks_checked == 3 and san.alerts == []
    assert "0 invariant alerts over 3 checked ticks" in san.render_report()


def test_sanitizer_catches_leaked_pages():
    pool = PagePool(num_pages=9, page_size=4)
    pool.alloc(1, 10)
    pool._tables.pop(1)          # a table lost with its pages still used
    san = Sanitizer()
    san.check(_StubEngine(pool), tick=7)
    kinds = {a.kind for a in san.alerts}
    assert "pool-leak" in kinds and "pool-invariant" in kinds
    assert san.report()["alerts"] >= 1 and "tick 7" in san.render_report()


def test_sanitizer_checks_the_draft_pool():
    class Spec:
        pool = PagePool(num_pages=9, page_size=4)
    Spec.pool.alloc(3, 6)
    Spec.pool._tables.pop(3)
    san = Sanitizer()
    san.check(_StubEngine(PagePool(num_pages=5, page_size=4), Spec()), 2)
    assert {a.kind for a in san.alerts} >= {"draft-pool-leak"}
    assert not any(a.kind == "pool-leak" for a in san.alerts)


def test_sanitizer_check_every_throttles():
    eng = _StubEngine(PagePool(num_pages=5, page_size=4))
    san = Sanitizer(check_every=2).attach(eng)
    for t in range(4):
        eng.step(float(t))
    assert san.ticks_checked == 2


def small_engine(**over):
    cfg = reduced(get_model_config("qwen3-1.7b"), dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    kw = dict(num_slots=3, num_pages=64, page_size=8, max_prompt_len=32,
              max_new_tokens=6, token_budget=32, kv_dtype="float32",
              compute_dtype="float32")
    kw.update(over)
    return Engine(cfg, params, EngineConfig(**kw), device="cpu")


def submit(eng, n=3, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        eng.submit(rng.integers(0, 500, (5 + 7 * i,)).astype(np.int32), 6)


def test_engine_run_is_clean_and_the_twin_runs_once(monkeypatch):
    from repro_torch.analysis import hornshape
    calls = []
    real = hornshape.crosscheck_paged_geometry

    def counted(**kw):
        calls.append(kw)
        return real(**kw)
    monkeypatch.setattr(hornshape, "crosscheck_paged_geometry", counted)
    eng = small_engine()
    san = Sanitizer()
    san.install_torch_guards()
    san.attach(eng)
    submit(eng)
    eng.run(clock=lambda: 0.0)
    assert san.alerts == [] and san.ticks_checked == eng.steps > 2
    assert len(calls) == 1
    assert calls[0]["batch"] == 3 and calls[0]["kv_heads"] == 2 \
        and calls[0]["head_dim"] == 16 and calls[0]["page_size"] == 8 \
        and calls[0]["num_pages"] == 64 and calls[0]["dtype"] == "float32"
    assert san.guards.ops_checked > 0


def test_stale_mirror_row_is_caught():
    eng = small_engine()
    san = Sanitizer().attach(eng)
    submit(eng)
    eng.step(0.0)
    assert san.alerts == []
    slot = next(iter(eng.sched.running))
    # the device row loses its first page; the mirror's state still
    # claims it fresh, so the next sync does not repair it
    eng._bt.dev[slot, 0] += 1
    eng.step(0.0)
    (a,) = [a for a in san.alerts]
    assert a.kind == "block-table" and "device row" in a.message
    san2 = Sanitizer()
    rid, *rest = eng._bt._state[slot]
    eng._bt._state[slot] = (rid, *rest[:-1], rest[-1] - 1)
    san2.check_block_tables(eng, eng.steps)
    assert [a.kind for a in san2.alerts] == ["block-table"]
    assert "stale" in san2.alerts[0].message


def test_engine_pool_leak_is_caught():
    eng = small_engine()
    submit(eng)
    eng.step(0.0)
    rid = next(iter(eng.sched.running.values())).id
    eng.pool._tables[rid] = eng.pool._tables[rid][:-1] or []
    san = Sanitizer()
    san.check(eng, eng.steps)
    assert "pool-leak" in {a.kind for a in san.alerts}


# ---------------------------------------------------------------------------
# the torch guards
# ---------------------------------------------------------------------------
RANK_CASES = [
    ("add", (3,), (2, 3)), ("add", (), (2, 3)), ("add", (2, 3), (2, 3)),
    ("add", (1, 3), (2, 3)), ("multiply", (4, 1, 3), (3,)),
    ("subtract", (2, 1), (2, 5)), ("maximum", (5,), (4, 5)),
    ("less", (3,), (2, 3)), ("where", (2, 3), (3,)),
    ("where", (2, 3), (2, 3)), ("multiply", (), ()),
    ("divide", (7,), (7,)), ("power", (2, 2, 2), (2,)),
    ("clip", (2, 3), (3,)), ("fmod", (3, 1), (1,)),
    ("logaddexp", (4,), (4,)),
]


def _jax_raises(op, a, b):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    x, y = jnp.ones(a), jnp.ones(b)
    with jax.numpy_rank_promotion("raise"):
        try:
            if op == "where":
                jnp.where(x > 0, x, y)
            elif op == "clip":
                jnp.clip(x, y, y)
            else:
                getattr(jnp, op)(x, y)
        except ValueError:
            return True
    return False


def _torch_raises(op, a, b):
    x, y = torch.ones(a), torch.ones(b)
    fn = {"multiply": torch.mul, "subtract": torch.sub, "less": torch.lt,
          "divide": torch.div, "power": torch.pow}.get(op) or getattr(
        torch, op)
    with TorchGuards():
        try:
            if op == "where":
                torch.where(x > 0, x, y)
            elif op == "clip":
                torch.clip(x, y, y)
            else:
                fn(x, y)
        except RankPromotionError:
            return True
    return False


@pytest.mark.parametrize("op,a,b", RANK_CASES)
def test_rank_guard_raises_where_jax_raises(op, a, b):
    assert _torch_raises(op, a, b) == _jax_raises(op, a, b)


@pytest.mark.parametrize("expr", [
    "x + w", "w + x", "x * w", "x - w", "x / w", "x.add(w)", "x.mul_(w)",
    "torch.add(x, w)", "x == w", "x < w", "torch.maximum(x, w)"])
def test_rank_guard_raises_on_each_spelling(expr):
    x, w = torch.ones(2, 4, 8), torch.ones(8)
    with TorchGuards(), pytest.raises(RankPromotionError,
                                      match="ranks \\[1, 3\\]"):
        eval(expr)


@pytest.mark.parametrize("expr", [
    "x + 1.0", "x * torch.tensor(2.0)", "x + w.view(1, 1, -1)",
    "x.sum(-1) + 1", "torch.matmul(x, torch.ones(8, 3))", "x[..., 0] * 2"])
def test_rank_guard_passes_scalars_and_explicit_ranks(expr):
    x, w = torch.ones(2, 4, 8), torch.ones(8)
    with TorchGuards():
        eval(expr)


def test_nan_guard_names_the_op():
    x = torch.tensor([0.0, 1.0])
    with TorchGuards(), pytest.raises(NaNGuardError, match="div"):
        x / x
    with TorchGuards():
        torch.empty(4)                        # uninitialised by design
        torch.tensor([float("-inf"), 1.0]) * 2  # infinities are masks
        torch.tensor([1, 2]) // 1


@pytest.mark.parametrize("expr,name", [
    ("x.div_(x)", "div_"), ("x.mul_(inf)", "mul_"),
    ("x.copy_(nan)", "copy_"), ("x.index_copy_(0, i, nan1)", "index_copy_"),
    ("operator.itruediv(x, x)", "div_")])
def test_nan_guard_names_an_in_place_op(expr, name):
    """An op that writes a NaN into its operand in place (and hands that
    operand back) is named at once, as a functional op would be."""
    import operator
    x = torch.tensor([0.0, 1.0])
    inf, nan = torch.tensor(float("inf")), torch.full((2,), float("nan"))
    i, nan1 = torch.tensor([1]), torch.full((1,), float("nan"))
    with TorchGuards(), pytest.raises(NaNGuardError,
                                      match=f"{re.escape(name)} produced"):
        eval(expr)


def test_nan_guard_passes_a_clean_in_place_op():
    x = torch.tensor([0.0, 1.0])
    with TorchGuards():
        x.add_(1).mul_(2)
        x.copy_(torch.ones(2))
        x.to(torch.float32)                   # a no-op cast hands back x
    assert x.tolist() == [1.0, 1.0]


def test_nan_guard_defers_device_results_to_the_exit():
    """On a deferred device the flags are read once, when the mode exits,
    and the first op that made a NaN is named, as it would be at once."""
    x = torch.tensor([0.0, 1.0])
    guards = TorchGuards()
    guards.DEFER = ("cpu",)
    with pytest.raises(NaNGuardError, match="div produced a NaN at "
                                            "<outside the port>"):
        with guards:
            y = x / x                          # the first NaN
            z = y * 2                          # propagates, no raise yet
            assert guards._pending and torch.isnan(z).any()
    assert guards._pending == []
    with guards:                               # clean: one read, no raise
        x + 1
    # a later error inside the step: the NaN is the cause reported
    with pytest.raises(NaNGuardError):
        with guards:
            x / x
            raise RuntimeError("a consumer of the NaN failed")


def test_nan_guard_names_a_kernel_entry():
    from repro_torch.kernels.paged_attention import ops
    TorchGuards().install()
    q = torch.full((1, 2, 32), float("nan"))
    pools = torch.zeros(3, 8, 1, 32)
    with pytest.raises(NaNGuardError, match="kernel entry .*paged_attention"
                                            "_ref"):
        ops.paged_attention(q, pools, pools, torch.ones(1, 2, dtype=torch
                                                          .int32),
                            torch.tensor([3], dtype=torch.int32), scale=0.1)


def test_nan_in_a_layers_wo_raises_at_that_op():
    eng = small_engine()
    san = Sanitizer()
    san.install_torch_guards()
    san.attach(eng)
    with torch.no_grad():
        eng.params.layers[1].attn.wo[0, 0, 0] = float("nan")
    submit(eng)
    with pytest.raises(NaNGuardError, match="einsum produced a NaN at "
                       "models/layers.py:[0-9]+ \\(mm\\) <- "
                       "models/attention.py:[0-9]+ \\(attn_apply\\)"):
        eng.step(0.0)


def test_rank_mismatch_in_the_step_raises():
    eng = small_engine()
    san = Sanitizer()
    san.install_torch_guards()
    san.attach(eng)
    submit(eng)
    real = eng._step

    def broken(*a, **kw):
        x = torch.ones(3, 5, 64)
        x + torch.ones(64)                    # a [B, S, d] + [d] add
        return real(*a, **kw)
    eng._step = broken
    with pytest.raises(RankPromotionError):
        eng.step(0.0)


# ---------------------------------------------------------------------------
# against the JAX engine: a sanitized replay of a pinned trace
# ---------------------------------------------------------------------------
def sanitized_replays(name):
    """(JAX sanitizer, JAX replay, port sanitizer, port replay) of the
    pinned trace ``name`` at 2 layers f32, the port on JAX's weights, each
    sanitizer with its guards installed (JAX's config restored after)."""
    jax = pytest.importorskip("jax")
    from repro.analysis.sanitize import Sanitizer as JaxSanitizer
    from repro.configs.base import get_model_config as jax_config
    from repro.configs.base import reduced as jax_reduced
    from repro.launch.serve import build_draft as jax_build_draft
    from repro.models import api as jax_api
    from repro.serving import Engine as JaxEngine
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving.observability import load_trace as jax_load
    from repro.serving.observability import replay as jax_replay
    from repro_torch.launch.serve import build_draft
    from repro_torch.models.params import load_jax_flat
    from repro_torch.serving.observability import load_trace, replay

    path = TRACES / f"{name}.jsonl"
    precs, meta = load_trace(str(path))
    jrecs, _ = jax_load(str(path))
    jcfg = jax_reduced(jax_config(meta["arch"]), dtype="float32")
    cfg = reduced(get_model_config(meta["arch"]), dtype="float32")
    assert cfg.num_layers == 2
    jparams = jax_api.model_init(jax.random.key(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
            in jax.tree_util.tree_leaves_with_path(jparams)}
    params = load_jax_flat(flat, cfg, device="cpu")
    psize = int(meta["page_size"])
    kw = dict(num_slots=int(meta["slots"]), num_pages=int(meta["pages"]),
              page_size=psize,
              max_prompt_len=-(-int(meta["max_prompt"]) // psize) * psize,
              max_new_tokens=int(meta["gen"]),
              token_budget=max(int(meta["budget"]), int(meta["slots"])),
              seed=0, policy=meta["policy"],
              prefix_cache=bool(meta["prefix_cache"]),
              speculate_k=int(meta["speculate_k"]), kv_dtype="float32",
              compute_dtype="float32")
    draft_kw = dict(speculate=kw["speculate_k"], draft_circuit=0,
                    draft_keep=float(meta.get("draft_keep", 0.875)),
                    mask_block=16, seed=0)
    tick_dt = float(meta["tick_dt"])

    old = (jax.config.jax_debug_nans, jax.config.jax_numpy_rank_promotion)
    try:
        jsan = JaxSanitizer()
        JaxSanitizer.install_jax_guards()
        jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**kw),
                         draft=jax_build_draft(jcfg, jparams, None,
                                               **draft_kw))
        jsan.attach(jeng)
        jres = jax_replay(jeng, jrecs, tick_dt=tick_dt)
    finally:
        jax.config.update("jax_debug_nans", old[0])
        jax.config.update("jax_numpy_rank_promotion", old[1])

    san = Sanitizer()
    san.install_torch_guards()
    peng = Engine(cfg, params, EngineConfig(**kw),
                  draft=build_draft(cfg, params, None, **draft_kw),
                  device="cpu")
    san.attach(peng)
    pres = replay(peng, precs, tick_dt=tick_dt)
    assert pres.token_digest == jres.token_digest
    return jsan, jres, san, pres


def test_sanitized_replay_matches_the_jax_engine():
    jsan, jres, san, pres = sanitized_replays("shared_prefix")
    assert jsan.alerts == [] and san.alerts == []
    assert san.ticks_checked == jsan.ticks_checked == pres.ticks \
        == jres.ticks
    assert san.render_report() == jsan.render_report()


def test_sanitized_speculating_replay_is_clean():
    """decode_heavy speculates (K 4): the draft pool is audited every tick
    and the mirror at each sync, after the verify's rollbacks too."""
    from repro_torch.launch.serve import build_draft
    from repro_torch.serving.observability import load_trace, replay
    precs, meta = load_trace(str(TRACES / "decode_heavy.jsonl"))
    cfg = reduced(get_model_config(meta["arch"]), dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    psize = int(meta["page_size"])
    eng = Engine(cfg, params, EngineConfig(
        num_slots=int(meta["slots"]), num_pages=int(meta["pages"]),
        page_size=psize, max_prompt_len=-(-int(meta["max_prompt"])
                                          // psize) * psize,
        max_new_tokens=int(meta["gen"]), token_budget=int(meta["budget"]),
        prefix_cache=bool(meta["prefix_cache"]),
        speculate_k=int(meta["speculate_k"]), kv_dtype="float32",
        compute_dtype="float32"),
        draft=build_draft(cfg, params, None, speculate=4, draft_circuit=0,
                          draft_keep=float(meta["draft_keep"]),
                          mask_block=16, seed=0), device="cpu")
    san = Sanitizer()
    san.install_torch_guards()
    san.attach(eng)
    audited = []
    real = san.check_block_tables
    san.check_block_tables = lambda e, t: (audited.append(t), real(e, t))
    res = replay(eng, precs, tick_dt=float(meta["tick_dt"]))
    assert san.alerts == [] and san.ticks_checked == res.ticks
    assert eng.stats.spec_slot_ticks > 0 and eng.spec.pool.num_seqs == 0
    assert len(audited) == res.ticks


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def _serve(*argv, prelude=""):
    code = (prelude + "import sys\nfrom repro_torch.launch import serve\n"
            f"serve.main({list(argv)!r})\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(REPO))


def test_serve_cli_sanitize_exits_0_with_the_verdict():
    r = _serve("--device", "cpu", "--requests", "4", "--gen", "4",
               "--stream", "batch", "--sanitize", "--speculate", "2")
    assert r.returncode == 0, r.stderr
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("sanitizer: 0 invariant alerts over ")
    ticks = int(last.split(" over ")[1].split()[0])
    assert ticks > 0


def test_serve_cli_sanitize_replay_exits_0():
    r = _serve("--device", "cpu", "--replay",
               str(TRACES / "shared_prefix.jsonl"), "--sanitize")
    assert r.returncode == 0, r.stderr
    out = r.stdout.strip().splitlines()
    ticks = next(int(ln.split(", ")[-1].split()[0]) for ln in out
                 if "virtual s (" in ln)
    assert out[-1] == f"sanitizer: 0 invariant alerts over {ticks} " \
                      f"checked ticks"


def test_serve_cli_sanitize_exits_3_on_a_seeded_leak():
    # free_seq forgets the table but keeps its pages off the free list
    prelude = ("from repro_torch.serving import kv_cache\n"
               "def leak(self, seq_id):\n"
               "    self._owners.pop(seq_id, None)\n"
               "    self._version.pop(seq_id, None)\n"
               "    self._deferred.pop(seq_id, None)\n"
               "    return len(self._tables.pop(seq_id))\n"
               "kv_cache.PagePool.free_seq = leak\n")
    r = _serve("--device", "cpu", "--requests", "4", "--gen", "4",
               "--stream", "batch", "--sanitize", prelude=prelude)
    assert r.returncode == 3, (r.returncode, r.stderr[-2000:])
    assert "invariant alert(s)" in r.stdout and "[pool-leak]" in r.stdout
