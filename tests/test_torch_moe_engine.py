"""The port's paged engine over an MoE model against the JAX package's.

Reduced phi3.5-moe-42b (every layer MoE: 4 experts, top 2) in f32, the
JAX weights carried over with ``load_jax_flat``.  An MoE layer routes per
row with a capacity that depends on the row's chunk width, so a prompt's
expert drops depend on how the scheduler chunks it: the paged stream need
not equal a dense recompute, even in the JAX package.  Both engines chunk
the same way (power-of-two widths, the same token budget), so the port's
streams are held against the JAX engine's, token for token: plain greedy
and at temperature 0.8, at a tight capacity factor (0.5, where choices
drop), through a routed 2-circuit ModelBank whose masks hold the experts'
hidden units ("moe"), and with a mean-logit ensemble.  Then the serve CLI
end to end on the CPU.

    PYTHONPATH=src python -m pytest tests/test_torch_moe_engine.py
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs.base import HornConfig as JaxHorn  # noqa: E402
from repro.configs.base import get_model_config as jax_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serving import ModelBank as JaxBank  # noqa: E402
from repro.serving import Router as JaxRouter  # noqa: E402
from repro_torch.configs.base import HornConfig, get_model_config, reduced
from repro_torch.models.params import load_jax_flat
from repro_torch.serving import Engine, EngineConfig, ModelBank, Router

ARCH = "phi3.5-moe-42b"
HORN = dict(enabled=True, keep_hidden=0.5, keep_input=1.0, block_size=16)
ENGINE_KW = dict(num_pages=64, page_size=8, max_prompt_len=24,
                 max_new_tokens=5, token_budget=16, policy="on_demand",
                 kv_dtype="float32", compute_dtype="float32")
PROMPTS = (6, 13, 21, 3)


def _clock():
    return iter(np.arange(1e6)).__next__


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the flat layout of them)."""
    jcfg = jax_reduced(jax_config(ARCH), dtype="float32")
    params = jax_api.model_init(jax.random.key(0), jcfg)
    flat = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf
            in jax.tree_util.tree_leaves_with_path(params)}
    return params, flat


def configs(**over):
    over = {"dtype": "float32", **over}
    return (jax_reduced(jax_config(ARCH), **over),
            reduced(get_model_config(ARCH), **over))


CASES = {
    "greedy": {},
    "t0.8": dict(temperature=0.8),
    "tight": dict(capacity_factor=0.5),
    "bank": dict(bank=2),
    "bank_t0.8": dict(bank=2, temperature=0.8),
    "ensemble": dict(bank=2, ensemble="mean_logit", slots=4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_streams_equal_the_jax_engine(weights, case):
    """Every request's tokens equal the JAX engine's: 4 prompts of 3-21
    tokens on 2 slots (4 with an ensemble), chunked prefill, mixed
    prompt and decode ticks."""
    spec = dict(CASES[case])
    cf = spec.pop("capacity_factor", None)
    G = spec.pop("bank", 0)
    ensemble = spec.pop("ensemble", None)
    slots = spec.pop("slots", 2)
    temperature = spec.pop("temperature", 0.0)
    over = {} if cf is None else {"capacity_factor": cf}
    jcfg, cfg = configs(**over)
    jparams, flat = weights
    params = load_jax_flat(flat, cfg, device="cpu")
    kw = dict(num_slots=slots, temperature=temperature, **ENGINE_KW)
    bank = jbank = router = jrouter = None
    if G:
        bank = ModelBank(cfg, HornConfig(**HORN), G, seed=1)
        jbank = JaxBank(jcfg, JaxHorn(**HORN), G, seed=1)
        assert "moe" in bank.masks
        router, jrouter = Router(G), JaxRouter(G)
    eng = Engine(cfg, params, EngineConfig(**kw), bank=bank, router=router,
                 device="cpu")
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(**kw), bank=jbank,
                     router=jrouter)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPTS]
    out = []
    for e in (eng, jeng):
        reqs = [e.submit(p, 5) for p in prompts[:-1]]
        reqs.append(e.submit(prompts[-1], 4, ensemble=ensemble)
                    if ensemble else e.submit(prompts[-1], 4))
        e.run(clock=_clock())
        out.append([list(r.out_tokens) for r in reqs])
    assert out[0] == out[1]
    assert all(len(s) for s in out[0])
    eng.pool.check_invariants()
    assert eng.pool.used_pages == 0


@pytest.mark.parametrize("argv", [[], ["--submodels", "2"]],
                         ids=["plain", "bank"])
def test_serve_cli_serves_phi35_moe_on_the_cpu(argv, capsys):
    """``launch.serve --arch phi3.5-moe-42b`` at the reduced size, with and
    without a bank: every request finishes."""
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "4",
                "--gen", "4", "--stream", "batch", "--slots", "2",
                "--budget", "16"] + argv)
    out = capsys.readouterr().out
    assert out.count(" done: ") == 4
    assert "throughput:" in out
    if argv:
        assert "co-batch ratio" in out
