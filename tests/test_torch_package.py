"""Import hygiene and device rules of the PyTorch port (``src/repro_torch``).

The port imports ``torch`` and ``numpy``, never ``jax`` and nothing of the
JAX package ``repro``; its entry points default to the card and raise when
there is none instead of carrying on on the CPU.
"""
import ast
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import base
from repro_torch.configs.base import get_model_config, reduced
from repro_torch.models.params import init_params
from repro_torch.serving import Engine, EngineConfig, ModelBank, Router

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    """Every submodule imports in a process where ``import jax`` fails."""
    mods = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
    code = ("import sys, importlib\nsys.modules['jax'] = None\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in mods)
            + "assert not any(k == 'repro' or k.startswith('repro.') "
              "for k in sys.modules)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for m in ("serving.engine", "launch.serve", "launch.train",
              "kernels.flash_attention.kernel", "kernels.flash_attention.ops",
              "kernels.dropout_matmul.kernel", "kernels.dropout_matmul.ops",
              "kernels.ssd.kernel", "kernels.ssd.ops", "models.ssm",
              "core.parallel_dropout", "core.submodel", "core.steps",
              "core.neuron_centric", "core.group_sync",
              "core.collective_trainer", "configs.horn_mnist",
              "configs.qwen1p5_4b", "configs.gemma3_4b",
              "checkpoint.checkpointer", "runtime.fault_tolerance",
              "benchmarks.mnist_repro", "optim.sgd", "optim.compression",
              "data.pipeline", "data.mnist", "serving.observability",
              *(f"serving.observability.{n}" for n in (
                  "anomaly", "metrics", "profiler", "replay", "slo",
                  "stats", "telemetry", "trace"))):
        assert f"repro_torch.{m}" in mods, m


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    """AST scan: no ``jax`` and no ``repro.`` import in the port's sources
    or in ``chip_smoke.py``."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(n)
    assert not bad, f"{path}: imports {bad}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")


def test_entry_points_refuse_missing_cuda(no_cuda):
    cfg = reduced(get_model_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="no CUDA"):
        init_params(cfg, 0)                        # device defaults to cuda
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Engine(cfg, params, EngineConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Engine(cfg, params, EngineConfig())
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA"):
        train.main(["--arch", "qwen3-1.7b", "--steps", "1"])  # cuda default
    from repro_torch.core import steps
    run = base.RunConfig(model=reduced(get_model_config("mamba2-2.7b")),
                         shape=base.ShapeConfig("p", "prefill", 16, 2))
    with pytest.raises(RuntimeError, match="no CUDA"):
        steps.make_prefill_step(run)
    with pytest.raises(RuntimeError, match="no CUDA"):
        steps.make_decode_step(run)


@pytest.mark.parametrize("what", ["bank", "router", "draft", "speculate_k",
                                  "draft_vocab", "temperature", "kv_dtype"])
def test_engine_refuses_unported_features(what):
    """What the engine cannot serve raises instead of being silently
    ignored: a KV pool dtype it has no kernel for, a bank built for
    another model, a Router without a bank, and the JAX engine's
    speculation checks (a DraftModel without ``speculate_k > 0``,
    ``speculate_k > 0`` without a DraftModel, a draft whose vocabulary is
    not the parent's).  Temperature > 0 samples."""
    cfg = reduced(get_model_config("qwen3-1.7b"))
    params = init_params(cfg, 0, device="cpu")
    kw, ecfg = {}, EngineConfig(max_new_tokens=4)
    err = ValueError
    horn = base.HornConfig(enabled=True, keep_hidden=0.5, keep_input=1.0,
                           block_size=16)
    if what == "bank":
        kw["bank"] = ModelBank(reduced(get_model_config("gemma2-27b")),
                               horn, 2)
        match = "bank was built for"
    elif what == "router":
        kw["router"] = Router(2)
        match = "needs a ModelBank"
    elif what == "draft":
        kw["draft"] = ModelBank(cfg, horn, 1).draft_model(0, params)
        match = "needs speculate_k > 0"
    elif what == "draft_vocab":
        draft = ModelBank(cfg, horn, 1).draft_model(0, params)
        kw["draft"] = dataclasses.replace(draft, cfg=dataclasses.replace(
            draft.cfg, vocab_size=cfg.vocab_size + 1))
        ecfg = dataclasses.replace(ecfg, speculate_k=2)
        match = "draft vocab"
    elif what == "temperature":
        eng = Engine(cfg, params, dataclasses.replace(ecfg, temperature=0.8),
                     device="cpu")
        req = eng.submit(np.arange(1, 6), 4)
        eng.run()
        assert len(req.out_tokens) == 4
        return
    else:
        value = {"speculate_k": 2, "kv_dtype": "float16"}
        ecfg = dataclasses.replace(ecfg, **{what: value[what]})
        match = {"speculate_k": "needs a DraftModel",
                 "kv_dtype": "float32, bfloat16 or int8"}[what]
    with pytest.raises(err, match=match):
        Engine(cfg, params, ecfg, device="cpu", **kw)


@pytest.mark.parametrize("argv,item", [
    (["--topology", "zero1"], "slice 5, item 10"),
    (["--topology", "local_sgd"], "slice 5, item 10"),
    (["--checkpoint-dir", "ckpt", "--topology", "local_sgd"],
     "slice 5, item 10"),
    (["--mesh-data", "2"], "slice 5"),
    (["--arch", "mamba2-2.7b"], "slice 4"),
])
def test_train_cli_refuses_unported_features(argv, item):
    """The trainer names the ROADMAP item that ports what it refuses,
    before it builds anything."""
    from repro_torch.launch import train

    if "--arch" not in argv:
        argv = ["--arch", "qwen3-1.7b"] + argv
    with pytest.raises(NotImplementedError, match=item):
        train.main(argv + ["--device", "cpu"])


def test_configs_match_the_jax_package():
    """Same field names, defaults and values for every arch the port
    registers, full and reduced, and for the run configs (``RunConfig``,
    ``HornConfig``, ``TopologyConfig``, ``ShapeConfig``)."""
    pytest.importorskip("jax")
    from repro.configs import base as jbase

    for arch in ("qwen3-1.7b", "qwen1.5-4b", "gemma2-27b", "gemma3-4b",
                 "mamba2-2.7b"):
        ours, theirs = get_model_config(arch), jbase.get_model_config(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert dataclasses.asdict(reduced(ours)) == \
            dataclasses.asdict(jbase.reduced(theirs))
        assert ours.layer_kinds() == theirs.layer_kinds()
        shape = ("t", "train", 128, 4)
        ours_run = base.RunConfig(model=ours, shape=base.ShapeConfig(*shape))
        theirs_run = jbase.RunConfig(model=theirs,
                                     shape=jbase.ShapeConfig(*shape))
        assert dataclasses.asdict(ours_run) == dataclasses.asdict(theirs_run)
    for name in ("HornConfig", "TopologyConfig", "ShapeConfig", "RunConfig"):
        ours, theirs = getattr(base, name), getattr(jbase, name)
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)], name
    assert dataclasses.asdict(base.HornConfig()) == \
        dataclasses.asdict(jbase.HornConfig())


def test_serve_cli_runs_on_the_cpu(capsys):
    """The launcher end to end at the reduced size, on the plain versions:
    every request finishes and the report names the kernel's launches
    (none on the CPU)."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "5", "--gen", "6",
                "--stream", "batch", "--slots", "2", "--budget", "8"])
    out = capsys.readouterr().out
    assert out.count(" done: ") == 5
    assert "throughput:" in out and "TTFT" in out
    assert "paged_chunk_attention launches: 0" in out
