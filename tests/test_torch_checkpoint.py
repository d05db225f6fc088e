"""The port's checkpointer and fault-tolerant loop, and checkpoints that
cross between the packages.

The first tests are ports of ``tests/test_checkpoint.py`` (the elastic
reshard across ranks is in ``tests/test_torch_distributed.py``).  Then the LM train state on reduced
qwen3-1.7b, with momentum SGD and with AdamW: the port writes JAX's
layout (keys, shapes, dtypes), a JAX checkpoint restores in the port and
a port checkpoint in JAX with equal arrays, and a run resumed from a
checkpoint takes the same steps as one that never stopped.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import (Checkpointer, flatten,
                                                 unflatten)
from repro_torch.runtime.fault_tolerance import (NanGuard, PreemptionHandler,
                                                 fault_tolerant_loop)


def make_state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(4)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    state = make_state(1.5)
    ck.save(7, state)
    restored, step = ck.restore(make_state(0.0))
    assert step == 7
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["step"].dtype == torch.int32


def test_async_save_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, make_state(float(s)), blocking=False)
        ck.wait()
    assert ck.available_steps() == [3, 4]


def test_async_save_copies_before_returning(tmp_path):
    """The port updates tensors in place: a save on a background thread
    writes the values the state had when ``save`` was called."""
    ck = Checkpointer(str(tmp_path))
    state = make_state(1.0)
    ck.save(1, state, blocking=False)
    state["params"]["w"].fill_(5.0)
    ck.wait()
    restored, _ = ck.restore(make_state())
    assert float(restored["params"]["w"].mean()) == 1.0


def test_corruption_detected_and_fallback(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    ck.save(1, make_state(1.0))
    ck.save(2, make_state(2.0))
    # corrupt step 2's payload
    path = os.path.join(str(tmp_path), "step_000000002", "shard_0.npz")
    data = dict(np.load(path))
    key = list(data)[0]
    data[key] = data[key] + 99.0
    np.savez(path, **data)
    with pytest.raises(ValueError):
        ck.restore(make_state(), step=2)
    restored, step = ck.restore_latest_good(make_state())
    assert step == 1
    assert float(restored["params"]["w"].mean()) == 1.0


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, make_state(1.0))
    # simulate a preempted save: directory without _COMMITTED
    os.makedirs(os.path.join(str(tmp_path), "step_000000005"))
    assert ck.latest_step() == 1


def test_fault_tolerant_loop_nan_rollback(tmp_path):
    """A poisoned step triggers skip, then rollback to the last
    checkpoint."""
    ck = Checkpointer(str(tmp_path), keep=5)
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        step = state["step"]
        poisoned = 5 <= calls["n"] <= 8 and step >= 4
        loss = float("nan") if poisoned else 1.0 / (step + 1)
        new = dict(state)
        new["step"] = state["step"] + 1
        new["params"] = {k: v + 1 for k, v in state["params"].items()}
        return new, {"loss": loss}

    state = {"params": {"w": torch.zeros(2)}, "step": 0}
    final, step, reason = fault_tolerant_loop(
        state=state, step_fn=step_fn, batch_at=lambda s: {},
        checkpointer=ck, num_steps=10, checkpoint_every=2,
        preemption=PreemptionHandler(signals=()),
        nan_guard=NanGuard(patience=2))
    assert reason == "completed"
    assert step == 10
    assert calls["n"] > 10          # retries happened
    assert isinstance(final["step"], int)


def test_preemption_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path))
    handler = PreemptionHandler(signals=())

    def step_fn(state, batch):
        if state["step"] == 3:
            handler.trigger()       # simulate SIGTERM mid-run
        new = dict(state)
        new["step"] = state["step"] + 1
        return new, {"loss": 0.5}

    state = {"params": {"w": torch.zeros(2)}, "step": 0}
    final, step, reason = fault_tolerant_loop(
        state=state, step_fn=step_fn, batch_at=lambda s: {},
        checkpointer=ck, num_steps=100, checkpoint_every=50,
        preemption=handler)
    assert reason == "preempted"
    assert ck.latest_step() == step
    restored, at = ck.restore(state)
    assert at == step == restored["step"] == 4


class NoCheckpoints:
    """A checkpointer that keeps nothing (the loop below never rolls
    back)."""

    def save(self, step, state, blocking=True):
        pass

    def wait(self):
        pass

    def restore_latest_good(self, like, device=None):
        raise AssertionError("the loop rolled back: the steps after the "
                             "skipped one were non-finite too")


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_skipped_non_finite_lm_step_leaves_no_update(optimizer,
                                                     monkeypatch):
    """The loop's "skip" of a non-finite LM step keeps nothing of it
    (ROADMAP section 3, fault (B)).  Reduced qwen3-1.7b, f32, Horn on:
    the loss and so every gradient of batch 1 are made NaN, the guard
    skips it, and the run ends bit-equal to the same loop over the
    batches with batch 1 dropped: masters, moments, AdamW's ``t`` and
    ``step``."""
    from repro_torch.configs import base as tbase
    from repro_torch.core import steps as S
    from repro_torch.data import pipeline as tpipe
    from repro_torch.models import api

    run = tbase.RunConfig(
        model=tbase.reduced(tbase.get_model_config("qwen3-1.7b")),
        shape=tbase.ShapeConfig("t", "train", 16, 2),
        horn=tbase.HornConfig(num_groups=2, block_size=32),
        optimizer=optimizer, learning_rate=0.01, compute_dtype="float32",
        seed=3)
    pipe = tpipe.SyntheticTokenPipeline(tpipe.TokenPipelineConfig(
        vocab_size=run.model.vocab_size, seq_len=16, global_batch=2,
        seed=3))
    bad, steps = 1, 4
    poisoned = {"now": False}
    model_loss = api.model_loss

    def nan_loss(*args, **kw):
        loss, metrics = model_loss(*args, **kw)
        if poisoned["now"]:
            loss = loss * float("nan")
            metrics = dict(metrics, loss=loss)
        return loss, metrics

    monkeypatch.setattr(api, "model_loss", nan_loss)

    def train(batch_at, num_steps):
        step = S.make_train_step(run, "cpu")

        def step_fn(state, batch):
            poisoned["now"] = batch["poisoned"]
            return step(state, batch)

        guard = NanGuard()
        state, at, reason = fault_tolerant_loop(
            state=S.init_state(run, "cpu"), step_fn=step_fn,
            batch_at=batch_at, checkpointer=NoCheckpoints(),
            num_steps=num_steps, checkpoint_every=100,
            preemption=PreemptionHandler(signals=()), nan_guard=guard)
        assert reason == "completed" and at == num_steps
        return state, guard.total_skipped

    def batch(i):
        return dict(pipe.batch_at(i), poisoned=i == bad)

    skipped, n_skipped = train(batch, steps)
    dropped, n_dropped = train(
        lambda i: batch(i if i < bad else i + 1), steps - 1)
    assert (n_skipped, n_dropped) == (1, 0)
    assert skipped["step"] == dropped["step"] == steps - 1
    assert skipped["opt"].get("t") == dropped["opt"].get("t")
    for name in ("mom", "m", "v"):
        for a, b in zip(skipped["opt"].get(name, []),
                        dropped["opt"].get(name, [])):
            assert torch.equal(a, b), name
    for (name, a), b in zip(skipped["params"].named_parameters(),
                            dropped["params"].parameters()):
        assert torch.isfinite(a).all() and torch.equal(a, b), name


def test_flatten_gives_jax_keystr_paths():
    jax = pytest.importorskip("jax")
    tree = {"b": [np.zeros(2), {"x": np.ones(1)}], "a": {"z": np.ones(3),
                                                          "c": (1, 2)}}
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_leaves_with_path(tree)]
    assert list(flatten(tree)) == want
    dict_only = {"a": {"z": 1, "c": 2}, "b": 3}
    assert unflatten(flatten(dict_only)) == dict_only


# ---------------------------------------------------------------------------
# the LM train state across the packages
# ---------------------------------------------------------------------------
def runs(optimizer, seed=3):
    """(JAX RunConfig, port RunConfig) for reduced qwen3-1.7b, f32."""
    pytest.importorskip("jax")
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase

    common = dict(optimizer=optimizer, learning_rate=0.01,
                  compute_dtype="float32", seed=seed)
    return tuple(
        m.RunConfig(model=m.reduced(m.get_model_config("qwen3-1.7b")),
                    shape=m.ShapeConfig("t", "train", 16, 2),
                    horn=m.HornConfig(num_groups=2, block_size=32), **common)
        for m in (jbase, tbase))


def one_jax_step(jrun):
    import jax
    import jax.numpy as jnp
    from repro.core import steps as JS
    from repro.data import pipeline as jpipe
    from repro.launch.mesh import make_test_mesh

    step_fn, _ = JS.make_train_step(jrun, make_test_mesh(1, 1))
    state = JS.init_state(jax.random.key(jrun.seed), jrun)
    b = jpipe.SyntheticTokenPipeline(jpipe.TokenPipelineConfig(
        vocab_size=jrun.model.vocab_size, seq_len=16, global_batch=2,
        seed=jrun.seed)).batch_at(0)
    state, _ = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
    return state


def one_port_step(trun):
    from repro_torch.core import steps as S
    from repro_torch.data import pipeline as tpipe

    state = S.init_state(trun, "cpu")
    b = tpipe.SyntheticTokenPipeline(tpipe.TokenPipelineConfig(
        vocab_size=trun.model.vocab_size, seq_len=16, global_batch=2,
        seed=trun.seed)).batch_at(0)
    state, _ = S.make_train_step(trun, "cpu")(state, b)
    return state


def meta_of(directory, step):
    with open(os.path.join(directory, f"step_{step:09d}",
                           "meta.json")) as f:
        meta = json.load(f)
    return meta["shapes"], meta["dtypes"]


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_port_state_has_the_jax_layout(optimizer, tmp_path):
    """The same keys, shapes and dtypes in ``meta.json`` as JAX's
    ``Checkpointer`` writes for ``init_state`` of the same run."""
    import jax
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.core import steps as JS
    from repro_torch.core import steps as S
    from repro_torch.launch.train import TrainStateCheckpointer

    jrun, trun = runs(optimizer)
    JCheckpointer(str(tmp_path / "jax")).save(
        0, JS.init_state(jax.random.key(trun.seed), jrun))
    TrainStateCheckpointer(str(tmp_path / "port"), trun).save(
        0, S.init_state(trun, "cpu"))
    want, got = meta_of(tmp_path / "jax", 0), meta_of(tmp_path / "port", 0)
    assert set(got[0]) == set(want[0])
    assert got == want
    assert got[1]["['rng']"] == "uint32" and got[1]["['step']"] == "int32"


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_jax_checkpoint_restores_in_the_port(optimizer, tmp_path):
    """A JAX train state after one step (moments non-zero), saved by JAX,
    restores in the port with every array equal."""
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.checkpoint.checkpointer import _flatten
    from repro_torch.core import steps as S
    from repro_torch.launch.train import TrainStateCheckpointer

    jrun, trun = runs(optimizer)
    jstate = one_jax_step(jrun)
    JCheckpointer(str(tmp_path)).save(1, jstate)
    ck = TrainStateCheckpointer(str(tmp_path), trun)
    state, at = ck.restore(S.init_state(trun, "cpu"), device="cpu")
    assert at == 1 and state["step"] == 1 and state["rng"] == trun.seed
    want = {k: np.asarray(v) for k, v in _flatten(jstate).items()}
    got = S.state_to_jax_flat(state, trun)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_port_checkpoint_restores_in_jax(optimizer, tmp_path):
    """A port train state after one step, saved by the port, restores in
    JAX's ``Checkpointer`` into ``init_state``'s tree with every array
    equal."""
    import jax
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.checkpoint.checkpointer import _flatten
    from repro.core import steps as JS
    from repro_torch.core import steps as S
    from repro_torch.launch.train import TrainStateCheckpointer

    jrun, trun = runs(optimizer)
    tstate = one_port_step(trun)
    TrainStateCheckpointer(str(tmp_path), trun).save(1, tstate)
    like = JS.init_state(jax.random.key(0), jrun)
    restored, at = JCheckpointer(str(tmp_path)).restore(like)
    assert at == 1 and int(restored["step"]) == 1
    want = S.state_to_jax_flat(tstate, trun)
    got = {k: np.asarray(v) for k, v in _flatten(restored).items()}
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["['rng']"], np.asarray(
        jax.random.key_data(jax.random.key(trun.seed))))


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
def test_cli_resume_takes_the_same_steps(optimizer, tmp_path):
    """The train CLI with ``--checkpoint-dir``: 2 steps, then a second
    invocation that resumes to 4, gives steps 3-4 the losses and grad
    norms of 4 steps straight through, bit for bit, and the same final
    state."""
    from repro_torch.launch import train

    def cli(directory, steps):
        return train.main([
            "--arch", "qwen3-1.7b", "--device", "cpu", "--steps",
            str(steps), "--batch", "2", "--seq", "16", "--optimizer",
            optimizer, "--horn-groups", "2", "--checkpoint-dir",
            str(directory), "--log-every", "1", "--seed", "1"])["steps"]

    straight = cli(tmp_path / "a", 4)
    first = cli(tmp_path / "b", 2)
    resumed = cli(tmp_path / "b", 4)
    assert [r["step"] for r in straight] == [1, 2, 3, 4]
    assert [r["step"] for r in first + resumed] == [1, 2, 3, 4]
    for a, b in zip(straight, first + resumed):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    for d in ("a", "b"):
        assert Checkpointer(str(tmp_path / d)).latest_step() == 4
    za = np.load(tmp_path / "a" / "step_000000004" / "shard_0.npz")
    zb = np.load(tmp_path / "b" / "step_000000004" / "shard_0.npz")
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert np.array_equal(za[k], zb[k]), k


def test_cli_checkpoints_every_n_steps_and_prints_resume(tmp_path, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "qwen3-1.7b", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2", "--optimizer", "sgdm"]
    train.main(argv + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "exit: completed at step 5" in out
    assert Checkpointer(str(tmp_path)).available_steps() == [2, 4, 5]
    recs = train.main(argv + ["--steps", "6"])["steps"]
    assert "resumed from step 5" in capsys.readouterr().out
    assert [r["step"] for r in recs] == [6]
