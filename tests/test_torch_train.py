"""The port's training path against the JAX package's: the synthetic
pipelines and the train CLI.  The per-arch parity cases (loss and
gradients, three train steps) are in ``tests/test_torch_train_<arch>.py``,
over the checks of ``tests/torch_train_common.py``.

"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


@pytest.mark.parametrize("seed,vocab", [(0, 512), (5, 151936)])
def test_pipeline_batches_are_identical(seed, vocab):
    def cfg(mod):
        return mod.TokenPipelineConfig(vocab_size=vocab, seq_len=64,
                                       global_batch=3, seed=seed)
    jp = jpipe.SyntheticTokenPipeline(cfg(jpipe))
    tp = tpipe.SyntheticTokenPipeline(cfg(tpipe))
    for step in (0, 1, 7):
        a, b = jp.batch_at(step), tp.batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def test_train_cli_runs_on_the_cpu(capsys):
    """The launcher end to end at the reduced size on the plain versions:
    every step logs a finite loss, and no kernel is launched."""
    from repro_torch.launch import train

    out = train.main(["--arch", "qwen3-1.7b", "--device", "cpu", "--steps",
                      "3", "--batch", "4", "--seq", "16", "--log-every",
                      "1", "--horn-groups", "2"])
    text = capsys.readouterr().out
    assert len(out["steps"]) == 3
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in out["steps"])
    assert text.count("grad_norm") == 3 and "loss: first=" in text
    assert "flash_attention_fwd launches: 0" in text
    assert "flash_attention_bwd launches: 0" in text
