"""Deterministic synthetic token pipeline and MNIST batcher (numpy only).

A copy of the JAX package's ``TokenPipelineConfig``,
``SyntheticTokenPipeline`` and ``MnistBatcher``: a batch is a pure
function of (seed, step), so a resumed run replays exactly the batches it
would have consumed, and the two packages hand their trainers
byte-identical batches.  On a mesh every rank builds the global batch
and the train step takes its own rows (``core/steps.py``), so the JAX
package's per-host slicing (``host_slice``) has no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticTokenPipeline:
    """Markov-ish synthetic token stream (structured enough that loss
    falls)."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab_size, 4096)
        self._table = base.integers(0, v, size=(v, 4)).astype(np.int32)
        self._v = v

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for ``step``: a pure function of (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self._v, B)
        noise = rng.integers(0, 4, size=(B, S))
        explore = rng.random((B, S)) < 0.1
        rand_tok = rng.integers(0, self._v, (B, S))
        for t in range(S):
            nxt = self._table[toks[:, t], noise[:, t]]
            toks[:, t + 1] = np.where(explore[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MnistBatcher:
    """Step-indexed MNIST batcher (same determinism contract): a copy of
    the JAX package's, byte-identical batches for the same seed."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int,
                 seed: int = 0):
        self.x, self.y, self.batch, self.seed = x, y, batch, seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, len(self.x), self.batch)
        return {"x": self.x[idx], "y": self.y[idx]}

    def group_batch_at(self, step: int, num_groups: int
                       ) -> Dict[str, np.ndarray]:
        """[G, B/G, ...] batches: each Horn group gets its own data shard."""
        b = self.batch_at(step)
        per = self.batch // num_groups
        return {k: v[: per * num_groups].reshape(
            (num_groups, per) + v.shape[1:]) for k, v in b.items()}
