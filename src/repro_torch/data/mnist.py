"""MNIST data for the paper's §3 experiment (numpy only).

A copy of the JAX package's ``data/mnist.py``: the same seed gives
byte-identical arrays in both packages.

Nothing is downloaded: if a real MNIST npz is present (``MNIST_PATH`` env or
``data/mnist.npz``), we use it.  Otherwise we fall back to a *procedural*
digit dataset: 28x28 renders of a 7-segment-style glyph per class with random
shift / scale / noise / stroke-width jitter.  It is learnable but non-trivial
(a linear model does NOT saturate it), so the paper's parallel-vs-non-parallel
dropout comparison remains meaningful.  The source is recorded in benchmark
output so results are interpretable.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

# 7-segment encodings per digit: (top, top-l, top-r, mid, bot-l, bot-r, bottom)
_SEGS = {
    0: (1, 1, 1, 0, 1, 1, 1), 1: (0, 0, 1, 0, 0, 1, 0),
    2: (1, 0, 1, 1, 1, 0, 1), 3: (1, 0, 1, 1, 0, 1, 1),
    4: (0, 1, 1, 1, 0, 1, 0), 5: (1, 1, 0, 1, 0, 1, 1),
    6: (1, 1, 0, 1, 1, 1, 1), 7: (1, 0, 1, 0, 0, 1, 0),
    8: (1, 1, 1, 1, 1, 1, 1), 9: (1, 1, 1, 1, 0, 1, 1),
}


def _render_digit(digit: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    # glyph box with random placement/size
    x0 = rng.integers(4, 9)
    y0 = rng.integers(3, 7)
    w = rng.integers(10, 14)
    h = rng.integers(14, 18)
    t = rng.integers(2, 4)          # stroke width
    top, tl, tr, mid, bl, br, bot = _SEGS[digit]
    ym = y0 + h // 2
    if top:
        img[y0:y0 + t, x0:x0 + w] = 1
    if bot:
        img[y0 + h - t:y0 + h, x0:x0 + w] = 1
    if mid:
        img[ym - t // 2: ym - t // 2 + t, x0:x0 + w] = 1
    if tl:
        img[y0:ym, x0:x0 + t] = 1
    if bl:
        img[ym:y0 + h, x0:x0 + t] = 1
    if tr:
        img[y0:ym, x0 + w - t:x0 + w] = 1
    if br:
        img[ym:y0 + h, x0 + w - t:x0 + w] = 1
    # amplitude jitter + blur-ish smoothing + noise
    img *= rng.uniform(0.7, 1.0)
    img += rng.normal(0, 0.15, img.shape).astype(np.float32)
    return np.clip(img, 0, 1)


def synthetic_mnist(n_train: int = 20000, n_test: int = 2000,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    def make(n):
        ys = rng.integers(0, 10, n).astype(np.int32)
        xs = np.stack([_render_digit(int(y), rng) for y in ys])
        return xs.reshape(n, 784).astype(np.float32), ys
    xtr, ytr = make(n_train)
    xte, yte = make(n_test)
    return {"x_train": xtr, "y_train": ytr, "x_test": xte, "y_test": yte,
            "source": "synthetic-7seg"}


def load_mnist(n_train: int = 20000, n_test: int = 2000,
               seed: int = 0) -> Dict[str, np.ndarray]:
    path = os.environ.get("MNIST_PATH", "data/mnist.npz")
    if os.path.exists(path):
        z = np.load(path)
        return {"x_train": z["x_train"].reshape(-1, 784).astype(np.float32) / 255.0,
                "y_train": z["y_train"].astype(np.int32),
                "x_test": z["x_test"].reshape(-1, 784).astype(np.float32) / 255.0,
                "y_test": z["y_test"].astype(np.int32),
                "source": f"mnist:{path}"}
    return synthetic_mnist(n_train, n_test, seed)
