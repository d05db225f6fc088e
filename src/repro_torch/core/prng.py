"""Threefry2x32 in torch integer math: the JAX package's random keys,
bits, uniforms and categorical draws, bit for bit.

The JAX package draws the model bank's circuit masks and every sampled
token from ``jax.random`` (threefry2x32 keys, ``jax_threefry_partitionable``
on, as jax 0.9 defaults).  This module computes the same numbers on any
torch device, so a served circuit and a sampled stream are the JAX
package's for the same seed:

  * ``key(seed)``: the raw key ``(seed >> 32, seed & 0xFFFFFFFF)``;
  * ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``, vectorised
    over a tensor of data (and of keys);
  * ``random_bits(key, shape)``: 32-bit bits ``y1 ^ y2`` of the hash of
    the 64-bit flat index split into (hi, lo) words;
  * ``uniform``: the mantissa recipe of ``jax.random.uniform`` in f32;
  * ``gumbel``/``categorical``: ``-log(-log(u))`` with ``u`` uniform in
    ``[tiny, 1)`` (JAX's "low" mode, its default), argmax of logits plus
    noise.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words; all the
math runs in int64 masked to 32 bits (``uint32`` has few CUDA kernels), on
the device of the tensors it is given.  The integer results are exact on
every device; the f32 logs of ``gumbel`` are the device's own, so a draw
may part from JAX's only at a near-tie within an ulp.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny

Data = Union[int, torch.Tensor]


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``'s two words as an int64 tensor [2]: a
    32-bit seed (negative ones as their two's complement) gives
    ``(0, seed)``, a wider one its high and low words."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} is outside [-2**31, 2**64)")
    hi = (seed >> 32) & M32 if seed >= 2 ** 32 else 0
    return torch.tensor([hi, seed & M32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of count words ``(x1, x2)`` under
    key words ``(k1, k2)``; int64 tensors holding uint32 values, broadcast
    together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y0 = (x1 + k1) & M32
    y1 = (x2 + k2) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            y0 = (y0 + y1) & M32
            y1 = _rotl(y1, r) ^ y0
        y0 = (y0 + ks[(i + 1) % 3]) & M32
        y1 = (y1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return y0, y1


def _words(data: Data, like: torch.Tensor) -> torch.Tensor:
    """``data`` as uint32 words in int64 on ``like``'s device (an int32
    -1 becomes 0xFFFFFFFF, as ``jnp.asarray(data, uint32)`` makes it)."""
    return torch.as_tensor(data, device=like.device).long() & M32


def fold_in(k: torch.Tensor, data: Data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2] and data (an int or a tensor)
    broadcast against each other; returns keys of the broadcast shape
    [..., 2]."""
    d = _words(data, k)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _counts(shape: Sequence[int], device) -> Tuple[torch.Tensor, ...]:
    """The (hi, lo) words of the 64-bit flat index of every element of
    ``shape`` (JAX's ``iota_2x32_shape``)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape))
    return idx >> 32, idx & M32


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit random bits (as int64) of ``shape`` under each key: keys
    [*batch, 2] give [*batch, *shape], every key drawing the whole shape
    as ``jax.random.bits(key, shape, uint32)`` does."""
    shape = tuple(int(s) for s in shape)
    lead = k.shape[:-1]
    view = lead + (1,) * len(shape)
    # the counts at the keys' rank (rank clean under --sanitize)
    hi, lo = (c.reshape((1,) * len(lead) + shape)
              for c in _counts(shape, k.device))
    y0, y1 = threefry2x32(k[..., 0].reshape(view), k[..., 1].reshape(view),
                          hi, lo)
    return y0 ^ y1


def uniform(k: torch.Tensor, shape: Sequence[int] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms in [minval, maxval) as ``jax.random.uniform``: the top
    23 bits as a mantissa of [1, 2), minus 1, scaled and shifted, then
    clamped below at ``minval``.  The scale and shift round once, as the
    fused multiply-add XLA emits for them: the f32 product is exact in
    f64."""
    bits = random_bits(k, shape)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=k.device) - lo
    fma = floats.double() * span.double() + lo.double()
    return torch.maximum(lo, fma.float())


def gumbel(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """f32 Gumbel noise ``-log(-log(u))``, ``u`` uniform in [tiny, 1)
    (``jax.random.gumbel``'s "low" mode)."""
    return -torch.log(-torch.log(uniform(k, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row: keys [B, 2], logits [B, V] f32 -> [B] int64, the
    argmax of ``logits + gumbel(key_b, (V,))`` (ties to the lowest index),
    as ``vmap(jax.random.categorical)(keys, logits)``."""
    return categorical_with(gumbel(keys, logits.shape[-1:]), logits)


def categorical_with(noise: torch.Tensor,
                     logits: torch.Tensor) -> torch.Tensor:
    """``categorical`` on noise drawn before: rows that share keys share
    their noise, so one draw serves several logits of the same slots."""
    return torch.argmax(noise + logits, dim=-1)
