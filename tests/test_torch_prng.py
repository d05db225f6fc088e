"""The port's threefry2x32 (``repro_torch/core/prng.py``) against
``jax.random``, bit for bit.

Keys, folded keys, random bits and uniforms are compared for exact
equality (integer math, and the uniform's one rounding); categorical draws
for equal indices.  Gumbel noise goes through each library's own f32 log,
whose last bits differ, so it is held to 1e-6; its draws still pick the
same indices.  Seeds 0, 1 and 2**31 - 1, data up to 2**32 - 1, odd sizes
(V = 1, 7, 151936), scalar and [B]-vectorised forms.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 2 ** 31 - 1]
DATA = [0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
SHAPES = [(), (1,), (7,), (3, 5), (151936,)]


def jwords(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + [42, -1, -2 ** 31])
def test_key_matches_jax(seed):
    assert np.array_equal(prng.key(seed).numpy(),
                          jwords(jax.random.key(seed)))


def test_key_rejects_out_of_range_seeds():
    with pytest.raises(ValueError):
        prng.key(-2 ** 31 - 1)
    with pytest.raises(ValueError):
        prng.key(2 ** 64)


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_scalar_matches_jax(seed, data):
    want = jwords(jax.random.fold_in(jax.random.key(seed), data))
    assert np.array_equal(prng.fold_in(prng.key(seed), data).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_vectorised_matches_jax(seed):
    """fold_in over a [B] tensor of data (int32, negatives as their uint32
    words), then again with [B] keys against [B] data: the engine's
    ``fold_in(fold_in(root, req_id), step)`` chain."""
    data = np.array([0, 1, 5, 2 ** 31 - 1, -1, -7, 123456], np.int32)
    steps = np.array([0, 3, 1, 9, 2 ** 20, 0, 77], np.int32)
    root = jax.random.key(seed)
    want = jax.vmap(lambda r, s: jax.random.fold_in(
        jax.random.fold_in(root, r), s))(jnp.asarray(data),
                                         jnp.asarray(steps))
    once = prng.fold_in(prng.key(seed), torch.from_numpy(data))
    assert once.shape == (7, 2)
    assert np.array_equal(once.numpy(), jwords(jax.vmap(
        lambda r: jax.random.fold_in(root, r))(jnp.asarray(data))))
    got = prng.fold_in(once, torch.from_numpy(steps))
    assert np.array_equal(got.numpy(), jwords(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed, shape):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64)
    got = prng.random_bits(prng.fold_in(prng.key(seed), 3), shape)
    assert got.shape == shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-2.5, 3.0), (0.1, 0.7)],
                         ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax_bit_for_bit(seed, shape, bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                         minval=lo, maxval=hi))
    got = prng.uniform(prng.key(seed), shape, lo, hi).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_batched_keys_draw_each_keys_shape():
    """Keys [B, 2] give [B, *shape], row b the draw of key b alone."""
    keys = prng.fold_in(prng.key(5), torch.arange(4))
    got = prng.uniform(keys, (3, 2))
    assert got.shape == (4, 3, 2)
    for b in range(4):
        want = jax.random.uniform(jax.random.fold_in(jax.random.key(5), b),
                                  (3, 2))
        assert np.array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(7,), (151936,)], ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_matches_jax(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.key(seed), shape))
    got = prng.gumbel(prng.key(seed), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("V", [1, 7, 151936])
@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_vectorised_matches_jax(seed, V):
    """``vmap(jax.random.categorical)(keys, logits / T)`` as the serving
    step calls it: per-slot keys from the (request, step) chain, f32
    logits at temperature 0.8."""
    B = 8
    rng = np.random.default_rng(seed % 1000)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    reqs = np.arange(B, dtype=np.int32) * 5
    steps = np.arange(B, dtype=np.int32) + 2
    root = jax.random.key(seed)
    keys = jax.vmap(lambda r, s: jax.random.fold_in(
        jax.random.fold_in(root, r), s))(jnp.asarray(reqs),
                                         jnp.asarray(steps))
    want = np.asarray(jax.vmap(jax.random.categorical)(
        keys, jnp.asarray(logits) / 0.8))
    tkeys = prng.fold_in(prng.fold_in(prng.key(seed), torch.from_numpy(reqs)),
                         torch.from_numpy(steps))
    got = prng.categorical(tkeys, torch.from_numpy(logits) / 0.8)
    assert got.shape == (B,)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("V", [1, 7, 151936])
def test_categorical_scalar_key_matches_jax(V):
    logits = np.random.default_rng(V).normal(size=(V,)).astype(np.float32)
    for seed in SEEDS:
        want = int(jax.random.categorical(jax.random.key(seed),
                                          jnp.asarray(logits)))
        got = prng.categorical(prng.key(seed), torch.from_numpy(logits))
        assert got.shape == () and int(got) == want


def test_categorical_with_shared_noise_is_categorical():
    """One noise draw serves several logits of the same keys (the
    ensemble combine samples the mean and each member's own logits)."""
    keys = prng.fold_in(prng.key(2), torch.arange(5))
    a = torch.randn(5, 33)
    b = torch.randn(5, 33)
    noise = prng.gumbel(keys, (33,))
    assert torch.equal(prng.categorical_with(noise, a),
                       prng.categorical(keys, a))
    assert torch.equal(prng.categorical_with(noise, b),
                       prng.categorical(keys, b))
