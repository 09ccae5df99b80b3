"""The port's threefry2x32 (``repro_torch.core.prng``) against the
installed ``jax.random``, bit for bit: keys, folds, splits and uniform
draws over seeds, rounds, the four fold indices of the reference's key
convention, mask sizes from 1 to 1024 and 2-D and 3-D shapes (the edge
mask's ``(n, n)``); normal draws and the Gumbel noise of ``categorical``
to a measured tolerance, and its samples exactly."""
import jax
import numpy as np
import pytest

from repro_torch.core import prng

SEEDS = [0, 1, 7, 123, 2 ** 31 + 5, 2 ** 32 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    assert np.array_equal(prng.key(seed), want)
    assert prng.key(seed).dtype == np.uint32


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fold", [0, 1, 2, 3])
def test_fold_in_matches_jax(seed, fold):
    """The reference's round key ``fold_in(fold_in(key(s), r), i)``."""
    for r in (0, 1, 5, 39, 1000, 2 ** 32 - 1):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), r),
                                fold)
        k = prng.fold_in(prng.fold_in(prng.key(seed), r), fold)
        assert np.array_equal(k, np.asarray(jax.random.key_data(jk))), r


@pytest.mark.parametrize("n", [1, 4, 33, 1024])
@pytest.mark.parametrize("fold", [0, 1, 2, 3])
def test_uniform_matches_jax_bit_for_bit(n, fold):
    for seed in SEEDS[:4]:
        for r in (0, 3, 39):
            jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                       r), fold)
            want = np.asarray(jax.random.uniform(jk, (n,)))
            got = prng.uniform(prng.fold_in(prng.fold_in(prng.key(seed), r),
                                            fold), n)
            assert got.dtype == np.float32 and got.shape == (n,)
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
            assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (16, 16), (33, 33),
                                   (2, 3, 4), (64, 64)])
def test_uniform_of_a_shape_matches_jax_bit_for_bit(shape):
    """jax 0.9.0 with ``jax_threefry_partitionable=True`` hashes the flat
    row-major index of each element as its counter, the high word 0."""
    assert jax.config.jax_threefry_partitionable
    for seed in SEEDS[:4]:
        for r in (0, 39):
            jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                                       r), 0)
            want = np.asarray(jax.random.uniform(jk, shape))
            got = prng.uniform(prng.fold_in(prng.fold_in(prng.key(seed), r),
                                            0), shape)
            assert got.dtype == np.float32 and got.shape == shape
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    flat = prng.uniform(prng.key(3), int(np.prod(shape)))
    assert np.array_equal(prng.uniform(prng.key(3), shape).ravel(), flat)


def test_out_of_range_seeds_and_data_raise():
    with pytest.raises(ValueError, match="seed"):
        prng.key(-1)
    with pytest.raises(ValueError, match="seed"):
        prng.key(2 ** 32)
    with pytest.raises(ValueError, match="fold_in"):
        prng.fold_in(prng.key(0), 2 ** 32)


# ----------------------------------------------------------------------
# normal: threefry bits exact, XLA's f32 erf_inv to a measured tolerance
# ----------------------------------------------------------------------
# Over a 10**6 draw (seed 7, fold 3) the port's erf_inv — XLA's f32
# polynomial in numpy, each Horner step a fused multiply-add — equals
# jax.random.normal in 98.7% of the values and differs by at most 3 ulps
# (4.77e-7 absolute) elsewhere: numpy's log1p is not XLA's.  scipy's and
# torch's erfinv differ by up to 91 ulps (2.17e-5), so the port does not
# use them.
NORMAL_MAX_ULPS = 3


def test_normal_matches_jax_over_a_million_draws():
    import jax.numpy as jnp

    n = 1_000_000
    jk = jax.random.fold_in(jax.random.key(7), 3)
    want = np.asarray(jax.random.normal(jk, (n,), jnp.float32))
    got = prng.normal(prng.fold_in(prng.key(7), 3), n)
    assert got.dtype == np.float32 and got.shape == (n,)
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= NORMAL_MAX_ULPS, ulps.max()
    assert np.mean(got == want) > 0.98


@pytest.mark.parametrize("shape", [(5,), (4, 33), (2, 3, 7)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_shapes_match_jax(shape, seed):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 2), 3)
    want = np.asarray(jax.random.normal(jk, shape))
    got = prng.normal(prng.fold_in(prng.fold_in(prng.key(seed), 2), 3),
                      shape)
    assert got.shape == want.shape
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= NORMAL_MAX_ULPS


def test_normal_at_equals_the_whole_draw_bit_for_bit():
    """A row subset of a ``(rows, cols)`` draw is its own counters, so it
    equals the same rows of the whole draw exactly (the ``"noise"`` fault
    draws only the faulty rows)."""
    k = prng.fold_in(prng.key(3), 5)
    whole = prng.normal(k, (9, 1000))
    rows = np.array([0, 4, 8])
    idx = rows[:, None] * 1000 + np.arange(1000)[None]
    assert np.array_equal(prng.normal_at(k, idx).view(np.uint32),
                          whole[rows].view(np.uint32))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        prng.normal_at(k, np.array([-1]))


# ----------------------------------------------------------------------
# split and categorical (temperature sampling)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("num", [2, 3, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax_bit_for_bit(seed, num):
    """``split`` of a key, and a chain of ``rng, sub = split(rng)`` as the
    generator draws it, equal ``jax.random.split``'s keys exactly."""
    want = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(seed), num)))
    got = prng.split(prng.key(seed), num)
    assert got.dtype == np.uint32 and got.shape == (num, 2)
    assert np.array_equal(got, want)
    jrng, rng = jax.random.PRNGKey(seed), prng.key(seed)
    for _ in range(4):
        jrng, jsub = jax.random.split(jrng)
        rng, sub = prng.split(rng)
        assert np.array_equal(rng, np.asarray(jrng))
        assert np.array_equal(sub, np.asarray(jsub))


def _gumbel(k, shape):
    """The Gumbel noise ``categorical`` adds: the uniform on ``[tiny, 1)``
    from the host's bits, the two logs in torch."""
    import torch

    tiny = np.finfo(np.float32).tiny
    u = np.maximum(tiny, prng.uniform(k, shape) * (np.float32(1) - tiny)
                   + tiny)
    return (-torch.log(-torch.log(torch.as_tensor(u)))).numpy()


# Over a 10**6 draw (seed 7, fold 3) the port's Gumbel noise equals
# jax.random.gumbel's in 77.1% of the values: the uniform is bit for bit
# the same, and torch's f32 log differs from XLA's by at most 1 ulp (in
# 14.1% of the values), twice.  The noise then differs by at most 2 ulps
# where |g| >= 0.5 and by at most 9.5e-7 (8 ulps of 1) anywhere: near
# g = 0 (u near 1/e) the outer log's input sits near 1, where one ulp of
# the inner log is many ulps of the result.
GUMBEL_MAX_ULPS, GUMBEL_MAX_ABS = 2, 2e-6


def test_gumbel_noise_matches_jax_to_the_last_ulps():
    import jax.numpy as jnp

    n = 1_000_000
    want = np.asarray(jax.random.gumbel(jax.random.fold_in(
        jax.random.key(7), 3), (n,), jnp.float32))
    got = _gumbel(prng.fold_in(prng.key(7), 3), (n,))
    assert got.dtype == np.float32
    far = np.abs(want) >= 0.5
    ulps = np.abs(got - want)[far] / np.spacing(np.abs(want[far]))
    assert ulps.max() <= GUMBEL_MAX_ULPS, ulps.max()
    assert np.abs(got - want).max() <= GUMBEL_MAX_ABS
    assert np.mean(got == want) > 0.75


@pytest.mark.parametrize("temperature", [0.8, 1.0, 2.5])
@pytest.mark.parametrize("shape", [(3, 7), (2, 128), (4, 32001)])
def test_categorical_matches_jax(shape, temperature):
    """``categorical(key, logits / temperature)`` draws the reference's
    samples exactly, for 5 keys a case, at hymba-1.5b's vocabulary of
    32,001 among them (a last-ulp difference in the noise can only flip
    a sample whose top two noisy logits tie to that ulp)."""
    import jax.numpy as jnp
    import torch

    for seed in range(5):
        logits = 3 * np.random.default_rng(seed).standard_normal(
            shape).astype(np.float32)
        want = np.asarray(jax.random.categorical(
            jax.random.key(seed), jnp.asarray(logits) / temperature))
        got = prng.categorical(prng.key(seed),
                               torch.as_tensor(logits) / temperature)
        assert got.shape == shape[:-1]
        assert np.array_equal(got.numpy(), want), seed
    with pytest.raises(TypeError, match="f32"):
        prng.categorical(prng.key(0), torch.zeros(2, 3, dtype=torch.float64))
