"""The port's threefry2x32 (``repro_torch.core.prng``) against the
installed ``jax.random``, bit for bit: keys, folds and uniform draws over
seeds, rounds, the four fold indices of the reference's key convention,
mask sizes from 1 to 1024 and 2-D and 3-D shapes (the edge mask's
``(n, n)``)."""
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
