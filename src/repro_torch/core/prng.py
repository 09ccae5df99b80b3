"""JAX-compatible threefry2x32 draws, in numpy (the port's own copy).

The reference draws its per-round masks from ``jax.random`` keys:
``fold_in(fold_in(key(seed), round), i)`` with ``i = 2`` for
participation and ``i = 3`` for faults (``repro/core/dynamic.py``).  To
hold those masks to the reference bit for bit, the port computes the same
threefry2x32 stream here, matching jax 0.9.0 with
``jax_threefry_partitionable=True``:

* ``key(s)`` is the pair ``(0, s)`` for a 32-bit seed;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* ``uniform(k, n)`` hashes the counters ``(0, i)`` for ``i < n``, takes
  ``bits = out0 ^ out1``, and reads ``(bits >> 9) | 0x3F800000`` as a
  float32 in [1, 2), minus 1.

Masks are ``(n,)`` per round and depend only on seeds and the round
index, so drawing them on the host costs no device synchronisation.
``normal`` (the ``"noise"`` fault mode) is not ported yet (ROADMAP Queue 1
[links]), nor ``categorical`` (temperature sampling, [serving]).
"""
from __future__ import annotations

import numpy as np

__all__ = ["key", "fold_in", "uniform", "threefry2x32"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k: np.ndarray, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) of the counter pairs
    ``(x0, x1)`` under the key ``k = (k0, k1)``; uint32 in and out."""
    k = np.asarray(k, np.uint32)
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` for a 32-bit seed."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must fit in 32 unsigned bits, got {seed}")
    return np.array([0, seed], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in`` of a 32-bit ``data`` into the key ``k``."""
    data = int(data)
    if not 0 <= data < 2 ** 32:
        raise ValueError(f"fold_in data must fit in 32 bits, got {data}")
    out0, out1 = threefry2x32(k, np.zeros(1, np.uint32),
                              np.array([data], np.uint32))
    return np.concatenate([out0, out1])


def uniform(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(k, (n,))``: ``(n,)`` float32 in [0, 1)."""
    b0, b1 = threefry2x32(k, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
