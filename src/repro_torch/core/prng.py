"""JAX-compatible threefry2x32 draws, in numpy (the port's own copy).

The reference draws its per-round masks from ``jax.random`` keys:
``fold_in(fold_in(key(seed), round), i)`` with ``i = 2`` for
participation and ``i = 3`` for faults (``repro/core/dynamic.py``).  To
hold those masks to the reference bit for bit, the port computes the same
threefry2x32 stream here, matching jax 0.9.0 with
``jax_threefry_partitionable=True``:

* ``key(s)`` is the pair ``(0, s)`` for a 32-bit seed;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* ``uniform(k, shape)`` hashes the counters ``(0, i)`` for each flat
  (row-major) index ``i`` of the shape — the partitionable form's 64-bit
  iota split into a high and a low word, the high word 0 below 2^32
  values — takes ``bits = out0 ^ out1``, and reads ``(bits >> 9) |
  0x3F800000`` as a float32 in [1, 2), minus 1.

* ``normal(k, shape)`` is ``√2 · erf_inv(u)`` with ``u`` uniform on
  ``(nextafter(−1, 0), 1)`` from the same counters (the uniform's
  ``[0, 1)`` value times 2 plus the lower bound, clamped to it, in f32).
  ``erf_inv`` is XLA's f32 polynomial (Giles' single-precision form, the
  one ``lax.erf_inv`` lowers to), evaluated in numpy with each Horner step
  a fused multiply-add; numpy's ``log1p`` is not XLA's, so a draw may
  differ from ``jax.random.normal`` in the last ulps
  (``tests/test_torch_prng.py`` measures it).  :func:`normal_at` draws
  only the given flat indices: the value at index ``i`` depends on the
  key and ``i`` alone, so a subset equals the same entries of the whole
  draw bit for bit.

* ``split(k, num)`` hashes the counters ``(0, i)``, i < num, and key i
  is the pair of the two output words at i (the partitionable form's
  fold-like split).
* ``categorical(k, logits)`` is ``argmax(logits + gumbel)`` over the last
  axis, ``gumbel = −log(−log(u))`` with ``u`` the uniform on ``[tiny,
  1)`` from the same counters (``[0, 1)`` values times ``1 − tiny``,
  which rounds to 1, plus ``tiny``, clamped to it).  The bits and ``u``
  are the host's, bit for bit; the two logs run in torch on the logits'
  device, where they may differ from XLA's in the last ulp
  (``tests/test_torch_prng.py`` measures it).

Masks (``(n,)`` node masks, the ``(n, n)`` edge mask of
``core.dynamic.edge_mask``) depend only on seeds and the round index, so
drawing them on the host costs no device synchronisation.
"""
from __future__ import annotations

import numpy as np

__all__ = ["key", "fold_in", "split", "uniform", "normal", "normal_at",
           "categorical", "threefry2x32"]

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


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: ``(num, 2)`` uint32 keys."""
    out0, out1 = threefry2x32(k, np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
    return np.stack([out0, out1], axis=1)


def _shape_size(shape):
    shape = (int(shape),) if np.ndim(shape) == 0 else tuple(shape)
    size = int(np.prod(shape, dtype=np.int64))
    if size >= 2 ** 32:
        raise ValueError(f"a draw holds fewer than 2**32 values, got {size}")
    return shape, size


def _unit_floats(k: np.ndarray, index: np.ndarray) -> np.ndarray:
    """float32 in [0, 1) at the flat (uint32) counter indices ``index``."""
    b0, b1 = threefry2x32(k, np.zeros(index.shape, np.uint32), index)
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def uniform(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1); an int
    ``shape`` means ``(shape,)``."""
    shape, size = _shape_size(shape)
    return _unit_floats(k, np.arange(size, dtype=np.uint32)).reshape(shape)


# XLA's f32 erf_inv: degree-9 polynomials in w - 2.5 (w < 5) and
# sqrt(w) - 3 (w >= 5), w = -log1p(-x^2)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _erf_inv32(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = -np.log1p(-x * x)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    w64 = w.astype(np.float64)
    p = np.where(small, f32(_ERFINV_SMALL[0]), f32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, f32(a), f32(b)).astype(np.float64)
        # one rounding a step: the f64 product of two f32 values is exact
        p = (c + p.astype(np.float64) * w64).astype(f32)
    out = p * x
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max, out)


_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def normal_at(k: np.ndarray, index) -> np.ndarray:
    """The entries of ``normal(k, shape)`` at the flat indices ``index``
    (any shape of non-negative ints below 2**32), float32."""
    index = np.asarray(index)
    if index.size and (index.min() < 0 or index.max() >= 2 ** 32):
        raise ValueError("normal_at indices must lie in [0, 2**32)")
    u = _unit_floats(k, index.astype(np.uint32))
    # jax's uniform on (lo, 1): floats · (1 − lo) + lo, clamped to lo; the
    # range 1 − lo rounds to 2 in f32
    u = np.maximum(_NORMAL_LO, u * np.float32(2.0) + _NORMAL_LO)
    return np.float32(np.sqrt(2.0)) * _erf_inv32(u)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(k, shape)`` (float32) to within the last ulps
    of ``erf_inv``; an int ``shape`` means ``(shape,)``."""
    shape, size = _shape_size(shape)
    return normal_at(k, np.arange(size, dtype=np.int64)).reshape(shape)


_TINY = np.finfo(np.float32).tiny


def categorical(k: np.ndarray, logits):
    """``jax.random.categorical(k, logits)`` over the last axis of an f32
    torch tensor: the index of ``logits + gumbel``'s maximum (the first
    on a tie), int64 on the logits' device, of shape ``logits.shape[:-1]``.
    The uniform is drawn on the host (one threefry hash per logit) and
    copied to the device."""
    import torch

    if logits.dtype != torch.float32:
        raise TypeError(f"categorical: f32 logits expected, got "
                        f"{logits.dtype}")
    u = uniform(k, tuple(logits.shape))
    u = np.maximum(_TINY, u * (np.float32(1.0) - _TINY) + _TINY)
    u = torch.as_tensor(u, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
