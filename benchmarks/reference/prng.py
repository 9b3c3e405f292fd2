"""JAX's default random stream in NumPy, for the BRIEF pair table: a
frozen copy of the threefry-2x32 draws behind
``jax.random.normal(jax.random.PRNGKey(seed), shape)`` (float32): the raw
key (0, seed), the partitionable counter stream, the uniform mantissa
trick and XLA's single-precision ``erf_inv``.  A few normals can differ
from JAX's by an ulp (XLA fuses some products into FMAs); the table,
rounded to integers, does not.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's ErfInv32 coefficients (Giles' single-precision approximation),
# highest order first; the two sets split at w = -log1p(-x^2) < 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def prng_key(seed: int) -> np.ndarray:
    """(2,) uint32: the raw key of ``jax.random.PRNGKey(seed)`` (JAX's
    default 32-bit mode: the high word is 0, the low word the seed's
    two's-complement bits)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1`` under
    the (2,) uint32 ``key``; uint32 arithmetic wraps."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = x[0] ^ _rotl(x[1], r)
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """uint32 words of ``jax.random.bits(key, shape)`` (32-bit,
    partitionable threefry)."""
    n = int(np.prod(shape, dtype=np.int64))
    counts = np.arange(n, dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 ``jax.random.uniform(key, shape, minval=, maxval=)``."""
    lo = np.float32(minval)
    hi = np.float32(maxval)
    bits = random_bits(key, shape)
    mant = (bits >> np.uint32(32 - 23)) | np.float32(1.0).view(np.uint32)
    floats = mant.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 inverse error function on float32 ``x`` in (-1, 1)."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, np.float32(_ERFINV_SMALL[0]),
                 np.float32(_ERFINV_LARGE[0])).astype(np.float32)
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, np.float32(cs), np.float32(cl))
        p = (c + p * w).astype(np.float32)
    return p * x


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """float32 ``jax.random.normal(key, shape)``, up to an ulp (see the
    module docstring)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * erf_inv(u)
