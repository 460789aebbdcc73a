"""JAX's partitionable Threefry-2x32 uniform draws in numpy (a frozen copy
of the program's ``ops/prng.py``, uniform floats only), which the node's
voxel-grid filter ranks points with: ``jax.random.uniform(PRNGKey(seed),
(n,))`` bit for bit. The configuration's float32 runs draw float32."""
from __future__ import annotations

import numpy as np

__all__ = ["uniform"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(key, x0, x1):
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _bits(seed: int, n: int, width: int):
    s = int(np.int64(seed).view(np.uint64))
    key = (s >> 32, s & 0xFFFFFFFF)
    count = np.arange(n, dtype=np.uint64)
    b1, b2 = _threefry2x32(key, (count >> np.uint64(32)).astype(np.uint32),
                           (count & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    if width == 32:
        return b1 ^ b2
    return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)


def uniform(seed: int, n: int, dtype: str = "float32") -> np.ndarray:
    """``n`` draws in [0, 1) of ``dtype``: the draw's top mantissa bits
    under the exponent of 1.0, minus 1."""
    with np.errstate(over="ignore"):
        if dtype == "float32":
            mant = (_bits(seed, n, 32) >> np.uint32(9)) | np.uint32(0x3F800000)
            return mant.view(np.float32) - np.float32(1.0)
        mant = (_bits(seed, n, 64) >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
        return mant.view(np.float64) - 1.0
