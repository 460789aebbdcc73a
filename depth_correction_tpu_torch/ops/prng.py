"""Threefry-2x32 uniform floats without JAX.

The JAX package's voxel-grid mask ranks points with
``jax.random.uniform(jax.random.PRNGKey(seed), (n,))``
(depth_correction_tpu/ops/filters.py:115). This module computes the same
values bit for bit in numpy ``uint32`` arithmetic, so the port keeps the
same points. It follows JAX's partitionable threefry stream (the default
of jax 0.9, ``jax_threefry_partitionable``):

- the key of an integer seed is ``(seed >> 32, seed & 0xFFFFFFFF)``;
- element ``i`` of a flat shape hashes the counter pair ``(0, i)`` with
  Threefry-2x32 (20 rounds) into ``(b1, b2)``;
- 32-bit draws are ``b1 ^ b2``; 64-bit draws are ``b1 << 32 | b2``;
- a float keeps the top mantissa bits of the draw under the exponent of
  1.0, giving ``[1, 2)``, minus 1.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["random_bits", "threefry2x32", "uniform"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 hash of the counter pairs ``(x0, x1)`` under ``key``
    (two uint32); JAX's ``threefry2x32_p`` (jax/_src/prng.py)."""
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


def random_bits(seed: int, n: int, bits: int = 32) -> np.ndarray:
    """``n`` draws of ``bits`` (32 or 64) random bits from the key of
    ``seed``, as ``jax.random.bits(jax.random.PRNGKey(seed), (n,))``."""
    seed = int(np.int64(seed).view(np.uint64))
    key = (seed >> 32, seed & 0xFFFFFFFF)
    count = np.arange(n, dtype=np.uint64)
    b1, b2 = threefry2x32(key, (count >> np.uint64(32)).astype(np.uint32),
                          (count & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    if bits == 32:
        return b1 ^ b2
    if bits == 64:
        return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    raise ValueError("bits must be 32 or 64, got %r" % bits)


def _uniform_np(seed: int, n: int, dtype: str) -> np.ndarray:
    if dtype == "float32":
        mant = (random_bits(seed, n, 32) >> np.uint32(9)) | np.uint32(0x3F800000)
        return mant.view(np.float32) - np.float32(1.0)
    mant = (random_bits(seed, n, 64) >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
    return mant.view(np.float64) - 1.0


_CACHE: dict = {}


def uniform(seed: int, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype)`` as a
    torch tensor: float32 (JAX's default without x64) or float64 (its
    default with x64). A stream corrects scans of one padded size, so the
    tensor is cached per (seed, n, dtype, device)."""
    name = {torch.float32: "float32", torch.float64: "float64"}.get(dtype)
    if name is None:
        raise TypeError("uniform draws float32 or float64, not %s" % dtype)
    device = torch.device(device if device is not None else "cpu")
    key = (int(seed), int(n), name, str(device))
    out = _CACHE.get(key)
    if out is None:
        if len(_CACHE) >= 8:
            _CACHE.pop(next(iter(_CACHE)))
        out = torch.from_numpy(_uniform_np(int(seed), int(n), name)).to(device)
        _CACHE[key] = out
    return out
