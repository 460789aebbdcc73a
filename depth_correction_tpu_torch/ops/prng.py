"""Threefry-2x32 keys, bits, uniform floats and integers without JAX.

The JAX package's voxel-grid mask ranks points with
``jax.random.uniform(jax.random.PRNGKey(seed), (n,))``
(depth_correction_tpu/ops/filters.py:115), and its plane RANSAC samples
point triples with ``jax.random.randint(key, (H, 3), 0, n)``
(depth_correction_tpu/segmentation.py:37). This module computes the same
values bit for bit in numpy unsigned arithmetic, so the port keeps the same
points and the same hypotheses. It follows JAX's partitionable threefry
stream (the default of jax 0.9, ``jax_threefry_partitionable``):

- the key of an integer seed is ``(seed >> 32, seed & 0xFFFFFFFF)``
  (:func:`PRNGKey`);
- element ``i`` of a flat shape hashes the counter pair
  ``(i >> 32, i & 0xFFFFFFFF)`` with Threefry-2x32 (20 rounds) into
  ``(b1, b2)``;
- 32-bit draws are ``b1 ^ b2``; 64-bit draws are ``b1 << 32 | b2``
  (:func:`random_bits`);
- ``split(key, n)`` hashes the counters ``0 .. n-1`` the same way and
  takes ``(b1, b2)`` of each as a new key;
- a float keeps the top mantissa bits of the draw under the exponent of
  1.0, giving ``[1, 2)``, minus 1 (:func:`uniform`);
- an integer in ``[minval, maxval)`` combines two draws of the split key
  with JAX's ``span`` / ``multiplier`` remainder arithmetic (:func:`randint`).

The draws' width is JAX's integer width: 64 bits under ``jax_enable_x64``,
32 bits without it. The port has no such flag, so the caller names it
(the JAX package's float64 runs have x64 on, its float32 runs off).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRNGKey", "randint", "random_bits", "split", "threefry2x32", "uniform"]

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


def PRNGKey(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` as a pair of Python ints (uint32)."""
    seed = int(np.int64(seed).view(np.uint64))
    return (seed >> 32, seed & 0xFFFFFFFF)


def _as_key(key) -> tuple:
    if isinstance(key, (int, np.integer)):
        return PRNGKey(int(key))
    k0, k1 = key
    return (int(k0), int(k1))


def _hash_counts(key, shape):
    """Threefry of the flat counters of ``shape``: (b1, b2) uint32."""
    n = int(np.prod(shape, dtype=np.int64))
    count = np.arange(n, dtype=np.uint64)
    b1, b2 = threefry2x32(_as_key(key), (count >> np.uint64(32)).astype(np.uint32),
                          (count & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return b1.reshape(shape), b2.reshape(shape)


def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)``: ``num`` new keys, each a pair of ints."""
    b1, b2 = _hash_counts(key, (int(num),))
    return [(int(a), int(b)) for a, b in zip(b1, b2)]


def random_bits(key, shape, bits: int = 32) -> np.ndarray:
    """Draws of ``bits`` (32 or 64) random bits of ``shape`` (an int or a
    tuple) under ``key`` (a key pair, or an integer seed for
    ``PRNGKey(seed)``), as ``jax.random.bits(key, shape)``: uint32 or
    uint64."""
    shape = (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(shape)
    b1, b2 = _hash_counts(key, shape)
    if bits == 32:
        return b1 ^ b2
    if bits == 64:
        return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    raise ValueError("bits must be 32 or 64, got %r" % bits)


def randint(key, shape, minval: int, maxval: int, bits: int = 32) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` with JAX's integer
    of ``bits`` bits (64 under ``jax_enable_x64``, else 32), bit for bit
    (jax 0.9 ``_randint``, jax/_src/random.py:581-657): the key splits in
    two, each half draws ``bits`` bits (higher, lower), and
    ``minval + ((hi % span) * mult + lo % span) % span`` in wrapping
    unsigned arithmetic, with ``span = maxval - minval`` (1 where
    ``maxval <= minval``) and ``mult = (2**(bits/2) % span)**2 % span``.
    Returns int32 or int64 of ``shape``."""
    if bits not in (32, 64):
        raise ValueError("bits must be 32 or 64, got %r" % bits)
    sdt, udt = (np.int32, np.uint32) if bits == 32 else (np.int64, np.uint64)
    info = np.iinfo(sdt)
    lo_v = int(np.clip(int(minval), info.min, info.max))
    hi_v = int(np.clip(int(maxval), info.min, info.max))
    k1, k2 = split(key, 2)
    higher = random_bits(k1, shape, bits)
    lower = random_bits(k2, shape, bits)
    span = udt(1) if hi_v <= lo_v else udt((hi_v - lo_v) % (1 << bits))
    # maxval past the dtype's largest value widens the span by one (JAX's
    # maxval_out_of_range); wrapping to 0 makes the remainders below no-ops.
    if int(maxval) > info.max and hi_v > lo_v:
        span = udt((int(span) + 1) % (1 << bits))
    with np.errstate(over="ignore", divide="ignore"):
        sp = np.full(np.shape(higher), span, udt)
        safe = np.where(sp == 0, udt(1), sp)  # span 0: JAX's rem by 0 leaves x
        rem = lambda x: np.where(sp == 0, x, x % safe)  # noqa: E731
        mult = rem(np.full_like(sp, udt(1 << (bits // 2))))
        mult = rem(mult * mult)
        offset = rem(rem(higher) * mult + rem(lower))
    return (np.asarray(lo_v, sdt) + offset.astype(sdt)).astype(sdt)


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
