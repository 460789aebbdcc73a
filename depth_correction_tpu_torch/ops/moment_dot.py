"""The moment product's precision probe (P2) and the TF32 split.

Counterpart of the Pallas probe ``scripts/exp_mosaic_dot_probe.py``: on
each of ``n_tiles`` grid steps, sum over spans s the product a[s] @ b[s] of
(16, S) float32 features and an (S, 128) right-hand side that is exactly
{0, 1}. The kernel is ``csrc/moment_dot.cu``; on CPU tensors the wrapper
runs :func:`moment_dot_plain`.

Precisions (:data:`PRECISIONS`) and the TPU variants they stand for
(:data:`TPU_VARIANTS`): ``fp32`` float32 FMAs without tensor cores
(``highest``); ``tf32`` one TF32 tensor-core pass of trunc(a)
(``default``); ``tf32x2`` two passes, hi + mid (``split2_cast``,
``split2_bits``); ``tf32x3`` three passes, hi + mid + lo, exact for
float32 (``split3_bits``). The split truncates with an integer mask
(:func:`tf32_trunc`), so the code defines every operand's rounding and the
plain version repeats it in any float dtype.
"""
from __future__ import annotations

import torch

from . import _kernels

__all__ = ["PRECISIONS", "TPU_VARIANTS", "moment_dot", "moment_dot_plain", "tf32_split",
           "tf32_trunc"]

PRECISIONS = ("fp32", "tf32", "tf32x2", "tf32x3")
TPU_VARIANTS = {"highest": "fp32", "default": "tf32", "split2_cast": "tf32x2",
                "split2_bits": "tf32x2", "split3_bits": "tf32x3"}
R = 128

# Keep sign, exponent and the top 10 mantissa bits (TF32), by dtype.
_TF32_MASKS = {torch.float32: (torch.int32, -(1 << 13)),
               torch.float64: (torch.int64, -(1 << 42))}


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x truncated toward zero to TF32's 10 mantissa bits, in x's dtype
    (float32: ``x & 0xFFFFE000``, as csrc/tf32_mma.cuh does)."""
    if x.dtype not in _TF32_MASKS:
        raise TypeError("tf32_trunc takes float32 or float64, got %s" % x.dtype)
    itype, mask = _TF32_MASKS[x.dtype]
    return (x.view(itype) & mask).view(x.dtype)


def tf32_split(x: torch.Tensor, prec: str) -> list:
    """The TF32 components the kernels multiply for precision ``prec``:
    [x] for fp32; hi = trunc(x), then mid = trunc(x - hi), then
    lo = trunc(x - hi - mid), as many as ``prec`` has passes."""
    if prec not in PRECISIONS:
        raise ValueError("unknown precision %r (precisions: %s)"
                         % (prec, ", ".join(PRECISIONS)))
    if prec == "fp32":
        return [x]
    comps, rem = [], x
    for _ in range(PRECISIONS.index(prec)):
        hi = tf32_trunc(rem)
        comps.append(hi)
        rem = rem - hi
    return comps


def moment_dot_plain(a, b, n_tiles: int, prec: str):
    """Plain torch version of P2 in the dtype of ``a``: (16, 128 n_tiles),
    every tile's columns sum_s a[s] @ b[s] over the components of ``a``
    (b truncated to TF32 too, except for fp32), each tile's product
    computed on its own as the kernel's blocks compute theirs.

    :param a: (ns, 16, S); :param b: (ns, S, 128).
    """
    ns, rows, s_len = a.shape
    k = ns * s_len
    bb = b if prec == "fp32" else tf32_trunc(b)
    rhs = bb.reshape(k, R).expand(n_tiles, k, R)
    out = sum(torch.bmm(c.permute(1, 0, 2).reshape(rows, k).expand(n_tiles, rows, k), rhs)
              for c in tf32_split(a, prec))  # (n_tiles, 16, R)
    return out.permute(1, 0, 2).reshape(rows, n_tiles * R)


def _prec_id(prec: str) -> int:
    if prec not in PRECISIONS:
        raise ValueError("unknown precision %r (precisions: %s)"
                         % (prec, ", ".join(PRECISIONS)))
    return PRECISIONS.index(prec)


def moment_dot(a, b, n_tiles: int, prec: str):
    """P2 wrapper: the CUDA kernel for CUDA tensors (float32 only; anything
    else raises), :func:`moment_dot_plain` for CPU tensors."""
    prec_id = _prec_id(prec)
    if a.device.type == "cpu":
        return moment_dot_plain(a, b, n_tiles, prec)
    return _kernels.launch_moment_dot(prec_id, a, b, n_tiles)
