"""Weighted neighbourhood statistics: mean, covariance and trace
(counterpart of ``depth_correction_tpu/ops/covs.py``).

Masked-weight equivalents of the reference's ``covs``
(reference: src/depth_correction/utils.py:109-149): neighbourhoods are
fixed-shape (..., K, D) gathers where missing slots carry zero weight.

- the normaliser is the weight sum (the valid-neighbour count for 0/1
  weights);
- Bessel's correction subtracts 1 from the weight sum;
- the corrected normaliser is clamped at 1e-6 from below.

The weighted product is a plain batched product (``torch.einsum``); TF32
is off for the package, so float32 products keep full precision.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["trace3", "weighted_cov", "weighted_mean"]


def weighted_mean(x: torch.Tensor, weights: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Weighted mean over the neighbour axis: (..., K, D) values and
    (..., K) or (..., K, 1) weights -> (..., D)."""
    if weights.dim() == x.dim():
        weights = weights[..., 0]
    w_sum = weights.sum(-1, keepdim=True)
    m = (weights[..., None] * x).sum(-2)
    return m / torch.clamp(w_sum, min=eps)


def weighted_cov(x: torch.Tensor, weights: Optional[torch.Tensor] = None, center: bool = True,
                 correction: bool = True, mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted covariance over the neighbour axis:
    sum_k w_k (x_k - m)(x_k - m)^T / max(sum_k w_k - correction, 1e-6).

    :param x: (..., K, D) values.
    :param weights: (..., K) or (..., K, 1); None weighs every slot 1.
    :param center: subtract the weighted mean first.
    :param correction: Bessel's -1 on the normaliser (reference:
        utils.py:143-147).
    :param mean: a precomputed (..., D) mean to reuse.
    :return: (..., D, D).
    """
    if weights is None:
        weights = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    elif weights.dim() == x.dim():
        weights = weights[..., 0]
    weights = weights.to(x.dtype)
    w_sum = weights.sum(-1)
    if center:
        if mean is None:
            mean = weighted_mean(x, weights)
        xc = x - mean[..., None, :]
    else:
        xc = x
    xx = torch.einsum("...ki,...kj->...ij", xc * weights[..., None], xc)
    denom = w_sum - 1.0 if correction else w_sum
    return xx / torch.clamp(denom, min=1e-6)[..., None, None]


def trace3(cov: torch.Tensor) -> torch.Tensor:
    """Trace of (..., 3, 3) matrices (reference: utils.py:152-154)."""
    return cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]
