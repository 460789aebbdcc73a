"""Masked reductions and quantiles (counterpart of ``depth_correction_tpu/
ops/reduce.py``).

Where the reference drops elements by boolean indexing
(reference: src/depth_correction/loss.py:125-150), an explicit mask is
carried, so shapes stay static and masked-out NaN/inf never reach a sum.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import trace

__all__ = ["masked_mean", "masked_quantile", "masked_sum", "reduce_loss"]


def _sum(x, axis):
    return x.sum() if axis is None else x.sum(axis)


def masked_sum(x: torch.Tensor, mask: Optional[torch.Tensor], axis=None):
    if mask is None:
        return _sum(x, axis)
    return _sum(torch.where(mask, x, torch.zeros_like(x)), axis)


def masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor], axis=None,
                weights: Optional[torch.Tensor] = None):
    """Mean over unmasked elements; 0 when nothing is unmasked."""
    if weights is None:
        weights = torch.ones_like(x)
    if mask is not None:
        weights = torch.where(mask, weights, torch.zeros_like(weights))
    denom = _sum(weights, axis)
    # Zero masked entries before multiplying: 0 * inf would poison the sum.
    x_safe = torch.where(weights > 0, x, torch.zeros_like(x))
    num = _sum(weights * x_safe, axis)
    return torch.where(denom > 0, num / torch.clamp(denom, min=1e-30),
                       torch.zeros_like(num))


def masked_quantile(x: torch.Tensor, mask: Optional[torch.Tensor], q: float):
    """Quantile of the unmasked subset of a 1-D tensor, by linear
    interpolation between order statistics (``torch.quantile`` semantics;
    reference: loss.py:256-267). Masked entries sort to +inf. The two
    order statistics' positions are read on the host (one counted sync)."""
    x = x.reshape(-1)
    valid = (torch.ones_like(x, dtype=torch.bool) if mask is None
             else mask.reshape(-1))
    xs = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf")))).values
    n = valid.sum()
    pos = q * torch.clamp(n - 1, min=0).to(x.dtype)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.to(x.dtype)
    last = x.shape[0] - 1
    i_lo, i_hi = trace.to_host(torch.stack([lo, hi]).clamp(0, last)).tolist()
    v_lo, v_hi = xs[i_lo], xs[i_hi]
    return v_lo * (1.0 - frac) + v_hi * frac


def reduce_loss(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                reduction: str = "mean", only_finite: bool = False,
                skip_nans: bool = False):
    """Reduce pointwise losses under a mask (reference: loss.py:125-150);
    ``only_finite`` / ``skip_nans`` extend the mask instead of dropping
    elements. Returns (reduced value, effective mask)."""
    eff = mask
    if only_finite:
        fin = torch.isfinite(x)
        eff = fin if eff is None else (eff & fin)
    elif skip_nans:
        notnan = ~torch.isnan(x)
        eff = notnan if eff is None else (eff & notnan)
    if reduction == "mean":
        return masked_mean(x, eff), eff
    if reduction == "sum":
        return masked_sum(x, eff), eff
    if reduction == "none":
        return x, eff
    raise ValueError("Unknown reduction: %s" % reduction)
