"""Point-cloud filters (counterpart of ``depth_correction_tpu/ops/filters.py``).

Mask-producing filters (reference: src/depth_correction/filters.py:8-309):
filters AND boolean masks instead of shrinking tensors. The voxel-grid
subsample, which genuinely reduces the point count, runs host-side in numpy
during dataset preprocessing, with the same seeded generator as the JAX
package, so both packages keep the same points.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = [
    "filter_depth_mask",
    "filter_eigenvalue_ratios_mask",
    "filter_eigenvalues_mask",
    "filter_grid_indices",
    "filter_grid_mask",
    "filter_valid_neighbors_mask",
    "global_cloud_mask",
    "within_bounds",
]


def within_bounds(x: torch.Tensor, lo=None, hi=None, bounds=None) -> torch.Tensor:
    """Mask of lo <= x <= hi; None / non-finite bounds are open
    (reference: filters.py:85-113)."""
    if bounds is not None:
        lo, hi = bounds
    keep = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if lo is not None and lo == lo and lo > -float("inf"):  # lo==lo filters NaN
        keep = keep & (x >= lo)
    if hi is not None and hi == hi and hi < float("inf"):
        keep = keep & (x <= hi)
    return keep


def filter_depth_mask(cloud, lo=None, hi=None) -> torch.Tensor:
    """Depth-bounds mask (reference: filters.py:116-141)."""
    return within_bounds(cloud.depth, lo, hi) & cloud.valid


_INT32_MIN = -(2 ** 31)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's-complement wraparound."""
    return ((x - _INT32_MIN) & 0xFFFFFFFF) + _INT32_MIN


def filter_grid_mask(points: torch.Tensor, valid: torch.Tensor, grid_res: float,
                     seed: int = 135, table_size: Optional[int] = None) -> torch.Tensor:
    """Voxel-grid subsample as a mask, on the points' device: one winner
    per hash slot, the point of lowest seeded random rank (the masked
    analogue of ``keep='random'``; JAX package, filters.py:89-130).

    The hash is the JAX package's, with int32 wraparound: the products of
    the voxel coordinates with 73856093, 19349663 and 83492791, XORed,
    ``abs % table_size`` (``table_size = max(4n, 1024)``). Distinct voxels
    that collide in a slot share one winner. Ranks are
    ``jax.random.uniform(PRNGKey(seed), (n,))`` bit for bit
    (:mod:`.prng`), in float64 for float64 points and float32 otherwise:
    the JAX package draws them in its default float type, which is float64
    where x64 is enabled (as for its float64 clouds) and float32 where it is
    not. Invalid rows rank ``inf`` and never win.
    """
    from .prng import uniform

    n = points.shape[0]
    if table_size is None:
        table_size = max(4 * n, 1024)
    # A true division, as in JAX: CUDA divides by a Python scalar as a
    # multiply by its reciprocal, which can move a point across a voxel face.
    res = torch.full((), grid_res, dtype=points.dtype, device=points.device)
    cell = torch.floor(points / res).to(torch.int64)
    h = _wrap_int32((cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663)
                    ^ (cell[:, 2] * 83492791))
    # abs() of int32 min stays int32 min; the floor modulo makes it positive.
    slot = torch.where(h == _INT32_MIN, h, h.abs()) % table_size
    rank_dtype = torch.float64 if points.dtype == torch.float64 else torch.float32
    rank = uniform(seed, n, rank_dtype, points.device)
    rank = torch.where(valid, rank, torch.full_like(rank, float("inf")))
    # Winner = first of each slot's run in (slot, rank, index) order: two
    # stable sorts, minor key first.
    by_rank = torch.argsort(rank, stable=True)
    order = by_rank[torch.argsort(slot[by_rank], stable=True)]
    s_slot = slot[order]
    first = torch.ones(n, dtype=torch.bool, device=points.device)
    first[1:] = s_slot[1:] != s_slot[:-1]
    win = torch.zeros(n, dtype=torch.bool, device=points.device)
    win[order] = first & torch.isfinite(rank[order])
    return valid & win


def filter_grid_indices(points: np.ndarray, grid_res: float, keep: str = "random",
                        rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Host-side voxel-grid subsample: indices of one point per cell.

    Reference semantics (filters.py:24-82): voxel key = floor(x / res); the
    representative is the first / a seeded-random / the last point of the
    cell. Vectorized with lexsort instead of a Python dict.
    """
    assert keep in ("first", "random", "last")
    pts = np.asarray(points, dtype=np.float64)
    keys = np.floor(pts / grid_res).astype(np.int64)
    order = np.arange(len(keys))
    if keep == "first":
        rank = order
    elif keep == "last":
        rank = order[::-1].copy()
    else:
        rng = rng or np.random.default_rng(135)
        rank = rng.permutation(len(keys))
    # Group by voxel; within each voxel keep the entry with the lowest rank.
    sort_idx = np.lexsort((rank, keys[:, 2], keys[:, 1], keys[:, 0]))
    k_sorted = keys[sort_idx]
    new_cell = np.ones(len(k_sorted), dtype=bool)
    new_cell[1:] = np.any(k_sorted[1:] != k_sorted[:-1], axis=1)
    return np.sort(sort_idx[new_cell])


def filter_valid_neighbors_mask(neighbors, weights, min_neighbors: int):
    """Keep points with enough valid neighbors (reference: filters.py:184-193)."""
    return (weights > 0).sum(-1) >= min_neighbors


def filter_eigenvalues_mask(eigvals: torch.Tensor, bounds) -> torch.Tensor:
    """AND of eigenvalue-bound masks (reference: filters.py:196-221);
    ``bounds`` is a list of [eig_index, lo, hi], NaN bounds open."""
    eigvals = eigvals.detach()
    keep = torch.ones(eigvals.shape[:-1], dtype=torch.bool, device=eigvals.device)
    for i, lo, hi in bounds or []:
        keep = keep & within_bounds(eigvals[..., i], lo, hi)
    return keep


def filter_eigenvalue_ratios_mask(eigvals: torch.Tensor, bounds) -> torch.Tensor:
    """AND of eigenvalue-ratio masks (reference: filters.py:224-254);
    ``bounds`` is a list of [i, j, lo, hi] bounding eig_i / eig_j."""
    eigvals = eigvals.detach()
    keep = torch.ones(eigvals.shape[:-1], dtype=torch.bool, device=eigvals.device)
    for i, j, lo, hi in bounds or []:
        ratio = eigvals[..., i] / torch.clamp(eigvals[..., j], min=1e-30)
        keep = keep & within_bounds(ratio, lo, hi)
    return keep


_NOT_PORTED_BOUNDS = (
    "dir_dispersion_bounds",
    "vp_dispersion_bounds",
    "vp_dispersion_to_depth2_bounds",
    "vp_dist_to_depth_bounds",
)


def global_cloud_mask(cloud, neighbors, weights, cfg,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Composite trainable-region mask of the global cloud
    (reference: src/depth_correction/preproc.py:122-164): valid-neighbor
    count and eigenvalue(-ratio) bounds, ANDed with any carried-over local
    mask. The viewpoint / direction dispersion bounds are not ported yet."""
    for name in _NOT_PORTED_BOUNDS:
        if getattr(cfg, name, None):
            raise NotImplementedError("%s is not ported yet" % name)
    if mask is None:
        mask = torch.ones(cloud.size, dtype=torch.bool, device=cloud.valid.device)
    mask = mask & cloud.valid
    if cfg.min_valid_neighbors:
        mask = mask & filter_valid_neighbors_mask(neighbors, weights,
                                                  cfg.min_valid_neighbors)
    if cfg.eigenvalue_bounds:
        mask = mask & filter_eigenvalues_mask(cloud.eigvals, cfg.eigenvalue_bounds)
    if cfg.eigenvalue_ratio_bounds:
        mask = mask & filter_eigenvalue_ratios_mask(cloud.eigvals,
                                                    cfg.eigenvalue_ratio_bounds)
    return mask
