"""Point-cloud filters (counterpart of ``depth_correction_tpu/ops/filters.py``).

Mask-producing filters (reference: src/depth_correction/filters.py:8-309):
filters AND boolean masks instead of shrinking tensors. The voxel-grid
subsample, which genuinely reduces the point count, runs host-side in numpy
during dataset preprocessing, with the same seeded generator as the JAX
package, so both packages keep the same points. Its first-wins form on the
device (:func:`grid_first_mask`, :func:`mask_indices`) is the SLAM mapper's
merge.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .features import dir_dispersion, mean_depth, mean_vp_dist, vp_dispersion

__all__ = [
    "ball_angle_to_distance",
    "filter_depth_mask",
    "filter_eigenvalue_ratios_mask",
    "filter_eigenvalues_mask",
    "filter_grid_indices",
    "filter_grid_mask",
    "filter_shadow_mask",
    "filter_valid_neighbors_mask",
    "global_cloud_mask",
    "grid_first_mask",
    "mask_indices",
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


# A voxel key packed into one int64: 21 bits an axis, each biased by 2^20.
# The last value of an axis is left unused, so no packed key reaches
# _NO_KEY, which marks rows that take no part.
_KEY_BITS = 21
_KEY_BIAS = 1 << (_KEY_BITS - 1)
_NO_KEY = torch.iinfo(torch.int64).max


def grid_first_mask(points: torch.Tensor, grid_res: float, valid: torch.Tensor):
    """``filter_grid_indices(points[valid], grid_res, keep="first")`` on the
    points' device, with no host read: a mask of the first valid row of
    each voxel. The voxel is floor(p / grid_res) in float64 with a true
    division (the host's voxels, bit for bit); the three keys are packed
    into one int64 whose order is the host's lexicographic order, and one
    stable sort groups the rows of a voxel in row order.

    :return: (mask (N,) bool, a 0-d bool that is True where some valid
        row's voxel lies outside the packed range, ±2^20 voxels an axis,
        or is not finite; the mask then means nothing).
    """
    res = torch.full((), grid_res, dtype=torch.float64, device=points.device)
    cell = torch.floor(points.to(torch.float64) / res)
    ok = ((cell >= -_KEY_BIAS) & (cell < _KEY_BIAS - 1)).all(1)
    c = torch.where(ok[:, None], cell, 0.0).to(torch.int64) + _KEY_BIAS
    key = (c[:, 0] << (2 * _KEY_BITS)) | (c[:, 1] << _KEY_BITS) | c[:, 2]
    key = torch.where(valid, key, _NO_KEY)
    sorted_key, order = torch.sort(key, stable=True)
    first = torch.ones_like(valid)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    first &= sorted_key != _NO_KEY
    keep = torch.empty_like(first)
    keep[order] = first
    return keep, (valid & ~ok).any()


def mask_indices(mask: torch.Tensor, count: int) -> torch.Tensor:
    """``torch.nonzero(mask)[:, 0]`` given the mask's count (known on the
    host), with no host read: each set row scattered to its rank, the
    others to one spare slot past the end."""
    rank = torch.cumsum(mask, 0) - 1
    out = torch.empty(count + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, torch.where(mask, rank, count),
                 torch.arange(mask.shape[0], device=mask.device))
    return out[:count]


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


def ball_angle_to_distance(angle, radius: float = 1.0) -> float:
    """Chord length subtending ``angle`` on the unit sphere (reference:
    nearest_neighbors.py:13-19; JAX package, filters.py:178-184): turns an
    angular neighbourhood of view directions into a Euclidean radius."""
    angle = min(max(float(angle), 0.0), math.pi)
    return radius * math.sqrt(2.0 * (1.0 - math.cos(angle)))


def filter_shadow_mask(cloud, dir_neighbors, dir_weights, angle_bounds) -> torch.Tensor:
    """Shadow-point (veiling-point) removal (reference: filters.py:257-309;
    JAX package, filters.py:187-218): for each point x with viewpoint o and
    direction-space neighbours n, the angles between (o - x) and (n - x)
    must lie within ``angle_bounds``; points seen edge-on at depth
    discontinuities make extreme angles and are dropped."""
    lo = angle_bounds[0] if angle_bounds and angle_bounds[0] == angle_bounds[0] else 0.0
    hi = (angle_bounds[1] if len(angle_bounds) > 1 and angle_bounds[1] == angle_bounds[1]
          else math.pi)
    lo = max(lo or 0.0, 0.0)
    hi = min(hi if hi is not None else math.pi, math.pi)

    x = cloud.get_points()
    ox = cloud.vps - x  # (N, 3)
    nx = x[dir_neighbors.long().clamp(min=0)] - x[:, None, :]  # (N, K, 3)
    cos = (ox[:, None, :] * nx).sum(-1)
    denom = torch.linalg.norm(ox, dim=-1)[:, None] * torch.linalg.norm(nx, dim=-1)
    cos = cos / torch.clamp(denom, min=1e-20)
    a = torch.arccos(torch.clamp(cos, -1.0, 1.0))
    # Invalid neighbour slots sit at mid-bounds (filters.py:292-294).
    a = torch.where(dir_weights > 0, a, torch.full_like(a, (lo + hi) / 2.0))
    return (a.amin(-1) >= lo) & (a.amax(-1) <= hi) & cloud.valid


def global_cloud_mask(cloud, neighbors, weights, cfg,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Composite trainable-region mask of the global cloud
    (reference: src/depth_correction/preproc.py:122-164; JAX package,
    filters.py:221-260): valid-neighbor count, eigenvalue(-ratio) bounds,
    and the viewpoint / direction dispersion bounds, ANDed with any
    carried-over local mask. The two dispersions are kernel P7's moments
    of the neighbours' viewpoints and directions on the card."""
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
    if cfg.dir_dispersion_bounds:
        dd = dir_dispersion(cloud, neighbors, weights)
        mask = mask & within_bounds(dd, *cfg.dir_dispersion_bounds[:2])
    if cfg.vp_dispersion_bounds:
        vd = vp_dispersion(cloud, neighbors, weights)
        mask = mask & within_bounds(vd, *cfg.vp_dispersion_bounds[:2])
    if cfg.vp_dispersion_to_depth2_bounds:
        vd = vp_dispersion(cloud, neighbors, weights)
        md = mean_depth(cloud, neighbors, weights)
        ratio = vd / torch.clamp(md, min=1e-20) ** 2
        mask = mask & within_bounds(ratio, *cfg.vp_dispersion_to_depth2_bounds[:2])
    if cfg.vp_dist_to_depth_bounds:
        vp = mean_vp_dist(cloud, neighbors, weights)
        md = mean_depth(cloud, neighbors, weights)
        ratio = vp / torch.clamp(md, min=1e-20)
        mask = mask & within_bounds(ratio, *cfg.vp_dist_to_depth_bounds[:2])
    return mask
