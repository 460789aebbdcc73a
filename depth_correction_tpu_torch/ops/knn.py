"""Brute-force neighbour search over padded point arrays (counterpart of
``depth_correction_tpu/ops/knn.py``): the online corrector's small-scan
engine, establishment below ``GRID_NN_MIN_POINTS`` points, and the sizing
of K (:func:`suggest_k_max`).

A running top-k over tiles of 2048 points per chunk of 8192 queries, with
squared distances by direct (query - point) differences: the expansion
|q|^2 - 2 q.p + |p|^2 cancels in float32 at the radius boundary. Ties keep
the lower index, as ``lax.top_k`` does, so both packages return the same
neighbour sets. Missing neighbours are index -1 at distance ``inf``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["nearest_neighbors", "neighbor_counts", "radius_neighbors", "suggest_k_max"]

_TILE = 2048  # points per tile of the running top-k
_QUERY_CHUNK = 8192  # queries per chunk


def _knn_tiled(points, query, valid_points, k: int, tile: int = _TILE):
    """Running top-k over point tiles (JAX package, knn.py:51-97).

    :param points: (N, 3) reference points, N a multiple of ``tile``.
    :param query: (Q, 3) queries.
    :param valid_points: (N,) bool.
    :return: (d2 (Q, k) ascending, idx (Q, k) int64, -1 where d2 is inf).
    """
    q = query
    inf = torch.full((), float("inf"), dtype=q.dtype, device=q.device)
    best_d2 = torch.full((q.shape[0], k), float("inf"), dtype=q.dtype, device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
    cols = torch.arange(tile, device=q.device)
    for start in range(0, points.shape[0], tile):
        diff = q[:, None, :] - points[None, start:start + tile, :]
        d2 = (diff * diff).sum(-1)
        d2 = torch.where(valid_points[None, start:start + tile], d2, inf)
        cat_d2 = torch.cat([best_d2, d2], 1)
        cat_i = torch.cat([best_i, (start + cols).expand(q.shape[0], tile)], 1)
        # A stable sort keeps the lower index among equal distances, as
        # lax.top_k does (the running best precedes the tile, and indices
        # grow along both).
        best_d2, order = torch.sort(cat_d2, dim=1, stable=True)
        best_d2 = best_d2[:, :k]
        best_i = torch.gather(cat_i, 1, order[:, :k])
    best_i = torch.where(torch.isinf(best_d2), torch.full_like(best_i, -1), best_i)
    return best_d2, best_i


def _finish_knn(d2, idx, r, valid_query):
    """Radius cut, invalid-query masking, ``inf``-safe sqrt."""
    inf = torch.full((), float("inf"), dtype=d2.dtype, device=d2.device)
    minus = torch.full_like(idx, -1)
    if r is not None:
        within = d2 <= torch.full((), r, dtype=d2.dtype, device=d2.device) ** 2
        idx = torch.where(within, idx, minus)
        d2 = torch.where(within, d2, inf)
    if valid_query is not None:
        idx = torch.where(valid_query[:, None], idx, minus)
        d2 = torch.where(valid_query[:, None], d2, inf)
    missing = torch.isinf(d2)
    d = torch.sqrt(torch.where(missing, torch.zeros_like(d2), d2))
    return torch.where(missing, inf, d), idx


def nearest_neighbors(points, query=None, k: int = 1, r: Optional[float] = None,
                      valid_points=None, valid_query=None,
                      tile: int = _TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of ``query`` in ``points``; with ``r``, those
    farther than ``r`` are dropped (index -1, distance ``inf``), like
    cKDTree's ``distance_upper_bound`` (reference:
    nearest_neighbors.py:22-80).

    :return: (dist (Q, k) ascending, idx (Q, k) int32, -1 padded).
    """
    query = points if query is None else query
    dtype = torch.promote_types(points.dtype, query.dtype)
    points, query = points.to(dtype), query.to(dtype)
    n = points.shape[0]
    if valid_points is None:
        valid_points = torch.ones(n, dtype=torch.bool, device=points.device)
    pad = (-n) % tile
    if pad:
        points = torch.cat([points, points.new_zeros((pad, 3))])
        valid_points = torch.cat([valid_points, valid_points.new_zeros(pad)])
    parts = [_knn_tiled(points, query[i:i + _QUERY_CHUNK], valid_points, k, tile)
             for i in range(0, query.shape[0], _QUERY_CHUNK)]
    d2 = torch.cat([p[0] for p in parts])
    idx = torch.cat([p[1] for p in parts])
    d, idx = _finish_knn(d2, idx, r, valid_query)
    return d, idx.to(torch.int32)


def radius_neighbors(points, query=None, r: float = 1.0, k: int = 32,
                     valid_points=None, valid_query=None,
                     tile: int = _TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` nearest neighbours within radius ``r`` (JAX package,
    knn.py:241-268): the reference's ``query_ball_point`` sets whenever
    ``k`` is at least the largest within-r count."""
    return nearest_neighbors(points, query, k=k, r=r, valid_points=valid_points,
                             valid_query=valid_query, tile=tile)


def neighbor_counts(points, query=None, r: float = 1.0, valid_points=None,
                    tile: int = _TILE) -> torch.Tensor:
    """Number of valid points within ``r`` of each query (JAX package,
    knn.py:268-300): tiles of 2048 points per chunk of 8192 queries, int32."""
    query = points if query is None else query
    dtype = torch.promote_types(points.dtype, query.dtype)
    points, query = points.to(dtype), query.to(dtype)
    if valid_points is None:
        valid_points = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    r2 = torch.full((), r, dtype=dtype, device=points.device) ** 2
    parts = []
    for i in range(0, query.shape[0], _QUERY_CHUNK):
        q = query[i:i + _QUERY_CHUNK]
        counts = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
        for start in range(0, points.shape[0], tile):
            # Summed x, y, z, as kernel X2 sums them, so the counts size K
            # by the membership the grid search decides.
            p = points[start:start + tile]
            dx = q[:, None, 0] - p[None, :, 0]
            dy = q[:, None, 1] - p[None, :, 1]
            dz = q[:, None, 2] - p[None, :, 2]
            d2 = dx * dx + dy * dy + dz * dz
            inside = (d2 <= r2) & valid_points[None, start:start + tile]
            counts += inside.sum(1, dtype=torch.int32)
        parts.append(counts)
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=points.device)
    return torch.cat(parts)


def suggest_k_max(points, query=None, r: float = 1.0, valid_points=None,
                  cap: Optional[int] = None, multiple: int = 8,
                  quantile: float = 1.0) -> int:
    """Smallest K, rounded up to ``multiple``, that holds every radius
    neighbourhood, optionally capped or sized by a ``quantile`` of the
    counts (JAX package, knn.py:303-348). Counts through the grid engine
    (kernel X2 on the card) at ``GRID_NN_MIN_POINTS`` points and above,
    the tiled count below, as the JAX package routes them."""
    from .grid_hash import GRID_NN_MIN_POINTS, grid_neighbor_counts

    if points.shape[0] >= GRID_NN_MIN_POINTS:
        counts = grid_neighbor_counts(points, query, r=r, valid_points=valid_points)
    else:
        counts = neighbor_counts(points, query, r, valid_points)
    counts = counts.cpu().numpy()
    if counts.size == 0:
        k = 1
    elif quantile >= 1.0:
        k = int(counts.max())
    else:
        k = int(np.quantile(counts, quantile))
    k = max(k, 1)
    k = int(-(-k // multiple) * multiple)
    if cap is not None:
        k = min(k, cap)
    return k
