"""Brute-force neighbour search over padded point arrays (counterpart of
``depth_correction_tpu/ops/knn.py``): the online corrector's small-scan
engine, establishment below ``GRID_NN_MIN_POINTS`` points, the shadow
filter's search over view directions, and the sizing of K
(:func:`suggest_k_max`).

For each query, the k smallest keys (squared distance, point index) over
the valid points, with squared distances by direct (query - point)
differences (the expansion |q|^2 - 2 q.p + |p|^2 cancels in float32 at the
radius boundary), summed ``dx*dx + dy*dy + dz*dz`` with each operation
rounded on its own. Ties keep the lower index, as ``lax.top_k`` does, so
both packages return the same neighbour sets. Missing neighbours are index
-1 at distance ``inf``.

On CUDA tensors the search is kernel X3 (``csrc/knn_brute.cu``: with a
radius, points and queries ordered by cell and each warp of queries
reading only the tiles of points within r of its box; at k = 1 with no
radius, both ordered on the points' grid and each warp reading the tiles
around its queries' places in the point order, then those within each
query's nearest distance so far; a top-k past its shared memory takes the
warp-per-query body, ``csrc/knn_warp.cu``); on CPU
tensors, or with ``plain=True`` on any
device and dtype, its plain twins :func:`_knn_plain` and
:func:`_counts_plain`: a running top-k over tiles of 2048 points per chunk
of 8192 queries, the JAX package's loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels

__all__ = ["knn_d2", "nearest_neighbors", "nearest_neighbors_sharded",
           "neighbor_counts", "radius_neighbors", "suggest_k_max"]

_TILE = 2048  # points per tile of the plain running top-k
_QUERY_CHUNK = 8192  # queries per chunk of the plain loops


def _d2(q, p):
    """(Q, T) squared distances of (Q, 3) queries to (T, 3) points, summed
    x, y, z with each operation rounded on its own (the kernels' order)."""
    dx = q[:, None, 0] - p[None, :, 0]
    dy = q[:, None, 1] - p[None, :, 1]
    dz = q[:, None, 2] - p[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _knn_tiled(points, query, valid_points, r2, k: int):
    """Running top-k over point tiles (JAX package, knn.py:51-97), keeping
    only points within ``r2``.

    :param points: (N, 3) reference points.
    :param query: (Q, 3) queries.
    :param valid_points: (N,) bool.
    :param r2: 0-d tensor, the squared radius (``inf``: none).
    :return: (d2 (Q, k) ascending, idx (Q, k) int64, -1 where d2 is inf).
    """
    q = query
    inf = torch.full((), float("inf"), dtype=q.dtype, device=q.device)
    best_d2 = torch.full((q.shape[0], k), float("inf"), dtype=q.dtype, device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
    for start in range(0, points.shape[0], _TILE):
        d2 = _d2(q, points[start:start + _TILE])
        d2 = torch.where(valid_points[None, start:start + _TILE] & (d2 <= r2), d2, inf)
        if k == 1:
            # The same keys by a running minimum: min returns the first of
            # equal distances in the tile, and a tile replaces the running
            # best only when strictly nearer.
            tile_d2, tile_i = d2.min(1, keepdim=True)
            nearer = tile_d2 < best_d2
            best_d2 = torch.where(nearer, tile_d2, best_d2)
            best_i = torch.where(nearer, tile_i + start, best_i)
            continue
        cols = torch.arange(start, start + d2.shape[1], device=q.device)
        cat_d2 = torch.cat([best_d2, d2], 1)
        cat_i = torch.cat([best_i, cols.expand(q.shape[0], -1)], 1)
        # A stable sort keeps the lower index among equal distances, as
        # lax.top_k does (the running best precedes the tile, and indices
        # grow along both).
        best_d2, order = torch.sort(cat_d2, dim=1, stable=True)
        best_d2 = best_d2[:, :k]
        best_i = torch.gather(cat_i, 1, order[:, :k])
    best_i = torch.where(torch.isinf(best_d2), torch.full_like(best_i, -1), best_i)
    return best_d2, best_i


def _knn_plain(points, query, valid_points, valid_query, r2, k: int):
    """Plain twin of kernel X3's top-k: (d2 (Q, k), idx (Q, k) int32), the
    k nearest valid points within ``r2`` by (d2, index), inf / -1 padded,
    all padding for a query that ``valid_query`` (or None) marks invalid."""
    parts = [_knn_tiled(points, query[i:i + _QUERY_CHUNK], valid_points, r2, k)
             for i in range(0, query.shape[0], _QUERY_CHUNK)]
    if parts:
        d2 = torch.cat([p[0] for p in parts])
        idx = torch.cat([p[1] for p in parts]).to(torch.int32)
    else:
        d2 = query.new_zeros((0, k))
        idx = torch.zeros((0, k), dtype=torch.int32, device=query.device)
    if valid_query is not None:
        d2 = torch.where(valid_query[:, None], d2, torch.full_like(d2, float("inf")))
        idx = torch.where(valid_query[:, None], idx, torch.full_like(idx, -1))
    return d2, idx


def _counts_plain(points, query, valid_points, r2):
    """Plain twin of kernel X3's counts (JAX package, knn.py:268-300):
    the valid points within ``r2`` of every query, int32."""
    parts = []
    for i in range(0, query.shape[0], _QUERY_CHUNK):
        q = query[i:i + _QUERY_CHUNK]
        counts = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
        for start in range(0, points.shape[0], _TILE):
            inside = (_d2(q, points[start:start + _TILE]) <= r2) & \
                valid_points[None, start:start + _TILE]
            counts += inside.sum(1, dtype=torch.int32)
        parts.append(counts)
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=points.device)
    return torch.cat(parts)


_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


def _prepare(points, query, valid_points, r):
    """(points, query, valid_points, r2): the common float type, every point
    valid by default, and r2 = r * r rounded in that type as a float (inf
    without ``r``), computed on the host: a search on the card pays no
    tensor op for it."""
    query = points if query is None else query
    dtype = torch.promote_types(points.dtype, query.dtype)
    points, query = points.to(dtype), query.to(dtype)
    if valid_points is None:
        valid_points = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    if r is None:
        r2 = float("inf")
    elif dtype in _NP_FLOAT:
        r2 = float(_NP_FLOAT[dtype](r) * _NP_FLOAT[dtype](r))
    else:
        r2 = float(torch.full((), r, dtype=dtype) ** 2)
    return points, query, valid_points, r2


def knn_d2(points, query=None, k: int = 1, r: Optional[float] = None, valid_points=None,
           valid_query=None, plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared distances and indices of the k nearest valid points within
    ``r`` (all of them without ``r``): kernel X3 on CUDA tensors (float32,
    no gradient), its plain twin on CPU tensors or with ``plain``.

    :return: (d2 (Q, k) ascending, idx (Q, k) int32), inf / -1 padded, all
        padding for an invalid query.
    """
    points, query, valid_points, r2 = _prepare(points, query, valid_points, r)
    if plain or points.device.type == "cpu":
        return _knn_plain(points, query, valid_points, valid_query,
                          torch.tensor(r2, dtype=points.dtype, device=points.device), int(k))
    return _kernels.launch_knn_brute(query, valid_query, points, valid_points, r2, int(k))



def _finish_knn(d2, idx, r, valid_query):
    """Radius cut, invalid-query masking, ``inf``-safe sqrt (JAX package,
    knn.py:149-163)."""
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
                      plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours of ``query`` in ``points``; with ``r``, those
    farther than ``r`` are dropped (index -1, distance ``inf``), like
    cKDTree's ``distance_upper_bound`` (reference:
    nearest_neighbors.py:22-80). Kernel X3 on CUDA tensors; ``plain`` takes
    the plain twin on any device and dtype.

    :return: (dist (Q, k) ascending, idx (Q, k) int32, -1 padded).
    """
    d2, idx = knn_d2(points, query, k, r, valid_points, valid_query, plain)
    return _finish_knn(d2, idx, r, valid_query)


def nearest_neighbors_sharded(points, query=None, k: int = 1, r: Optional[float] = None,
                              valid_points=None, valid_query=None, mesh=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nearest_neighbors` with the queries split over the ranks of
    ``mesh`` (a ``parallel.DataMesh``; JAX package, knn.py:177-240): each
    rank searches its slice against the whole point table (kernel X3 on
    the card) and the (Q, k) tables are all-gathered in query order, bit
    for bit those of the single search (a query's k nearest do not depend
    on the other queries)."""
    from ..parallel.collectives import gather_query_slices, query_slice

    q = points if query is None else query
    nq = q.shape[0]
    lo, hi, per = query_slice(nq, mesh)
    vq = None if valid_query is None else valid_query[lo:hi]
    d, idx = nearest_neighbors(points, q[lo:hi], k, r, valid_points, vq)
    return gather_query_slices((d, idx), nq, per, mesh, (float("inf"), -1))


def radius_neighbors(points, query=None, r: float = 1.0, k: int = 32,
                     valid_points=None, valid_query=None,
                     plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` nearest neighbours within radius ``r`` (JAX package,
    knn.py:241-268): the reference's ``query_ball_point`` sets whenever
    ``k`` is at least the largest within-r count."""
    return nearest_neighbors(points, query, k=k, r=r, valid_points=valid_points,
                             valid_query=valid_query, plain=plain)


def neighbor_counts(points, query=None, r: float = 1.0, valid_points=None,
                    plain: bool = False) -> torch.Tensor:
    """Number of valid points within ``r`` of each query (JAX package,
    knn.py:268-300), int32: kernel X3 in counts mode on CUDA tensors, the
    plain twin on CPU tensors or with ``plain``. Summed x, y, z, as kernels
    X2 and X3 sum them, so the counts size K by the membership the searches
    decide."""
    points, query, valid_points, r2 = _prepare(points, query, valid_points, r)
    if plain or points.device.type == "cpu":
        return _counts_plain(points, query, valid_points,
                             torch.tensor(r2, dtype=points.dtype, device=points.device))
    return _kernels.launch_knn_brute(query, None, points, valid_points, r2, 0)


def suggest_k_max(points, query=None, r: float = 1.0, valid_points=None,
                  cap: Optional[int] = None, multiple: int = 8,
                  quantile: float = 1.0) -> int:
    """Smallest K, rounded up to ``multiple``, that holds every radius
    neighbourhood, optionally capped or sized by a ``quantile`` of the
    counts (JAX package, knn.py:303-348). Counts through the grid engine
    (kernel X2 on the card) at ``GRID_NN_MIN_POINTS`` points and above,
    the brute count (kernel X3 on the card) below, as the JAX package
    routes them."""
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
