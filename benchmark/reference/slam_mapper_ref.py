"""Plain reference of the SLAM-drift evaluation's scan-to-map mapper: each
scan's corrected feature cloud (``slam_ref.feature_cloud``) registers by
point-to-plane ICP against a voxel map of the scans before it, then merges
into the map, in plain torch. Imports nothing of the program.

Follows the documented semantics of the program's ``slam_mapper``: the
first scan placed at the first prior makes the map; each later scan starts
from the previous estimate times the priors' increment, runs ``n_iters``
steps of ``slam_ref``'s ICP against the map (its points and normals in the
world), and merges into it posed at its estimate. A merge keys
``[map; scan]``'s rows by floor(p / voxel) in float64 and keeps the first
row of each voxel (old map rows before the scan's), the kept rows in
ascending order. Past ``map_capacity`` rows it keeps the capacity rows
nearest the scan's estimated position (the first prior's at the first
scan), in ascending order.

Departures from the program:

- float64 throughout (``precision`` as in ``slam_ref``); the program runs
  in the clouds' float type;
- the merge sorts the three keys and the row's rank lexicographically
  (four stable sorts); the program packs the keys into one int64;
- the eviction is a full stable sort of the float64 distances; the
  program takes ``topk``. Rows tied at the capacity's edge may differ;
- the nearest search sweeps the queries in blocks along x against the map
  rows within ``SEARCH_BOUND`` of the block's x-range, in column chunks
  that keep a block's distances under ``PAIR_BUDGET`` (a 4,096-query block
  against a 524,288-row map would take 17 GB in float64). Each query's
  nearest is chosen by the expanded form |c|^2 - 2 q.c about the block's
  mean, in float64 in every precision (its rounding, ~1e-13 m^2 in a
  72 m scene, decides only near-ties); the chosen pair's distance is then
  taken directly in the working precision. A correspondence farther than
  ``SEARCH_BOUND`` counts as an outlier, as in ``slam_ref``; the program's
  search (X3) has no bound;
- normals are rotated by the estimate's rotation alone (``slam_ref``'s
  odometry subtracts the translation again).

``keep="last"`` and ``map_capacity=None`` (no eviction) are faults for
``calibrate.py``: a mapper that should fail the comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from . import slam_ref
from .common import dtype_of, round_tf32

__all__ = ["mapper", "merge", "nearest", "voxel_keys"]

SEARCH_BOUND = slam_ref.SEARCH_BOUND
QUERY_BLOCK = 1024
PAIR_BUDGET = 1 << 26  # distances a chunk: 512 MB in float64


def voxel_keys(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """(N, 3) int64: floor(p / voxel), a true division in float64."""
    res = torch.tensor(voxel, dtype=torch.float64, device=points.device)
    return torch.floor(points.to(torch.float64) / res).to(torch.int64)


def merge(map_pts, map_normals, pts, normals, voxel: float, capacity, center,
          keep: str = "first"):
    """``[map; scan]`` thinned to one row a voxel (the first, or with
    ``keep="last"`` the last), then past ``capacity`` the rows nearest
    ``center`` (float64 (3,)): (points, normals, rows evicted)."""
    P, N = torch.cat([map_pts, pts]), torch.cat([map_normals, normals])
    n = P.shape[0]
    k = voxel_keys(P, voxel)
    rank = torch.arange(n, device=P.device)
    o = torch.argsort(rank if keep == "first" else -rank, stable=True)
    for col in (2, 1, 0):
        o = o[torch.argsort(k[o, col], stable=True)]
    ks = k[o]
    new = torch.ones(n, dtype=torch.bool, device=P.device)
    new[1:] = (ks[1:] != ks[:-1]).any(1)
    kept = torch.sort(o[new]).values
    P, N = P[kept], N[kept]
    evicted = 0
    if capacity is not None and P.shape[0] > capacity:
        d2 = ((P.to(torch.float64) - center) ** 2).sum(1)
        sel = torch.sort(torch.argsort(d2, stable=True)[:capacity]).values
        evicted = P.shape[0] - capacity
        P, N = P[sel], N[sel]
    return P, N, evicted


def nearest(src: torch.Tensor, tgt: torch.Tensor):
    """Each source point's nearest target point within SEARCH_BOUND:
    (distance, index), inf and -1 beyond."""
    order = torch.argsort(tgt[:, 0])
    ts = tgt[order]
    t64 = ts.to(torch.float64)
    xs = t64[:, 0].contiguous()
    so = torch.argsort(src[:, 0])
    dist = torch.full((src.shape[0],), float("inf"), dtype=src.dtype, device=src.device)
    idx = torch.full((src.shape[0],), -1, dtype=torch.int64, device=src.device)
    cols = max(1, PAIR_BUDGET // QUERY_BLOCK)
    for b in range(0, src.shape[0], QUERY_BLOCK):
        qi = so[b:b + QUERY_BLOCK]
        q = src[qi].to(torch.float64)
        lo = int(torch.searchsorted(xs, q[:, 0].min() - SEARCH_BOUND))
        hi = int(torch.searchsorted(xs, q[:, 0].max() + SEARCH_BOUND, right=True))
        if hi <= lo:
            continue
        mu = q.mean(0)
        qc = q - mu
        best = torch.full((q.shape[0],), float("inf"), dtype=torch.float64, device=q.device)
        arg = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
        for c0 in range(lo, hi, cols):
            c = t64[c0:min(hi, c0 + cols)] - mu
            m, j = torch.addmm((c * c).sum(1)[None, :], qc, c.T, alpha=-2.0).min(1)
            better = m < best
            best = torch.where(better, m, best)
            arg = torch.where(better, j + c0, arg)
        s, c = src[qi], ts[arg]
        d2 = ((s[:, 0] - c[:, 0]) ** 2 + (s[:, 1] - c[:, 1]) ** 2 + (s[:, 2] - c[:, 2]) ** 2)
        near = d2 <= SEARCH_BOUND ** 2
        dist[qi] = torch.where(near, d2.sqrt(), dist[qi])
        idx[qi] = torch.where(near, order[arg], idx[qi])
    return dist, idx


def icp(src_pts, tgt_pts, tgt_normals, T0, n_iters: int, inlier_ratio: float,
        precision: str = "float64") -> torch.Tensor:
    """``slam_ref.icp`` with :func:`nearest` as its search."""
    def tf(x):
        return round_tf32(x, precision).to(x.dtype)

    T = T0.clone()
    for _ in range(n_iters):
        s = slam_ref._transform(T, src_pts, precision)
        d, i = nearest(s, tgt_pts)
        thr = slam_ref._quantile(d, inlier_ratio)
        w = ((i >= 0) & (d <= thr)).to(s.dtype)
        i = i.clamp(min=0)
        q, n = tgt_pts[i], tgt_normals[i]
        r = (n * (q - s)).sum(-1)
        J = torch.cat([torch.linalg.cross(s, n), n], -1)
        Jw = tf(J * w[:, None])
        H = Jw.T @ tf(J) + 1e-9 * torch.eye(6, dtype=s.dtype, device=s.device)
        dx = torch.linalg.solve(H, Jw.T @ tf(r))
        delta = torch.eye(4, dtype=s.dtype, device=s.device)
        delta[:3, :3] = slam_ref._rotation(dx[:3])
        delta[:3, 3] = dx[3:]
        T = delta @ T
    return T


def _posed(T, cloud: dict, precision: str):
    R = round_tf32(T[:3, :3], precision).to(T.dtype)
    normals = round_tf32(cloud["normals"], precision).to(T.dtype) @ R.T
    return slam_ref._transform(T, cloud["points"].to(T.dtype), precision), normals


def mapper(clouds: list, priors: np.ndarray, n_iters: int = 8, inlier_ratio: float = 0.8,
           map_voxel: float = 0.1, map_capacity=1 << 19, precision: str = "float64",
           keep: str = "first") -> dict:
    """Scan-to-map ICP over ``slam_ref.feature_cloud`` clouds: ``poses``
    (S, 4, 4) float64, the final map's ``points`` and ``normals``, ``work``
    (each registration's (queries, map rows)) and ``evicted`` (the rows
    each merge's eviction dropped, one entry a scan)."""
    dev = clouds[0]["points"].device
    dt = dtype_of(precision)
    est = [np.asarray(priors[0], np.float64)]
    T = torch.as_tensor(est[0], dtype=dt, device=dev)
    map_pts, map_normals, ev = merge(
        *(torch.zeros((0, 3), dtype=dt, device=dev),) * 2, *_posed(T, clouds[0], precision),
        map_voxel, map_capacity, torch.as_tensor(est[0][:3, 3], device=dev), keep)
    work, evicted = [], [ev]
    for k in range(1, len(clouds)):
        prior = est[-1] @ np.linalg.inv(priors[k - 1]) @ priors[k]
        work.append((int(clouds[k]["points"].shape[0]), int(map_pts.shape[0])))
        T = icp(clouds[k]["points"].to(dt), map_pts, map_normals,
                torch.as_tensor(prior, dtype=dt, device=dev), n_iters, inlier_ratio, precision)
        est.append(T.cpu().numpy().astype(np.float64))
        map_pts, map_normals, ev = merge(map_pts, map_normals, *_posed(T, clouds[k], precision),
                                         map_voxel, map_capacity, T[:3, 3].to(torch.float64),
                                         keep)
        evicted.append(ev)
    return {"poses": np.stack(est), "points": map_pts, "normals": map_normals, "work": work,
            "evicted": evicted}
