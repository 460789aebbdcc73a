"""Cloud preprocessing pipeline (counterpart of ``depth_correction_tpu/
preproc.py``).

Reference pipeline helpers: src/depth_correction/preproc.py:14-244.

- host-side: depth + voxel-grid subsampling of raw scans
  (:func:`filtered_cloud`);
- neighbourhood establishment, routed by ``cfg.nn_backend`` as the JAX
  package routes it: ``'scipy'`` takes scipy's cKDTree on the host (the
  reference's index, :func:`_host_neighbors`), ``'native'`` the port's
  build of the C++ KD-tree (``utils/native.py``); otherwise kNN configs
  (``nn_k``) take the brute-force search (``ops/knn.py``, kernel X3 on the
  card), and radius configs take the grid-hash search (``ops/grid_hash.py``,
  kernel X2 on the card) when ``nn_backend == 'grid'`` or when
  ``nn_backend`` is None and the cloud has at least ``GRID_NN_MIN_POINTS``
  points, the brute search otherwise,
  with K sized by ``knn.suggest_k_max`` unless ``nn_max_neighbors`` caps
  it (:func:`_device_radius_neighbors`, :func:`establish_scan_neighbors`,
  :func:`establish_neighborhoods`); capped radius graphs keep only their
  mutual pairs (:func:`symmetrize_neighbors`);
- tensor-side: per-scan feature clouds (:func:`local_feature_cloud`,
  with the shadow filter over direction-space neighbourhoods),
  batched sequences of padded scans (:class:`SequenceBatch`), the corrected
  and posed global cloud (:func:`global_cloud`), and feature recomputation
  over frozen neighborhoods (:func:`compute_neighborhood_features`).

Scan sizes are padded to multiples of :data:`PAD_MULTIPLE`, as in the JAX
package, so the two packages build identical padded layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .cloud import Cloud
from .config import Config, NeighborhoodType
from .ops.features import compute_features
from .ops.grid_hash import GRID_NN_MIN_POINTS, grid_radius_neighbors
from .ops.knn import nearest_neighbors, radius_neighbors, suggest_k_max
from .ops.filters import (
    ball_angle_to_distance,
    filter_eigenvalue_ratios_mask,
    filter_eigenvalues_mask,
    filter_grid_indices,
    filter_shadow_mask,
)
from .ops.se3 import xyz_axis_angle_to_matrix

__all__ = [
    "PAD_MULTIPLE",
    "SequenceBatch",
    "compute_neighborhood_features",
    "corrected_poses",
    "establish_neighborhoods",
    "establish_scan_neighbors",
    "filtered_cloud",
    "flatten_batch",
    "global_cloud",
    "local_feature_cloud",
    "offset_cloud",
    "pad_size",
    "sequence_batch",
    "symmetrize_neighbors",
]

PAD_MULTIPLE = 512


def pad_size(n: int, multiple: int = PAD_MULTIPLE) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def _split_structured(arr: np.ndarray):
    from numpy.lib.recfunctions import structured_to_unstructured as s2u

    names = arr.dtype.names or ()
    pts = s2u(arr[["x", "y", "z"]], dtype=np.float64) if names else np.asarray(arr)
    vps = s2u(arr[["vp_x", "vp_y", "vp_z"]], dtype=np.float64) if "vp_x" in names else None
    normals = (
        s2u(arr[["normal_x", "normal_y", "normal_z"]], dtype=np.float64)
        if "normal_x" in names
        else None
    )
    return pts, vps, normals


def filtered_cloud(cloud, cfg: Config) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Depth-bounds + seeded random voxel-grid subsample of a raw scan
    (reference: preproc.py:25-32): a fresh generator seeded with
    ``cfg.random_seed`` per scan keeps the grid tie-breaks deterministic.

    :param cloud: structured array (x/y/z[/vp_*/normal_*]) or (N, 3) points.
    :return: (points, vps or None, normals or None) as numpy arrays.
    """
    if isinstance(cloud, np.ndarray) and cloud.dtype.names:
        pts, vps, normals = _split_structured(cloud)
    else:
        pts, vps, normals = np.asarray(cloud, dtype=np.float64), None, None
    depth = np.linalg.norm(pts - (vps if vps is not None else 0.0), axis=1)
    keep = np.ones(len(pts), dtype=bool)
    if cfg.min_depth is not None and cfg.min_depth > 0.0:
        keep &= depth >= cfg.min_depth
    if cfg.max_depth is not None and np.isfinite(cfg.max_depth):
        keep &= depth <= cfg.max_depth
    idx = np.flatnonzero(keep)
    if cfg.grid_res and cfg.grid_res > 0.0:
        rng = np.random.default_rng(cfg.random_seed)
        sub = filter_grid_indices(pts[idx], cfg.grid_res, keep="random", rng=rng)
        idx = idx[sub]
    return (
        pts[idx],
        vps[idx] if vps is not None else None,
        normals[idx] if normals is not None else None,
    )


def _native_neighbors(pts: np.ndarray, val: np.ndarray, cfg: Config,
                      k_max: Optional[int] = None) -> np.ndarray:
    """The native KD-tree's neighbours (JAX package, preproc.py:202-230):
    kNN with the radius as an upper bound, or the within-r sets nearest
    first, K from a counting pass rounded up to a multiple of 8 unless
    capped. Raises when the library does not build."""
    from .utils.native import KDTree

    idx_valid = np.flatnonzero(val)
    tree = KDTree(pts[idx_valid])
    if cfg.nn_k:
        _, ind = tree.query(pts, k=int(cfg.nn_k), distance_upper_bound=cfg.nn_r or -1.0)
    else:
        k = int(k_max or cfg.nn_max_neighbors or 0)
        if not k:
            # One counting pass to size K, then the real query.
            _, counts = tree.query_ball(pts[val], cfg.nn_r, 1)
            k = max(int(counts.max()), 1)
            k = -(-k // 8) * 8
        ind, _ = tree.query_ball(pts, cfg.nn_r, k)
    miss = ind < 0
    out = idx_valid[np.where(miss, 0, ind)]
    out[miss] = -1
    return out


def _host_neighbors(points, valid, cfg: Config, k_max: Optional[int] = None):
    """Neighbors from a host KD-tree: the port's build of the native C++
    library (``nn_backend='native'``, :func:`_native_neighbors`) or scipy's
    cKDTree (``'scipy'``, the reference's index, nearest_neighbors.py:22-80),
    as the JAX package's branch (preproc.py:202-262). Returns padded (N, K)
    int64 indices (-1 = none) and 0/1 weights in the dtype and on the device
    of ``points``."""
    from scipy.spatial import cKDTree

    pts_t = torch.as_tensor(points)
    pts = pts_t.detach().cpu().to(torch.float64).numpy()
    val = np.asarray(torch.as_tensor(valid).cpu())
    n = len(pts)
    if cfg.nn_backend == "native":
        out = _native_neighbors(pts, val, cfg, k_max)
        out[~val] = -1
        idx = torch.as_tensor(out, device=pts_t.device)
        return idx, (idx >= 0).to(pts_t.dtype)
    idx_valid = np.flatnonzero(val)
    tree = cKDTree(pts[idx_valid])
    if cfg.nn_k:
        kw = {"distance_upper_bound": cfg.nn_r} if cfg.nn_r else {}
        _, ind = tree.query(pts, k=int(cfg.nn_k), workers=-1, **kw)
        ind = ind.reshape(n, -1)  # (N,) for k=1
        miss = ind == tree.n
        ind = np.where(miss, 0, ind)
        out = idx_valid[ind]
        out[miss] = -1
    else:
        balls = tree.query_ball_point(pts, cfg.nn_r, workers=-1)
        k = k_max or cfg.nn_max_neighbors or max(
            (len(b) for b, v in zip(balls, val) if v), default=1
        )
        out = np.full((n, int(k)), -1, np.int64)
        for i, b in enumerate(balls):
            if val[i]:
                if len(b) > int(k):
                    # Keep the k NEAREST: query_ball_point's order is
                    # arbitrary, and an index-ordered cut would make the
                    # neighborhoods backend-dependent.
                    d2 = np.sum((pts[idx_valid[b]] - pts[i]) ** 2, axis=1)
                    b = [b[j] for j in np.argsort(d2, kind="stable")[: int(k)]]
                out[i, : len(b)] = idx_valid[b]
    out[~val] = -1
    idx = torch.as_tensor(out, device=pts_t.device)
    return idx, (idx >= 0).to(pts_t.dtype)


def _device_radius_neighbors(points, r: float, k: int, valid, backend=None):
    """The tensor-side radius engine (JAX package, preproc.py:278-289): the
    grid-hash search when ``backend == 'grid'`` or, with ``backend`` None,
    at ``GRID_NN_MIN_POINTS`` points and above; the brute search otherwise.
    Both are exact up to ``k``. Returns (dist, idx (N, k) int32)."""
    if backend == "grid" or (backend is None and points.shape[0] >= GRID_NN_MIN_POINTS):
        return grid_radius_neighbors(points, r=r, k=int(k), valid_points=valid,
                                     valid_query=valid)
    return radius_neighbors(points, r=r, k=int(k), valid_points=valid, valid_query=valid)


def establish_scan_neighbors(cloud: Cloud, cfg: Config):
    """Neighbor graph of a single cloud per config, kNN or ball radius
    (JAX package, preproc.py:292-314)."""
    points = cloud.get_points()
    if cfg.nn_backend in ("scipy", "native"):
        return _host_neighbors(points, cloud.valid, cfg)
    if cfg.nn_k:
        _, idx = nearest_neighbors(points, points, k=int(cfg.nn_k), r=cfg.nn_r or None,
                                   valid_points=cloud.valid, valid_query=cloud.valid)
    else:
        k = cfg.nn_max_neighbors or suggest_k_max(points, r=cfg.nn_r,
                                                  valid_points=cloud.valid)
        _, idx = _device_radius_neighbors(points, cfg.nn_r, k, cloud.valid,
                                          backend=cfg.nn_backend)
    return idx, (idx >= 0).to(points.dtype)


def local_feature_cloud(cloud, cfg: Config, pad_to: Optional[int] = None,
                        return_neighbors: bool = False):
    """Per-scan feature cloud: shadow filter, neighbors + mean/cov/eigh/
    normals/incidence angles + eigenvalue masks. ``mask`` marks the locally
    planar, correctable region the model applies to (reference:
    preproc.py:35-62). Computed in ``cfg.torch_dtype()`` on
    ``cfg.torch_device()``.

    :param return_neighbors: also return the scan's (neighbors, weights),
        which the loss offset re-evaluates under the current model
        (reference: preproc.py:67-77; JAX package, preproc.py:132-200).
    """
    dtype, device = cfg.torch_dtype(), cfg.torch_device()
    if isinstance(cloud, np.ndarray) and cloud.dtype.names:
        pts, vps, normals = _split_structured(cloud)
        cloud = Cloud.from_points(pts, vps=vps, normals=normals, dtype=dtype, device=device)
    elif isinstance(cloud, tuple):
        pts, vps, normals = cloud
        cloud = Cloud.from_points(pts, vps=vps, normals=normals, dtype=dtype, device=device)
    elif not isinstance(cloud, Cloud):
        cloud = Cloud.from_points(cloud, dtype=dtype, device=device)
    cloud = cloud.to(device=device, dtype=dtype)
    if cfg.shadow_angle_bounds:
        # Shadow-point removal over direction-space neighbourhoods (reference:
        # preproc.py:45-47; JAX package, preproc.py:163-171): the brute
        # search over the unit view directions, kernel X3 on the card.
        r_dir = ball_angle_to_distance(cfg.shadow_neighborhood_angle)
        k_dir = suggest_k_max(cloud.dirs, r=r_dir, valid_points=cloud.valid)
        _, dir_nn = radius_neighbors(cloud.dirs, r=r_dir, k=k_dir, valid_points=cloud.valid)
        dir_w = (dir_nn >= 0).to(dtype)
        shadow_ok = filter_shadow_mask(cloud, dir_nn, dir_w, cfg.shadow_angle_bounds)
        cloud = cloud.map(lambda x: x[shadow_ok])
    if pad_to is None:
        pad_to = pad_size(cloud.size)
    cloud = cloud.pad(pad_to)
    neighbors, weights = establish_scan_neighbors(cloud, cfg)
    # No Gaussian re-weighting here: the reference applies nn_scale to the
    # GLOBAL cloud only (preproc.py:184, 216).
    cloud = compute_features(cloud, neighbors, weights, scale=None)
    mask = cloud.valid
    if cfg.eigenvalue_bounds:
        mask = mask & filter_eigenvalues_mask(cloud.eigvals, cfg.eigenvalue_bounds)
    if cfg.eigenvalue_ratio_bounds:
        mask = mask & filter_eigenvalue_ratios_mask(cloud.eigvals, cfg.eigenvalue_ratio_bounds)
    out = cloud.replace(mask=mask)
    if return_neighbors:
        return out, neighbors, weights
    return out


@dataclasses.dataclass(frozen=True)
class SequenceBatch:
    """A sequence of S scans padded to a common width N: one (S, N, ...)
    Cloud plus (S, 4, 4) poses (reference: preproc.py:80-119 iterates
    lists; here per-scan work is batched)."""

    cloud: Cloud  # fields shaped (S, N, ...)
    poses: torch.Tensor  # (S, 4, 4)

    @property
    def num_scans(self) -> int:
        return self.poses.shape[0]

    def to(self, device=None, dtype=None) -> "SequenceBatch":
        return SequenceBatch(
            cloud=self.cloud.to(device=device, dtype=dtype),
            poses=self.poses.to(device=device, dtype=dtype or self.poses.dtype),
        )


def sequence_batch(clouds: Sequence[Cloud], poses) -> SequenceBatch:
    """Stack per-scan clouds (padding to the widest) with their poses."""
    n = max(pad_size(c.size) for c in clouds)
    padded = [c.pad(n) for c in clouds]
    fields = {}
    for f in dataclasses.fields(Cloud):
        xs = [getattr(c, f.name) for c in padded]
        fields[f.name] = None if any(x is None for x in xs) else torch.stack(xs)
    stacked = Cloud(**fields)
    poses = torch.as_tensor(np.asarray(poses), dtype=stacked.vps.dtype,
                            device=stacked.vps.device)
    return SequenceBatch(cloud=stacked, poses=poses)


def flatten_batch(cloud: Cloud) -> Cloud:
    """(S, N, ...) cloud -> (S*N, ...) global cloud."""
    return cloud.map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])))


def corrected_poses(poses: torch.Tensor, pose_deltas: Optional[torch.Tensor]):
    """poses @ delta(xyz_axis_angle) (reference: eval.py:68-82);
    ``pose_deltas`` (1, 6) broadcasts, (S, 6) is per pose."""
    if pose_deltas is None:
        return poses
    deltas = xyz_axis_angle_to_matrix(pose_deltas.to(poses.dtype))
    return poses @ deltas


def global_cloud(batch: SequenceBatch, model=None,
                 pose_deltas: Optional[torch.Tensor] = None) -> Cloud:
    """Depth-correct, pose-transform and merge a sequence into one global
    cloud (reference: preproc.py:80-119), batched over scans."""
    cloud = batch.cloud
    if model is not None:
        cloud = model.apply(cloud)
    transformed = cloud.transform(corrected_poses(batch.poses, pose_deltas))
    return flatten_batch(transformed).with_points()


def offset_cloud(batch: SequenceBatch, model=None) -> Cloud:
    """The sequence's local clouds, corrected by ``model`` and merged in
    their scan frames: the clouds of the loss offset (reference:
    preproc.py:67-77; JAX package, preproc.py:395-403)."""
    cloud = batch.cloud
    if model is not None:
        cloud = model.apply(cloud)
    return flatten_batch(cloud)


def symmetrize_neighbors(neighbors: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Keep only mutual pairs: (i, j) survives iff row j lists i too (JAX
    package, preproc.py:405-435). An uncapped radius graph is symmetric
    already; capping at ``nn_max_neighbors`` truncates one-sidedly, which
    makes the transpose in-degree up to ~5x the forward width. Each
    neighbour's own row is gathered back and compared, ``chunk`` rows at a
    time so the (chunk, K, K) block stays small.

    :param neighbors: (M, K) indices, -1 padded.
    :return: (M, K) of the same dtype, -1 where a pair is one-sided.
    """
    m = neighbors.shape[0]
    out = []
    for start in range(0, m, chunk):
        c = neighbors[start:start + chunk]
        rows = torch.arange(start, start + c.shape[0], device=c.device, dtype=c.dtype)
        back = neighbors[c.clamp(min=0).long()]  # (C, K, K)
        mutual = (back == rows[:, None, None]).any(-1) & (c >= 0)
        out.append(torch.where(mutual, c, torch.full_like(c, -1)))
    if not out:
        return neighbors.clone()
    return torch.cat(out)


def establish_neighborhoods(gcloud: Cloud, cfg: Config, k_max: Optional[int] = None,
                            mesh=None):
    """Frozen neighborhoods of the global cloud (reference:
    preproc.py:168-191, ball type; JAX package, preproc.py:513-568 on one
    device), computed once per training run and routed as the module
    docstring says. A radius graph truncated by a cap keeps its mutual
    pairs only (``nn_symmetrize``, JAX package, preproc.py:561-564); pure
    kNN stays one-sided. Plane neighbourhoods (``nn_type = 'plane'``; JAX
    package, preproc.py:499-512; reference: preproc.py:186-191) are the
    RANSAC planes of :func:`segmentation.fit_planes` (``min_support =
    min_valid_neighbors``, at most ``max_neighborhoods`` or 10 models,
    clustered at ``eps = 2 sqrt(3) grid_res``, seeded by ``random_seed``,
    its integer draws 64 bits wide for a float64 cloud and 32 otherwise),
    oriented toward the viewpoints.

    With ``mesh`` (a ``parallel.DataMesh``; JAX package, preproc.py:
    533-560) the device searches split the queries over the ranks and
    gather the tables back: kNN through ``knn.nearest_neighbors_sharded``,
    radius graphs through ``grid_hash.grid_radius_neighbors_sharded``
    whatever the cloud's size; the host searches and the planes run whole
    on every rank.

    :return: (neighbors (M, K) int32 or, from a host KD-tree, int64;
        weights (M, K) float), or for planes (:class:`segmentation.Planes`,
        None).
    """
    if cfg.nn_type == NeighborhoodType.plane:
        from .segmentation import fit_planes

        planes = fit_planes(
            gcloud, cfg.ransac_dist_thresh, min_support=cfg.min_valid_neighbors,
            max_iterations=cfg.num_ransac_iters, max_models=cfg.max_neighborhoods or 10,
            eps=2.0 * np.sqrt(3.0) * cfg.grid_res, seed=cfg.random_seed)
        return planes.orient(gcloud.vps), None
    capped = bool((k_max or cfg.nn_max_neighbors) and not cfg.nn_k)
    points = gcloud.get_points()
    if cfg.nn_backend in ("scipy", "native"):
        idx, _ = _host_neighbors(points, gcloud.valid, cfg, k_max=k_max)
    elif cfg.nn_k:
        kw = dict(k=int(cfg.nn_k), r=cfg.nn_r or None, valid_points=gcloud.valid,
                  valid_query=gcloud.valid)
        if mesh is not None:
            from .ops.knn import nearest_neighbors_sharded

            _, idx = nearest_neighbors_sharded(points, points, mesh=mesh, **kw)
        else:
            _, idx = nearest_neighbors(points, points, **kw)
    else:
        k = k_max or cfg.nn_max_neighbors or suggest_k_max(points, r=cfg.nn_r,
                                                           valid_points=gcloud.valid)
        if mesh is not None:
            from .ops.grid_hash import grid_radius_neighbors_sharded

            _, idx = grid_radius_neighbors_sharded(points, r=cfg.nn_r, k=int(k),
                                                   valid_points=gcloud.valid,
                                                   valid_query=gcloud.valid, mesh=mesh)
        else:
            _, idx = _device_radius_neighbors(points, cfg.nn_r, k, gcloud.valid,
                                              backend=cfg.nn_backend)
    if capped and cfg.nn_symmetrize:
        idx = symmetrize_neighbors(idx)
    return idx, (idx >= 0).to(points.dtype)


def compute_neighborhood_features(gcloud: Cloud, neighbors, weights, cfg: Config,
                                  compute_normals: bool = False) -> Cloud:
    """Neighborhood statistics over frozen neighborhoods
    (reference: preproc.py:195-217); normals skipped by default."""
    return compute_features(gcloud, neighbors, weights, scale=cfg.nn_scale,
                            compute_normals=compute_normals)
