"""Plane segmentation: batched RANSAC and voxel-graph clustering
(counterpart of ``depth_correction_tpu/segmentation.py``).

The reference fits planes one RANSAC at a time in PCL or Open3D
(reference: src/depth_correction/segmentation.py:95-293). Here every
hypothesis of a RANSAC is scored at once on the device: the plane-point
distances are one (N, 3) @ (3, H) product, and the winner has the most
inliers (the first of equal counts, as ``torch.argmax`` and JAX's
``argmax`` both return). The hypotheses' point triples are drawn on the
host by :func:`ops.prng.randint`, bit for bit the JAX package's
``jax.random.randint``, and copied to the device. The fit-remove loop and
the contiguity filter (a voxel-connectivity union-find standing in for
Open3D's DBSCAN, segmentation.py:166-178) stay on the host, as in the JAX
package: they are control flow over a handful of models.

The distance block of a full-width cloud (390,144 points x 500
hypotheses) is 780 MB of float32, so the scoring runs over chunks of
hypotheses of at most :data:`SCORE_BLOCK` elements; inlier counts are
integer sums, so the chunking changes no result.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .cloud import Cloud
from .ops.prng import PRNGKey, randint

__all__ = [
    "Planes",
    "SCORE_BLOCK",
    "cluster_voxel_graph",
    "compute_plane_features",
    "fit_plane_ransac",
    "fit_planes",
    "plane_neighborhood_features",
    "ransac_indices",
]

# Largest (points x hypotheses) distance block scored at once.
SCORE_BLOCK = 1 << 26


def ransac_indices(n: int, num_hypotheses: int, seed: int, bits: int = 32) -> np.ndarray:
    """The hypotheses' point triples, (H, 3) int64: the JAX package's
    ``jax.random.randint(PRNGKey(seed), (H, 3), 0, n)`` with its integer of
    ``bits`` bits (64 under ``jax_enable_x64``)."""
    return randint(PRNGKey(seed), (int(num_hypotheses), 3), 0, int(n), bits).astype(np.int64)


def _hypotheses(points: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor):
    """Unit normals (H, 3), offsets (H,) and usable flags (H,) of the
    triples ``idx``: the cross product's components, its norm and the
    offset sum in JAX's order (``jnp.cross``, ``jnp.linalg.norm``)."""
    tri = points[idx]  # (H, 3, 3)
    a = tri[:, 1] - tri[:, 0]
    b = tri[:, 2] - tri[:, 0]
    normal = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                          a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                          a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)
    sq = normal * normal
    norm = torch.sqrt(sq[:, 0] + sq[:, 1] + sq[:, 2])
    normal = normal / torch.clamp(norm, min=1e-12)[:, None]
    prod = normal * tri[:, 0]
    offset = -(prod[:, 0] + prod[:, 1] + prod[:, 2])
    # Degenerate (collinear) or invalid triples score no inliers.
    ok = (norm > 1e-9) & valid[idx].all(-1)
    return normal, offset, ok


def _inliers(points, valid, normal, offset, thresh: float):
    """(N, Hc) inlier block of the hypotheses (normal (Hc, 3), offset (Hc,))."""
    dist = torch.abs(points @ normal.T + offset[None, :])
    return (dist <= thresh) & valid[:, None]


def _ransac_score(points: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor, thresh: float,
                  block: int = SCORE_BLOCK):
    """Count every hypothesis's inliers and take the best (JAX package,
    segmentation.py:29-57).

    :return: (plane (4,), inlier mask (N,), count) tensors; the count is
        -1 when every hypothesis was degenerate or invalid.
    """
    n = points.shape[0]
    normal, offset, ok = _hypotheses(points, valid, idx)
    h = normal.shape[0]
    step = max(1, min(h, block // max(n, 1)))
    counts = torch.cat([_inliers(points, valid, normal[s:s + step], offset[s:s + step],
                                 thresh).sum(0) for s in range(0, h, step)])
    counts = torch.where(ok, counts, torch.full_like(counts, -1))
    best = int(torch.argmax(counts))  # the first of equal counts
    # The winner's mask from the same block product that counted it.
    s = best - best % step
    mask = _inliers(points, valid, normal[s:s + step], offset[s:s + step], thresh)[:, best - s]
    plane = torch.cat([normal[best], offset[best:best + 1]])
    return plane, mask, counts[best]


def fit_plane_ransac(points, valid=None, distance_threshold: float = 0.03,
                     max_iterations: int = 1000, seed: int = 135, bits: int = 32):
    """Best plane by batched RANSAC (JAX package, segmentation.py:60-86;
    replaces the reference's fit_plane_pcl / open3d, segmentation.py:127-163).

    :param points: (N, 3) float32 points, a tensor (scored on its device) or
        an array (scored on the CPU).
    :param bits: the width of the triples' draws (see :func:`ransac_indices`).
    :return: (plane (4,) [n, d] float32 array, inlier index array); no
        inliers when every hypothesis was degenerate or invalid.
    """
    points = torch.as_tensor(points)
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    valid = torch.as_tensor(valid, device=points.device)
    idx = torch.as_tensor(ransac_indices(points.shape[0], max_iterations, seed, bits),
                          device=points.device)
    plane, mask, count = _ransac_score(points, valid, idx, distance_threshold)
    plane = plane.cpu().numpy()
    if int(count) <= 0:
        # Every hypothesis struck out (triples sample all rows, so late
        # iterations over a sparse remainder can): argmax would fall back
        # to hypothesis 0's unchecked mask. Report no plane.
        return plane, np.empty(0, np.int64)
    return plane, np.flatnonzero(mask.cpu().numpy())


def cluster_voxel_graph(points: np.ndarray, eps: float, min_points: int = 10) -> np.ndarray:
    """Connected components over the eps-voxel adjacency graph: points whose
    voxels touch (26-neighbourhood at resolution ``eps``) share a label
    (JAX package, segmentation.py:89-130; the stand-in for the reference's
    Open3D cluster_dbscan).

    :return: (N,) labels, -1 for points in components below ``min_points``.
    """
    pts = np.asarray(points)
    keys = np.floor(pts / eps).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    m = len(uniq)
    parent = np.arange(m)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    lookup = {tuple(k): i for i, k in enumerate(uniq)}
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
               if (dx, dy, dz) != (0, 0, 0)]
    for i, k in enumerate(uniq):
        for off in offsets:
            j = lookup.get((k[0] + off[0], k[1] + off[1], k[2] + off[2]))
            if j is not None:
                ra, rb = find(i), find(j)
                if ra != rb:
                    parent[rb] = ra
    roots = np.array([find(i) for i in range(m)])
    labels = roots[inv]
    # Compact labels; suppress small components.
    uniq_labels, counts = np.unique(labels, return_counts=True)
    remap = {u: (li if c >= min_points else -1)
             for li, (u, c) in enumerate(zip(uniq_labels, counts))}
    return np.asarray([remap[lab] for lab in labels])


@dataclasses.dataclass(frozen=True)
class Planes:
    """Fitted planes with padded member indices (JAX package,
    segmentation.py:133-183; the reference's ``Planes(Primitives)``,
    segmentation.py:95-123): ``params`` rows are [nx, ny, nz, d] (float32,
    as the JAX package fits them); members are (P, S) indices padded with
    -1, S a multiple of 8. ``cov`` and ``eigvals`` come from
    :func:`plane_neighborhood_features` or :func:`compute_plane_features`.
    The losses take it as they take a feature cloud."""

    params: torch.Tensor  # (P, 4)
    member_idx: torch.Tensor  # (P, S) int32, -1 padding
    member_weights: torch.Tensor  # (P, S) float
    cov: Optional[torch.Tensor] = None  # (P, 3, 3)
    eigvals: Optional[torch.Tensor] = None  # (P, 3) ascending
    valid: Optional[torch.Tensor] = None  # (P,) bool
    mask: Optional[torch.Tensor] = None
    loss: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return self.params.shape[0]

    def __len__(self) -> int:
        return self.size

    def replace(self, **kw) -> "Planes":
        return dataclasses.replace(self, **kw)

    def to(self, device=None, dtype=None) -> "Planes":
        """Move to ``device``; cast the floating fields to ``dtype``."""
        def move(x):
            if x is None:
                return None
            if dtype is not None and x.is_floating_point():
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)

        return Planes(**{f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def distance(self, points: torch.Tensor) -> torch.Tensor:
        """Signed plane-point distances, (N, P) (segmentation.py:103-110)."""
        params = self.params.to(points.dtype)
        return points @ params[:, :3].T + params[None, :, 3]

    def orient(self, vps: torch.Tensor) -> "Planes":
        """Flip each normal toward the side of the mean viewpoint sign
        (segmentation.py:113-119); the params keep their dtype."""
        side = torch.sign(self.distance(vps)).mean(0)
        flip = torch.where(side < 0.0, -1.0, 1.0).to(self.params.dtype)
        return self.replace(params=self.params * flip[:, None])


def fit_planes(cloud, distance_threshold: float, min_support: int = 3,
               max_iterations: int = 1000, max_models: int = 10, eps: Optional[float] = None,
               seed: int = 135, verbose: int = 0, stats: Optional[dict] = None) -> Planes:
    """Iterative fit-remove plane extraction (JAX package,
    segmentation.py:186-252; reference: segmentation.py:193-276): fit the
    best RANSAC plane on the remaining points, keep its largest contiguous
    cluster, remove it, and repeat until the support falls below
    ``min_support`` or ``max_models`` planes are found. The points are
    scored in float32, as the JAX package casts them; RANSAC's integer
    draws are 64 bits wide for a float64 cloud, else 32 (the JAX package's
    x64 setting of such runs).

    :param cloud: a :class:`Cloud` (fitted on its device) or (N, 3) points
        (fitted on the CPU).
    :param stats: if given, receives ``ransac_s`` (a list of each model's
        scoring seconds, device-synchronised) and ``cluster_s``.
    :return: :class:`Planes` on the points' device, valid for every plane.
    """
    if isinstance(cloud, Cloud):
        pts = cloud.get_points().detach()
        valid_all = cloud.valid.cpu().numpy()
    else:
        pts = torch.as_tensor(np.asarray(cloud, dtype=np.float64))
        valid_all = np.ones(pts.shape[0], bool)
    bits = 64 if pts.dtype == torch.float64 else 32
    pts = pts.to(torch.float32).contiguous()
    pts_host = pts.cpu().numpy()
    sync = torch.cuda.synchronize if pts.device.type == "cuda" else (lambda: None)
    if stats is not None:
        stats.setdefault("ransac_s", [])
        stats.setdefault("cluster_s", 0.0)

    remaining = valid_all.copy()
    planes: List[np.ndarray] = []
    supports: List[np.ndarray] = []
    for label in range(max_models):
        if remaining.sum() < min_support:
            break
        t0 = time.perf_counter()
        plane, support = fit_plane_ransac(
            pts, valid=torch.as_tensor(remaining, device=pts.device),
            distance_threshold=distance_threshold, max_iterations=max_iterations,
            seed=seed + label, bits=bits)
        if stats is not None:
            sync()
            stats["ransac_s"].append(time.perf_counter() - t0)
        if len(support) < min_support:
            if verbose:
                print("Halt due to insufficient plane support.")
            break
        if eps:
            t0 = time.perf_counter()
            labels = cluster_voxel_graph(pts_host[support], eps,
                                         min_points=min(10, min_support))
            if stats is not None:
                stats["cluster_s"] += time.perf_counter() - t0
            uniq, counts = np.unique(labels[labels >= 0], return_counts=True)
            if len(counts) == 0 or counts.max() < min_support:
                remaining[support] = False
                continue
            support = support[labels == uniq[counts.argmax()]]
        planes.append(plane)
        supports.append(support)
        remaining[support] = False
        if verbose:
            print("Plane %d [%.3f %.3f %.3f %.3f], %d points." % (label, *plane, len(support)))

    if not planes:
        raise ValueError("No planes found with support >= %d" % min_support)

    s_max = max(len(s) for s in supports)
    s_max = -(-s_max // 8) * 8
    idx = np.full((len(planes), s_max), -1, np.int64)
    for i, s in enumerate(supports):
        idx[i, : len(s)] = s
    member_idx = torch.as_tensor(idx.astype(np.int32), device=pts.device)
    return Planes(
        params=torch.as_tensor(np.stack(planes), device=pts.device),
        member_idx=member_idx,
        member_weights=(member_idx >= 0).to(torch.float32),
        valid=torch.ones(len(planes), dtype=torch.bool, device=pts.device),
    )


def _plane_eigvals(cov: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of the planes' (P, 3, 3) covariances, solved in float64
    and returned in the covariance's dtype; a float64 run is unchanged.

    The trigonometric solver (``ops/eigh3``, the JAX package's formula)
    forms the smallest eigenvalue as q = tr/3 plus a term that cancels it,
    so it keeps an absolute error of about an ulp of q. A plane of up to
    ~2.5e5 points spread over tens of metres has its smallest eigenvalue
    at ~1e-7 of the trace, a few float32 ulps of q: the float32 solver
    misses it by 2-43% per plane in either package, while the float32
    covariance keeps it to ~2e-5 (``tests/plane_f32_error.py``). The
    point features keep the float32 solver, as the JAX package does: their
    masks on exact planes are decided by that rounding."""
    from .ops.eigh3 import eigvals3

    return eigvals3(cov.to(torch.float64)).to(cov.dtype)


def plane_neighborhood_features(gcloud: Cloud, planes: Planes, model, cfg=None) -> Planes:
    """The differentiable plane-mode features (JAX package,
    segmentation.py:255-280; reference: preproc.py:218-243): member points
    take their plane's normal for the incidence angle, the model corrects
    their depth, and each plane's covariance and eigenvalues are computed
    from the corrected, posed points (the eigenvalues as
    :func:`_plane_eigvals` says)."""
    from .ops.covs import weighted_cov
    from .ops.features import gather_neighbors

    idx = planes.member_idx
    vps = gather_neighbors(gcloud.vps, idx)  # (P, S, 3)
    dirs = gather_neighbors(gcloud.dirs, idx)
    depth = gather_neighbors(gcloud.depth, idx)
    normals = planes.params[:, None, :3].to(dirs.dtype)  # (P, 1, 3)
    cos = (dirs * normals).sum(-1)
    inc = torch.arccos(torch.clamp(torch.abs(cos), 0.0, 1.0))  # (P, S)
    if model is not None:
        depth = model.correct_depth(depth, inc)
    member_pts = vps + depth[..., None] * dirs
    cov = weighted_cov(member_pts, planes.member_weights)
    return planes.replace(cov=cov, eigvals=_plane_eigvals(cov))


def compute_plane_features(planes: Planes, points: torch.Tensor) -> Planes:
    """Each plane's covariance and eigenvalues of its member points (JAX
    package, segmentation.py:283-295), differentiable through ``points``."""
    from .ops.covs import weighted_cov
    from .ops.features import gather_neighbors

    cov = weighted_cov(gather_neighbors(points, planes.member_idx), planes.member_weights)
    return planes.replace(cov=cov, eigvals=_plane_eigvals(cov))
