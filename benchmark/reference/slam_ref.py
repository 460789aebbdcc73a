"""Plain reference of the SLAM-drift evaluation's odometry: the corrected
scans' feature clouds and scan-to-previous-scan point-to-plane ICP, in
plain torch. Imports nothing of the program.

Follows the documented semantics of the reference repository's SLAM
evaluation as the program states them: each scan's within-r
neighbourhoods, its incidence angles and ratio mask, the ScaledPolynomial
correction of the masked rows' depth, and the normals of the corrected
points over the same neighbourhoods; then, from the odometry prior of each
increment, ``n_iters`` Gauss-Newton steps: every source point's nearest
target point, the correspondences gated at the ``inlier_ratio`` quantile
of their distances (linear interpolation), the residual along the target
normal, the small-angle twist solved from J^T W J + 1e-9 I, applied as
[translation, axis-angle] on the left.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import dtype_of, eig_features, moments, radius_pairs_flagged, ratio_mask, round_tf32

__all__ = ["feature_cloud", "odometry"]

# The nearest-neighbour sweep looks this far along x; a correspondence
# farther away than this counts as an outlier, and the search raises if the
# gate's quantile would need one.
SEARCH_BOUND = 2.0


def feature_cloud(raw: np.ndarray, s: dict, w, exponent, device, precision="float64") -> dict:
    """A scan's corrected points and their normals, in the sensor frame,
    its ratio mask and the points whose neighbourhood is decided by
    rounding (``ambiguous``)."""
    dt = dtype_of(precision)
    p = torch.as_tensor(raw, device=device).to(dt)
    n = p.shape[0]
    rows, cols, amb = radius_pairs_flagged(p, torch.ones(n, dtype=torch.bool, device=device),
                                           float(s["nn_r"]))
    _, _, cov = moments(p, rows, cols, n, precision)
    depth = p.norm(dim=1)
    dirs = p / depth.clamp(min=1e-20)[:, None]
    lam, _, inc = eig_features(cov, dirs)
    mask = ratio_mask(lam, s.get("eigenvalue_ratio_bounds"))
    wt = torch.as_tensor(w, dtype=dt, device=device)
    ex = torch.as_tensor(exponent, dtype=dt, device=device)
    d = torch.where(mask, depth * (1.0 - torch.pow(inc[:, None], ex) @ wt), depth)
    q = dirs * d[:, None]
    _, _, cov = moments(q, rows, cols, n, precision)
    _, normals, _ = eig_features(cov, dirs)
    return {"points": q, "normals": normals, "mask": mask, "ambiguous": amb}


def _nearest(src: torch.Tensor, tgt: torch.Tensor, block: int = 4096):
    """Each source point's nearest target point within SEARCH_BOUND along
    x: (distance, index), inf and -1 beyond."""
    order = torch.argsort(tgt[:, 0])
    ts, xs = tgt[order], tgt[order][:, 0].contiguous()
    so = torch.argsort(src[:, 0])
    dist = torch.full((src.shape[0],), float("inf"), dtype=src.dtype, device=src.device)
    idx = torch.full((src.shape[0],), -1, dtype=torch.int64, device=src.device)
    for b in range(0, src.shape[0], block):
        qi = so[b:b + block]
        q = src[qi]
        lo = int(torch.searchsorted(xs, q[:, 0].min() - SEARCH_BOUND))
        hi = int(torch.searchsorted(xs, q[:, 0].max() + SEARCH_BOUND, right=True))
        if hi <= lo:
            continue
        c = ts[lo:hi]
        d2 = ((q[:, None, 0] - c[None, :, 0]) ** 2 + (q[:, None, 1] - c[None, :, 1]) ** 2
              + (q[:, None, 2] - c[None, :, 2]) ** 2)
        m, j = d2.min(1)
        near = m <= SEARCH_BOUND ** 2
        dist[qi] = torch.where(near, m.sqrt(), dist[qi])
        idx[qi] = torch.where(near, order[lo + j], idx[qi])
    return dist, idx


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    xs = torch.sort(x).values
    pos = q * (xs.numel() - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if not torch.isfinite(xs[hi]):
        raise RuntimeError("the ICP gate's quantile lies beyond the search bound")
    return xs[lo] * (1.0 - (pos - lo)) + xs[hi] * (pos - lo)


def _rotation(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle -> 3 x 3."""
    t = aa.norm()
    K = torch.zeros(3, 3, dtype=aa.dtype, device=aa.device)
    K[0, 1], K[0, 2], K[1, 0] = -aa[2], aa[1], aa[2]
    K[1, 2], K[2, 0], K[2, 1] = -aa[0], -aa[1], aa[0]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    if float(t) < 1e-12:
        return eye + K
    return eye + torch.sin(t) / t * K + (1.0 - torch.cos(t)) / (t * t) * (K @ K)


def _transform(T: torch.Tensor, p: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    dt = p.dtype
    return (round_tf32(p, precision).to(dt) @ round_tf32(T[:3, :3], precision).to(dt).T
            + T[:3, 3])


def icp(src: dict, tgt_pts: torch.Tensor, tgt_normals: torch.Tensor, T0: torch.Tensor,
        n_iters: int, inlier_ratio: float, precision: str = "float64") -> torch.Tensor:
    """Align ``src`` onto the target (points and normals in the world); the
    transform's and the normal equations' products rounded as
    ``precision`` says."""
    def tf(x):
        return round_tf32(x, precision).to(x.dtype)

    T = T0.clone()
    for _ in range(n_iters):
        s = _transform(T, src["points"], precision)
        d, i = _nearest(s, tgt_pts)
        thr = _quantile(d, inlier_ratio)
        w = ((i >= 0) & (d <= thr)).to(s.dtype)
        i = i.clamp(min=0)
        q, n = tgt_pts[i], tgt_normals[i]
        r = (n * (q - s)).sum(-1)
        J = torch.cat([torch.linalg.cross(s, n), n], -1)
        Jw = tf(J * w[:, None])
        H = Jw.T @ tf(J) + 1e-9 * torch.eye(6, dtype=s.dtype, device=s.device)
        dx = torch.linalg.solve(H, Jw.T @ tf(r))
        delta = torch.eye(4, dtype=s.dtype, device=s.device)
        delta[:3, :3] = _rotation(dx[:3])
        delta[:3, 3] = dx[3:]
        T = delta @ T
    return T


def odometry(clouds: list, priors: np.ndarray, n_iters: int = 8,
             inlier_ratio: float = 0.8, precision: str = "float64") -> np.ndarray:
    """Scan-to-previous-scan odometry from the priors' increments: the
    estimated world poses (S, 4, 4), float64."""
    dev = clouds[0]["points"].device
    dt = clouds[0]["points"].dtype
    est = [np.asarray(priors[0], np.float64)]
    for k in range(1, len(clouds)):
        inc = np.linalg.inv(priors[k - 1]) @ priors[k]
        prior = est[-1] @ inc
        Tp = torch.as_tensor(est[-1], dtype=dt, device=dev)
        tgt = _transform(Tp, clouds[k - 1]["points"], precision)
        tn = _transform(Tp, clouds[k - 1]["normals"], precision) - Tp[:3, 3]
        T = icp(clouds[k], tgt, tn, torch.as_tensor(prior, dtype=dt, device=dev), n_iters,
                inlier_ratio, precision)
        est.append(T.cpu().numpy().astype(np.float64))
    return np.stack(est)
