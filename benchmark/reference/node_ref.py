"""Plain reference of the online corrector: one raw scan in, the kept rows
with their corrected points, normals and mask out, in plain torch and
numpy. Imports nothing of the program.

Follows the documented semantics of the reference repository's
``depth_correction`` node as the configuration states them: the depth
bounds; the voxel-grid filter (one point a hash slot of the voxel, the
point of lowest seeded rank, ``jax.random.uniform(PRNGKey(135), (n,))``
over the scan padded to a multiple of 512, drawn in the configuration's
float32); each kept point's within-r neighbourhood among the kept points;
its covariance's eigen-features, the normal turned against the view
direction and the incidence angle; the mask (at least
``min_valid_neighbors`` neighbours and the eigenvalue-ratio bounds); the
ScaledPolynomial correction of the masked rows' depth.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import dtype_of, eig_features, moments, pad_size, radius_pairs_flagged, ratio_mask
from .prng import uniform

__all__ = ["correct"]

_INT32_MIN = -(2 ** 31)
GRID_SEED = 135


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    return ((x - _INT32_MIN) & 0xFFFFFFFF) + _INT32_MIN


def grid_keep(pts: torch.Tensor, keep: torch.Tensor, res: float) -> torch.Tensor:
    """The voxel-grid filter's winners among ``keep``."""
    n = pts.shape[0]
    n_pad = pad_size(n)
    table = max(4 * n_pad, 1024)
    cell = torch.floor(pts / res).to(torch.int64)
    h = _wrap_int32((cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) ^ (cell[:, 2] * 83492791))
    slot = torch.where(h == _INT32_MIN, h, h.abs()) % table
    rank = torch.as_tensor(uniform(GRID_SEED, n_pad, "float32")[:n].astype(np.float64),
                           device=pts.device)
    rank = torch.where(keep, rank, torch.full_like(rank, float("inf")))
    order = torch.argsort(rank, stable=True)
    order = order[torch.argsort(slot[order], stable=True)]
    s = slot[order]
    first = torch.ones(n, dtype=torch.bool, device=pts.device)
    first[1:] = s[1:] != s[:-1]
    win = torch.zeros(n, dtype=torch.bool, device=pts.device)
    win[order] = first & torch.isfinite(rank[order])
    return keep & win


def correct(raw: np.ndarray, s: dict, w, exponent, device, precision: str = "float64") -> dict:
    """The corrected scan: {"kept" (indices into ``raw``, ascending),
    "points", "normals" ((kept, 3)), "mask" ((kept,) bool), "pairs" (the
    kept rows' within-r pairs), "ambiguous" ((kept,) bool: a neighbour at
    r to rounding)}. ``raw`` is (N, 3) in the sensor frame."""
    dt = dtype_of(precision)
    pts = torch.as_tensor(raw, device=device).to(dt)
    depth = pts.norm(dim=1)
    keep = torch.ones_like(depth, dtype=torch.bool)
    if s.get("min_depth"):
        keep &= depth >= float(s["min_depth"])
    if s.get("max_depth") is not None:
        keep &= depth <= float(s["max_depth"])
    if s.get("grid_res"):
        keep = grid_keep(pts, keep, float(s["grid_res"]))
    kept = torch.nonzero(keep).reshape(-1)
    p = pts[kept]
    n = p.shape[0]
    rows, cols, amb = radius_pairs_flagged(p, torch.ones(n, dtype=torch.bool, device=device),
                                           float(s["nn_r"]))
    cnt, _, cov = moments(p, rows, cols, n, precision)
    d = depth[kept]
    dirs = p / d.clamp(min=1e-20)[:, None]
    lam, normals, inc = eig_features(cov, dirs)
    mask = (cnt >= int(s.get("min_valid_neighbors") or 1)) & ratio_mask(
        lam, s.get("eigenvalue_ratio_bounds"))
    wt = torch.as_tensor(w, dtype=dt, device=device)
    ex = torch.as_tensor(exponent, dtype=dt, device=device)
    bias = torch.pow(inc[:, None], ex) @ wt
    d = torch.where(mask, d * (1.0 - bias), d)
    return {"kept": kept, "points": dirs * d[:, None], "normals": normals, "mask": mask,
            "pairs": int(rows.numel()), "ambiguous": amb}
