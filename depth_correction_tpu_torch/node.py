"""Online depth correction, the deployable product path (counterpart of
``depth_correction_tpu/node.py``).

The reference ships it as a ROS node (reference: scripts/depth_correction:
13-79): per scan, filter, estimate local features, apply the model,
republish. Here :func:`correct_cloud` corrects one padded cloud on its own
device, and :class:`DepthCorrector` wraps it for structured scans and drops
stale ones (scripts/depth_correction:63-66).

Engines (``cfg.nn_backend``), as in the JAX package:

- ``'slab'``, the default at padded sizes >= ``GRID_NN_MIN_POINTS``: the
  column-aligned cell sort (``ops/grid_hash.py``) and slab-window moments
  (``ops/slabwin.py``, kernel X1), within-r and uncapped (the reference's
  query_ball_point semantics);
- ``'brute'``, the default below: the brute-force search (``ops/knn.py``,
  kernel X3: up to K neighbours within r) and the gather moments
  (``ops/features.py``, kernel P7);
- ``'grid'``, the K-capped gather-window engine: the cell sort sized on
  the device (``grid_hash.grid_sort_traced``), the up-to-K nearest within
  r of every row (``grid_hash.grid_query``, kernel X2, which needs no
  start table) and the gather moments (kernel P7).

With CUDA tensors the kernels launch or raise; ``plain=True`` computes the
neighbours and moments with their plain torch versions on any device and
dtype (the reference runs of the tests and of ``chip_smoke.py``).

Left out, with the JAX package's jit: the static slab width ``w_slab`` and
the grid engine's static window ``width``, their verify-and-retry loops
and ``_WIDTH_CACHE`` (kernel X1 reads each span, kernel X2 each column's
run, to its own length), and the static column bound's retry: the layout
takes the scan's own column count, read once per scan.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .cloud import Cloud
from .config import Config
from .models import load_model
from .ops.eigh3 import _eigvec_c, eigvals3_c
from .ops.features import neighborhood_features
from .ops.filters import (
    filter_depth_mask,
    filter_eigenvalue_ratios_mask,
    filter_eigenvalues_mask,
    filter_grid_mask,
)
from .ops.grid_hash import (
    GRID_NN_MIN_POINTS,
    cell_candidates,
    colpad_dims0_ideal,
    _grid_query_plain,
    grid_query,
    grid_sort_colpad_traced,
    grid_sort_traced,
)
from .ops.knn import radius_neighbors
from .ops.slabwin import slab_window_moments
from .preproc import pad_size
from .utils import trace

__all__ = ["CloudFilter", "DepthCorrector", "correct_cloud"]

# Cell-table bound of the slab and grid engines' sorts (2^21 cells); scans
# whose extent needs more cells coarsen, which keeps the results exact.
NODE_N_CELLS_PAD = 1 << 21
# Upper bound on the major-axis column count of the slab layout: every
# column costs up to 127 padding slots.
NODE_X_COLS_MAX = 2048


def _filter_impl(cloud: Cloud, min_depth, max_depth, grid_res):
    """Depth + voxel-grid filters -> keep mask (shared by both engines)."""
    keep = filter_depth_mask(cloud, min_depth, max_depth)
    if grid_res and grid_res > 0.0:
        keep = keep & filter_grid_mask(cloud.to_points(), keep, grid_res)
    return keep


def _apply_impl(model, cloud: Cloud, nn, eigval_bounds, ratio_bounds,
                min_valid: int = 1, plain: bool = False):
    """Features from an established neighbour table -> masked model apply.
    Rows with fewer than ``min_valid`` within-r neighbours keep their raw
    depth (degenerate covariances give arbitrary normals; the reference's
    neighbourhood-validity filter, filters.py:146-171)."""
    points = cloud.to_points()
    weights = (nn >= 0).to(cloud.depth.dtype)
    feats = neighborhood_features(points, nn, weights, dirs=cloud.dirs, plain=plain)
    mask = cloud.valid
    if min_valid > 1:
        mask = mask & (weights.sum(-1) >= min_valid)
    if eigval_bounds:
        mask = mask & filter_eigenvalues_mask(feats["eigvals"], eigval_bounds)
    if ratio_bounds:
        mask = mask & filter_eigenvalue_ratios_mask(feats["eigvals"], ratio_bounds)
    cloud = cloud.replace(inc_angles=feats["inc_angles"], normals=feats["normals"], mask=mask)
    corrected = model.apply(cloud)
    return corrected.to_points(), corrected.depth, feats["normals"], mask, cloud.valid


def _apply_from_moments(model, cloud: Cloud, comps, w_sum, eigval_bounds, ratio_bounds,
                        min_valid: int = 1):
    """Feature tail + masked model apply straight from neighbourhood
    moments (no neighbour table): eigenvalues, normals and incidence
    angles in component form (JAX package, node.py:203-230)."""
    l1, l2, l3 = eigvals3_c(*comps)
    eigvals = torch.stack([l1, l2, l3], -1)
    dirs = cloud.dirs
    vx, vy, vz = _eigvec_c(*comps, l1)
    cos = dirs[..., 0] * vx + dirs[..., 1] * vy + dirs[..., 2] * vz
    sign = -torch.sign(cos)
    normals = torch.stack([vx * sign, vy * sign, vz * sign], -1)
    inc_angles = torch.arccos(torch.clamp(cos.abs(), 0.0, 1.0))
    mask = cloud.valid
    if min_valid > 1:
        mask = mask & (w_sum >= min_valid)
    if eigval_bounds:
        mask = mask & filter_eigenvalues_mask(eigvals, eigval_bounds)
    if ratio_bounds:
        mask = mask & filter_eigenvalue_ratios_mask(eigvals, ratio_bounds)
    cloud = cloud.replace(inc_angles=inc_angles, normals=normals, mask=mask)
    corrected = model.apply(cloud)
    return corrected.to_points(), corrected.depth, normals, mask, cloud.valid


def _slab_layout(points, keep, nn_r: float):
    """The slab engine's sorted layout of one scan: (pts_pad_T, valid_pad,
    ids_pad, slot_of_orig, dims). The column bound is the scan's own column
    count (one host read), capped at ``NODE_X_COLS_MAX``."""
    cand = cell_candidates(points, keep, nn_r, NODE_N_CELLS_PAD)
    x_cols = min(max(int(trace.to_host(colpad_dims0_ideal(cand))), 1), NODE_X_COLS_MAX)
    (pts_pad_T, valid_pad, ids_pad, slot_of_orig, _, dims, _,
     _) = grid_sort_colpad_traced(points, keep, nn_r, NODE_N_CELLS_PAD, x_cols_pad=x_cols,
                                  candidates=cand)
    return pts_pad_T, valid_pad, ids_pad, slot_of_orig, dims


def _slab_moments(points, keep, nn_r: float, plain: bool):
    """Slab engine: column-aligned sort, slab-window moments, unsort ->
    (comps 6-tuple, w_sum) per original row."""
    pts_pad_T, valid_pad, ids_pad, slot_of_orig, dims = _slab_layout(points, keep, nn_r)
    _, comps, w_sum, _ = slab_window_moments(
        pts_pad_T, valid_pad, ids_pad, dims, float(nn_r) ** 2, NODE_N_CELLS_PAD, plain=plain)
    packed = torch.cat([torch.stack(comps), w_sum[None]], 0)[:, slot_of_orig]  # (7, N)
    return tuple(packed[0:6]), packed[6]


def _grid_neighbors(points, keep, nn_r: float, k: int, plain: bool):
    """Grid engine: traced cell sort, then the up-to-k nearest within r of
    every row (JAX package, node.py:178-198) -> (dist (N, k), idx (N, k)
    int32), inf / -1 padded. The kernel reads every column's run whole and
    needs no start table; the plain twin builds the dense table and takes
    the largest 3-cell run as its window (host reads)."""
    (pts_T, val_s, ids_s, order, mins, dims,
     cell) = grid_sort_traced(points, keep, nn_r, NODE_N_CELLS_PAD)
    r2 = torch.full((), nn_r, dtype=points.dtype) ** 2  # a host scalar: no device read
    args = (points, keep, pts_T, val_s, ids_s, order, mins, dims, r2, k, None, cell)
    if plain:
        return _grid_query_plain(*args)
    return grid_query(*args, own_points=True)


def correct_cloud(model, cloud: Cloud, cfg: Config, k: Optional[int] = None,
                  plain: bool = False):
    """Correct one (padded) cloud on its device.

    :param model: correction model (``models``), on the cloud's device.
    :param cloud: raw scan; ``valid`` marks padding.
    :param k: neighbour cap of the brute and grid engines (default
        ``cfg.nn_max_neighbors`` or 32); the slab engine has none.
    :param plain: compute the neighbours and moments with the plain torch
        versions of the kernels, on any device and dtype.
    :return: (points (N, 3), depth (N,), normals (N, 3), mask (N,) the
        corrected rows, valid (N,) the rows kept by the filters).
    """
    k = int(k or cfg.nn_max_neighbors or 32)
    backend = getattr(cfg, "nn_backend", None)
    n = cloud.size
    if backend not in ("brute", "grid", "slab"):
        backend = "slab" if n >= GRID_NN_MIN_POINTS else "brute"
    min_valid = int(cfg.min_valid_neighbors or 1)
    bounds = (cfg.eigenvalue_bounds or [], cfg.eigenvalue_ratio_bounds or [])
    with torch.no_grad():
        keep = _filter_impl(cloud, float(cfg.min_depth or 0.0),
                            float(cfg.max_depth or np.inf),
                            float(cfg.grid_res or 0.0))
        cloud = cloud.replace(valid=keep)
        points = cloud.to_points()
        if backend == "brute":
            _, nn = radius_neighbors(points, points, r=float(cfg.nn_r), k=k,
                                     valid_points=keep, valid_query=keep, plain=plain)
            return _apply_impl(model, cloud, nn, *bounds, min_valid=min_valid, plain=plain)
        if backend == "grid":
            _, nn = _grid_neighbors(points, keep, float(cfg.nn_r), k, plain)
            return _apply_impl(model, cloud, nn, *bounds, min_valid=min_valid, plain=plain)
        comps, w_sum = _slab_moments(points, keep, float(cfg.nn_r), plain)
        return _apply_from_moments(model, cloud, comps, w_sum, *bounds, min_valid=min_valid)


class CloudFilter:
    """Streaming depth + grid filter (the cloud_filter node, reference:
    scripts/cloud_filter:23-31): host-side filtering of raw scans to the
    preprocessed form the rest of the pipeline consumes."""

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def process(self, scan: np.ndarray) -> np.ndarray:
        from .datasets.synthetic import make_structured
        from .preproc import filtered_cloud

        pts, vps, normals = filtered_cloud(scan, self.cfg)
        return make_structured(pts, normals=normals, vps=vps)


class DepthCorrector:
    """Streaming wrapper around :func:`correct_cloud`.

    ``process(structured_scan) -> structured_scan`` with corrected x/y/z,
    normals and mask of the rows the filters keep; scans older than
    ``max_age`` seconds are dropped (reference: scripts/depth_correction:
    63-66). Computes in ``cfg.torch_dtype()`` on ``cfg.torch_device()``.
    """

    def __init__(self, cfg: Config, model=None, max_age: float = float("inf"),
                 k: Optional[int] = None):
        self.cfg = cfg
        self.model = model if model is not None else load_model(cfg=cfg)
        self.max_age = max_age
        self.k = k or cfg.nn_max_neighbors or 32
        self.scans = 0  # scans processed, the node.scan spans' ``scan``

    def process(self, scan: np.ndarray, stamp: Optional[float] = None):
        if stamp is not None and (time.time() - stamp) > self.max_age:
            return None  # stale scan dropped
        self.scans += 1
        with trace.span("node.scan", scan=self.scans):
            return self._process(scan)

    def _process(self, scan: np.ndarray):
        dtype, device = self.cfg.torch_dtype(), self.cfg.torch_device()
        if scan.dtype.names:
            cloud = Cloud.from_structured_array(scan, dtype=dtype, device=device)
        else:
            cloud = Cloud.from_points(scan, dtype=dtype, device=device)
        cloud = cloud.pad(pad_size(cloud.size))
        with trace.span("node.correct"):
            outs = correct_cloud(self.model, cloud, self.cfg, k=self.k)
        points, _, normals, mask, valid = (trace.to_host(x).numpy() for x in outs)
        out = np.zeros(int(valid.sum()), dtype=[
            ("x", "f4"), ("y", "f4"), ("z", "f4"),
            ("normal_x", "f4"), ("normal_y", "f4"), ("normal_z", "f4"),
            ("mask", "u1"),
        ])
        pts = points[valid]
        nrm = normals[valid]
        out["x"], out["y"], out["z"] = pts.T.astype(np.float32)
        out["normal_x"], out["normal_y"], out["normal_z"] = nrm.T.astype(np.float32)
        out["mask"] = mask[valid].astype(np.uint8)
        return out
