"""Evaluation metrics: chamfer distance, map accuracy, pose errors
(counterpart of ``depth_correction_tpu/metrics.py``).

- chamfer distance (reference: src/depth_correction/metrics.py:57-125, a
  trimmed pytorch3d kNN wrapper),
- mapping/reconstruction accuracy: inlier-trimmed point-to-point map error
  (reference: scripts/mapping_accuracy:100-118),
- SLAM-style localization errors: absolute/relative rotation and
  translation per pose (reference: scripts/robot_data:153-205).

The 1-NN searches go through :func:`ops.knn.nearest_neighbors`: kernel X3
(k = 1, no radius) on CUDA tensors, its plain twin on CPU tensors or with
``plain=True`` (``mapping_accuracy``'s float64 reference runs).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .ops.knn import nearest_neighbors
from .ops.reduce import masked_mean, masked_quantile
from .ops.se3 import delta_transform, rotation_angle, translation_norm

__all__ = [
    "chamfer_distance",
    "mapping_accuracy",
    "localization_errors",
    "static_intervals",
    "tracker_position_error",
]


def chamfer_distance(x: torch.Tensor, y: torch.Tensor, valid_x: Optional[torch.Tensor] = None,
                     valid_y: Optional[torch.Tensor] = None,
                     bidirectional: bool = False) -> torch.Tensor:
    """One-directional (x -> y) chamfer: mean over x of the euclidean
    distance to the nearest y (the sqrt of the 1-NN squared distance,
    reference: metrics.py:103-117); with ``bidirectional`` plus y -> x."""
    d, idx = nearest_neighbors(y, x, k=1, valid_points=valid_y)
    ok = idx[:, 0] >= 0
    if valid_x is not None:
        ok = ok & valid_x
    out = masked_mean(d[:, 0], ok)
    if bidirectional:
        out = out + chamfer_distance(y, x, valid_y, valid_x)
    return out


def mapping_accuracy(cloud: torch.Tensor, gt_map: torch.Tensor, icp_inlier_ratio: float = 0.8,
                     valid_cloud: Optional[torch.Tensor] = None,
                     valid_gt: Optional[torch.Tensor] = None,
                     plain: bool = False) -> torch.Tensor:
    """Inlier-trimmed point-to-point distance of an aggregated (corrected)
    map against a ground-truth scanner map (reference:
    scripts/mapping_accuracy:100-118): the mean 1-NN distance over the
    closest ``icp_inlier_ratio`` fraction of points."""
    d, idx = nearest_neighbors(gt_map, cloud, k=1, valid_points=valid_gt, plain=plain)
    d = d[:, 0]
    ok = idx[:, 0] >= 0
    if valid_cloud is not None:
        ok = ok & valid_cloud
    thr = masked_quantile(d, ok, icp_inlier_ratio)
    return masked_mean(d, ok & (d <= thr))


def localization_errors(T_gt: torch.Tensor, T_est: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pose absolute and relative localization errors, as the
    robot_data evaluator computes them (reference: scripts/robot_data:
    153-205): the absolute delta gt^-1 @ est per pose; the relative errors
    compare consecutive-pose increments of gt and est.

    :param T_gt: (N, 4, 4) ground-truth poses.
    :param T_est: (N, 4, 4) estimated poses.
    :return: (abs_angle (N,), abs_offset (N,), rel_angle (N-1,),
        rel_offset (N-1,)).
    """
    delta = delta_transform(T_gt, T_est)
    rel = delta_transform(delta_transform(T_gt[:-1], T_gt[1:]),
                          delta_transform(T_est[:-1], T_est[1:]))
    return rotation_angle(delta), translation_norm(delta), rotation_angle(rel), \
        translation_norm(rel)


def static_intervals(times, positions, min_duration: float = 1.0, max_motion: float = 0.01):
    """Stationary intervals of a tracked-position time series, on the host
    (reference: scripts/localization_accuracy keeps the scans taken while
    the total-station crystal did not move): an interval is static when
    every position stays within ``max_motion`` of its first sample and it
    lasts at least ``min_duration``.

    :param times: (N,) seconds, ascending.
    :param positions: (N, 3) tracked positions.
    :return: list of (start, end) index pairs, end exclusive.
    """
    times = np.asarray(times, np.float64)
    positions = np.asarray(positions, np.float64)
    out = []
    i, n = 0, len(times)
    while i < n:
        j = i + 1
        while j < n and np.linalg.norm(positions[j] - positions[i]) <= max_motion:
            j += 1
        if j > i + 1 and times[j - 1] - times[i] >= min_duration:
            out.append((i, j))
        i = j if j > i + 1 else i + 1
    return out


def tracker_position_error(T_est, xyz_tracker) -> torch.Tensor:
    """Mean position error of estimated poses against tracker positions
    (reference: scripts/model_poses_learning:138-140)."""
    T_est = torch.as_tensor(T_est)
    xyz = torch.as_tensor(xyz_tracker, dtype=T_est.dtype, device=T_est.device)
    return torch.linalg.norm(T_est[:, :3, 3] - xyz, dim=1).mean()
