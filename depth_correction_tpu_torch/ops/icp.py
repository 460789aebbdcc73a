"""One point-to-plane Gauss-Newton step of ICP after its 1-NN search: the
inlier gate at a quantile of the distances, the normal equations of the
inliers, the 6x6 solve and the update of the transform (counterpart of
``depth_correction_tpu/slam_eval.py:48-71``, ``_icp_step`` after its
``nearest_neighbors``).

On CUDA float32 tensors the step is kernel X6 (``csrc/icp_solve.cu``):
its gate launch and the sort of its keys (span ``icp.gate``), then its
solve launch (span ``icp.solve``), on the stream, no value read back to
the host, the sums in float64. On CPU tensors, or with ``plain=True`` on
any device and dtype, its plain twin :func:`icp_update_plain` (the
threshold through ``ops/reduce.py``'s ``masked_quantile``, which reads its
two positions on the host), under the same two spans.
"""
from __future__ import annotations

import torch

from ..utils import trace
from . import _kernels
from .reduce import masked_mean, masked_quantile
from .se3 import xyz_axis_angle_to_matrix

__all__ = ["icp_update", "icp_update_plain"]


def icp_update_plain(T, d2, idx, src_pts, src_valid, tgt_pts, tgt_normals,
                     inlier_ratio: float):
    """Plain twin of X6 (JAX package, slam_eval.py:48-71), in the inputs'
    float type: the rows whose nearest target exists and whose source point
    is valid, gated at the ``inlier_ratio`` quantile of their distances;
    J^T W J dx = J^T W r solved for the 6-DoF twist (small-angle
    linearisation); (delta @ T, the inliers' mean |r|). ``solve_ex`` is
    ``solve`` without the host check of its status.

    :param d2, idx: (N,) the search's squared distance and index of each
        source row's nearest target (-1 at ``inf``: none).
    """
    with trace.span("icp.gate"):
        d = torch.sqrt(d2)
        ok = (idx >= 0) & src_valid
        thr = masked_quantile(d, ok, inlier_ratio)
        w = (ok & (d <= thr)).to(src_pts.dtype)
    with trace.span("icp.solve"):
        i = torch.clamp(idx, min=0).long()
        q, n = tgt_pts[i], tgt_normals[i]
        r = (n * (q - src_pts)).sum(-1)  # residual along the target normal
        J = torch.cat([torch.linalg.cross(src_pts, n), n], -1)  # (N, 6)
        Jw = J * w[:, None]
        H = Jw.T @ J + 1e-9 * torch.eye(6, dtype=src_pts.dtype, device=src_pts.device)
        dx = torch.linalg.solve_ex(H, Jw.T @ r)[0]
        # [rot, trans] ordering in J => [trans, rot] for the 6-vector.
        delta = xyz_axis_angle_to_matrix(torch.cat([dx[3:], dx[:3]]))
        return delta @ T, masked_mean(r.abs(), w > 0)


def icp_update(T, d2, idx, src_pts, src_valid, tgt_pts, tgt_normals, inlier_ratio: float,
               plain: bool = False, stats=None):
    """One ICP step from the search's (``d2``, ``idx``) of the source
    points ``src_pts`` placed by ``T``: (the updated T, the inliers' mean
    |r|), both on the inputs' device. Kernel X6 on CUDA tensors (float32,
    no gradient); its plain twin :func:`icp_update_plain` on CPU tensors or
    with ``plain``.

    :param stats: None, or a float64 CUDA tensor of
        ``_kernels.ICP_STATS`` that X6 fills with its sums, counts,
        threshold and dx (``_kernels.launch_icp_solve``); the twin fills
        none and refuses one.
    """
    if plain or src_pts.device.type == "cpu":
        if stats is not None:
            raise ValueError("stats are X6's; the plain twin fills none")
        return icp_update_plain(T, d2, idx, src_pts, src_valid, tgt_pts, tgt_normals,
                                inlier_ratio)
    with trace.span("icp.gate"):
        key, scratch = _kernels.launch_icp_gate(d2, idx, src_valid)
        key = torch.sort(key).values
    with trace.span("icp.solve"):
        return _kernels.launch_icp_solve(key, scratch, T, d2, idx, src_pts, src_valid, tgt_pts,
                                         tgt_normals, inlier_ratio, stats)
