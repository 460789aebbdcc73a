"""Differentiable SE(3) utilities (counterpart of ``depth_correction_tpu/
ops/se3.py``).

The 6-vector (xyz translation + axis-angle rotation) parameterization is the
pose-correction representation used throughout training
(reference: src/depth_correction/transform.py:68-91,
src/depth_correction/utils.py:170-304). All functions are batched and
numerically safe at the identity (zero rotation), so gradients flow through
zero-initialized pose deltas.

Every contraction here is a plain float32/float64 ``matmul``: the package
import pins ``allow_tf32 = False``, the counterpart of the JAX package's
``PPREC`` (full-f32 passes for position-critical products).
"""
from __future__ import annotations

import torch

__all__ = [
    "absolute_orientation",
    "axis_angle_to_matrix",
    "delta_transform",
    "matrix_to_quaternion",
    "matrix_to_xyz_axis_angle",
    "quaternion_to_axis_angle",
    "rotation_angle",
    "transform_inv",
    "transform_points",
    "translation_norm",
    "xyz_axis_angle_to_matrix",
]


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation.

    R = I + sinc(t) * K + cosc(t) * K^2 with K = skew(aa), t = |aa|. Near
    t = 0 the factors switch to Taylor series in t^2 and sqrt only sees a
    guarded argument, so gradients at exactly zero rotation are finite.
    """
    t2 = (aa * aa).sum(-1)
    small = t2 < 1e-8
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    s = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    c = torch.where(
        small,
        0.5 - t2 / 24.0,
        (1.0 - torch.cos(t)) / torch.where(small, torch.ones_like(t2), t2),
    )
    x, y, z = aa[..., 0], aa[..., 1], aa[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye + s[..., None, None] * K + c[..., None, None] * (K @ K)


def xyz_axis_angle_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) [tx ty tz rx ry rz] -> (..., 4, 4) homogeneous transform
    (reference: transform.py:68-78)."""
    R = axis_angle_to_matrix(x[..., 3:])
    top = torch.cat([R, x[..., :3, None]], -1)  # (..., 3, 4)
    bottom = torch.zeros(x.shape[:-1] + (1, 4), dtype=x.dtype, device=x.device)
    bottom[..., 0, 3].fill_(1.0)  # a fill: storing a Python float copies it from the host
    return torch.cat([top, bottom], -2)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) unit quaternion (w, x, y, z), by the
    branch-free Shepperd extraction seeded by the largest diagonal term."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    best = torch.stack([qw2, qx2, qy2, qz2], -1).argmax(-1)

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-24))

    sw, sx, sy, sz = safe_sqrt(qw2), safe_sqrt(qx2), safe_sqrt(qy2), safe_sqrt(qz2)
    cand_w = torch.stack([0.5 * sw, (m21 - m12) / (2 * sw), (m02 - m20) / (2 * sw), (m10 - m01) / (2 * sw)], -1)
    cand_x = torch.stack([(m21 - m12) / (2 * sx), 0.5 * sx, (m01 + m10) / (2 * sx), (m02 + m20) / (2 * sx)], -1)
    cand_y = torch.stack([(m02 - m20) / (2 * sy), (m01 + m10) / (2 * sy), 0.5 * sy, (m12 + m21) / (2 * sy)], -1)
    cand_z = torch.stack([(m10 - m01) / (2 * sz), (m02 + m20) / (2 * sz), (m12 + m21) / (2 * sz), 0.5 * sz], -1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], -2)  # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion (w, x, y, z) -> (..., 3) axis-angle."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = (v * v).sum(-1)
    small = vn2 < 1e-24
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    angle = 2.0 * torch.atan2(vn, w)
    scale = torch.where(small, torch.full_like(vn, 2.0), angle / vn)
    return v * scale[..., None]


def matrix_to_xyz_axis_angle(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [xyz, axis-angle] (reference: transform.py:81-91)."""
    aa = quaternion_to_axis_angle(matrix_to_quaternion(T[..., :3, :3]))
    return torch.cat([T[..., :3, 3], aa], -1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transform to (..., N, 3) points (rotate + translate)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def transform_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid (..., 4, 4) transform (reference: utils.py:183-189)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3:]
    top = torch.cat([Rt, -(Rt @ t)], -1)
    bottom = torch.zeros(T.shape[:-2] + (1, 4), dtype=T.dtype, device=T.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def delta_transform(T0: torch.Tensor, T1: torch.Tensor) -> torch.Tensor:
    """Delta D such that T1 = T0 @ D (reference: utils.py:192-196)."""
    return transform_inv(T0) @ T1


def rotation_angle(T: torch.Tensor) -> torch.Tensor:
    """Rotation angle of (..., 4, 4) or (..., 3, 3) (reference: utils.py:170-174)."""
    R = T[..., :3, :3]
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def translation_norm(T: torch.Tensor) -> torch.Tensor:
    """Translation magnitude of (..., 4, 4) (reference: utils.py:177-180)."""
    return torch.linalg.norm(T[..., :3, 3], dim=-1)


def absolute_orientation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kabsch/Umeyama: rigid T in SE(D) minimizing ||R x_i + t - y_i||^2
    (reference: utils.py:253-304).

    :param x: D-by-M points to align.
    :param y: D-by-M reference points.
    :return: (D+1, D+1) homogeneous transform.
    """
    d = x.shape[0]
    xm = x.mean(1, keepdim=True)
    ym = y.mean(1, keepdim=True)
    U, _, Vt = torch.linalg.svd((x - xm) @ (y - ym).T)
    # Proper rotation: flip the last singular direction if det < 0.
    S = torch.eye(d, dtype=x.dtype, device=x.device)
    S[-1, -1] = torch.sign(torch.linalg.det((U @ Vt).T))
    R = (U @ S @ Vt).T
    T = torch.eye(d + 1, dtype=x.dtype, device=x.device)
    T[:d, :d] = R
    T[:d, d:] = ym - R @ xm
    return T
