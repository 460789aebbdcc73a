"""Immutable point cloud of tensors (counterpart of ``depth_correction_tpu/
cloud.py``).

Same parameterization as the reference's ``DepthCloud``
(reference: src/depth_correction/depth_cloud.py:18-93): points = vps +
depth * dirs, so per-point depth is the differentiable scalar the correction
model edits (depth_cloud.py:122-124). A frozen dataclass of fixed-shape
tensors: ``valid`` marks padding, ``mask`` the trainable region, derived
features are threaded back in with ``replace``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .utils import trace

__all__ = ["Cloud"]


class _Rotate(torch.autograd.Function):
    """``x @ Rt`` whose backward sums the rotation's gradient over the
    points as elementwise products and a reduction. Autograd's own backward
    is the product x^T g, a GEMM with a (3, 3) output for each batch and
    every point to reduce: cuBLAS runs it on a few blocks, about 0.9 ms a
    call for a 65,024-point scan of the bench slice on an H100, which made
    the pose deltas' gradient most of a training step's device time."""

    @staticmethod
    def forward(ctx, x, Rt):
        ctx.save_for_backward(x, Rt)
        return x @ Rt

    @staticmethod
    def backward(ctx, g):
        x, Rt = ctx.saved_tensors
        gx = gR = None
        if ctx.needs_input_grad[0]:
            gx = (g @ Rt.transpose(-1, -2)).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            gR = (x.unsqueeze(-1) * g.unsqueeze(-2)).sum(-3).sum_to_size(Rt.shape)
        return gx, gR


@dataclasses.dataclass(frozen=True)
class Cloud:
    """Fixed-shape depth cloud: points = vps + depth[..., None] * dirs.

    All tensors share the leading point axis N (optionally with leading
    batch axes). Optional fields are ``None`` until computed.
    """

    vps: torch.Tensor  # (..., N, 3) viewpoints
    dirs: torch.Tensor  # (..., N, 3) unit view directions
    depth: torch.Tensor  # (..., N) depths
    valid: torch.Tensor  # (..., N) bool, False = padding
    points: Optional[torch.Tensor] = None  # (..., N, 3)
    normals: Optional[torch.Tensor] = None  # (..., N, 3)
    inc_angles: Optional[torch.Tensor] = None  # (..., N)
    mask: Optional[torch.Tensor] = None  # (..., N) bool trainable region
    mean: Optional[torch.Tensor] = None  # (..., N, 3)
    cov: Optional[torch.Tensor] = None  # (..., N, 3, 3)
    eigvals: Optional[torch.Tensor] = None  # (..., N, 3) ascending
    eigvecs: Optional[torch.Tensor] = None  # (..., N, 3, 3) columns
    trace: Optional[torch.Tensor] = None  # (..., N)
    loss: Optional[torch.Tensor] = None  # (..., N)

    @property
    def size(self) -> int:
        return self.depth.shape[-1]

    def __len__(self) -> int:
        return self.size

    def replace(self, **kwargs) -> "Cloud":
        return dataclasses.replace(self, **kwargs)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Cloud":
        """New cloud with ``fn`` applied to every present field."""
        return Cloud(**{
            f.name: (None if getattr(self, f.name) is None
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)
        })

    def to(self, device=None, dtype=None) -> "Cloud":
        """Move to ``device``; cast floating fields to ``dtype``."""
        def move(x):
            if dtype is not None and x.is_floating_point():
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)

        return self.map(move)

    # ------------------------------------------------------------------
    def to_points(self) -> torch.Tensor:
        """points = vps + depth * dirs (reference: depth_cloud.py:122-124)."""
        return self.vps + self.depth[..., None] * self.dirs

    def with_points(self) -> "Cloud":
        return self.replace(points=self.to_points())

    def get_points(self) -> torch.Tensor:
        return self.points if self.points is not None else self.to_points()

    # ------------------------------------------------------------------
    def transform(self, T: torch.Tensor) -> "Cloud":
        """Rigid transform of vps/dirs (+normals); depth is invariant
        (reference: depth_cloud.py:135-152). Derived geometry is dropped.
        Full-precision products: TF32 is off for the package."""
        Rt = T[..., :3, :3].transpose(-1, -2)
        t = T[..., :3, 3]
        return Cloud(
            vps=_Rotate.apply(self.vps, Rt) + t[..., None, :],
            dirs=_Rotate.apply(self.dirs, Rt),
            depth=self.depth,
            valid=self.valid,
            normals=_Rotate.apply(self.normals, Rt) if self.normals is not None else None,
            inc_angles=self.inc_angles,
            mask=self.mask,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def from_points(pts, vps=None, normals=None, valid=None, dtype=None,
                    device=None, pad_to: Optional[int] = None) -> "Cloud":
        """Cloud from (N, 3) points and optional viewpoints
        (reference: depth_cloud.py:592-638). Zero-depth points get a zero
        direction and stay valid (depth_cloud.py:626-627)."""
        pts = trace.to_device(pts, dtype=dtype, device=device)
        n = pts.shape[0]
        if vps is None:
            vps = torch.zeros_like(pts)
        else:
            vps = trace.to_device(vps, pts)
            vps = vps.expand(pts.shape)
        rays = pts - vps
        depth = torch.linalg.norm(rays, dim=-1)
        dirs = rays / torch.clamp(depth[..., None], min=1e-20)
        dirs = torch.where(depth[..., None] > 0.0, dirs, torch.zeros_like(dirs))
        if valid is None:
            valid = torch.ones(n, dtype=torch.bool, device=pts.device)
        else:
            valid = trace.to_device(valid, pts, dtype=torch.bool)
        if normals is not None:
            normals = trace.to_device(normals, pts)
        cloud = Cloud(vps=vps, dirs=dirs, depth=depth, valid=valid,
                      normals=normals)
        if pad_to is not None and pad_to != n:
            cloud = cloud.pad(pad_to)
        return cloud

    @staticmethod
    def from_structured_array(arr: np.ndarray, dtype=None, device=None,
                              pad_to=None) -> "Cloud":
        """From a numpy structured array with x/y/z (+vp_*, +normal_*)
        fields — the dataset interchange format (depth_cloud.py:577-590).
        Fields are read as float64 and cast to ``dtype`` (default float64)."""
        from numpy.lib.recfunctions import structured_to_unstructured as s2u

        dtype = dtype or torch.float64
        names = arr.dtype.names
        pts = s2u(arr[["x", "y", "z"]], dtype=np.float64)
        vps = (s2u(arr[["vp_x", "vp_y", "vp_z"]], dtype=np.float64)
               if "vp_x" in names else None)
        normals = (
            s2u(arr[["normal_x", "normal_y", "normal_z"]], dtype=np.float64)
            if "normal_x" in names
            else None
        )
        return Cloud.from_points(pts, vps=vps, normals=normals, dtype=dtype,
                                 device=device, pad_to=pad_to)

    # ------------------------------------------------------------------
    def pad(self, n: int) -> "Cloud":
        """Pad the point axis to static size ``n`` (invalid slots)."""
        cur = self.size
        if n < cur:
            raise ValueError("pad target %d < current size %d" % (n, cur))
        if n == cur:
            return self
        axis = self.depth.dim() - 1  # the point axis

        def pad_field(x):
            shape = list(x.shape)
            shape[axis] = n - cur
            return torch.cat([x, x.new_zeros(shape)], dim=axis)

        return self.map(pad_field)

    def keep(self, mask) -> "Cloud":
        """Boolean filtering of the point axis (reference: cloud[mask])."""
        keep = torch.as_tensor(np.asarray(mask), device=self.depth.device)
        return self.map(lambda x: x[keep])
