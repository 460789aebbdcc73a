"""Range-image projection (counterpart of ``depth_correction_tpu/ops/
range_image.py``).

The reference's depth-denoising projection utilities (reference:
scripts/depth_denoising:18-23, 44-91): project a lidar scan into an (H, W)
range image over azimuth x elevation bins, and unproject back to rays.
Fixed shapes; a scatter-min resolves bin collisions.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["project_range_image", "unproject_range_image"]


def project_range_image(points: torch.Tensor, valid: torch.Tensor, height: int = 128,
                        width: int = 1024, fov_up: float = 0.3927,  # 22.5 deg
                        fov_down: float = -0.3927) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project (N, 3) sensor-frame points to an (H, W) range image.

    Azimuth spans [-pi, pi) across the width; elevation spans
    [fov_down, fov_up] across the height (row 0 = fov_up, the lidar
    convention). Collisions keep the closest return (scatter-min).

    :return: (range image (H, W), hit mask (H, W)); empty bins hold 0.
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    depth = torch.linalg.norm(points, dim=-1)
    ok = valid & (depth > 1e-6)

    azimuth = torch.atan2(y, x)  # [-pi, pi)
    elevation = torch.arcsin(torch.clamp(z / torch.clamp(depth, min=1e-9), -1.0, 1.0))

    u = (azimuth + math.pi) / (2.0 * math.pi) * width
    v = (fov_up - elevation) / (fov_up - fov_down) * height
    # Truncation toward zero, as astype(int32) does.
    ui = torch.clamp(u.to(torch.int32), 0, width - 1)
    vi = torch.clamp(v.to(torch.int32), 0, height - 1)
    # Inclusive bottom edge: a beam at exactly fov_down projects to
    # v == height and belongs in row height - 1 (vi clamps it there), as
    # the top edge v == 0 stays in row 0; otherwise the common
    # linspace(fov_down, fov_up, H) beam layout loses its bottom row.
    inside = ok & (v >= 0) & (v <= height)

    flat = (vi * width + ui).long()
    big = torch.full((), float("inf"), dtype=depth.dtype, device=depth.device)
    img = torch.full((height * width,), float("inf"), dtype=depth.dtype, device=depth.device)
    img = img.scatter_reduce(0, torch.where(inside, flat, torch.zeros_like(flat)),
                             torch.where(inside, depth, big), "amin")
    img = img.reshape(height, width)
    hit = torch.isfinite(img)
    return torch.where(hit, img, torch.zeros_like(img)), hit


def unproject_range_image(image: torch.Tensor, hit: torch.Tensor, height: int = 128,
                          width: int = 1024, fov_up: float = 0.3927,
                          fov_down: float = -0.3927) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`project_range_image` at bin centres.

    :return: ((H*W, 3) points, (H*W,) valid mask).
    """
    kw = {"dtype": image.dtype, "device": image.device}
    vi, ui = torch.meshgrid(torch.arange(height, **kw), torch.arange(width, **kw),
                            indexing="ij")
    azimuth = (ui + 0.5) / width * 2.0 * math.pi - math.pi
    elevation = fov_up - (vi + 0.5) / height * (fov_up - fov_down)
    cos_e = torch.cos(elevation)
    pts = torch.stack([image * cos_e * torch.cos(azimuth), image * cos_e * torch.sin(azimuth),
                       image * torch.sin(elevation)], -1)
    return pts.reshape(-1, 3), hit.reshape(-1)
