"""Visualization helpers (host-side, optional matplotlib; counterpart of
``depth_correction_tpu/visualization.py``). Tensors convert to numpy at the
boundary.

Re-design of the reference's plotting utilities (reference: src/depth_correction/
visualization.py:9-74, utils.py:23-51): incidence-angle histograms and
colormapping. 3-D interactive viewing (the reference uses Open3D) is out of
scope for the core; clouds export to structured arrays for external viewers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "map_colors",
    "visualize_incidence_angles",
    "plot_model_curve",
    "plot_cloud_poses",
]


def _host(x) -> np.ndarray:
    """A tensor (any device, any grad state) or array as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def map_colors(values, colormap=None, min_value=None, max_value=None):
    """Scale values to [0, 1] and map through a colormap
    (reference: utils.py:23-51). ``colormap`` may be a matplotlib colormap
    or an (C, 3) array of anchor colors (2 anchors interpolate).
    """
    values = _host(values).astype(np.float64).ravel()
    lo = np.nanmin(values) if min_value is None else min_value
    hi = np.nanmax(values) if max_value is None else max_value
    scale = hi - lo
    a = (values - lo) / scale if scale > 0 else values - lo
    a = np.clip(a, 0.0, 1.0)
    if colormap is None:
        from matplotlib import cm

        colormap = cm.gist_rainbow
    if callable(colormap):
        return np.asarray(colormap(a))[:, :3]
    colormap = np.asarray(colormap)
    if len(colormap) == 2:
        return (1 - a[:, None]) * colormap[0] + a[:, None] * colormap[1]
    idx = np.round(a * (len(colormap) - 1)).astype(int)
    return colormap[idx]


def visualize_incidence_angles(clouds: Sequence, bins: int = 36, ax=None,
                               labels: Optional[Sequence[str]] = None,
                               show: bool = False):
    """Histogram grid of incidence angles per cloud
    (reference: visualization.py:9-48)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    n = len(clouds)
    if ax is not None:
        axes = np.atleast_2d(ax)
        fig = axes[0, 0].figure
    else:
        fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    for i, cloud in enumerate(clouds):
        inc = _host(cloud.inc_angles).ravel()
        if getattr(cloud, "valid", None) is not None:
            inc = inc[_host(cloud.valid).ravel()]
        axes[0, i].hist(np.degrees(inc), bins=bins, range=(0, 90))
        axes[0, i].set_xlabel("Incidence angle [deg]")
        if labels:
            axes[0, i].set_title(labels[i])
    fig.tight_layout()
    if show:  # pragma: no cover - interactive
        plt.show()
    return fig


def plot_model_curve(model, max_angle_deg: float = 89.0, depth: float = 1.0,
                     n: int = 100, ax=None):
    """Corrected depth vs incidence angle for a model
    (reference: model.py:100-109)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    angles = np.linspace(0.0, np.radians(max_angle_deg), n)
    p = next(model.parameters(), None)  # the model's float type and device
    kw = {"dtype": torch.float64, "device": "cpu"} if p is None else \
        {"dtype": p.dtype, "device": p.device}
    with torch.no_grad():
        corrected = _host(model.correct_depth(torch.full((n,), depth, **kw),
                                              torch.as_tensor(angles, **kw)))
    if ax is None:
        _, ax = plt.subplots()
    ax.plot(np.degrees(angles), corrected, label=str(model))
    ax.set_xlabel("Incidence Angle [deg]")
    ax.set_ylabel("Depth [m]")
    ax.legend()
    return ax


def plot_cloud_poses(clouds, poses=None, color_by: Optional[str] = None,
                     max_points: int = 50_000, path: Optional[str] = None,
                     axis_len: float = 0.5, show: bool = False):
    """3-D viewer of (global) clouds + sensor pose frames.

    Matplotlib substitute for the reference's Open3D dataset viewer
    (reference: visualization.py:51-74): scatter the merged cloud (random
    subsample above ``max_points``), draw RGB axis triads at each pose, and
    either save a PNG (``path``) or show interactively.

    :param clouds: (N, 3) array, Cloud, or a sequence of either.
    :param poses: optional (S, 4, 4) pose array.
    :param color_by: None = height (z); or a per-point value array.
    """
    import matplotlib

    if path is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    def to_pts(c):
        if hasattr(c, "get_points"):
            pts = _host(c.get_points())
            if getattr(c, "valid", None) is not None:
                pts = pts[_host(c.valid)]
            return pts.reshape(-1, 3)
        return _host(c).reshape(-1, 3)

    if hasattr(clouds, "get_points") or (
        isinstance(clouds, (np.ndarray, torch.Tensor)) and clouds.ndim == 2
    ):
        clouds = [clouds]
    pts = np.concatenate([to_pts(c) for c in clouds])
    if color_by is not None:
        values = _host(color_by).ravel()
        if len(values) != len(pts):
            # Per-point values were given for the PADDED clouds: apply the
            # same validity filter to_pts applied to the coordinates.
            keep = np.concatenate([
                _host(c.valid).ravel()
                if hasattr(c, "valid") and getattr(c, "valid", None) is not None
                else np.ones(len(to_pts(c)), bool)
                for c in clouds
            ])
            if len(values) == len(keep):
                values = values[keep]
            else:
                raise ValueError(
                    "color_by has %d values for %d plotted points"
                    % (len(values), len(pts))
                )
    else:
        values = pts[:, 2]
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts, values = pts[sel], values[sel]

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.3,
               c=map_colors(values), linewidths=0)
    if poses is not None:
        poses = _host(poses).reshape(-1, 4, 4)
        for T in poses:
            o = T[:3, 3]
            for a, col in enumerate(["r", "g", "b"]):
                d = T[:3, a] * axis_len
                ax.plot([o[0], o[0] + d[0]], [o[1], o[1] + d[1]],
                        [o[2], o[2] + d[2]], col, linewidth=1.5)
        ax.plot(poses[:, 0, 3], poses[:, 1, 3], poses[:, 2, 3],
                "k--", linewidth=0.8)
    # Equal aspect.
    span = (pts.max(0) - pts.min(0)).max()
    mid = (pts.max(0) + pts.min(0)) / 2
    for setl, m in zip((ax.set_xlim, ax.set_ylim, ax.set_zlim), mid):
        setl(m - span / 2, m + span / 2)
    if path is not None:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    elif show:  # pragma: no cover - interactive
        plt.show()
    return fig
