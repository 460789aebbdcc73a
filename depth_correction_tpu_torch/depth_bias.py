"""Depth-bias analysis: fit plane-distance vs incidence-angle trends
(counterpart of ``depth_correction_tpu/depth_bias.py``).

Re-design of the reference's bias visualizer (reference: src/depth_correction/
depth_bias.py:57-156): for a feature cloud, regress the signed distance to
the local plane (along the normal) against the incidence angle with low-order
polynomials — the empirical signature of the bias a correction model should
remove.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .cloud import Cloud

__all__ = ["plane_distances", "fit_depth_bias", "plot_fit", "plot_depth_bias"]


def plane_distances(cloud: Cloud) -> torch.Tensor:
    """Signed distance of each point to its local-plane fit, along the
    normal: n . (x - mean) (reference: loss.py demo:648)."""
    assert cloud.normals is not None and cloud.mean is not None
    return (cloud.normals * (cloud.get_points() - cloud.mean)).sum(-1)


def _host(x) -> np.ndarray:
    """A tensor (any device, any grad state) or array as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def fit_depth_bias(
    cloud: Cloud, mask: Optional[np.ndarray] = None, degrees=(1, 2)
) -> Dict[str, np.ndarray]:
    """Polynomial fits of bias trends (reference: depth_bias.py:57-87).

    :return: dict with per-degree coefficients (ascending order, numpy
        polynomial convention) for three regressions: distance vs incidence
        angle, normalized distance (dist/depth) vs angle, and normalized
        distance vs 1/cos(angle).
    """
    dist = _host(plane_distances(cloud))
    inc = _host(cloud.inc_angles)
    depth = _host(cloud.depth)
    keep = _host(cloud.valid)
    if mask is not None:
        keep = keep & _host(mask)
    keep = keep & np.isfinite(dist) & np.isfinite(inc)
    dist, inc, depth = dist[keep], inc[keep], depth[keep]
    norm_dist = dist / np.maximum(depth, 1e-9)
    inv_cos = 1.0 / np.maximum(np.cos(inc), 1e-9)

    out = {}
    for deg in degrees:
        out["dist_vs_angle_deg%d" % deg] = np.polynomial.polynomial.polyfit(
            inc, dist, deg
        )
        out["norm_dist_vs_angle_deg%d" % deg] = np.polynomial.polynomial.polyfit(
            inc, norm_dist, deg
        )
        out["norm_dist_vs_inv_cos_deg%d" % deg] = np.polynomial.polynomial.polyfit(
            inv_cos, norm_dist, deg
        )
    return out


def plot_fit(x, y, y_corr=None, x_label="x", y_label="y", deg: int = 1,
             show: bool = False,
             ax=None, path: Optional[str] = None):
    """Scatter + low-order polynomial fit, optionally before/after
    correction (reference: depth_bias.py:57-87).

    :return: the matplotlib axis.
    """
    import matplotlib

    if path is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    x = _host(x).ravel()
    y = _host(y).ravel()
    coef = np.polynomial.polynomial.polyfit(x, y, deg)
    xs = np.linspace(x.min(), x.max(), 200)
    if ax is None:
        fig, ax = plt.subplots(1, 1, figsize=(6.4, 6.4))
    else:
        fig = ax.figure
    ax.plot(x, y, "r.", markersize=0.5, alpha=0.2, label="data")
    ax.plot(xs, np.polynomial.polynomial.polyval(xs, coef), "r--",
            linewidth=2, label="fit deg. %d" % deg)
    if y_corr is not None:
        y_corr = _host(y_corr).ravel()
        coef_c = np.polynomial.polynomial.polyfit(x, y_corr, deg)
        ax.plot(x, y_corr, "b.", markersize=0.5, alpha=0.2, label="data corr.")
        ax.plot(xs, np.polynomial.polynomial.polyval(xs, coef_c), "b--",
                linewidth=2, label="fit deg. %d corr." % deg)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    ax.grid(True)
    ax.legend()
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
    if show:  # interactive display (reference: cfg.show_results)
        plt.show()
    if path is not None:
        # Close even after show(): on non-interactive backends show() is a
        # no-op and plot_depth_bias calls this per (cloud, tag) — leaking a
        # figure per scan grows unbounded over a long eval run.
        plt.close(fig)
    return ax


def plot_depth_bias(clouds, cfg, model=None, out_dir: Optional[str] = None):
    """Bias-signature plots for feature clouds: plane distance (raw and,
    with a model, corrected) vs incidence angle and vs 1/cos(angle)
    (reference: depth_bias.py:90-156), saved as PNGs when ``out_dir``.

    :param clouds: sequence of per-scan feature Clouds (with normals/mean/
        inc_angles — e.g. from ``preproc.local_feature_cloud``).
    :return: list of created figure paths (or axes when out_dir is None).
    """
    import os

    outs = []
    for i, cloud in enumerate(clouds):
        keep = _host(cloud.valid)
        if cloud.mask is not None:
            keep = keep & _host(cloud.mask)
        # Same finite filter as fit_depth_bias: one NaN row (degenerate
        # neighborhood) would turn the polyfit all-NaN and silently drop
        # the fit line from every figure.
        keep = keep & np.isfinite(_host(plane_distances(cloud)))
        keep = keep & np.isfinite(_host(cloud.inc_angles))
        dist = _host(plane_distances(cloud))[keep]
        inc = _host(cloud.inc_angles)[keep]
        depth = _host(cloud.depth)[keep]
        norm_dist = dist / np.maximum(depth, 1e-9)
        dist_corr = None
        if model is not None:
            with torch.no_grad():
                corrected = model.apply(cloud)
            dist_corr = _host(plane_distances(corrected.with_points()))[keep]
            dist_corr = dist_corr / np.maximum(depth, 1e-9)
        for x, xl, tag in (
            (inc, "incidence angle [rad]", "angle"),
            (1.0 / np.maximum(np.cos(inc), 1e-9), "1/cos(angle)", "inv_cos"),
        ):
            path = None
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(
                    out_dir, "depth_bias_%02d_%s.png" % (i, tag)
                )
            ax = plot_fit(x, norm_dist, y_corr=dist_corr, x_label=xl,
                          y_label="normalized plane distance", path=path,
                          show=bool(getattr(cfg, "show_results", False)))
            outs.append(path if path is not None else ax)
    return outs
