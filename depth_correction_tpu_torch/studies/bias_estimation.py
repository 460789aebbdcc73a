"""Board-plane depth-bias estimation.

Port of the JAX package's scripts/bias_estimation.py (reference:
scripts/bias_estimation:28-60, bias_estimation_big_board): scans of a
planar calibration board viewed under varying incidence angles are
compared against the true board plane; the signed plane distance as a
function of incidence angle is the empirical bias curve, fitted with
low-order polynomials and re-checked after applying a correction model.

Without input data, a synthetic board (known plane, injected
ScaledPolynomial bias) demonstrates the pipeline and recovers the injected
bias curve.

Usage: python -m depth_correction_tpu_torch.studies.bias_estimation
           [--model-w W] [--out DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import add_device_arg, torch_device


def synthetic_board_scans(w_bias=-0.002, exponent=4.0, n_views=7, seed=0):
    """Board at z=0 viewed from poses at increasing tilt; returns
    (points, vps, true normal) per view with the bias injected along rays."""
    rng = np.random.default_rng(seed)
    outs = []
    for i in range(n_views):
        # Sensor above the board, tilted so incidence angles vary per view.
        tilt = np.deg2rad(10 + 70 * i / max(n_views - 1, 1))
        vp = np.asarray([-3.0 * np.sin(tilt), 0.0, 3.0 * np.cos(tilt)])
        board = np.stack([rng.uniform(-1.0, 1.0, 800), rng.uniform(-1.0, 1.0, 800),
                          np.zeros(800)], axis=1)
        rays = board - vp
        depth = np.linalg.norm(rays, axis=1)
        dirs = rays / depth[:, None]
        inc = np.arccos(np.clip(np.abs(dirs @ [0.0, 0.0, 1.0]), 0, 1))
        # Inverse model injects the bias (reference: model.py:263-274).
        biased_depth = depth / (1.0 - w_bias * inc**exponent)
        pts = vp + biased_depth[:, None] * dirs
        outs.append((pts, np.tile(vp, (len(pts), 1)), np.asarray([0.0, 0.0, 1.0])))
    return outs


def estimate_bias(scans, model=None):
    """Pool (incidence angle, normalized plane distance) over all views and
    fit deg-1/2 polynomials (reference: bias_estimation:28-60 uses the
    known board plane instead of local plane fits). The model's correction
    runs on the model's device in its float type."""
    angles, norm_dists = [], []
    for pts, vps, normal in scans:
        rays = pts - vps
        depth = np.linalg.norm(rays, axis=1)
        dirs = rays / np.maximum(depth, 1e-9)[:, None]
        inc = np.arccos(np.clip(np.abs(dirs @ normal), 0.0, 1.0))
        if model is not None:
            w = model.w
            with torch.no_grad():
                depth = model.correct_depth(
                    torch.as_tensor(depth, dtype=w.dtype, device=w.device),
                    torch.as_tensor(inc, dtype=w.dtype, device=w.device)).cpu().numpy()
            pts = vps + depth[:, None] * dirs
        # Signed distance to the board plane along its normal.
        dist = (pts - pts.mean(axis=0)) @ normal
        angles.append(inc)
        norm_dists.append(dist / np.maximum(depth, 1e-9))
    inc = np.concatenate(angles)
    nd = np.concatenate(norm_dists)
    fits = {deg: np.polynomial.polynomial.polyfit(inc, nd, deg) for deg in (1, 2)}
    return inc, nd, fits


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-w", type=float, default=-0.002)
    p.add_argument("--exponent", type=float, default=4.0)
    p.add_argument("--out", default="gen/bias_estimation")
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..depth_bias import plot_fit
    from ..models import ScaledPolynomial

    device = torch_device(args.device)
    scans = synthetic_board_scans(w_bias=args.model_w, exponent=args.exponent)
    inc, nd, fits = estimate_bias(scans)
    print("raw bias fits (deg1, deg2):", fits[1], fits[2])

    model = ScaledPolynomial(w=[args.model_w], exponent=[args.exponent], dtype=torch.float64,
                             device=device)
    inc_c, nd_c, fits_c = estimate_bias(scans, model=model)
    print("corrected bias fits (deg1, deg2):", fits_c[1], fits_c[2])

    os.makedirs(args.out, exist_ok=True)
    try:
        plot_fit(inc, nd, y_corr=nd_c, x_label="incidence angle [rad]",
                 y_label="normalized board-plane distance",
                 path=os.path.join(args.out, "bias_estimation.png"))
        print("plot:", os.path.join(args.out, "bias_estimation.png"))
    except ImportError as e:  # no matplotlib: the fits are the result
        print("plot skipped: %s" % e)
    # Correction must flatten the trend (slope shrinks).
    return abs(fits[1][1]), abs(fits_c[1][1])


if __name__ == "__main__":
    main(sys.argv[1:])
