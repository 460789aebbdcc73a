"""Grid search over model weights against a chosen loss.

Port of the JAX package's scripts/weights_search.py (reference:
scripts/weights_search:59-80): the data is prepared once and the weights
are swept by ``loss_landscape.sweep_weight`` (kernel K1 once a weight on
the cell-window graph, forward only).

Usage: python -m depth_correction_tpu_torch.studies.weights_search
           [--dataset NAME] [--loss NAME] [--gt-w W] [--n N] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from . import add_device_arg, default_float_type


def make_cfg(dataset: str = "ground_plane/6", loss: str = "min_eigval_loss",
             gt_w: float = -0.002, device: str = "cuda"):
    """The JAX script's settings (weights_search.py:36-47); its float64 on
    the CPU, float32 on a card (:func:`default_float_type`)."""
    from ..config import Config

    cfg = Config()
    cfg.device = device
    cfg.float_type = default_float_type(device)
    cfg.train_names = [dataset]
    cfg.loss = loss
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.2
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [gt_w], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": False}
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="ground_plane/6")
    ap.add_argument("--loss", default="min_eigval_loss")
    ap.add_argument("--gt-w", type=float, default=-0.002)
    ap.add_argument("--w-min", type=float, default=-0.005)
    ap.add_argument("--w-max", type=float, default=0.005)
    ap.add_argument("--n", type=int, default=21)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..loss_landscape import loss_landscape

    cfg = make_cfg(args.dataset, args.loss, args.gt_w, args.device)
    w, losses = loss_landscape(cfg, weights=np.linspace(args.w_min, args.w_max, args.n))
    w, losses = np.asarray(w), np.asarray(losses)
    for wi, li in zip(w, losses):
        marker = " <- min" if li == losses.min() else ""
        print("w=%+.5f  loss=%.6e%s" % (wi, li, marker))
    print("best w: %+.5f (GT %+.5f)" % (w[np.argmin(losses)], args.gt_w))
    return w, losses


if __name__ == "__main__":
    main(sys.argv[1:])
