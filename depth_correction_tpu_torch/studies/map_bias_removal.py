"""Remove the learned depth bias from an aggregated map.

Port of the JAX package's scripts/map_bias_removal.py (reference:
scripts/map_bias_removal:765-836, which reads a SLAM map from a rosbag):
load an aggregated map with per-point viewpoints (npz from
``slam_eval.export_corrected_clouds`` or any structured cloud with
``x y z vp_x vp_y vp_z``), estimate local features (normals, incidence
angles), apply the correction model in the inverse direction of the
recorded bias, and save the corrected map.

Without input, a synthetic biased map demonstrates the pipeline.

Usage: python -m depth_correction_tpu_torch.studies.map_bias_removal
           [--map FILE.npz] [--model-w W] [--out DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import add_device_arg


def make_cfg(device: str = "cuda", float_type: str = "float32"):
    """The JAX script's settings (map_bias_removal.py:49-55)."""
    from ..config import Config

    cfg = Config()
    cfg.device = device
    cfg.float_type = float_type
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.5, 50.0, 0.0
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.nn_max_neighbors = 32
    cfg.eigenvalue_ratio_bounds = []
    cfg.vp_dispersion_bounds = []
    return cfg


def correct_map(points, vps, cfg, model):
    """Feature-annotate the map and correct its depths with ``model``."""
    from ..preproc import local_feature_cloud

    cloud = local_feature_cloud((points, vps, None), cfg)
    with torch.no_grad():
        corrected = model.apply(cloud).with_points()
    keep = corrected.valid.cpu().numpy()
    return corrected.points.cpu().numpy()[keep]


def synthetic_map(cfg, model_w: float = -0.002, exponent: float = 4.0):
    """The open box's scans with the bias injected, posed and merged, and
    each point's viewpoint (map_bias_removal.py:62-75)."""
    from numpy.lib.recfunctions import structured_to_unstructured as s2u

    from ..datasets import create_dataset
    from ..datasets.synthetic import transform_structured

    cfg.depth_bias_model_kwargs = {"w": [model_w], "exponent": [exponent]}
    ds = create_dataset("open_box/n_4_size_12_12_4_height_1_density_60", cfg)
    pts, vp_list = [], []
    for arr, pose in ds:
        posed = transform_structured(np.asarray(pose), arr)
        pts.append(s2u(posed[["x", "y", "z"]], dtype=np.float64))
        vp_list.append(np.tile(np.asarray(pose)[:3, 3], (len(posed), 1)))
    return np.concatenate(pts), np.concatenate(vp_list)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map", default=None, help="npz with points (+ vps) arrays")
    p.add_argument("--model-w", type=float, default=-0.002)
    p.add_argument("--exponent", type=float, default=4.0)
    p.add_argument("--out", default="gen/map_bias_removal")
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..models import ScaledPolynomial

    cfg = make_cfg(args.device)
    cfg.torch_device()  # no card: raise before any work
    if args.map:
        data = np.load(args.map)
        points = np.asarray(data["points"], np.float64)
        vps = np.asarray(data["vps"], np.float64) if "vps" in data else np.zeros_like(points)
    else:
        print("no input map; running the synthetic demo")
        points, vps = synthetic_map(cfg, args.model_w, args.exponent)

    model = ScaledPolynomial(w=[args.model_w], exponent=[args.exponent],
                             dtype=cfg.torch_dtype(), device=cfg.torch_device())
    corrected = correct_map(points, vps, cfg, model)
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "map_corrected.npz")
    np.savez_compressed(out_path, points=corrected)
    print("corrected map: %d points -> %s" % (len(corrected), out_path))
    return corrected


if __name__ == "__main__":
    main(sys.argv[1:])
