"""Reconstruction (map) quality against a ground-truth cloud.

Port of the JAX package's scripts/reconstruction_eval.py (reference:
scripts/reconstruction_eval:16-60): aggregate the (optionally
depth-corrected) dataset map and compare it to the ground-truth cloud with
the one-sided chamfer distance (kernel X3 at k = 1 on the card), before and
after correction. Appends ``reconstruction_eval.csv`` rows
``"<dataset> <chamfer_raw> <chamfer_corr>"``.

Runs on newer_college (GT prior map) when the data is present, otherwise on
a synthetic open-box stand-in with an injected bias.

Usage: python -m depth_correction_tpu_torch.studies.reconstruction_eval
           [--dataset NAME] [--out DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import add_device_arg


def aggregate_map(datasets, cfg, model=None) -> np.ndarray:
    """Corrected, GT-posed, merged map points (the reference aggregates the
    SLAM map; here the map is the GT-posed merge, the quantity
    mapping_accuracy uses, scripts/mapping_accuracy:91-99)."""
    from ..preproc import global_cloud, local_feature_cloud, sequence_batch

    parts = []
    with torch.no_grad():
        for ds in datasets:
            clouds, poses = [], []
            for scan, pose in ds:
                clouds.append(local_feature_cloud(scan, cfg))
                poses.append(np.asarray(pose))
            g = global_cloud(sequence_batch(clouds, np.stack(poses)), model=model)
            parts.append(g.get_points()[g.valid].cpu().numpy())
    return np.concatenate(parts)


def make_cfg(device: str = "cuda"):
    """The JAX script's settings (reconstruction_eval.py:58-64)."""
    from ..config import Config

    cfg = Config()
    cfg.device = device
    cfg.float_type = "float32"
    cfg.grid_res = 0.2
    cfg.min_depth, cfg.max_depth = 1.0, 20.0
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.nn_max_neighbors = 32
    cfg.eigenvalue_ratio_bounds = []
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="newer_college/01_short_experiment")
    p.add_argument("--out", default="gen/reconstruction_eval")
    p.add_argument("--model-w", type=float, default=-0.002)
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..datasets import create_dataset
    from ..datasets.newer_college import data_dir
    from ..metrics import chamfer_distance
    from ..models import ScaledPolynomial
    from ..utils.io import append

    cfg = make_cfg(args.device)
    dtype, device = cfg.torch_dtype(), cfg.torch_device()
    name = args.dataset
    if name.startswith("newer_college") and os.path.isdir(data_dir):
        from ..datasets.newer_college import Dataset

        ds = create_dataset(name, cfg)
        gt = Dataset(name).get_ground_truth_cloud(voxel_size=cfg.grid_res)
    else:
        from ..experiments import synthetic_gt_map

        name = "open_box/n_4_size_12_12_4_height_1_density_60"
        cfg.min_depth = 0.5
        cfg.depth_bias_model_kwargs = {"w": [args.model_w], "exponent": [4.0]}
        print("newer_college data not found; running the synthetic stand-in")
        ds = create_dataset(name, cfg)
        gt = synthetic_gt_map(name, cfg, density_mult=2.0)

    model = ScaledPolynomial(w=[args.model_w], exponent=[4.0], dtype=dtype, device=device)
    map_raw = aggregate_map([ds], cfg, model=None)
    map_corr = aggregate_map([ds], cfg, model=model)
    gt_t = torch.as_tensor(np.asarray(gt, np.float32), dtype=dtype, device=device)
    ch_raw = float(chamfer_distance(torch.as_tensor(map_raw, dtype=dtype, device=device), gt_t))
    ch_corr = float(chamfer_distance(torch.as_tensor(map_corr, dtype=dtype, device=device),
                                     gt_t))
    print("chamfer vs GT: raw %.6g m, corrected %.6g m (%s)" % (ch_raw, ch_corr, name))
    os.makedirs(args.out, exist_ok=True)
    append(os.path.join(args.out, "reconstruction_eval.csv"),
           "%s %.9g %.9g\n" % (name, ch_raw, ch_corr))
    return ch_raw, ch_corr


if __name__ == "__main__":
    main(sys.argv[1:])
