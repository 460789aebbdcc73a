"""Map accuracy before and after depth correction against a ground-truth map.

Port of the JAX package's scripts/mapping_accuracy.py (reference:
scripts/mapping_accuracy:72-118): aggregate (corrected) scans into a map
and measure the inlier-trimmed point-to-point distance to the
ground-truth map (``metrics.mapping_accuracy``: kernel X3 at k = 1 on the
card) for a bank of models. Without the FEE Corridor data and without
``--gt-map``, a synthetic open box with an injected bias stands in, its
ground truth from ``experiments.synthetic_gt_map``.

Usage: python -m depth_correction_tpu_torch.studies.mapping_accuracy
           [--dataset NAME] [--gt-map FILE.npz] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import add_device_arg

# The only concrete trained-model numbers published in the reference repo
# (FEE Corridor, exponent 4; reference: scripts/mapping_accuracy:72-80).
REFERENCE_MODELS = [
    ("ScaledPolynomial", [-0.00068]),
    ("ScaledPolynomial", [-0.00110]),
    ("ScaledPolynomial", [-0.00096]),
    ("ScaledPolynomial", [-0.00035]),
    ("Polynomial", [-0.001227]),
    ("Polynomial", [-0.001375]),
    ("Polynomial", [-0.001376]),
    ("Polynomial", [-0.001159]),
]
SYNTHETIC = "open_box/n_4_size_12_12_4_height_1_density_60"


def aggregate_map(ds, cfg, model=None):
    """Each scan's feature cloud, corrected by ``model``, posed and merged:
    (points (M, 3), valid (M,))."""
    from ..preproc import local_feature_cloud

    pts, valid = [], []
    with torch.no_grad():
        for scan, pose in ds:
            cloud = local_feature_cloud(scan, cfg)
            if model is not None:
                cloud = model.apply(cloud)
            T = torch.as_tensor(np.asarray(pose), dtype=cloud.vps.dtype, device=cloud.vps.device)
            cloud = cloud.transform(T).with_points()
            pts.append(cloud.get_points())
            valid.append(cloud.valid)
    return torch.cat(pts), torch.cat(valid)


def make_cfg(device: str = "cuda"):
    """The JAX script's settings (mapping_accuracy.py:61-64)."""
    from ..config import Config

    cfg = Config()
    cfg.device = device
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 1.0, 25.0, 0.2
    cfg.nn_r = 0.4
    cfg.depth_bias_model_kwargs = {"w": [0.0], "exponent": [4.0]}
    return cfg


def _xyz(arr) -> np.ndarray:
    from numpy.lib.recfunctions import structured_to_unstructured

    arr = np.asarray(arr)
    return structured_to_unstructured(arr[["x", "y", "z"]]) if arr.dtype.names else arr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="fee_corridor/seq1")
    ap.add_argument("--gt-map", default=None, help="npz with 'cloud' or (N,3)")
    ap.add_argument("--inlier-ratio", type=float, default=0.8)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..datasets import create_dataset
    from ..datasets.fee_corridor import data_dir
    from ..experiments import synthetic_gt_map
    from ..metrics import mapping_accuracy
    from ..models import load_model

    cfg = make_cfg(args.device)
    dtype, device = cfg.torch_dtype(), cfg.torch_device()
    name = args.dataset
    if (name.startswith("fee_corridor") and not args.gt_map
            and not os.path.isdir(os.path.join(data_dir, "sequences"))):
        print("fee_corridor data not found; running the synthetic stand-in")
        name = SYNTHETIC
        cfg.min_depth = 0.5
        cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
        ds = create_dataset(name, cfg)
        gt = synthetic_gt_map(name, cfg, density_mult=2.0)
    else:
        ds = create_dataset(name, cfg)
        if args.gt_map:
            data = np.load(args.gt_map)
            gt = data["cloud"] if "cloud" in getattr(data, "files", []) else np.asarray(data)
        else:
            # The dataset's own GT map (fee_corridor exposes map_5cm_alligned.npz).
            gt = ds.global_cloud()
        gt = _xyz(gt)
    gt = torch.as_tensor(np.asarray(gt, np.float32), dtype=dtype, device=device)

    pts, valid = aggregate_map(ds, cfg, model=None)
    before = float(mapping_accuracy(pts, gt, args.inlier_ratio, valid_cloud=valid))
    print("uncorrected map accuracy: %.4f m" % before)
    results = {"before": before}
    for cls, w in REFERENCE_MODELS:
        model = load_model(class_name=cls, model_kwargs={"w": w, "exponent": [4.0]},
                           dtype=dtype, device=device)
        pts, valid = aggregate_map(ds, cfg, model=model)
        after = float(mapping_accuracy(pts, gt, args.inlier_ratio, valid_cloud=valid))
        print("%s(w=%s): %.4f m (%+.2f%%)" % (cls, w, after, 100 * (after - before) / before))
        results["%s%s" % (cls, w)] = after
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
