"""Joint model and pose optimization with map and pose accuracy tracking.

Port of the JAX package's scripts/model_poses_learning.py (reference:
scripts/model_poses_learning:56-195): FEE-corridor static scans, joint
(ScaledPolynomial, per-pose SE(3) delta) optimization of a map-consistency
loss (``experiments.joint_learning``), tracking (a) the pose L2 against
the Leica tracker positions and (b) the mapping accuracy against the
ground-truth scanner map.

Runs on the real fee_corridor data when present, otherwise on a synthetic
open-box stand-in with an injected known bias and pose noise.

Usage: python -m depth_correction_tpu_torch.studies.model_poses_learning
           [--loss trace_loss] [--out DIR] [--iters N] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import add_device_arg

SYNTHETIC = "open_box/n_6_size_20_20_5_height_1_density_100"


def make_cfg(loss: str, device: str = "cuda", float_type: str = "float32"):
    """The JAX script's settings (model_poses_learning.py:30-47)."""
    from ..config import Config, PoseCorrection

    cfg = Config()
    cfg.device = device
    cfg.float_type = float_type
    cfg.grid_res = 0.2
    cfg.min_depth, cfg.max_depth = 1.0, 20.0
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.nn_max_neighbors = 32
    cfg.lr = 1e-3
    cfg.n_opt_iters = 100
    cfg.pose_correction = PoseCorrection.pose
    cfg.loss = loss
    cfg.loss_kwargs = {"sqrt": False, "normalization": loss == "min_eigval_loss"}
    # Two-term polynomial like the reference run (model_poses_learning:96).
    cfg.model_class = "ScaledPolynomial"
    cfg.model_kwargs = {"w": [0.0, 0.0], "exponent": [2.0, 4.0]}
    return cfg


def fee_corridor_inputs(cfg, seq: str = "seq2_end_10"):
    """Real-data inputs: static scans, Leica positions, GT map."""
    from numpy.lib.recfunctions import structured_to_unstructured as s2u

    from ..datasets import create_dataset
    from ..datasets.fee_corridor import Dataset, read_poses

    cfg.dataset_kwargs = {"static_poses": True}
    ds = create_dataset("fee_corridor/" + seq, cfg)
    base = Dataset(name=seq, static_poses=True)
    # Leica rows are in pose-file order; map them onto the windowed ids
    # (reference: model_poses_learning:112-113 indexes leica_xyz by id).
    ids_all, _ = read_poses(base.cloud_poses_path())
    xyz_by_id = dict(zip(ids_all, base.read_leica_xyz()))
    gt_xyz = np.stack([xyz_by_id[i] for i in base.ids])
    gt_map = s2u(base.global_cloud(resolution_cm=5)[["x", "y", "z"]])
    return [ds], gt_map, gt_xyz


def synthetic_inputs(cfg, name: str = SYNTHETIC):
    """Stand-in: open box + injected bias + per-pose noise."""
    from ..datasets import create_dataset
    from ..experiments import synthetic_gt_map, synthetic_gt_positions

    cfg.min_depth = 0.5
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.pose_noise = [1e-3, 1e-3, 1e-3, 0.01, 0.01, 0.01]
    cfg.pose_noise_mode = "pose"
    ds = create_dataset(name, cfg)
    return [ds], synthetic_gt_map(name, cfg), synthetic_gt_positions(name, cfg)


def run(argv=None, pose_correction=None, loss: str = "trace_loss", out: str = None):
    """The script's body; ``pose_correction`` overrides the config's mode
    (``none`` is scripts/model_learning's model-only run), ``loss`` and
    ``out`` are the defaults of ``--loss`` and ``--out``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--loss", default=loss, choices=["trace_loss", "min_eigval_loss", "icp_loss"])
    p.add_argument("--seq", default="seq2_end_10")
    p.add_argument("--out", default=out or "gen/model_poses_learning")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--float-type", default="float32")
    p.add_argument("--scene", default=SYNTHETIC,
                   help="the synthetic stand-in's open box when the data is missing")
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..datasets.fee_corridor import data_dir
    from ..experiments import joint_learning

    cfg = make_cfg(args.loss, args.device, args.float_type)
    cfg.torch_device()  # no card: raise before any work
    if pose_correction is not None:
        cfg.pose_correction = pose_correction
    if args.iters:
        cfg.n_opt_iters = args.iters
    if os.path.isdir(os.path.join(data_dir, "sequences")):
        datasets, gt_map, gt_xyz = fee_corridor_inputs(cfg, args.seq)
        print("Training on fee_corridor/%s" % args.seq)
    else:
        datasets, gt_map, gt_xyz = synthetic_inputs(cfg, args.scene)
        print("fee_corridor data not found; running the synthetic stand-in")

    hist = joint_learning(cfg, datasets=datasets, gt_map=gt_map, gt_positions=gt_xyz,
                          metrics_every=10,
                          log_csv=os.path.join(args.out, "%s_history.csv" % args.loss))
    print("final: loss %.6g, pose L2 %.4g m, map accuracy %.4g m"
          % (hist.train_loss[-1], hist.pose_l2[-1], hist.map_accuracy[-1]))
    print("model:", hist.params["model"])
    return hist


def main(argv=None):
    return run(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
