"""Pair-of-scans ICP optimization demo.

Port of the JAX package's scripts/optimization_pair_of_scans.py
(reference: scripts/optimization_pair_of_scans:60-176): optimize a
depth-correction model on one consecutive scan pair with the
point-to-plane ICP objective, track a held-out validation pair, and save
the loss curves, a top-down cloud view and the model curve the reference
shows interactively (a saved figure and a CSV here). Correspondences are
frozen in prep (kernel X3 at k = 1 on the card).

Skips training pairs whose viewpoints are farther apart than
``--max-pose-dist`` (reference :94-97).

Usage: python -m depth_correction_tpu_torch.studies.optimization_pair_of_scans
           [--dataset NAME] [--train-pair I] [--val-pair J] [--iters N] [--out DIR]
           [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import add_device_arg


def make_cfg(name, device: str = "cuda", float_type: str = "float32"):
    """The JAX script's settings (optimization_pair_of_scans.py:30-45)."""
    from ..config import Config

    cfg = Config()
    cfg.device = device
    cfg.float_type = float_type
    cfg.train_names = [name]
    cfg.min_depth, cfg.max_depth = 1.0, 25.0
    cfg.grid_res = 0.2
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.loss = "icp_loss"
    cfg.loss_kwargs = {"icp_point_to_plane": True, "icp_inlier_ratio": 0.5}
    cfg.lr = 2e-4
    return cfg


def pair_data(ds, i, cfg):
    """TrainData over scans (i, i+1) and the viewpoint distance."""
    from ..datasets.wrappers import Subscriptable
    from ..train import prepare_sequences

    data = prepare_sequences([Subscriptable(ds)[i:i + 2]], cfg)
    poses = data.batches[0].poses.cpu().numpy()
    return data, float(np.linalg.norm(poses[0][:3, 3] - poses[1][:3, 3]))


def optimize(cfg, train_data, val_data, iters: int):
    """``iters`` Adam steps (optax's update, ``optim.Adam``) of w on the
    training pair, the validation loss taken after each step. Returns
    (model, [(it, train loss, val loss)]); the train loss is taken at the
    parameters the step starts from."""
    from ..models import ScaledPolynomial
    from ..optim import Adam
    from ..train import make_loss_fn

    loss_fn = make_loss_fn(cfg)
    model = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=cfg.torch_dtype(),
                             device=cfg.torch_device())
    opt = Adam([model.w], lr=cfg.lr)
    hist = []
    for it in range(iters):
        opt.zero_grad(set_to_none=True)
        train_loss = loss_fn(model, train_data)
        train_loss.backward()
        opt.step()
        with torch.no_grad():
            val_loss = loss_fn(model, val_data)
        hist.append((it, float(train_loss.detach()), float(val_loss)))
        if it % 50 == 0 or it == iters - 1:
            print("it %03d: train %.6e  val %.6e  w %.5e"
                  % (it, hist[-1][1], hist[-1][2], float(model.w.detach()[0])))
    return model, hist


def save_dashboard(path: str, hist_np, model, train_data) -> None:
    """Loss deltas, the top-down corrected training cloud and the model
    curve (reference: scripts/optimization_pair_of_scans:135-172)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..preproc import global_cloud

    fig, axes = plt.subplots(2, 2, figsize=(14, 8), constrained_layout=True)
    fig.suptitle("ICP optimization (pair of scans)")
    axes[0, 0].plot(hist_np[:, 0], hist_np[:, 1] - hist_np[0, 1])
    axes[0, 0].set_xlabel("Iterations")
    axes[0, 0].set_ylabel("ICP train loss delta")
    axes[0, 0].grid(True)
    axes[0, 1].plot(hist_np[:, 0], hist_np[:, 2] - hist_np[0, 2])
    axes[0, 1].set_xlabel("Iterations")
    axes[0, 1].set_ylabel("ICP val loss delta")
    axes[0, 1].grid(True)
    with torch.no_grad():
        gc = global_cloud(train_data.batches[0], model=model)
        pts = gc.get_points()[gc.valid].cpu().numpy()
        gamma = np.linspace(0, np.pi / 2, 100)
        w = model.w
        corrected = model.correct_depth(torch.ones(100, dtype=w.dtype, device=w.device),
                                        torch.as_tensor(gamma, dtype=w.dtype, device=w.device))
    ax = axes[1, 0]
    sel = np.unique(np.linspace(0, len(pts) - 1, 5000, dtype=int))
    ax.plot(pts[sel, 0], pts[sel, 1], ".", markersize=2)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("train cloud: y [m]")
    ax.grid(True)
    ax.axis("equal")
    axes[1, 1].plot(np.degrees(gamma), corrected.cpu().numpy() - 1.0)
    axes[1, 1].set_xlabel("incidence angle [deg]")
    axes[1, 1].set_ylabel("depth correction @ 1 m [m]")
    axes[1, 1].grid(True)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="ground_plane/6")
    p.add_argument("--train-pair", type=int, default=0)
    p.add_argument("--val-pair", type=int, default=3)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--max-pose-dist", type=float, default=3.0)
    p.add_argument("--bias-w", type=float, default=-0.002,
                   help="synthetic injected bias (synthetic datasets)")
    p.add_argument("--out", default="gen/optimization_pair_of_scans")
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..datasets import create_dataset

    cfg = make_cfg(args.dataset, args.device)
    cfg.torch_device()  # no card: raise before any work
    if args.bias_w:
        cfg.depth_bias_model_kwargs = {"w": [args.bias_w], "exponent": [4.0]}
    ds = create_dataset(args.dataset, cfg)

    train_data, train_dist = pair_data(ds, args.train_pair, cfg)
    if train_dist > args.max_pose_dist:
        print("Distance between view points is too big: %.3f > %.1f m"
              % (train_dist, args.max_pose_dist))
        return None
    val_data, val_dist = pair_data(ds, args.val_pair, cfg)
    print("Train pair (%d, %d): pose dist %.3f m; val pair (%d, %d): %.3f m"
          % (args.train_pair, args.train_pair + 1, train_dist, args.val_pair,
             args.val_pair + 1, val_dist))

    model, hist = optimize(cfg, train_data, val_data, args.iters)
    os.makedirs(args.out, exist_ok=True)
    hist_np = np.asarray(hist)
    np.savetxt(os.path.join(args.out, "pair_icp_history.csv"), hist_np,
               header="iter train_loss val_loss", comments="")
    try:
        save_dashboard(os.path.join(args.out, "pair_icp_dashboard.png"), hist_np, model,
                       train_data)
    except ImportError as e:  # no matplotlib: the CSV is the result
        print("dashboard skipped: %s" % e)
    print("final model:", model)
    return model, hist_np


if __name__ == "__main__":
    main(sys.argv[1:])
