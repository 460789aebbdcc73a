"""Pairwise ICP-loss optimization example.

Port of the JAX package's examples/optimization_icp.py (reference:
examples/optimization_icp): correct two neighbouring scans with a
ScaledPolynomial model trained against the point-to-plane distance between
them (``loss.point_to_plane_dist``: its correspondences by kernel X3 at
k = 1 on the card, each step), with Adam (optax's update, ``optim.Adam``).

Usage: python -m depth_correction_tpu_torch.studies.optimization_icp [NAME]
           [--iters N] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import add_device_arg

DEFAULT = "open_box/n_4_size_10_10_5_height_1_density_50"


def make_cfg(device: str = "cuda"):
    """The example's settings (examples/optimization_icp.py:30-37)."""
    from ..config import Config

    cfg = Config()
    cfg.device = device
    cfg.grid_res = 0.1
    cfg.min_depth = 1.0
    cfg.max_depth = 15.0
    cfg.nn_r = 0.4
    cfg.lr = 2e-4
    cfg.eigenvalue_ratio_bounds = []
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    return cfg


def posed_clouds(ds, cfg):
    """Feature clouds (normals, incidence angles) of scans 0 and 1, posed
    into the world frame."""
    from ..preproc import local_feature_cloud

    out = []
    for i in (0, 1):
        scan, pose = ds[i]
        cloud = local_feature_cloud(scan, cfg)
        out.append(cloud.transform(torch.as_tensor(np.asarray(pose), dtype=cloud.vps.dtype,
                                                   device=cloud.vps.device)))
    return out


def optimize(cfg, cloud1, cloud2, iters: int = 100, log_every: int = 10):
    """``iters`` Adam steps of w on the pair's point-to-plane distance.
    Returns (w, losses at each step's start)."""
    from ..loss import point_to_plane_dist
    from ..models import ScaledPolynomial
    from ..optim import Adam

    model = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=cfg.torch_dtype(),
                             device=cfg.torch_device())
    opt = Adam([model.w], lr=cfg.lr)
    losses = []
    for it in range(iters):
        opt.zero_grad(set_to_none=True)
        c1 = model.apply(cloud1).with_points()
        c2 = model.apply(cloud2).with_points()
        loss = point_to_plane_dist([c1, c2], icp_inlier_ratio=0.5)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if it % log_every == 0:
            print("it %03d  p2p loss %.5f  w %.5f"
                  % (it, losses[-1], float(model.w.detach()[0])))
    return model.w.detach().cpu().numpy(), losses


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("name", nargs="?", default=DEFAULT)
    p.add_argument("--iters", type=int, default=100)
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..datasets import create_dataset

    cfg = make_cfg(args.device)
    cfg.torch_device()  # no card: raise before any work
    ds = create_dataset(args.name, cfg)
    cloud1, cloud2 = posed_clouds(ds, cfg)
    w, losses = optimize(cfg, cloud1, cloud2, args.iters)
    print("final w:", w)
    return w, losses


if __name__ == "__main__":
    main(sys.argv[1:])
