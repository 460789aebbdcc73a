"""Minimal map-consistency optimization example.

Port of the JAX package's examples/optimization.py (reference:
examples/optimization:18-78): build feature clouds for a short sequence,
establish frozen neighbourhoods, then jointly optimize the correction model
and per-pose SE(3) deltas against the min-eigenvalue map-consistency loss
with Adam (optax's update, ``optim.Adam``).

Runs on the synthetic open_box fixture by default; pass a real dataset
name (e.g. ``asl_laser/eth``) with data under ``DEPTH_CORRECTION_DATA``.

Usage: python -m depth_correction_tpu_torch.studies.optimization [NAME]
           [--iters N] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys

from . import add_device_arg

DEFAULT = "open_box/n_4_size_10_10_5_height_1_density_50"


def make_cfg(device: str = "cuda"):
    """The example's settings (examples/optimization.py:39-53)."""
    from ..config import Config, PoseCorrection

    cfg = Config()
    cfg.device = device
    cfg.grid_res = 0.1
    cfg.min_depth = 1.0
    cfg.max_depth = 15.0
    cfg.nn_r = 0.4
    cfg.lr = 2e-4
    cfg.n_opt_iters = 100
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.pose_correction = PoseCorrection.pose
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    # Inject a known bias so there is something to recover.
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    return cfg


def optimize(cfg, data, iters: int, log_every: int = 10):
    """``iters`` Adam steps of the model's w and every pose delta (the
    example masks none, unlike ``train.fit``, which freezes the first
    pose's). Returns (model, deltas, losses at each step's start)."""
    from ..models import ScaledPolynomial
    from ..optim import Adam
    from ..train import init_pose_deltas, make_loss_fn

    # Model d' = d * (1 - w * gamma^4), plus per-pose SE(3) deltas.
    model = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=cfg.torch_dtype(),
                             device=cfg.torch_device())
    deltas = init_pose_deltas(data, cfg)
    loss_fn = make_loss_fn(cfg)
    opt = Adam([model.w] + list(deltas or ()), lr=cfg.lr)
    losses = []
    for it in range(iters):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, data, deltas)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if it % log_every == 0:
            print("it %03d  loss %.3e  %s" % (it, losses[-1], model))
    return model, deltas, losses


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("name", nargs="?", default=DEFAULT)
    p.add_argument("--iters", type=int, default=None, help="default: the config's 100")
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..datasets import create_dataset
    from ..train import prepare_sequences

    cfg = make_cfg(args.device)
    cfg.torch_device()  # no card: raise before any work
    if args.iters:
        cfg.n_opt_iters = args.iters
    data = prepare_sequences([create_dataset(args.name, cfg)], cfg)
    model, deltas, losses = optimize(cfg, data, cfg.n_opt_iters)
    print("final:", model)
    return model, deltas, losses


if __name__ == "__main__":
    main(sys.argv[1:])
