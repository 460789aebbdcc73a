"""Training demo with ground-truth tracking.

Port of the JAX package's scripts/train_demo.py (reference:
scripts/train_demo:25-421): train on a synthetic dataset with a known
injected bias through ``train()`` and track, per iteration,

- the train loss,
- the distance of the learned weights to the ground truth,
- the L2 distance of the corrected cloud to the clean cloud (the injected
  bias is ``gt_model.inverse``, so ``gt_model.apply`` recovers the clean
  points exactly: the residual after the learned correction is the
  remaining metric bias, reference train_demo:102-109),
- the pose error of learned pose corrections against ground-truth poses
  (with pose noise and pose correction, train_demo:201-236),

and write the curves as saved matplotlib panels and a CSV.

Usage: python -m depth_correction_tpu_torch.studies.train_demo [--dataset NAME]
           [--iters N] [--pose-noise S] [--log-dir DIR] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..train import TrainCallbacks
from . import add_device_arg, default_float_type


class DemoCallbacks(TrainCallbacks):
    """Track recovery of the known GT model (and poses) during training."""

    def __init__(self, cfg, gt_model, datasets=None, gt_poses=None, every=5):
        from ..preproc import local_feature_cloud

        super().__init__(cfg)
        self.gt_model = gt_model
        self.gt_w = (gt_model.w.detach().cpu().numpy().ravel() if hasattr(gt_model, "w")
                     else np.zeros(1))
        self.every = max(int(every), 1)
        self.history = []  # (it, loss, w_err, cloud_l2, pose_err)
        self.clouds = []
        self.clean_pts = []
        self.noisy_poses = []
        self.gt_poses = gt_poses
        with torch.no_grad():
            for ds in datasets or []:
                seq_clouds, seq_poses = [], []
                for scan, pose in ds:
                    cloud = local_feature_cloud(scan, cfg)
                    seq_clouds.append(cloud)
                    seq_poses.append(np.asarray(pose))
                    # gt_model.apply inverts the injected inverse-bias exactly.
                    self.clean_pts.append(gt_model.apply(cloud).to_points().cpu().numpy())
                self.clouds.append(seq_clouds)
                self.noisy_poses.append(np.stack(seq_poses))

    @torch.no_grad()
    def _cloud_l2(self, model):
        if not self.clouds:
            return float("nan")
        errs = []
        k = 0
        for seq in self.clouds:
            for cloud in seq:
                pts = model.apply(cloud).to_points().cpu().numpy()
                keep = cloud.valid.cpu().numpy()
                d = np.linalg.norm(pts - self.clean_pts[k], axis=-1)
                errs.append(float(d[keep].mean()))
                k += 1
        return float(np.mean(errs))

    @torch.no_grad()
    def _pose_err(self, pose_deltas):
        from ..ops.se3 import rotation_angle, translation_norm
        from ..preproc import corrected_poses

        if pose_deltas is None or self.gt_poses is None:
            return float("nan")
        r_sum, t_sum, n = 0.0, 0.0, 0
        for i, noisy in enumerate(self.noisy_poses):
            delta = pose_deltas[min(i, len(pose_deltas) - 1)].detach()
            corr = corrected_poses(torch.as_tensor(noisy, device=delta.device), delta)
            corr = corr.cpu().numpy()
            gt = np.asarray(self.gt_poses[i])
            for a, b in zip(corr, gt):
                d = torch.as_tensor(np.linalg.inv(a) @ b)
                r_sum += float(rotation_angle(d))
                t_sum += float(translation_norm(d))
                n += 1
        return (r_sum / n, t_sum / n) if n else float("nan")

    def train_loss(self, it, model, pose_deltas, loss):
        w = (model.w.detach().cpu().numpy().ravel() if hasattr(model, "w")
             else np.zeros_like(self.gt_w))
        w_err = float(np.linalg.norm(w - self.gt_w))
        cloud_l2 = pose_err = float("nan")
        if it % self.every == 0:
            cloud_l2 = self._cloud_l2(model)
            pe = self._pose_err(pose_deltas)
            pose_err = pe[1] if isinstance(pe, tuple) else pe
        self.history.append((it, float(loss.detach()), w_err, cloud_l2, pose_err))
        if it % 10 == 0:
            print("it %03d  loss %.3e  |w - w_gt| %.3e  cloud L2 %s  pose %s"
                  % (it, float(loss.detach()), w_err,
                     "%.3e" % cloud_l2 if np.isfinite(cloud_l2) else "-",
                     "%.3e" % pose_err if np.isfinite(pose_err) else "-"))

    def save_outputs(self, out_dir):
        """Write the demo history CSV and the 4-panel dashboard figure
        (the reference's live matplotlib panels, train_demo:102-109,
        201-236, as saved files); without matplotlib the CSV alone, and
        the figure's path is None."""
        os.makedirs(out_dir, exist_ok=True)
        hist = np.asarray(self.history, np.float64)
        csv = os.path.join(out_dir, "demo_history.csv")
        with open(csv, "w") as f:
            f.write("iter loss w_err cloud_l2 pose_err\n")
            for row in hist:
                f.write("%d %.9g %.9g %.9g %.9g\n" % tuple(row))

        try:
            import matplotlib
        except ImportError:
            return csv, None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 2, figsize=(11, 8))
        panels = [(1, "train loss", True), (2, "|w - w_gt|", True),
                  (3, "corrected-cloud L2 to GT [m]", True),
                  (4, "pose translation error [m]", False)]
        for ax, (col, title, logy) in zip(axes.ravel(), panels):
            vals = hist[:, col]
            ok = np.isfinite(vals)
            if ok.any():
                (ax.semilogy if logy and (vals[ok] > 0).all() else ax.plot)(hist[ok, 0], vals[ok])
            ax.set_title(title)
            ax.set_xlabel("iteration")
            ax.grid(True)
        fig.tight_layout()
        fig_path = os.path.join(out_dir, "train_demo.png")
        fig.savefig(fig_path)
        plt.close(fig)
        return csv, fig_path


def make_cfg(args):
    """The JAX script's settings (train_demo.py:177-195); its float64 on
    the CPU, float32 on a card (:func:`default_float_type`)."""
    from ..config import Config, PoseCorrection

    cfg = Config()
    cfg.device = args.device
    cfg.log_dir = args.log_dir
    cfg.float_type = default_float_type(args.device)
    cfg.train_names = [args.dataset]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.2
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [args.gt_w], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": False}
    cfg.lr, cfg.n_opt_iters = args.lr, args.iters
    if args.pose_noise:
        cfg.pose_noise = [0.0, 0.0, 0.0] + [args.pose_noise] * 3
        cfg.pose_noise_mode = "pose"
        cfg.pose_correction = PoseCorrection.pose
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="ground_plane/6")
    ap.add_argument("--gt-w", type=float, default=-0.002)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--pose-noise", type=float, default=0.0,
                    help="inject pose noise and co-optimize per-pose deltas")
    ap.add_argument("--log-dir", default="gen/train_demo")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..datasets import create_dataset
    from ..models import load_model
    from ..train import train

    cfg = make_cfg(args)
    gt_model = load_model(class_name=cfg.depth_bias_model_class,
                          model_kwargs=dict(cfg.depth_bias_model_kwargs),
                          dtype=cfg.torch_dtype(), device=cfg.torch_device())
    datasets = [create_dataset(n, cfg) for n in cfg.train_names]
    gt_poses = None
    if args.pose_noise:
        clean = [create_dataset(n, cfg, noisy=False) for n in cfg.train_names]
        gt_poses = [np.stack([np.asarray(p) for _, p in ds]) for ds in clean]

    callbacks = DemoCallbacks(cfg, gt_model, datasets=datasets, gt_poses=gt_poses)
    best_cfg = train(cfg, callbacks=callbacks, train_datasets=datasets)
    model = load_model(cfg=best_cfg)
    print("recovered:", model, "(GT w = %g)" % args.gt_w)
    csv, fig = callbacks.save_outputs(cfg.log_dir)
    hist = np.asarray(callbacks.history)
    print("weight error: start %.3e -> end %.3e" % (hist[0, 2], hist[-1, 2]))
    l2 = hist[np.isfinite(hist[:, 3]), 3]
    if len(l2):
        print("cloud L2 to GT: start %.3e -> end %.3e m" % (l2[0], l2[-1]))
    print("dashboard: %s, history: %s" % (fig, csv))
    return callbacks, model


if __name__ == "__main__":
    main(sys.argv[1:])
