"""Joint model + pose-correction experiment harness (counterpart of
``depth_correction_tpu/experiments.py``).

The reference's FEE-corridor experiment scripts (reference:
scripts/model_poses_learning:56-195, model_poses_learning_icp,
model_learning, mapping_accuracy:100-118) as one library routine:

- joint (model, pose-delta) optimisation on static scans under any
  configured objective (map consistency or ICP),
- per-iteration experiment metrics: pose accuracy against ground-truth
  scanner positions (the Leica tracker for fee_corridor, reference:
  model_poses_learning:138-140) and mapping accuracy against a
  ground-truth map (the inlier-trimmed point-to-point 1-NN distance,
  reference: mapping_accuracy:100-118; kernel X3 on the card),
- a CSV history for plots and aggregation.

The step is :func:`train.fit`'s: the loss and its gradients on
``cfg.torch_device()``, the model's gradients zeroed without
``optimize_model`` and the first pose's in ``pose`` mode, then the
optimizer's update. The probes run every ``metrics_every`` iterations and
on the last, where they see the updated parameters.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["ExperimentHistory", "joint_learning", "synthetic_gt_map",
           "synthetic_gt_positions"]


@dataclasses.dataclass
class ExperimentHistory:
    iters: List[int]
    train_loss: List[float]
    pose_l2: List[float]  # NaN when no GT positions
    map_accuracy: List[float]  # NaN when no GT map
    params: dict = None  # final params: {"model": ..., "pose_deltas": ...}

    def to_csv(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write("iter train_loss pose_l2 map_accuracy\n")
            for row in zip(self.iters, self.train_loss, self.pose_l2, self.map_accuracy):
                f.write("%i %.9g %.9g %.9g\n" % row)


def synthetic_gt_map(name: str, cfg, density_mult: float = 4.0) -> np.ndarray:
    """Ground-truth map of a synthetic scene: the clean (unbiased, noiseless)
    dataset merged at its poses, densified; the stand-in for the
    fee_corridor scanner map. float64 on the host."""
    from numpy.lib.recfunctions import structured_to_unstructured as s2u

    from .datasets import create_dataset
    from .datasets.synthetic import transform_structured

    clean_cfg = cfg.copy()
    clean_cfg.depth_bias_model_kwargs = {}
    clean_cfg.pose_noise = 0.0
    clean_cfg.depth_noise = 0.0
    if name.startswith("open_box") and "density" in name:
        head, dens = name.rsplit("density_", 1)
        name = head + "density_%g" % (float(dens) * density_mult)
    ds = create_dataset(name, clean_cfg, noisy=False)
    parts = [s2u(transform_structured(np.asarray(pose), arr)[["x", "y", "z"]]) for arr, pose in ds]
    return np.concatenate(parts).astype(np.float64)


def synthetic_gt_positions(name: str, cfg) -> np.ndarray:
    """Ground-truth scanner positions of the clean dataset (the synthetic
    'Leica')."""
    from .datasets import create_dataset

    clean_cfg = cfg.copy()
    clean_cfg.pose_noise = 0.0
    ds = create_dataset(name, clean_cfg, noisy=False)
    return np.stack([np.asarray(p)[:3, 3] for _, p in ds])


def joint_learning(cfg, datasets: Optional[Sequence] = None, gt_map: Optional[np.ndarray] = None,
                   gt_positions: Optional[np.ndarray] = None, metrics_every: int = 10,
                   log_csv: Optional[str] = None, callbacks=None,
                   data=None) -> ExperimentHistory:
    """Jointly optimise (model, pose deltas) and track experiment metrics.

    :param cfg: full config; ``cfg.loss`` picks the objective (consistency
        or ICP), ``cfg.pose_correction`` the pose-delta granularity
        (``none`` is scripts/model_learning's model-only run).
    :param gt_map: (G, 3) ground-truth map points for mapping accuracy.
    :param gt_positions: (S, 3) ground-truth scanner positions for pose
        accuracy (first sequence; reference: model_poses_learning:138-140).
    :param callbacks: ``callbacks(it, params, loss, pose_l2, map_acc)`` at
        each probe.
    :param data: the prepared :class:`train.TrainData` (default: prepared
        from ``datasets`` or ``cfg.train_names``).
    :return: :class:`ExperimentHistory` with the final params attached.
    """
    from .datasets import create_dataset
    from .metrics import mapping_accuracy
    from .models import load_model
    from .preproc import corrected_poses, global_cloud
    from .train import (_delta_for_seq, _grads_of, _mask_delta_grads, _opt_step,
                        init_pose_deltas, make_loss_fn, make_optimizer, prepare_sequences)

    if data is None:
        if datasets is None:
            datasets = [create_dataset(n, cfg) for n in (cfg.train_names or [])]
        data = prepare_sequences(datasets, cfg)
    dtype, device = cfg.torch_dtype(), cfg.torch_device()

    model = load_model(cfg=cfg)
    deltas = init_pose_deltas(data, cfg)
    params = {"model": model}
    if deltas is not None:
        params["pose_deltas"] = deltas
    loss_fn = make_loss_fn(cfg)
    weights = [p for p in model.parameters() if p.requires_grad]
    groups = [g for g in (weights, list(deltas or ())) if g]
    opt = make_optimizer(cfg, [{"params": g} for g in groups])
    trained = [t for g in groups for t in g]

    def loss_at():
        value = loss_fn(model, data, deltas)
        return value.detach(), _grads_of(value, trained)

    gt_map_t = None if gt_map is None else torch.as_tensor(gt_map, dtype=dtype, device=device)
    gt_xyz_t = (None if gt_positions is None
                else torch.as_tensor(gt_positions, dtype=dtype, device=device))

    @torch.no_grad()
    def probe():
        """The experiment metrics under the current params."""
        batch = data.batches[0]
        delta = _delta_for_seq(deltas, 0, cfg.pose_correction)
        poses = corrected_poses(batch.poses, delta)
        pose_l2 = (float(torch.linalg.norm(poses[:, :3, 3] - gt_xyz_t, dim=1).mean())
                   if gt_xyz_t is not None else float("nan"))
        if gt_map_t is not None:
            g = global_cloud(batch, model=model, pose_deltas=delta)
            map_acc = float(mapping_accuracy(g.get_points(), gt_map_t, icp_inlier_ratio=0.8,
                                             valid_cloud=g.valid))
        else:
            map_acc = float("nan")
        return pose_l2, map_acc

    hist = ExperimentHistory([], [], [], [])
    last = cfg.n_opt_iters - 1
    for it in range(cfg.n_opt_iters):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, data, deltas)
        loss.backward()
        if not cfg.optimize_model:
            for p in weights:
                p.grad.zero_()
        _mask_delta_grads(deltas, cfg)
        probed = it % max(metrics_every, 1) == 0 or it == last
        if probed and it != last:
            metrics = probe()
        _opt_step(opt, loss, loss_at)
        if it == last:
            # The final row probes the updated params: those are what
            # hist.params holds and the caller saves.
            metrics = probe()
        if probed:
            value = float(loss.detach())
            pose_l2, map_acc = metrics
            hist.iters.append(it)
            hist.train_loss.append(value)
            hist.pose_l2.append(pose_l2)
            hist.map_accuracy.append(map_acc)
            if callbacks is not None:
                callbacks(it, params, value, pose_l2, map_acc)
            print("It. %03i: loss %.6g, pose L2 %.4g m, map acc %.4g m"
                  % (it, value, pose_l2, map_acc))

    hist.params = params
    if log_csv:
        hist.to_csv(log_csv)
    return hist
