"""Loss evaluation (counterpart of ``depth_correction_tpu/eval.py``).

Evaluate a trained model's map-consistency loss on test sequences and
append the result to a CSV in the reference's schema
(``loss_eval_<loss>[_<subset>].csv``, rows ``"<names> <loss>"``;
reference: eval.py:115-211). Pose corrections come from
``cfg.test_pose_deltas`` (an npz file that either package's ``train()``
wrote) or start at zero. :func:`eval_icp` takes the ICP loss of consecutive
scans at ground-truth poses, its correspondences found by the 1-NN search
(kernel X3 on the card). :func:`eval_slam_all` runs
:func:`slam_eval.eval_slam` for every configured SLAM pipeline.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import Config, PoseCorrection, loss_eval_csv
from .loss import create_loss
from .models import load_model
from .train import TrainData, _pose_path, init_pose_deltas, make_loss_fn, prepare_sequences
from .utils.io import append

__all__ = ["eval_icp", "eval_loss", "eval_loss_all", "eval_slam_all",
           "initialize_pose_corrections"]


def initialize_pose_corrections(data: TrainData, cfg: Config):
    """Zero pose deltas for ``cfg.pose_correction`` (reference:
    eval.py:31-65): :func:`train.init_pose_deltas`."""
    return init_pose_deltas(data, cfg)


def _test_pose_deltas(cfg: Config, data: TrainData):
    """The deltas of ``cfg.test_pose_deltas`` (keys sorted as integers,
    so that ``10`` follows ``9``), or zeros; None without pose correction."""
    if cfg.pose_correction == PoseCorrection.none:
        return None
    if not cfg.test_pose_deltas:
        return init_pose_deltas(data, cfg)
    from .utils.checkpoint import load_pytree

    loaded = load_pytree(cfg.test_pose_deltas)
    try:
        keys = sorted(loaded, key=int)
    except ValueError:
        keys = sorted(loaded)
    return tuple(torch.as_tensor(loaded[k], device=cfg.torch_device()) for k in keys)


def eval_loss(cfg: Config, test_datasets: Optional[Sequence] = None, model=None,
              loss_fun=None, test_data: Optional[TrainData] = None,
              return_data: bool = False):
    """The configured loss on test sequences, forward only (reference:
    eval.py:115-191; JAX package, eval.py:40-141), on ``cfg.torch_device()``.

    The sequences are ``test_datasets`` or ``cfg.test_names`` (with
    ``cfg.test_poses_path``); the model ``model`` or ``load_model(cfg=cfg)``.
    Prints the loss and, with ``cfg.loss_eval_csv`` set, appends
    ``"<names> <loss>"`` to it.

    With ``cfg.mesh_shape`` or ``cfg.dist_coordinator`` and no
    ``test_data`` (JAX package, eval.py:72-130) every rank calls it alike:
    prep runs under the mesh, the tables split over the ranks and the loss
    is ``parallel.make_sharded_loss_fn``'s; every rank returns the same
    value and rank 0 prints it and appends the CSV row. A custom
    ``loss_fun`` cannot be sharded and raises NotImplementedError.

    :return: the loss as a float (and the prepared TrainData when
        ``return_data``).
    """
    from .datasets import create_dataset
    from .parallel.sharding import is_writer

    if test_datasets:
        test_names = [str(ds) for ds in test_datasets]
    else:
        test_names = list(cfg.test_names or [])
        test_datasets = [create_dataset(name, cfg,
                                        poses_path=_pose_path(cfg.test_poses_path, i, test_names))
                         for i, name in enumerate(test_names)]
    if not test_datasets:
        raise ValueError("No test data: set cfg.test_names or pass test_datasets.")
    if model is None:
        model = load_model(cfg=cfg)
    mesh = None
    if (cfg.mesh_shape or cfg.dist_coordinator) and test_data is None:
        from .parallel import make_sharded_loss_fn, mesh_from_config, shard_train_data

        mesh = mesh_from_config(cfg)
    if mesh is not None and loss_fun is not None:
        raise NotImplementedError("a custom loss_fun cannot be sharded; unset cfg.mesh_shape "
                                  "or configure the loss by cfg.loss and cfg.loss_kwargs")
    if test_data is None:
        test_data = prepare_sequences(test_datasets, cfg, for_grad=False, mesh=mesh)
    if mesh is not None:
        test_data = shard_train_data(test_data, mesh)
        loss_fn = make_sharded_loss_fn(cfg, mesh)
    else:
        loss_fn = make_loss_fn(cfg, loss_fun=loss_fun or create_loss(cfg))
    deltas = _test_pose_deltas(cfg, test_data)
    with torch.no_grad():
        value = float(loss_fn(model, test_data, deltas))
    if is_writer(mesh):
        print("Test loss on %s: %.9f" % (", ".join(test_names), value))
        if cfg.loss_eval_csv:
            append(cfg.loss_eval_csv, "%s %.9f\n" % (",".join(test_names), value))
    if return_data:
        return value, test_data
    return value


def eval_loss_all(cfg: Config):
    """Every loss of ``cfg.eval_losses`` on the train, val and test
    sequences with ground-truth poses (reference: eval.py:194-211), each
    appended to ``loss_eval_<loss>_<subset>.csv`` in ``cfg.log_dir``.

    :return: {(subset, loss): value}.
    """
    results = {}
    for names, suffix in zip([cfg.train_names, cfg.val_names, cfg.test_names],
                             ["train", "val", "test"]):
        if not names:
            continue
        for loss in cfg.eval_losses:
            eval_cfg = cfg.copy()
            eval_cfg.test_names = list(names)
            eval_cfg.train_poses_path = []
            eval_cfg.val_poses_path = []
            eval_cfg.test_poses_path = []
            eval_cfg.loss = loss
            eval_cfg.loss_eval_csv = loss_eval_csv(cfg.log_dir, loss, suffix)
            evaluate = eval_icp if loss == "icp_loss" else eval_loss
            results[(suffix, loss)] = evaluate(eval_cfg)
    return results


def eval_slam_all(cfg: Config):
    """Every SLAM pipeline of ``cfg.eval_slams`` on the train, val and test
    sequences with ground-truth pose priors (reference: eval.py:266-290;
    JAX package, eval.py:174-198): :func:`slam_eval.eval_slam` per
    (subset, slam), each appending ``slam_eval_<slam>_<subset>.csv`` in
    ``cfg.log_dir``.

    :return: {(subset, slam): {name: errors}}.
    """
    from .config import slam_eval_csv
    from .slam_eval import eval_slam

    results = {}
    for names, suffix in zip([cfg.train_names, cfg.val_names, cfg.test_names],
                             ["train", "val", "test"]):
        if not names:
            continue
        for slam in cfg.eval_slams:
            eval_cfg = cfg.copy()
            eval_cfg.test_names = list(names)
            eval_cfg.train_poses_path = []
            eval_cfg.val_poses_path = []
            eval_cfg.test_poses_path = []
            eval_cfg.slam = slam
            eval_cfg.slam_eval_csv = slam_eval_csv(cfg.log_dir, slam, suffix)
            eval_cfg.slam_poses_csv = ""
            results[(suffix, slam)] = eval_slam(eval_cfg)
    return results


def eval_icp(cfg: Config, test_datasets: Optional[Sequence] = None,
             return_data: bool = False):
    """The ICP loss on test sequences at ground-truth poses (reference:
    eval.py:100-104; JAX package, eval.py:201-243), on
    ``cfg.torch_device()``: each scan's feature cloud (its own padding),
    corrected by the loaded model, posed, and the point-to-plane (or
    point-to-point) distance of consecutive scans over 1-NN
    correspondences gated at the ``icp_inlier_ratio`` quantile (default
    0.3). Prints the loss and, with ``cfg.loss_eval_csv`` set, appends
    ``"<names> <loss>"`` to it. Under ``mesh_shape`` or
    ``dist_coordinator`` every rank computes it whole and rank 0 alone
    prints and writes.

    :return: the loss as a float (and, with ``return_data``, the scans'
        feature clouds, a list a sequence, and their (S, 4, 4) poses).
    """
    from .datasets import create_dataset
    from .loss import icp_loss
    from .parallel.sharding import writes_for
    from .preproc import local_feature_cloud

    if test_datasets:
        names = [str(ds) for ds in test_datasets]
    else:
        names = list(cfg.test_names or [])
        test_datasets = [create_dataset(n, cfg, poses_path=_pose_path(cfg.test_poses_path, i, names))
                         for i, n in enumerate(names)]
    model = load_model(cfg=cfg)
    seqs, poses_all = [], []
    for ds in test_datasets:
        clouds, poses = [], []
        for scan, pose in ds:
            clouds.append(local_feature_cloud(scan, cfg))
            poses.append(np.asarray(pose))
        seqs.append(clouds)
        poses_all.append(torch.as_tensor(np.stack(poses), dtype=cfg.torch_dtype(),
                                         device=cfg.torch_device()))
    kwargs = cfg.loss_kwargs or {}
    with torch.no_grad():
        value, _ = icp_loss(seqs, poses=poses_all, model=model,
                            icp_point_to_plane=bool(kwargs.get("icp_point_to_plane", True)),
                            icp_inlier_ratio=float(kwargs.get("icp_inlier_ratio", 0.3)))
    value = float(value)
    if writes_for(cfg):
        print("ICP loss on %s: %.9f" % (", ".join(names), value))
        if cfg.loss_eval_csv:
            append(cfg.loss_eval_csv, "%s %.9f\n" % (",".join(names), value))
    if return_data:
        return value, (seqs, poses_all)
    return value
