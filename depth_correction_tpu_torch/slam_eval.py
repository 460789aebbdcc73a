"""SLAM-style evaluation without ROS (counterpart of
``depth_correction_tpu/slam_eval.py``).

The reference evaluates localization drift by spinning a roslaunch pipeline
(robot_data replayer -> filters -> correction node -> norlab_icp_mapper C++
SLAM -> TF lookback; reference: src/depth_correction/eval.py:214-263,
scripts/robot_data:123-205). This module replaces it with:

- an in-process point-to-plane ICP, scan to previous scan
  (:func:`slam_odometry`) or scan to a maintained voxel map
  (:func:`slam_mapper`), run over corrected clouds on
  ``cfg.torch_device()``; each iteration's 1-NN correspondences are kernel
  X3 (k = 1, no radius) on the card, its gate and solve kernel X6, so an
  alignment's iterations queue on the card with no host read between them,
- odometry noise injection mirroring robot_data's perturbed odometry
  (scripts/robot_data:123-151),
- CSV outputs with the reference schemas (``slam_eval_<slam>.csv``:
  ``"<name> <r_angle> <t_norm> <rel_angle> <rel_offset>"``;
  ``slam_poses_<slam>.csv``: the robot_data poses file),
- the subprocess route to an external mapper (:func:`run_external_slam`)
  and an export of corrected clouds and poses for parity runs elsewhere.

The clouds of a run share one float type; poses are cast to it (float32 on
the card, where X3 and X6 take float32 only). ``plain=True`` takes X3's and
X6's plain twins on any device and float type (the float64 reference runs).
"""
from __future__ import annotations

import glob
import os
import shlex
import subprocess
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from .cloud import Cloud
from .config import SLAM, Config
from .metrics import localization_errors
from .models import load_model
from .ops.icp import icp_update
from .ops.knn import knn_d2
from .ops.se3 import delta_transform, transform_points
from .preproc import local_feature_cloud
from .utils import trace
from .utils.io import append

__all__ = ["icp_align", "perturb_odometry", "slam_clouds", "slam_odometry", "slam_mapper",
           "eval_slam", "export_corrected_clouds", "run_external_slam"]


def _icp_step(T, src_pts, src_valid, tgt_pts, tgt_normals, tgt_valid, inlier_ratio: float,
              plain: bool):
    """One Gauss-Newton point-to-plane step (JAX package, slam_eval.py:48-71)
    from the transform ``T`` that placed ``src_pts``: the 1-NN search (X3),
    then the gate at the ``inlier_ratio`` quantile of the distances and the
    normal equations' solve for the 6-DoF twist (X6, ``ops/icp.py``);
    returns (delta @ T, the inlier error). Stays on the device: on the card
    nothing is read back to the host."""
    with trace.span("icp.search"):
        d2, idx = knn_d2(tgt_pts, src_pts, k=1, valid_points=tgt_valid, plain=plain)
    return icp_update(T, d2[:, 0], idx[:, 0], src_pts, src_valid, tgt_pts, tgt_normals,
                      inlier_ratio, plain=plain)


def icp_align(source: Cloud, target: Cloud, T0=None, n_iters: int = 10,
              inlier_ratio: float = 0.8, plain: bool = False):
    """Align ``source`` onto ``target`` (point-to-plane ICP; the target
    needs normals), ``n_iters`` steps on the clouds' device with no value
    read back to the host between them (JAX package, slam_eval.py:73-117).

    :return: (T (4, 4) world transform of the source, the last iteration's
        inlier error, taken before its own update; ``inf`` at 0 iterations).
    """
    assert target.normals is not None
    tgt_pts = target.get_points()
    dtype = torch.promote_types(source.depth.dtype, tgt_pts.dtype)
    device = tgt_pts.device
    T = (torch.eye(4, dtype=dtype, device=device) if T0 is None
         else trace.to_device(T0 if torch.is_tensor(T0) else np.asarray(T0), dtype=dtype,
                              device=device))
    if n_iters == 0:
        return T, torch.full((), float("inf"), dtype=dtype, device=device)
    src_pts = source.get_points().to(dtype)
    tgt_pts, tgt_normals = tgt_pts.to(dtype), target.normals.to(dtype)
    err = None
    for _ in range(n_iters):
        T, err = _icp_step(T, transform_points(T, src_pts), source.valid, tgt_pts,
                           tgt_normals, target.valid, inlier_ratio, plain)
    return T, err


def _increment(T0: np.ndarray, T1: np.ndarray) -> np.ndarray:
    """float64 delta D with T1 = T0 @ D."""
    return delta_transform(torch.as_tensor(np.asarray(T0, np.float64)),
                           torch.as_tensor(np.asarray(T1, np.float64))).numpy()


def perturb_odometry(poses: np.ndarray, cov_diag, seed: int = 135) -> np.ndarray:
    """Noisy odometry chain: consecutive increments perturbed with Gaussian
    noise of the given 6-vector variance (rx ry rz tx ty tz), then chained
    again (reference: scripts/robot_data:123-151). float64 on the host."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    std = np.sqrt(np.asarray(cov_diag, np.float64))
    out = [poses[0]]
    for i in range(1, len(poses)):
        inc = _increment(poses[i - 1], poses[i])
        noise_vec = std * rng.normal(size=6)
        N = np.eye(4)
        N[:3, :3] = Rotation.from_euler("xyz", noise_vec[:3]).as_matrix()
        N[:3, 3] = noise_vec[3:]
        out.append(out[-1] @ inc @ N)
    return np.stack(out)


def _posed(cloud: Cloud, T: np.ndarray) -> Cloud:
    """``cloud`` transformed by the host pose ``T`` (cast to its float type),
    with points."""
    return cloud.transform(trace.to_device(np.asarray(T), cloud.depth)).with_points()


def slam_odometry(clouds: Sequence[Cloud], init_poses: np.ndarray, n_iters: int = 8,
                  inlier_ratio: float = 0.8, plain: bool = False) -> np.ndarray:
    """Scan-to-previous-scan ICP odometry over (corrected) feature clouds:
    each scan registers against the previous one placed at its estimate,
    starting from the odometry prior; the chained transforms are the
    trajectory estimate.

    :return: (S, 4, 4) estimated world poses, float64.
    """
    est = [np.asarray(init_poses[0], np.float64)]
    for i in range(1, len(clouds)):
        with trace.span("slam.scan", scan=i):
            with trace.span("slam.prior"):
                prior = est[-1] @ _increment(init_poses[i - 1], init_poses[i])
                target = _posed(clouds[i - 1], est[-1])
            T, _ = icp_align(clouds[i], target, T0=prior, n_iters=n_iters,
                             inlier_ratio=inlier_ratio, plain=plain)
            est.append(trace.to_host(T).numpy().astype(np.float64))
    return np.stack(est)


def slam_mapper(clouds: Sequence[Cloud], init_poses: np.ndarray, n_iters: int = 8,
                inlier_ratio: float = 0.8, map_voxel: float = 0.1,
                map_capacity: int = 1 << 19, plain: bool = False) -> np.ndarray:
    """Scan-to-MAP ICP with a maintained voxel map, the role of the
    reference's external ``norlab_icp_mapper`` (launch/slam.launch:42-80):
    each scan registers against the accumulated downsampled map, then
    merges into it on the host (first point in a voxel wins, like a
    mapper's static map). Past ``map_capacity`` voxels the map keeps those
    nearest the sensor, with a warning. The target is the map as it is, at
    its own size.

    :return: (S, 4, 4) estimated world poses, float64.
    """
    from .ops.filters import filter_grid_indices

    def merge(map_pts, map_normals, new_pts, new_normals, center):
        pts = np.concatenate([map_pts, new_pts])
        normals = np.concatenate([map_normals, new_normals])
        keep = filter_grid_indices(pts, map_voxel, keep="first")
        pts, normals = pts[keep], normals[keep]
        if len(pts) > map_capacity:
            # Voxel-level eviction, not truncation: keep the capacity voxels
            # nearest the current sensor position (a maintained local map),
            # so new nearby geometry always survives.
            warnings.warn("slam_mapper map at capacity (%d voxels at %.2g m); "
                          "evicting voxels farthest from the sensor"
                          % (map_capacity, map_voxel))
            d2 = np.sum((pts - np.asarray(center)[None]) ** 2, axis=1)
            nearest = np.argpartition(d2, map_capacity - 1)[:map_capacity]
            pts, normals = pts[nearest], normals[nearest]
        return pts, normals

    def as_target(map_pts, map_normals, like):
        kw = {"dtype": like.dtype, "device": like.device}
        n = len(map_pts)
        normals = trace.to_device(map_normals, like)
        return Cloud(vps=torch.zeros((n, 3), **kw), dirs=normals,
                     depth=torch.zeros(n, **kw),
                     valid=torch.ones(n, dtype=torch.bool, device=like.device),
                     points=trace.to_device(map_pts, like), normals=normals)

    def scan_arrays(cloud, T):
        posed = _posed(cloud, T)
        keep = trace.to_host(posed.valid).numpy()
        return (trace.to_host(posed.points).numpy()[keep],
                trace.to_host(posed.normals).numpy()[keep])

    est = [np.asarray(init_poses[0], np.float64)]
    map_pts, map_normals = merge(np.zeros((0, 3)), np.zeros((0, 3)),
                                 *scan_arrays(clouds[0], est[0]), est[0][:3, 3])
    for i in range(1, len(clouds)):
        with trace.span("slam.scan", scan=i):
            with trace.span("slam.prior"):
                prior = est[-1] @ _increment(init_poses[i - 1], init_poses[i])
                target = as_target(map_pts, map_normals, clouds[i].depth)
            T, _ = icp_align(clouds[i], target, T0=prior, n_iters=n_iters,
                             inlier_ratio=inlier_ratio, plain=plain)
            est.append(trace.to_host(T).numpy().astype(np.float64))
            map_pts, map_normals = merge(map_pts, map_normals, *scan_arrays(clouds[i], est[-1]),
                                         est[-1][:3, 3])
    return np.stack(est)


def slam_clouds(ds, cfg: Config, model=None):
    """A sequence's feature clouds for SLAM on ``cfg.torch_device()``, and
    its ground-truth poses (S, 4, 4). With a model, each corrected cloud's
    features are computed again over the scan's own neighbourhoods (kernel
    P7 on the card): the correction moves points along their rays, and the
    point-to-plane registration must see the corrected planes (the
    reference's external mapper likewise estimates normals from the
    corrected clouds it is fed)."""
    from .ops.features import compute_features

    clouds, poses = [], []
    with torch.no_grad():
        for scan, pose in ds:
            if model is not None:
                cloud, lnn, lw = local_feature_cloud(scan, cfg, return_neighbors=True)
                cloud = compute_features(model.apply(cloud), lnn, lw)
            else:
                cloud = local_feature_cloud(scan, cfg)
            clouds.append(cloud)
            poses.append(np.asarray(pose))
    return clouds, np.stack(poses)


def eval_slam(cfg: Config, test_datasets: Optional[Sequence] = None,
              apply_correction: bool = True):
    """Localization-drift evaluation (replaces the roslaunch pipeline,
    reference: eval.py:214-263; JAX package, slam_eval.py:242-345) on
    ``cfg.torch_device()``: scans replayed with noisy odometry, ICP over
    (corrected) clouds, errors against ground truth, the reference-schema
    CSVs appended; the clouds are :func:`slam_clouds`'. Under
    ``mesh_shape`` or ``dist_coordinator`` every rank computes it whole and
    rank 0 alone writes the CSVs.

    :return: dict name -> (mean_r_angle, mean_t_norm, mean_rel_angle,
        mean_rel_offset).
    """
    from .datasets import create_dataset
    from .parallel.sharding import writes_for
    from .train import _pose_path

    if not test_datasets:
        test_datasets = [create_dataset(n, cfg, poses_path=_pose_path(cfg.test_poses_path, i,
                                                                      cfg.test_names or []))
                         for i, n in enumerate(cfg.test_names or [])]
    model = load_model(cfg=cfg) if apply_correction else None
    writes = writes_for(cfg)

    results = {}
    for ds in test_datasets:
        name = str(ds)
        clouds, gt_poses = slam_clouds(ds, cfg, model)
        odom = perturb_odometry(gt_poses, cfg.odom_cov, seed=cfg.random_seed)
        if cfg.slam == SLAM.icp_odometry:
            est = slam_odometry(clouds, odom)
        elif cfg.slam == SLAM.icp_mapper:
            est = slam_mapper(clouds, odom, map_voxel=cfg.grid_res or 0.1)
        elif cfg.slam == SLAM.norlab_icp_mapper:
            est = run_external_slam(cfg, name, clouds, odom)
        else:
            raise NotImplementedError("cfg.slam=%s" % cfg.slam)

        errors = localization_errors(torch.as_tensor(gt_poses, dtype=torch.float64),
                                     torch.as_tensor(est, dtype=torch.float64))
        stats = tuple(float(e.mean()) for e in errors)
        results[name] = stats
        if writes and cfg.slam_eval_csv:
            append(cfg.slam_eval_csv, "%s %.9f %.9f %.9f %.9f\n" % ((name,) + stats))
        if writes and cfg.slam_poses_csv:
            # The robot_data schema (poseId, timestamp, T00..T33;
            # scripts/robot_data:196-204), so the file reads back through
            # read_poses (the PoseProvider axis).
            from .datasets.asl_laser import write_poses

            poses_path = cfg.slam_poses_csv
            if len(test_datasets) > 1:
                # One file a sequence, nested as slam_poses_csv(log_dir,
                # name, slam) nests it; a shared path would be overwritten.
                head, base = os.path.split(poses_path)
                poses_path = os.path.join(head, name, base)
            os.makedirs(os.path.dirname(poses_path) or ".", exist_ok=True)
            write_poses(list(range(len(est))), est, poses_path)
    return results


def _host(x: torch.Tensor, keep: torch.Tensor) -> np.ndarray:
    return x[keep].cpu().numpy()


def run_external_slam(cfg: Config, name: str, clouds: Sequence[Cloud],
                      prior_poses: np.ndarray) -> np.ndarray:
    """Drive an external SLAM program over exported corrected clouds, the
    half the reference runs through roslaunch (eval.py:234-259,
    scripts/robot_data:153-205).

    ``cfg.slam_command`` is a format template with:

    - ``{input_dir}``: a directory of ``scan_%04d.npz`` files with
      ``points`` / ``normals`` / ``mask`` (sensor frame, corrected),
      ``prior`` (the (4, 4) noisy-odometry pose prior) and ``frame``,
    - ``{poses_csv}``: where the mapper writes its estimated world poses
      (robot_data schema: ``poseId, timestamp, T00..T33``).

    :return: (S, 4, 4) estimated poses read back from the mapper's CSV.
    """
    from .datasets.asl_laser import read_poses

    if not cfg.slam_command:
        raise ValueError("cfg.slam=norlab_icp_mapper needs cfg.slam_command (a template with "
                         "{input_dir} and {poses_csv}); see scripts/stub_slam_mapper.py")
    in_dir = os.path.join(cfg.log_dir or ".", "external_slam", name.replace("/", "_"))
    os.makedirs(in_dir, exist_ok=True)
    # The mapper globs scan_*.npz: scans left by an earlier, longer run
    # would corrupt its input sequence.
    for stale in glob.glob(os.path.join(in_dir, "scan_*.npz")):
        os.remove(stale)
    for i, cloud in enumerate(clouds):
        keep = cloud.valid
        n = int(keep.sum())
        np.savez_compressed(
            os.path.join(in_dir, "scan_%04d.npz" % i),
            points=_host(cloud.to_points(), keep),
            normals=_host(cloud.normals, keep) if cloud.normals is not None
            else np.zeros((n, 3)),
            mask=_host(cloud.mask, keep) if cloud.mask is not None else np.ones(n, bool),
            prior=np.asarray(prior_poses[i]),
            # The frame the priors are expressed in (reference: ros.py:51-53).
            frame=np.asarray(cfg.world_frame),
        )
    poses_csv = os.path.join(in_dir, "slam_poses_external.csv")
    cmd = cfg.slam_command.format(input_dir=in_dir, poses_csv=poses_csv)
    print("Running external SLAM: %s" % cmd)
    subprocess.run(shlex.split(cmd), check=True)
    if not os.path.exists(poses_csv):
        raise RuntimeError("external SLAM wrote no poses: %s" % poses_csv)
    _, est = read_poses(poses_csv)
    if len(est) != len(clouds):
        raise RuntimeError("external SLAM returned %d poses for %d scans"
                           % (len(est), len(clouds)))
    return np.stack(est)


def export_corrected_clouds(cfg: Config, out_dir: str,
                            test_datasets: Optional[Sequence] = None):
    """Write corrected clouds and ground-truth poses as npz files for
    external SLAM parity runs (the framework's half of the reference's
    eval_slam): ``<name>_<i>.npz`` with ``points``, ``normals``, ``mask``,
    ``pose`` and ``frame``.

    :return: the written paths.
    """
    from .datasets import create_dataset

    if not test_datasets:
        test_datasets = [create_dataset(n, cfg) for n in (cfg.test_names or [])]
    model = load_model(cfg=cfg)
    os.makedirs(out_dir, exist_ok=True)
    manifest = []
    with torch.no_grad():
        for ds in test_datasets:
            name = str(ds).replace("/", "_")
            for i, (scan, pose) in enumerate(ds):
                corrected = model.apply(local_feature_cloud(scan, cfg))
                keep = corrected.valid
                path = os.path.join(out_dir, "%s_%04d.npz" % (name, i))
                np.savez_compressed(path, points=_host(corrected.to_points(), keep),
                                    normals=_host(corrected.normals, keep),
                                    mask=_host(corrected.mask, keep), pose=np.asarray(pose),
                                    frame=np.asarray(cfg.world_frame))
                manifest.append(path)
    return manifest
