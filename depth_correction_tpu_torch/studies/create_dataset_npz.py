"""Create an on-disk dataset in the FEE-Corridor npz layout, without ROS.

Port of the JAX package's scripts/create_dataset_npz.py (reference:
scripts/create_fee_corridor, leica_ouster_postproc): where those assemble
``sequences/<seq>/static_ouster_points/<id>.npz`` and
``poses/static_poses.csv`` from recorded rosbags, this builds the same
layout from any source the port can read: a named dataset (synthetic,
asl_laser, kitti360, ...) or a directory of ``*.npz`` exports (for example
``slam_eval.export_corrected_clouds`` output). The result loads through
``datasets.fee_corridor.Dataset(path=...)`` in either package.

Usage:
    python -m depth_correction_tpu_torch.studies.create_dataset_npz \\
        --source ground_plane/4 --out data/my_seq [--device cuda]
    python -m depth_correction_tpu_torch.studies.create_dataset_npz \\
        --source-dir gen/corrected --out data/my_seq
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from . import add_device_arg


def structured_cloud(points, vps=None, normals=None):
    """Build the structured array schema the fee_corridor loader reads
    (x/y/z + per-point vp_*; reference fee_corridor.py:94-106)."""
    from numpy.lib.recfunctions import unstructured_to_structured

    points = np.asarray(points, np.float32)
    cols = [points]
    names = ["x", "y", "z"]
    vps = np.zeros_like(points) if vps is None else np.asarray(vps, np.float32)
    if vps.shape != points.shape:
        vps = np.broadcast_to(vps, points.shape)
    cols.append(vps)
    names += ["vp_x", "vp_y", "vp_z"]
    if normals is not None:
        cols.append(np.asarray(normals, np.float32))
        names += ["normal_x", "normal_y", "normal_z"]
    return unstructured_to_structured(np.ascontiguousarray(np.concatenate(cols, axis=1)),
                                      names=names)


def scans_from_named_dataset(name, device: str = "cuda"):
    from ..config import Config
    from ..datasets import create_dataset

    cfg = Config()
    cfg.device = device
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.0, float("inf"), 0.0
    cfg.depth_bias_model_kwargs = {}
    for scan, pose in create_dataset(name, cfg, noisy=False):
        yield scan, np.asarray(pose)


def scans_from_export_dir(path):
    files = sorted(glob.glob(os.path.join(path, "*.npz")))
    if not files:
        raise SystemExit("no npz scans in %s" % path)
    for f in files:
        data = np.load(f)
        pose = None
        for key in ("prior", "pose"):
            if key in data:
                pose = np.asarray(data[key])
        if pose is None:
            pose = np.eye(4)
        if "cloud" in data:
            yield data["cloud"], pose
        else:
            yield structured_cloud(data["points"],
                                   normals=data["normals"] if "normals" in data else None), pose


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--source", help="dataset name (e.g. ground_plane/4)")
    src.add_argument("--source-dir", help="directory of npz scan exports")
    ap.add_argument("--out", required=True,
                    help="sequence directory to create (e.g. data/my_seq)")
    ap.add_argument("--dynamic", action="store_true",
                    help="write the dynamic-pose (no static_ prefix) variant")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..datasets.asl_laser import write_poses
    from . import torch_device

    torch_device(args.device)
    file_prefix = "" if args.dynamic else "static_"
    points_dir = os.path.join(args.out, file_prefix + "ouster_points")
    poses_dir = os.path.join(args.out, "poses")
    os.makedirs(points_dir, exist_ok=True)
    os.makedirs(poses_dir, exist_ok=True)

    scans = (scans_from_named_dataset(args.source, args.device) if args.source
             else scans_from_export_dir(args.source_dir))
    ids, poses = [], []
    for i, (cloud, pose) in enumerate(scans):
        if not (isinstance(cloud, np.ndarray) and cloud.dtype.names):
            cloud = structured_cloud(np.asarray(cloud))
        np.savez_compressed(os.path.join(points_dir, "%d.npz" % i), cloud=cloud)
        ids.append(i)
        poses.append(np.asarray(pose, np.float64))
    write_poses(ids, poses, os.path.join(poses_dir, file_prefix + "poses.csv"))
    print("wrote %d scans to %s (+ %s)"
          % (len(ids), points_dir, os.path.join(poses_dir, file_prefix + "poses.csv")))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
