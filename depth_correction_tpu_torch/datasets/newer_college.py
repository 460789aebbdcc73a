"""Newer College dataset loader (Ouster OS1-64 scans, quaternion pose CSV);
the port's copy of ``depth_correction_tpu/datasets/newer_college.py``
(numpy, scipy and yaml; the data root is
``$DEPTH_CORRECTION_DATA/newer_college``, default
``<repo>/data/newer_college``, read at import).

File layout and formats follow the reference loader
(reference: src/depth_correction/datasets/newer_college.py:20-293):

- ``<root>/<seq>/raw_format/ouster_scan/cloud_<sec>_<nsec>.pcd`` — per-scan
  PCD; per-point beam-origin viewpoints are offset ~15.8 mm radially from
  the sensor axis (Ouster optics; newer_college.py:34-42),
- ``<root>/<seq>/ground_truth/registered_poses.csv`` — rows
  [sec, nsec, x, y, z, qx, qy, qz, qw],
- kalibr YAML chain gives T_lidar2cam; poses are cam-frame and re-expressed
  in the lidar frame (newer_college.py:61-111),
- names encode windows: ``01_short_experiment/start_0_end_800_step_12``.
"""
from __future__ import annotations

import os
import re
from copy import copy
from typing import Optional

import numpy as np
import yaml
from numpy.lib.recfunctions import unstructured_to_structured
from scipy.spatial.transform import Rotation

from ..utils.pcd import read_pcd

__all__ = ["Dataset", "dataset_names", "data_dir", "prefix", "read_points",
           "read_poses"]

prefix = "newer_college"
data_dir = os.environ.get(
    "DEPTH_CORRECTION_DATA",
    os.path.join(os.path.dirname(__file__), "..", "..", "data"),
)
data_dir = os.path.realpath(os.path.join(data_dir, prefix))

sequence_names = ["01_short_experiment"]

# Eight slice windows, matching the reference's experiment list exactly
# (reference: newer_college.py:284-293 — quad / mid sections, step 12).
dataset_names = [
    "01_short_experiment/start_0_end_800_step_12",  # quad
    "01_short_experiment/start_800_end_1600_step_12",
    "01_short_experiment/start_1600_end_2400_step_12",  # mid
    "01_short_experiment/start_7000_end_7800_step_12",  # mid-quad
    "01_short_experiment/start_7800_end_8600_step_12",
    "01_short_experiment/start_8600_end_9500_step_12",  # quad-mid
    "01_short_experiment/start_13900_end_14600_step_12",  # mid-quad
    "01_short_experiment/start_14601_end_15301_step_12",  # mid-quad
]

# lidar_origin_to_beam_origin, Ouster OS1 software manual (m).
BEAM_ORIGIN_OFFSET = 0.015806


def read_points(path: str, dtype=np.float32, beam_origin_correction=True) -> np.ndarray:
    """PCD -> structured x/y/z + per-point beam-origin viewpoints."""
    pcd = read_pcd(path)
    pts = np.stack([pcd["x"], pcd["y"], pcd["z"]], axis=1).astype(np.float64)
    vps = np.zeros_like(pts)
    if beam_origin_correction:
        dp = np.linalg.norm(pts[:, :2], axis=1)
        vps[:, :2] = pts[:, :2] * BEAM_ORIGIN_OFFSET / (dp[:, None] + 1e-6)
    out = np.hstack([pts, vps]).astype(dtype)
    return unstructured_to_structured(
        out, names=["x", "y", "z", "vp_x", "vp_y", "vp_z"]
    )


def read_poses(path: str):
    """registered_poses.csv -> ([(sec, nsec)], (N, 4, 4))."""
    data = np.atleast_2d(np.genfromtxt(path, delimiter=",", skip_header=1))
    stamps = [tuple(t) for t in data[:, :2].astype(int)]
    poses = np.tile(np.eye(4), (len(data), 1, 1))
    poses[:, :3, :3] = Rotation.from_quat(data[:, 5:9]).as_matrix()
    poses[:, :3, 3] = data[:, 2:5]
    return stamps, poses


def read_calibration(root: Optional[str] = None) -> Optional[dict]:
    """kalibr YAML chain -> T_lidar2cam (newer_college.py:61-111)."""
    root = root or data_dir
    base = os.path.join(root, "2020-ouster-os1-64-realsense", "04_calibration",
                        "kalibr_output")
    try:
        with open(os.path.join(base, "ouster_imu_lidar_transforms.yaml")) as f:
            lidar = yaml.safe_load(f)["os1_lidar_to_os1_imu"]
        T_lidar2imu = np.eye(4)
        T_lidar2imu[:3, :3] = Rotation.from_quat(lidar["rotation"]).as_matrix()
        T_lidar2imu[:3, 3] = lidar["translation"]
        with open(
            os.path.join(base, "cam-ouster-imu",
                         "camchain-ouster_imu-cam-rooster_2020-03-11-10-05-35_0.yaml")
        ) as f:
            cams = yaml.safe_load(f)
        T_imu2cam = np.asarray(cams["cam0"]["T_cam_imu"])
    except (OSError, KeyError):
        return None
    T_cam_opt2cam = np.array(
        [[0.0, 0.0, 1.0, 0.0],
         [-1.0, 0.0, 0.0, 0.0],
         [0.0, -1.0, 0.0, 0.0],
         [0.0, 0.0, 0.0, 1.0]]
    )
    return {
        "T_lidar2lidar_imu": T_lidar2imu,
        "T_lidar_imu2cam_left": T_imu2cam,
        "T_cam_opt2cam": T_cam_opt2cam,
        "T_lidar2cam": T_cam_opt2cam @ T_imu2cam @ T_lidar2imu,
    }


class Dataset:
    default_poses_csv = "registered_poses.csv"

    def __init__(self, name: str = "01_short_experiment", path: Optional[str] = None,
                 poses_csv: str = default_poses_csv, poses_path: Optional[str] = None,
                 zero_origin: bool = True):
        window = slice(None)
        parts = name.split("/")
        if parts and parts[0] == prefix:
            parts = parts[1:]
        seq = parts[0] if parts else "01_short_experiment"
        for token in parts[1:]:
            m_step = re.search(r"step_(\d+)", token)
            m_start = re.search(r"start_(\d+)", token)
            m_end = re.search(r"end_(\d+)", token)
            window = slice(
                int(m_start.group(1)) if m_start else None,
                int(m_end.group(1)) if m_end else None,
                int(m_step.group(1)) if m_step else None,
            )
        self.name = seq
        self.path = path or os.path.join(data_dir, seq)
        self.poses_path = poses_path or os.path.join(
            self.path, "ground_truth", poses_csv
        )
        stamps, poses = read_poses(self.poses_path)
        calib = read_calibration()
        if calib is not None:
            # Express cam-frame poses in the lidar frame.
            poses = poses @ calib["T_lidar2cam"]
        self.poses = dict(zip(stamps, poses))
        # Scan ids come from the clouds actually on disk (reference:
        # read_available_timestamps, newer_college.py:162-170) — the poses
        # CSV can hold rows with no matching scan and vice versa; only
        # stamps present on BOTH sides become ids.
        scan_dir = os.path.join(self.path, "raw_format", "ouster_scan")
        if os.path.isdir(scan_dir):
            disk = []
            for f in os.listdir(scan_dir):
                if f.startswith("cloud_") and f.endswith(".pcd"):
                    s, ns = f[6:-4].split("_")
                    disk.append((int(s), int(ns)))
            ids = sorted(t for t in disk if t in self.poses)
        else:
            ids = list(stamps)
        self.ids = ids[window]
        # Zero origin AFTER window slicing: the window's first pose becomes
        # identity (reference: newer_college.py:318-320), not the full
        # sequence's first pose.
        if zero_origin and self.ids:
            Tr_inv = np.linalg.inv(self.poses[self.ids[0]])
            self.poses = {k: Tr_inv @ v for k, v in self.poses.items()}

    # --- protocol ------------------------------------------------------
    def local_cloud_path(self, id):
        sec, nsec = id
        return os.path.join(
            self.path, "raw_format", "ouster_scan",
            "cloud_%d_%09d.pcd" % (sec, nsec),
        )

    def local_cloud(self, id):
        return read_points(self.local_cloud_path(id))

    def cloud_pose(self, id):
        return self.poses[id]

    def ground_truth_cloud_path(self) -> str:
        root = os.path.dirname(self.path)
        return os.path.join(
            root,
            "03_new_college_prior_map",
            "new-college-29-01-2020-1cm-resolution-libpmfiltered.ply",
        )

    def get_ground_truth_cloud(self, voxel_size: float = 0.1) -> np.ndarray:
        """GT prior-map points expressed in this sequence's first-pose frame
        (reference: newer_college.py:216-229, Open3D replaced by own PLY IO
        + the voxel-grid filter).

        :return: (N, 3) float64 points.
        """
        from numpy.lib.recfunctions import structured_to_unstructured as s2u

        from ..ops.filters import filter_grid_indices
        from ..utils.ply import read_ply_structured

        data = read_ply_structured(self.ground_truth_cloud_path())
        cloud = s2u(data[["x", "y", "z"]], dtype=np.float64)
        # First pose in the raw (cam->lidar-calibrated, non-zero-origin)
        # frame, like the reference (newer_college.py:220-223).
        _, poses = read_poses(self.poses_path)
        calib = read_calibration()
        if calib is not None:
            poses = poses @ calib["T_lidar2cam"]
        pose0_inv = np.linalg.inv(poses[0])
        cloud = cloud @ pose0_inv[:3, :3].T + pose0_inv[:3, 3]
        if voxel_size:
            keep = filter_grid_indices(cloud, voxel_size, keep="first")
            cloud = cloud[np.asarray(keep)]
        return cloud

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            id = self.ids[item]
            return self.local_cloud(id), self.cloud_pose(id)
        ds = copy(self)
        if isinstance(item, (list, tuple)):
            ds.ids = [self.ids[i] for i in item]
        else:
            ds.ids = self.ids[item]
        return ds

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __str__(self):
        return "%s/%s" % (prefix, self.name)
