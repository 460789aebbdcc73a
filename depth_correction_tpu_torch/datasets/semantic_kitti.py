"""Semantic KITTI dataset loader (velodyne scans + SLAM/odometry poses);
the port's copy of ``depth_correction_tpu/datasets/semantic_kitti.py``
(numpy only; the data root is ``$DEPTH_CORRECTION_DATA/semantic_kitti``,
default ``<repo>/data/semantic_kitti``, read at import).

File layout and formats follow the reference loader
(reference: src/depth_correction/datasets/semantic_kitti.py:60-250):

- ``<root>/sequences/<NN>/velodyne/%06d.bin`` — float32 [x y z intensity]
  records; xyz kept,
- ``<root>/sequences/<NN>/poses.txt`` — KITTI 12-float rows (3x4, cam frame),
- ``<root>/sequences/<NN>/calib.txt`` — ``key: 12 floats`` rows,
- poses are re-expressed in the velodyne frame by right-multiplying the
  cam2->velo extrinsic (the fixed calibration matrix the reference embeds,
  semantic_kitti.py:120-123),
- names encode windows: ``08_start_100_end_150_step_1``.
"""
from __future__ import annotations

import os
import re
from copy import copy
from typing import Optional

import numpy as np
from numpy.lib.recfunctions import unstructured_to_structured

__all__ = ["Dataset", "dataset_names", "data_dir", "prefix", "sequence_names",
           "read_calibration", "read_kitti_poses"]

prefix = "semantic_kitti"
data_dir = os.environ.get(
    "DEPTH_CORRECTION_DATA",
    os.path.join(os.path.dirname(__file__), "..", "..", "data"),
)
data_dir = os.path.realpath(os.path.join(data_dir, prefix))

sequence_names = ["%02d" % i for i in range(11)]

# Fixed 50-scan evaluation windows (reference: semantic_kitti.py:240-249).
dataset_names = [
    "09_start_311_end_361_step_1",
    "10_start_223_end_273_step_1",
    "00_start_127_end_177_step_1",
    "03_start_366_end_416_step_1",
    "01_start_221_end_271_step_1",
    "04_start_72_end_122_step_1",
    "02_start_264_end_314_step_1",
    "07_start_28_end_78_step_1",
]

# Camera-2 -> velodyne extrinsic used to express poses in the lidar frame
# (calibration constant; reference: semantic_kitti.py:120-123).
T_CAM2_TO_VELO = np.array(
    [
        [2.34773698e-04, -9.99944155e-01, -1.05634778e-02, 5.93721868e-02],
        [1.04494074e-02, 1.05653536e-02, -9.99889574e-01, -7.51087914e-02],
        [9.99945389e-01, 1.24365378e-04, 1.04513030e-02, -2.72132796e-01],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def read_calibration(path: str) -> dict:
    """calib.txt -> {key: 4x4}."""
    calib = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, content = line.strip().split(":", 1)
            vals = [float(v) for v in content.split()]
            T = np.eye(4)
            T[:3, :4] = np.asarray(vals).reshape(3, 4)
            calib[key] = T
    return calib


def read_kitti_poses(path: str, transform: Optional[np.ndarray] = None):
    """poses.txt (12-float rows) -> (N, 4, 4), optionally right-multiplied
    into the lidar frame."""
    raw = np.atleast_2d(np.genfromtxt(path))
    poses = np.tile(np.eye(4), (len(raw), 1, 1))
    poses[:, :3, :4] = raw.reshape(-1, 3, 4)
    if transform is not None:
        poses = poses @ transform
    return poses


class Dataset:
    def __init__(self, name: Optional[str] = None, path: Optional[str] = None,
                 poses_file: str = "poses.txt", poses_path: Optional[str] = None):
        step = 1
        window = slice(None)
        if path:
            sequence = os.path.split(path)[1]
        else:
            name = name or "00"
            m_step = re.search(r"_step_(\d+)", name)
            m_start = re.search(r"start_(\d+)", name)
            m_end = re.search(r"end_(\d+)", name)
            step = int(m_step.group(1)) if m_step else 1
            window = slice(
                int(m_start.group(1)) if m_start else None,
                int(m_end.group(1)) if m_end else None,
                step,
            )
            parts = name.split("/")
            if len(parts) == 2:
                assert parts[0] == prefix
                name = parts[1]
            sequence = name.split("_")[0]
            path = os.path.join(data_dir, "sequences", sequence)

        self.name = name or sequence
        self.sequence = sequence
        self.path = path
        self.poses_path = poses_path or os.path.join(path, poses_file)

        poses = read_kitti_poses(self.poses_path, T_CAM2_TO_VELO)
        self.poses = poses
        self.ids = list(range(len(poses)))[window]
        # Move poses to the zero origin of the sliced window — the
        # reference does this unconditionally (semantic_kitti.py:218-221);
        # raw KITTI world translations run to hundreds of meters.
        if self.ids:
            Tr_inv = np.linalg.inv(self.poses[self.ids[0]])
            self.poses = np.asarray([Tr_inv @ p for p in self.poses])

    # --- protocol ------------------------------------------------------
    def local_cloud_path(self, id):
        return os.path.join(self.path, "velodyne", "%06d.bin" % id)

    def local_cloud(self, id, dtype=np.float32):
        cloud = np.fromfile(self.local_cloud_path(id), dtype=np.float32)
        cloud = cloud.reshape((-1, 4))[:, :3]
        return unstructured_to_structured(cloud.astype(dtype), names=["x", "y", "z"])

    def cloud_pose(self, id, dtype=np.float64):
        return self.poses[id].astype(dtype)

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
