"""ASL laser dataset loader (ETH ASL "Challenging data sets" Hokuyo scans);
the port's copy of ``depth_correction_tpu/datasets/asl_laser.py`` (numpy
only).

The data root is ``$DEPTH_CORRECTION_DATA/asl_laser`` (default
``<repo>/data/asl_laser``), read when the module is imported.

File layout and formats follow the reference loader
(reference: src/depth_correction/datasets/asl_laser.py:17-167):

- ``<root>/<name>/csv_local/Hokuyo_<id>.csv`` — per-scan CSV, header row,
  columns [timestamp, x, y, z, ...]; points are columns 1:4,
- ``<root>/<name>/csv_global/pose_scanner_leica.csv`` — header row, columns
  [poseId, timestamp, T00..T33] (row-major 4x4),
- names may carry a ``_step_N`` suffix subsampling scan ids.
"""
from __future__ import annotations

import os
import re
from copy import copy
from typing import Optional

import numpy as np
from numpy.lib.recfunctions import unstructured_to_structured

__all__ = ["Dataset", "dataset_names", "data_dir", "prefix", "read_points",
           "read_poses", "write_poses"]

prefix = "asl_laser"
data_dir = os.environ.get(
    "DEPTH_CORRECTION_DATA",
    os.path.join(os.path.dirname(__file__), "..", "..", "data"),
)
data_dir = os.path.realpath(os.path.join(data_dir, prefix))

dataset_names = [
    "apartment",
    "eth",
    "gazebo_summer",
    "gazebo_winter",
    "plain",
    "stairs",
    "wood_autumn",
    "wood_summer",
]


def read_points(path: str) -> np.ndarray:
    """Scan CSV -> structured x/y/z array (columns 1:4 after the header)."""
    raw = np.genfromtxt(path, delimiter=",", skip_header=1)
    pts = raw[:, 1:4]
    return unstructured_to_structured(pts, names=["x", "y", "z"])


def read_poses(path: str):
    """Poses CSV -> (ids, list of (4, 4) arrays)."""
    raw = np.genfromtxt(path, delimiter=", ", skip_header=1)
    raw = np.atleast_2d(raw)
    ids = raw[:, 0].astype(int).tolist()
    poses = list(raw[:, 2:].reshape((-1, 4, 4)))
    return ids, poses


def write_poses(ids, poses, path, ts=None):
    ts = ids if ts is None else ts
    with open(path, "w") as f:
        f.write(
            "poseId, timestamp, T00, T01, T02, T03, T10, T11, T12, T13, "
            "T20, T21, T22, T23, T30, T31, T32, T33\n"
        )
        for i, t, pose in zip(ids, ts, poses):
            f.write(
                "%s, %.9f, %s\n"
                % (i, t, ", ".join("%.9f" % x for x in np.asarray(pose).ravel()))
            )


class Dataset:
    """ASL-format dataset (reference protocol: ids / local_cloud /
    cloud_pose / indexing / slicing)."""

    default_poses_csv = "pose_scanner_leica.csv"

    def __init__(self, name: Optional[str] = None, path: Optional[str] = None,
                 poses_csv: str = default_poses_csv, poses_path: Optional[str] = None):
        data_step = 1
        if path:
            name = os.path.split(path)[1]
        elif name:
            s = re.search(r"_step_(\d+)", name)
            if s:
                name = name.replace(s.group(0), "")
                data_step = int(s.group(1))
            parts = name.split("/")
            if len(parts) == 2:
                assert parts[0] == prefix
                name = parts[1]
            path = os.path.join(data_dir, name)

        self.name = name
        self.data_step = data_step
        self.path = path
        self.poses_path = poses_path
        self.poses_csv = poses_csv or Dataset.default_poses_csv

        if self.poses_path or self.path:
            ids, poses = read_poses(self.cloud_poses_path())
            self.poses = dict(zip(ids, poses))
            self.ids = ids[:: self.data_step]
        else:
            self.ids = None
            self.poses = None

    # --- paths ---------------------------------------------------------
    def local_cloud_path(self, id):
        return os.path.join(self.path, "csv_local", "Hokuyo_%s.csv" % id)

    def global_cloud_path(self, id):
        return os.path.join(self.path, "csv_global", "PointCloud%s.csv" % id)

    def cloud_poses_path(self):
        return self.poses_path or os.path.join(self.path, "csv_global", self.poses_csv)

    # --- protocol ------------------------------------------------------
    def local_cloud(self, id):
        return read_points(self.local_cloud_path(id))

    def cloud_pose(self, id):
        return self.poses[id]

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
