"""FEE Corridor dataset loader (the paper authors' own dataset); the
port's copy of ``depth_correction_tpu/datasets/fee_corridor.py`` (numpy
only; the data root is ``$DEPTH_CORRECTION_DATA/fee_corridor``, default
``<repo>/data/fee_corridor``, read at import).

File layout and formats follow the reference loader
(reference: src/depth_correction/datasets/fee_corridor.py:14-178):

- ``<root>/sequences/<seq>/(static_)ouster_points/<id>.npz`` — per-scan
  npz with a structured ``cloud`` array (x/y/z + per-point ``vp_*``),
- ``<root>/sequences/<seq>/poses/(static_)poses.csv`` — rows
  [id, timestamp, T00..T33],
- ``<root>/sequences/<seq>/poses/(static_)leica_poses_raw.txt`` — xyz rows
  from the Leica total station; ``calibration/map2subt.txt`` aligns them,
- ``<root>/maps/npz/map_{2,5}cm_alligned.npz`` — ground-truth map,
- names encode windows: ``seq1_start_0_end_7_step_1``.
"""
from __future__ import annotations

import os
import re
from copy import copy
from typing import Optional

import numpy as np

__all__ = ["Dataset", "dataset_names", "data_dir", "prefix", "seq_names"]

prefix = "fee_corridor"
data_dir = os.environ.get(
    "DEPTH_CORRECTION_DATA",
    os.path.join(os.path.dirname(__file__), "..", "..", "data"),
)
data_dir = os.path.realpath(os.path.join(data_dir, prefix))

seq_names = ["seq1", "seq2"]

dataset_names = [
    "seq1_start_0_end_7_step_1",
    "seq1_start_8_end_15_step_1",
    "seq1_start_16_end_23_step_1",
    "seq1_start_24_end_33_step_1",
    "seq2_start_0_end_10_step_1",
    "seq2_start_11_end_20_step_1",
    "seq2_start_21_end_30_step_1",
    "seq2_start_31_end_42_step_1",
]


def read_points_npz(path: str) -> np.ndarray:
    with np.load(path) as data:
        return data["cloud"]


def read_poses(path: str):
    raw = np.genfromtxt(path, delimiter=", ", skip_header=1)
    raw = np.atleast_2d(raw)
    ids = np.genfromtxt(path, delimiter=", ", dtype=str, skip_header=1)
    ids = np.atleast_2d(ids)[:, 0].tolist()
    poses = raw[:, 2:].reshape((-1, 4, 4))
    return ids, poses


class Dataset:
    """FEE Corridor sequences with static (stop-and-scan) or dynamic poses."""

    def __init__(
        self,
        name: Optional[str] = None,
        path: Optional[str] = None,
        poses_path: Optional[str] = None,
        zero_origin: bool = False,
        static_poses: bool = True,
        xyz_from_leica_tracker: bool = False,
    ):
        step = 1
        window = slice(None)
        name = name or "seq2"
        if path:
            name = os.path.split(path)[1]
        else:
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
            name = name[:4]  # 'seqN'
            path = os.path.join(data_dir, "sequences", name)

        self.name = name
        self.path = path
        self.poses_path = poses_path
        self.static_poses = static_poses
        self.file_prefix = "static_" if static_poses else ""
        self.zero_origin = zero_origin
        self.xyz_from_leica_tracker = xyz_from_leica_tracker

        ids, poses = read_poses(self.cloud_poses_path())
        if xyz_from_leica_tracker:
            poses[:, :3, 3] = self.read_leica_xyz()
        if zero_origin:
            poses = np.linalg.inv(poses[0])[None] @ poses
        self.poses = dict(zip(ids, poses))
        self.ids = ids[window] if not poses_path else ids

    # --- paths ---------------------------------------------------------
    def local_cloud_path(self, id):
        return os.path.join(
            self.path, self.file_prefix + "ouster_points", "%s.npz" % id
        )

    def cloud_poses_path(self):
        return self.poses_path or os.path.join(
            self.path, "poses", self.file_prefix + "poses.csv"
        )

    def global_cloud_path(self, resolution_cm: int = 5):
        assert resolution_cm in (2, 5)
        return os.path.join(
            self.path, "..", "..", "maps", "npz",
            "map_%icm_alligned.npz" % resolution_cm,
        )

    def global_cloud(self, resolution_cm: int = 5) -> np.ndarray:
        return read_points_npz(self.global_cloud_path(resolution_cm))

    def read_leica_xyz(self) -> np.ndarray:
        xyz_raw = np.genfromtxt(
            os.path.join(self.path, "poses", self.file_prefix + "leica_poses_raw.txt")
        )
        T = np.genfromtxt(os.path.join(self.path, "calibration", "map2subt.txt"))
        return xyz_raw @ T[:3, :3].T + T[:3, 3]

    # --- protocol ------------------------------------------------------
    def local_cloud(self, id):
        return read_points_npz(self.local_cloud_path(id))

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
