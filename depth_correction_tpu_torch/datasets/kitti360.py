"""KITTI-360 dataset loader (raw velodyne scans + cam0-to-world poses);
the port's copy of ``depth_correction_tpu/datasets/kitti360.py`` (numpy
and scipy; the data root is ``$KITTI360_DATASET``, else
``$DEPTH_CORRECTION_DATA/kitti360``, default ``<repo>/data/kitti360``,
read at import).

File layout and formats follow the reference loader
(reference: src/depth_correction/datasets/kitti360.py:20-254):

- ``<root>/data_3d_raw/<drive>/velodyne_points/data/%010d.bin`` — float32
  [x y z intensity] records,
- ``<root>/data_poses/<drive>/cam0_to_world.txt`` — rows [frame, 16 floats],
- ``<root>/calibration/calib_cam_to_velo.txt`` — 12 floats (rigid cam->velo),
- lidar poses = cam0_to_world @ T_lidar2cam (inverse of cam->velo),
- ego points within +-1 m in x/y are removed (kitti360.py:96-109),
- names encode windows: ``00_start_102_end_152_step_1``.
"""
from __future__ import annotations

import os
import re
from copy import copy
from typing import Optional

import numpy as np
from numpy.lib.recfunctions import unstructured_to_structured

__all__ = [
    "Dataset",
    "dataset_names",
    "data_dir",
    "prefix",
    "dynamic_points_mask",
    "remove_dynamic_objects",
    "transfer_semantic_labels",
]

prefix = "kitti360"
data_dir = os.environ.get(
    "KITTI360_DATASET",
    os.path.join(
        os.environ.get(
            "DEPTH_CORRECTION_DATA",
            os.path.join(os.path.dirname(__file__), "..", "..", "data"),
        ),
        prefix,
    ),
)
data_dir = os.path.realpath(data_dir)

dataset_names = [
    "00_start_102_end_152_step_1",
    "03_start_102_end_152_step_1",
    "04_start_102_end_152_step_1",
    "05_start_102_end_152_step_1",
    "06_start_102_end_152_step_1",
    "07_start_102_end_152_step_1",
    "09_start_102_end_152_step_1",
    "10_start_102_end_152_step_1",
]


def load_rigid_calibration(path: str) -> np.ndarray:
    """12-float rigid calibration file -> 4x4."""
    vals = np.genfromtxt(path)
    T = np.eye(4)
    T[:3, :4] = np.asarray(vals).reshape(3, 4)
    return T


class Dataset:
    def __init__(self, name: Optional[str] = None, path: Optional[str] = None,
                 poses_path: Optional[str] = None, zero_origin: bool = True,
                 filtered_scans: bool = False,
                 filter_ego_pts_depth: float = 1.0):
        step = 1
        window = slice(None)
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
        seq = int(name.split("_")[0])
        self.name = name
        self.drive = "2013_05_28_drive_%04d_sync" % seq
        self.path = path or data_dir
        self.filter_ego_pts_depth = filter_ego_pts_depth
        sub = "data_3d_filtered" if filtered_scans else "data_3d_raw"
        self.cloud_dir = os.path.join(
            self.path, sub, self.drive, "velodyne_points", "data"
        )

        T_cam2lidar = load_rigid_calibration(
            os.path.join(self.path, "calibration", "calib_cam_to_velo.txt")
        )
        self.T_lidar2cam = np.linalg.inv(T_cam2lidar)

        poses_file = poses_path or os.path.join(
            self.path, "data_poses", self.drive, "cam0_to_world.txt"
        )
        data = np.atleast_2d(np.loadtxt(poses_file))
        ids = data[:, 0].astype(int).tolist()
        poses = data[:, 1:].reshape((-1, 4, 4)) @ self.T_lidar2cam
        # Keep only poses with an existing scan (kitti360.py:77-83).
        if os.path.isdir(self.cloud_dir):
            have = {int(f[:-4]) for f in os.listdir(self.cloud_dir) if f.endswith(".bin")}
            keep = [i in have for i in ids]
            ids = [i for i, k in zip(ids, keep) if k]
            poses = poses[np.asarray(keep, bool)]
        self.poses = dict(zip(ids, poses))
        self.ids = ids[window]
        # Move poses to the zero origin: the WINDOW's first pose becomes
        # identity (reference: kitti360.py:259-261). Raw cam0_to_world
        # translations run to hundreds of meters — float32 world-frame
        # points would lose mm-level precision otherwise.
        if zero_origin and self.ids:
            Tr_inv = np.linalg.inv(self.poses[self.ids[0]])
            self.poses = {i: Tr_inv @ p for i, p in self.poses.items()}

    # --- protocol ------------------------------------------------------
    def local_cloud_path(self, id):
        return os.path.join(self.cloud_dir, "%010d.bin" % int(id))

    def local_cloud(self, id):
        cloud = np.fromfile(self.local_cloud_path(id), dtype=np.float32)
        cloud = cloud.reshape((-1, 4))
        if self.filter_ego_pts_depth is not None:
            d = self.filter_ego_pts_depth
            keep = (
                (cloud[:, 0] < -d)
                | (cloud[:, 0] > d)
                | (cloud[:, 1] < -d)
                | (cloud[:, 1] > d)
            )
            cloud = cloud[keep]
        return unstructured_to_structured(cloud[:, :3], names=["x", "y", "z"])

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

    # --- dynamic-object tooling -----------------------------------------
    def get_dynamic_points(self):
        """Dynamic-object window clouds of this drive's semantic annotation
        (reference: kitti360.py:266-278): world-frame points of moving
        objects, one cloud per frame-id window.

        :return: (list of (Ni, 3) arrays, list of [start, end) frame ranges).
        """
        from numpy.lib.recfunctions import structured_to_unstructured as s2u

        from ..utils.ply import read_ply_structured

        pcd_path = os.path.join(
            self.path, "data_3d_semantics", "train", self.drive, "dynamic"
        )
        dynamic_points = []
        ids_ranges = []
        for p in sorted(os.listdir(pcd_path)):
            if not p.endswith(".ply"):
                continue
            data = read_ply_structured(os.path.join(pcd_path, p))
            dynamic_points.append(
                s2u(data[["x", "y", "z"]], dtype=np.float64)
            )
            ids_ranges.append([int(i) for i in p[:-4].split("_")])
        return dynamic_points, ids_ranges


def dynamic_points_mask(points_map, dynamic_points, dist_th: float = 0.2):
    """True for map-frame points within ``dist_th`` of any dynamic point
    (reference: scripts/generate_scans_wo_dynamic_objects_kitti360: 1-NN
    query against the dynamic cloud)."""
    from scipy.spatial import cKDTree

    points_map = np.asarray(points_map, np.float64)
    if dynamic_points is None or len(dynamic_points) == 0:
        return np.zeros(len(points_map), bool)
    tree = cKDTree(np.asarray(dynamic_points, np.float64))
    d, _ = tree.query(points_map, k=1, workers=-1)
    return d <= dist_th


def remove_dynamic_objects(ds: "Dataset", out_dir: Optional[str] = None,
                           dist_th: float = 0.2) -> str:
    """Write dynamic-object-filtered scans into the ``data_3d_filtered``
    layout the loader's ``filtered_scans=True`` mode reads
    (reference: scripts/generate_scans_wo_dynamic_objects_kitti360).

    Scans are matched against the semantic dynamic windows covering their
    frame id, in the world frame; points within ``dist_th`` of a dynamic
    point are dropped. Existing outputs are skipped (resume semantics).

    :return: the output scan directory.
    """
    folder = out_dir or os.path.join(
        ds.path, "data_3d_filtered", ds.drive, "velodyne_points", "data"
    )
    os.makedirs(folder, exist_ok=True)
    dynamic_points_list, ids_ranges = ds.get_dynamic_points()
    for i in ds.ids:
        out_path = os.path.join(folder, "%010d.bin" % int(i))
        if os.path.exists(out_path):
            continue
        raw = np.fromfile(ds.local_cloud_path(i), dtype=np.float32).reshape(-1, 4)
        pose = ds.cloud_pose(i)
        pts_map = raw[:, :3] @ pose[:3, :3].T + pose[:3, 3]
        drop = np.zeros(len(raw), bool)
        for dyn, (lo, hi) in zip(dynamic_points_list, ids_ranges):
            if lo <= int(i) < hi and len(dyn):
                drop |= dynamic_points_mask(pts_map, dyn, dist_th)
        raw[~drop].tofile(out_path)
    return folder


def transfer_semantic_labels(ds: "Dataset", out_dir: Optional[str] = None,
                             dist_th: float = 0.05) -> str:
    """Project the drive's static semantic annotation onto raw scans,
    producing a SemanticKITTI-style (points + labels) dataset
    (reference: kitti360.py:442-497 ``create_semantic_kitti360``).

    For each scan, the world-frame points match 1-NN against the static
    semantic window clouds; points within ``dist_th`` inherit the window
    point's semantic id, the rest get label 0 (unlabeled). Scans save as
    raw float32 [x y z i] ``.bin`` plus uint16 ``.label`` files.

    :return: the output sequence directory.
    """
    from numpy.lib.recfunctions import structured_to_unstructured as s2u
    from scipy.spatial import cKDTree

    from ..utils.ply import read_ply_structured

    out = out_dir or os.path.join(ds.path, "SemanticKITTI-360", ds.drive)
    pts_folder = os.path.join(out, "velodyne")
    lab_folder = os.path.join(out, "labels")
    os.makedirs(pts_folder, exist_ok=True)
    os.makedirs(lab_folder, exist_ok=True)

    static_dir = os.path.join(
        ds.path, "data_3d_semantics", "train", ds.drive, "static"
    )
    windows = []
    for p in sorted(os.listdir(static_dir)):
        if not p.endswith(".ply"):
            continue
        data = read_ply_structured(os.path.join(static_dir, p))
        pts = s2u(data[["x", "y", "z"]], dtype=np.float64)
        if "semantic" in (data.dtype.names or ()):
            sem = np.asarray(data["semantic"], np.int64)
        elif "instance" in (data.dtype.names or ()):
            # KITTI-360 globalId = semanticId * 1000 + instanceId.
            sem = np.asarray(data["instance"], np.int64) // 1000
        else:
            sem = np.zeros(len(pts), np.int64)
        lo, hi = (int(v) for v in p[:-4].split("_"))
        windows.append((cKDTree(pts), sem, lo, hi))

    for i in ds.ids:
        raw = np.fromfile(ds.local_cloud_path(i), dtype=np.float32).reshape(-1, 4)
        pose = ds.cloud_pose(i)
        world = raw[:, :3] @ pose[:3, :3].T + pose[:3, 3]
        labels = np.zeros(len(raw), np.uint16)
        for tree, sem, lo, hi in windows:
            if not (lo <= int(i) < hi):
                continue
            d, idx = tree.query(world, k=1, workers=-1)
            hit = d <= dist_th
            labels[hit] = sem[idx[hit]].astype(np.uint16)
        raw.tofile(os.path.join(pts_folder, "%010d.bin" % int(i)))
        labels.tofile(os.path.join(lab_folder, "%010d.label" % int(i)))
    return out
