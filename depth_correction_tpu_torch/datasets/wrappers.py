"""Dataset wrappers: filtering, corruption injection, slicing (counterpart of
``depth_correction_tpu/datasets/wrappers.py``).

Mirrors the reference wrapper stack (reference: src/depth_correction/
dataset.py:718-909). The corruption wrappers inject a known depth bias /
noise (:class:`DepthBiasDataset`, :class:`NoisyDepthDataset`) or pose noise
(:class:`NoisyPoseDataset`) so training can be validated against ground
truth; :class:`OverridePosesDataset` replaces the poses with those of a
CSV file (``*_poses_path``).
"""
from __future__ import annotations

import zlib
from typing import Optional

import numpy as np
import torch
from numpy.lib.recfunctions import structured_to_unstructured, unstructured_to_structured

__all__ = [
    "DepthBiasDataset",
    "FilteredDataset",
    "Forwarding",
    "NoisyDepthDataset",
    "NoisyPoseDataset",
    "OverridePosesDataset",
    "Subscriptable",
    "TransformingDataset",
]


def _stable_seed(*arrays) -> int:
    """Deterministic seed from array contents (process-independent; replaces
    the reference's ``abs(hash(...))`` of nested tuples, dataset.py:811)."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


class Forwarding:
    """Attribute-forwarding base (reference: dataset.py:718-735)."""

    def __init__(self, target):
        self.target = target

    def __getattr__(self, item):
        return getattr(self.target, item)

    def __getitem__(self, item):
        return self.target[item]

    def __iter__(self):
        return iter(self.target)

    def __len__(self):
        return len(self.target)

    def __str__(self):
        return str(self.target)


class TransformingDataset(Forwarding):
    """Applies cloud/pose transforms on access (reference: dataset.py:738-762)."""

    def transform_cloud(self, cloud, **kwargs):
        return cloud

    def transform_pose(self, pose, **kwargs):
        return pose

    def __getitem__(self, item):
        if not isinstance(item, (int, np.integer)):
            raise TypeError("TransformingDataset indexes by int; slice via Subscriptable")
        cloud, pose = self.target[item]
        return self.transform_cloud(cloud, item=item), self.transform_pose(pose, item=item)

    def __iter__(self):
        for item in range(len(self.target)):
            yield self[item]

    def local_cloud(self, id):
        return self.transform_cloud(self.target.local_cloud(id))

    def cloud_pose(self, id):
        return self.transform_pose(self.target.cloud_pose(id))


class OverridePosesDataset(TransformingDataset):
    """Replace the dataset's poses with ones read from a CSV file: training
    from SLAM-estimated rather than ground-truth poses (reference:
    main.py:288-293, dataset.py:533-571; JAX package,
    datasets/wrappers.py:85-133).

    The CSV uses the robot_data schema (``poseId, timestamp, T00..T33``),
    read by ``asl_laser.read_poses``. Poses align to the scans by id when
    every scan id is a pose id (a full-sequence file reused with a narrower
    or reordered slice); otherwise by position, which needs one pose a scan.
    """

    def __init__(self, dataset, poses_path: str):
        from .asl_laser import read_poses

        super().__init__(dataset)
        self.poses_path = poses_path
        ids, poses = read_poses(poses_path)
        n = len(dataset)
        by_id = {str(i): p for i, p in zip(ids, poses)}
        ds_ids = [str(i) for i in getattr(dataset, "ids", range(n))]
        alignable = (len(ds_ids) == n and len(set(ds_ids)) == n
                     and all(i in by_id for i in ds_ids))
        if alignable:
            poses = [by_id[i] for i in ds_ids]
        elif len(poses) != n:
            raise ValueError("poses file %s holds %d poses for %d scans and the scan ids do "
                             "not match the pose ids" % (poses_path, len(poses), n))
        self.poses = [np.asarray(p, np.float64) for p in poses]

    def transform_pose(self, pose, item=None):
        if item is None:
            return pose
        return self.poses[int(item)]

    def cloud_pose(self, id):
        ids = list(self.target.ids)
        return self.poses[ids.index(id)]


class FilteredDataset(TransformingDataset):
    """Depth + grid filtering on access (reference: dataset.py:765-773)."""

    def __init__(self, dataset, cfg):
        super().__init__(dataset)
        self.cfg = cfg

    def transform_cloud(self, cloud, **kwargs):
        from ..preproc import filtered_cloud
        from .synthetic import make_structured

        pts, vps, normals = filtered_cloud(cloud, self.cfg)
        return make_structured(pts, normals=normals, vps=vps)


class NoisyPoseDataset(TransformingDataset):
    """SE(3) pose noise, per pose or common to all (reference:
    dataset.py:776-817; JAX package, datasets/wrappers.py:151-193).

    ``pose`` mode draws each pose's noise from a seed of the pose itself
    and leaves the first pose as it is unless ``first_noisy``; ``common``
    draws one transform from seed 135 for every pose.
    """

    MODES = ("pose", "common")

    def __init__(self, dataset, noise=0.0, mode="common", first_noisy=False):
        assert mode in self.MODES
        super().__init__(dataset)
        noise = np.asarray(noise, np.float64)
        assert noise.ndim == 0 or noise.shape == (6,)
        self.noise = noise
        self.mode = mode
        self.first_noisy = first_noisy

    def random_transform(self, seed):
        from .synthetic import euler_matrix

        rng = np.random.default_rng(seed)
        vec = self.noise * rng.normal(size=6)
        T = euler_matrix(*vec[:3])
        T[:3, 3] = vec[3:]
        return T

    def transform_pose(self, pose, item=None):
        if self.mode == "pose":
            if not self.first_noisy and item == 0:
                return pose
            seed = _stable_seed(pose)
        else:
            seed = 135
        if np.any(self.noise != 0.0):
            pose = pose @ self.random_transform(seed)
        return pose

    def cloud_pose(self, id):
        # The positional index, so that the first-pose exemption holds
        # through both access paths (ds[0] and cloud_pose(id)).
        ids = list(self.target.ids)
        return self.transform_pose(self.target.cloud_pose(id), item=ids.index(id))


class NoisyDepthDataset(TransformingDataset):
    """Along-ray Gaussian depth noise (reference: dataset.py:820-847)."""

    def __init__(self, dataset, noise=None):
        super().__init__(dataset)
        self.noise = noise

    def transform_cloud(self, cloud, **kwargs):
        if not self.noise:
            return cloud
        pts = structured_to_unstructured(cloud[["x", "y", "z"]]).copy()
        if "vp_x" in cloud.dtype.names:
            vps = structured_to_unstructured(cloud[["vp_x", "vp_y", "vp_z"]])
        else:
            vps = np.zeros((1, 3))
        rays = pts - vps
        depth = np.linalg.norm(rays, axis=1)
        ok = depth > 0.0
        dirs = np.zeros_like(rays)
        dirs[ok] = rays[ok] / depth[ok, None]
        rng = np.random.default_rng(_stable_seed(depth))
        pts[ok] += dirs[ok] * self.noise * rng.normal(size=ok.sum())[:, None]
        cloud = cloud.copy()
        cloud[["x", "y", "z"]] = unstructured_to_structured(pts, names=["x", "y", "z"])
        return cloud


class DepthBiasDataset(TransformingDataset):
    """Injects a known incidence-angle depth bias by applying the model's
    *inverse* to clean data — the self-supervision ground-truth generator
    (reference: dataset.py:850-873). Host-side, in float64 on the CPU."""

    def __init__(self, dataset, model, cfg=None):
        super().__init__(dataset)
        self.model = model
        self.cfg = cfg

    def transform_cloud(self, cloud, **kwargs):
        if self.model is None:
            return cloud
        from ..cloud import Cloud
        from ..ops.features import compute_features
        from ..preproc import establish_scan_neighbors, pad_size

        dc = Cloud.from_structured_array(cloud, dtype=torch.float64)
        with torch.no_grad():
            if dc.normals is not None:
                # Analytic normals: incidence angle directly.
                cos = (dc.dirs * dc.normals).sum(-1)
                dc = dc.replace(inc_angles=torch.arccos(torch.clamp(cos.abs(), 0.0, 1.0)))
            else:
                # Estimate normals from data (reference: dataset.py:863-866).
                if self.cfg is None:
                    raise ValueError("cfg needed to estimate normals")
                dc = dc.pad(pad_size(dc.size))
                nn, w = establish_scan_neighbors(dc, self.cfg)
                dc = compute_features(dc, nn, w)
            dc = self.model.inverse(dc)
            pts = dc.to_points()[dc.valid].numpy()
        cloud = cloud.copy()
        cloud[["x", "y", "z"]] = unstructured_to_structured(
            pts.astype(np.float64), names=["x", "y", "z"]
        )
        return cloud


class Subscriptable(Forwarding):
    """Index-view wrapper allowing list/slice indexing
    (reference: dataset.py:876-909).

    >>> list(Subscriptable('qwerasdf')[::2])
    ['q', 'e', 'a', 'd']
    """

    def __init__(self, target, idx: Optional[list] = None):
        super().__init__(target)
        self.idx = list(range(len(target))) if idx is None else idx

    @property
    def ids(self):
        """Scan ids of the VIEW (sliced like the data)."""
        base = list(self.target.ids)
        return [base[i] for i in self.idx]

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self.target[self.idx[i]]
        if isinstance(i, (list, tuple)):
            return Subscriptable(self.target, [self.idx[j] for j in i])
        if isinstance(i, slice):
            return Subscriptable(self.target, self.idx[i])
        raise ValueError("Invalid index: %s" % (i,))

    def __iter__(self):
        for i in self.idx:
            yield self.target[i]

    def __len__(self):
        return len(self.idx)
