"""The street scene (``benchmark/street.py``): one seed, one street; every
scan sees surfaces facing along x, y and z within its range (so that no
registration is left without a constraint, as the open box's far side is);
the scans are thinned and bounded as the open box's; every surface lies
half a voxel off the voxel faces."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark import harness
from benchmark.street import _points, scan_pose, street, surfaces

SCENE = json.load(open(os.path.join(harness.BENCH_DIR, "configs", "box_seq50.json")))["scene"]
SMALL = dict(SCENE, n=3, density=20.0, max_depth=12.0)


def _flat(scans):
    return [np.stack([a["x"], a["y"], a["z"]], 1) for a, _ in scans], [T for _, T in scans]


def test_street_is_deterministic_per_seed_and_differs_across_seeds():
    big = 2 ** 31 + 12345
    a_pts, a_T = _flat(street(SMALL, big, "cpu"))
    b_pts, b_T = _flat(street(SMALL, big, "cpu"))
    c_pts, c_T = _flat(street(SMALL, big + 1, "cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a_pts, b_pts))
    assert all(np.array_equal(x, y) for x, y in zip(a_T, b_T))
    assert not np.array_equal(a_T[0], c_T[0])
    assert not all(len(x) == len(y) and np.array_equal(x, y) for x, y in zip(a_pts, c_pts))


def test_every_scan_sees_surfaces_facing_each_axis():
    """At the configuration's own size: of each scan's surface points
    within 1-25 m, thousands face along x, along y and along z."""
    rects = surfaces(SCENE)
    for i in (0, 17, 49):
        T = scan_pose(SCENE, 7, i, "cpu")
        world, nrm = _points(rects, 2.0, 7, i, "cpu")
        d = (world - T[:3, 3]).norm(dim=1)
        near = (d >= SCENE["min_depth"]) & (d <= SCENE["max_depth"])
        for axis in range(3):
            facing = int((near & (nrm[:, axis].abs() == 1)).sum())
            assert facing * 21 > 1000, (i, axis, facing)  # at density 42


def test_scans_are_thinned_within_the_depth_bounds():
    pts, _ = _flat(street(dict(SMALL, noise=0.0, bias_w=[0.0]), 7, "cpu"))
    for p in pts:
        d = np.linalg.norm(p, axis=1)
        assert len(p) > 1000 and d.min() >= 1.0 and d.max() <= 12.0
        assert len(np.unique(np.floor(p / 0.1), axis=0)) == len(p)


def test_surfaces_lie_half_a_voxel_off_the_voxel_faces():
    rects = surfaces(SCENE)
    assert len(rects) > 100
    for size, centre, normal in rects:
        axis = int(np.argmax(np.abs(normal)))
        assert size[axis] == 0.0
        assert abs(centre[axis] / 0.1 - np.floor(centre[axis] / 0.1) - 0.5) < 1e-6
    pose = scan_pose(SCENE, 7, 10, "cpu")
    assert torch.allclose(pose[:2, 3], torch.tensor([10.0, 0.0], dtype=torch.float64), atol=0.1)
