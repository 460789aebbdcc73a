"""The benchmark's scene: one seed, one scene; another seed, another."""
from __future__ import annotations

import numpy as np

from benchmark.scene import open_box

SCENE = {"n": 2, "size": [4.0, 4.0, 2.0], "height": 1.0, "density": 150.0, "min_depth": 1.0,
         "max_depth": 25.0, "grid_res": 0.1, "bias_w": [-0.002], "bias_exponent": [4.0],
         "noise": 0.005}


def _flat(scans):
    return [np.stack([a["x"], a["y"], a["z"]], 1) for a, _ in scans], [T for _, T in scans]


def test_scene_is_deterministic_per_seed_and_differs_across_seeds():
    big = 2 ** 31 + 12345
    a_pts, a_T = _flat(open_box(SCENE, big, "cpu"))
    b_pts, b_T = _flat(open_box(SCENE, big, "cpu"))
    c_pts, c_T = _flat(open_box(SCENE, big + 1, "cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a_pts, b_pts))
    assert all(np.array_equal(x, y) for x, y in zip(a_T, b_T))
    assert not np.array_equal(a_T[0], c_T[0])
    assert not all(len(x) == len(y) and np.array_equal(x, y) for x, y in zip(a_pts, c_pts))


def test_scene_thins_to_one_point_a_voxel_within_the_depth_bounds():
    raw, _ = _flat(open_box(dict(SCENE, noise=0.0, bias_w=[0.0]), 7, "cpu", thin=False))
    thin, _ = _flat(open_box(dict(SCENE, noise=0.0, bias_w=[0.0]), 7, "cpu"))
    for r, t in zip(raw, thin):
        assert len(t) < len(r)
        d = np.linalg.norm(t, axis=1)
        assert d.min() >= 1.0 and d.max() <= 25.0
        # The voxels of the sensor's frame: one point each.
        assert len(np.unique(np.floor(t / 0.1), axis=0)) == len(t)
