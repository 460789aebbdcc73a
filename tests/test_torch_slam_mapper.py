"""The port's scan-to-map SLAM with its map on the clouds' device
(``slam_eval.slam_mapper``), without JAX:

- the merge's voxel filter (``ops/filters.grid_first_mask``,
  ``mask_indices``) against the host's ``filter_grid_indices(keep="first")``:
  duplicate voxels within one scan, ties with old map rows, rows that take
  no part, points on voxel faces, and the packed key's range;
- the mapper against the benchmark's plain reference
  (``benchmark/reference/slam_mapper_ref.py``) on a seeded open box in
  float64, with and without eviction: poses within 1e-9, the final voxel
  sets equal;
- its spans and counters under ``trace.recording()``;
- on the card (``-m cuda``), a pass under
  ``torch.cuda.set_sync_debug_mode("error")``: only the counted copies
  sync. On the card: ``python -m pytest --noconftest -m cuda
  tests/test_torch_slam_mapper.py``.

The JAX parity of the mapper, at capacity too, is in ``test_torch_slam.py``.
"""
from __future__ import annotations

import json
import os
import warnings

import numpy as np
import pytest
import torch

from benchmark.drivers import slam as bench_slam
from benchmark.reference import slam_mapper_ref
from benchmark.scene import open_box
from depth_correction_tpu_torch import slam_eval
from depth_correction_tpu_torch.config import Config
from depth_correction_tpu_torch.models import ScaledPolynomial
from depth_correction_tpu_torch.ops.filters import (filter_grid_indices, grid_first_mask,
                                                    mask_indices)
from depth_correction_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 11
VOXEL = 0.1


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _host_first(points: torch.Tensor, valid: torch.Tensor, voxel: float) -> np.ndarray:
    """filter_grid_indices(keep="first") over the valid rows, as indices of
    all rows."""
    idx = np.nonzero(valid.numpy())[0]
    return idx[filter_grid_indices(points.numpy()[idx], voxel, keep="first")]


def _device_first(points, valid, voxel):
    keep, bad = grid_first_mask(points, voxel, valid)
    assert not bool(bad)
    return mask_indices(keep, int(keep.sum())).numpy()


def _merge_case(case: str, dtype):
    """(points, valid): a map of distinct voxels followed by a scan."""
    g = torch.Generator().manual_seed(7)
    if case == "duplicates":  # many rows a voxel within one scan, no map
        pts = torch.rand(3000, 3, generator=g, dtype=torch.float64) * 0.8 - 0.4
        valid = torch.ones(3000, dtype=torch.bool)
    elif case == "map_ties":  # the scan's rows share voxels with old map rows
        scan = torch.rand(4000, 3, generator=g, dtype=torch.float64) * 2.0 - 1.0
        old = scan[torch.from_numpy(filter_grid_indices(scan[:1500].numpy(), VOXEL,
                                                        keep="last"))]
        pts = torch.cat([old, scan])
        valid = torch.ones(pts.shape[0], dtype=torch.bool)
    elif case == "invalid_rows":  # rows that take no part, first in their voxels
        pts = torch.rand(2000, 3, generator=g, dtype=torch.float64) * 0.6 - 0.3
        valid = torch.rand(2000, generator=g) > 0.3
        pts[~valid] = pts[~valid].flip(0)
    else:  # "faces": points on voxel faces and at negative coordinates
        cells = torch.randint(-40, 40, (2500, 3), generator=g).to(torch.float64)
        pts = cells * VOXEL + torch.where(torch.rand(2500, 3, generator=g) < 0.5, 0.0, 1e-3)
        valid = torch.ones(2500, dtype=torch.bool)
    return pts.to(dtype), valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["duplicates", "map_ties", "invalid_rows", "faces"])
def test_merge_keeps_the_hosts_first_row_of_each_voxel(case, dtype):
    pts, valid = _merge_case(case, dtype)
    want = _host_first(pts, valid, VOXEL)
    got = _device_first(pts, valid, VOXEL)
    assert len(want) < int(valid.sum())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("where,bad", [("inside", False), ("beyond", True), ("nan", True),
                                       ("nan_invalid", False)])
def test_merge_flags_a_voxel_beyond_the_packed_range(where, bad):
    pts = torch.zeros(4, 3, dtype=torch.float64)
    valid = torch.ones(4, dtype=torch.bool)
    far = (2 ** 20 - 2) * VOXEL if where == "inside" else (2 ** 20 + 5) * VOXEL
    pts[1, 0] = float("nan") if where.startswith("nan") else -far
    if where == "nan_invalid":
        valid[1] = False
    assert bool(grid_first_mask(pts, VOXEL, valid)[1]) == bad


@pytest.mark.parametrize("share", [0.0, 0.01, 0.5, 1.0])
def test_mask_indices_is_nonzero_given_the_count(share):
    mask = torch.rand(5000, generator=torch.Generator().manual_seed(3)) < share
    got = mask_indices(mask, int(mask.sum()))
    np.testing.assert_array_equal(got.numpy(), torch.nonzero(mask)[:, 0].numpy())


@pytest.fixture(scope="module")
def box():
    """A seeded 4-scan open box of ~1,400 points a scan (the benchmark's
    scene at box_r25's settings), its corrected feature clouds in float64
    on the CPU, the perturbed priors, and the clouds as the reference
    takes them."""
    with open(os.path.join(ROOT, "benchmark", "configs", "box_r25.json")) as f:
        conf = json.load(f)
    cfg = Config()
    cfg.from_dict(conf["settings"], strict=True)
    cfg.device, cfg.float_type = "cpu", "float64"
    scene = dict(conf["scene"], n=4, size=[4.0, 4.0, 2.0], density=100.0)
    scans = open_box(scene, SEED, "cpu")
    model = ScaledPolynomial(w=[-0.002], exponent=[4.0], dtype=torch.float64, device="cpu")
    clouds, poses = slam_eval.slam_clouds(scans, cfg, model)
    priors = bench_slam._priors(poses, [0.01, 0.05], SEED)
    refs = [{"points": c.get_points()[c.valid], "normals": c.normals[c.valid]} for c in clouds]
    return clouds, priors, refs


def _keys(points):
    return {tuple(k) for k in slam_mapper_ref.voxel_keys(points, VOXEL).tolist()}


@pytest.mark.parametrize("capacity", [1 << 19, 2000])
def test_slam_mapper_matches_the_plain_reference(box, capacity):
    """Float64 on the CPU, the same clouds: the poses within 1e-9 and the
    final voxel sets equal; 2,000 voxels evict at every merge from the
    second (the first scan holds ~1,400)."""
    clouds, priors, refs = box
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        est, (pts, normals) = slam_eval.slam_mapper(clouds, priors, n_iters=4,
                                                    map_capacity=capacity, plain=True,
                                                    return_map=True)
    ref = slam_mapper_ref.mapper(refs, priors, n_iters=4, map_capacity=capacity)
    np.testing.assert_allclose(est, ref["poses"], rtol=0, atol=1e-9)
    assert pts.dtype == normals.dtype == torch.float64 and pts.shape == normals.shape
    assert _keys(pts) == _keys(ref["points"]) and len(_keys(pts)) == pts.shape[0]
    at_capacity = [w for w in caught if "at capacity" in str(w.message)]
    assert len(at_capacity) == sum(1 for e in ref["evicted"] if e)
    if capacity == 2000:
        assert ref["evicted"][0] == 0 and all(ref["evicted"][1:])
        assert pts.shape[0] == capacity
    else:
        assert not any(ref["evicted"])
    np.testing.assert_array_equal(
        slam_eval.slam_mapper(clouds, priors, n_iters=4, map_capacity=capacity, plain=True), est)


def test_slam_mapper_spans_nest_and_count(box):
    """Each registration's spans under its ``slam.scan``; the scan's one
    read (T and the merge's count) inside ``map.merge``; the map's rows
    and the evicted rows counted as the reference tallies them."""
    clouds, priors, refs = box
    cap = 2000
    ref = slam_mapper_ref.mapper(refs, priors, n_iters=2, map_capacity=cap)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        off = slam_eval.slam_mapper(clouds, priors, n_iters=2, map_capacity=cap, plain=True)
        with trace.recording():
            on = slam_eval.slam_mapper(clouds, priors, n_iters=2, map_capacity=cap, plain=True)
    np.testing.assert_array_equal(on, off)
    recs = trace.records()
    names = [r[0] for r in recs]
    scans = [i for i, n in enumerate(names) if n == "slam.scan"]
    assert len(scans) == len(clouds) - 1
    # The first scan's merge opens before the first registration.
    assert names[:names.index("slam.scan")].count("map.merge") == 1
    for i in scans:
        kids = [j for j, r in enumerate(recs) if r[3] == i]
        assert [recs[j][0] for j in kids if recs[j][0].startswith("map.")] == [
            "map.target", "map.merge", "map.evict"]
        merge = next(j for j in kids if recs[j][0] == "map.merge")
        assert [r[0] for r in recs if r[3] == merge] == ["copy.d2h"]
        assert "copy.d2h" not in [recs[j][0] for j in kids]
    assert trace.COUNTS["map_voxels"] == sum(m for _, m in ref["work"])
    assert trace.COUNTS["map_evicted"] == sum(ref["evicted"]) > 0
    assert trace.COUNTS["host_syncs"] == 0  # CPU tensors: no copy crosses


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run this file with -m cuda on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_slam_mapper_syncs_only_where_counted(cuda_device):
    """A mapper pass (X3, X6, the merge and an eviction on the card) with
    every host sync an error but the counted copies: the pose and the
    first merge's center up before the first registration, the first
    merge's read; then a registration's T0 up and its one read (T and the
    merge's count). The results are those of the untraced pass, and the
    map stays on the card."""
    with open(os.path.join(ROOT, "benchmark", "configs", "box_r25.json")) as f:
        conf = json.load(f)
    cfg = Config()
    cfg.from_dict(conf["settings"], strict=True)
    cfg.device = "cuda"
    scene = dict(conf["scene"], n=4, size=[10.0, 10.0, 5.0], density=60.0)
    scans = open_box(scene, SEED, "cuda")
    model = ScaledPolynomial(w=[-0.002], exponent=[4.0], dtype=torch.float32, device="cuda")
    clouds, poses = slam_eval.slam_clouds(scans, cfg, model)
    priors = bench_slam._priors(poses, [0.01, 0.05], SEED)
    cap = int(clouds[0].valid.sum()) + 1000
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, (want_pts, _) = slam_eval.slam_mapper(clouds, priors, map_capacity=cap,
                                                    return_map=True)
        torch.cuda.synchronize()
        trace.reset()
        with trace.recording():
            torch.cuda.set_sync_debug_mode("error")
            try:
                est, (pts, normals) = slam_eval.slam_mapper(clouds, priors, map_capacity=cap,
                                                            return_map=True)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(est, want)
    assert torch.equal(pts, want_pts) and pts.device.type == normals.device.type == "cuda"
    assert trace.COUNTS["map_evicted"] > 0
    assert trace.COUNTS["host_syncs"] == 3 + 2 * (len(clouds) - 1)
    copies = sum(1 for r in trace.records() if r[0].startswith("copy."))
    assert trace.COUNTS["host_syncs"] == copies
