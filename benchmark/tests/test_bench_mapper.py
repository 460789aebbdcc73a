"""The scan-to-map cells (``box_r25.slam_mapper``, ``box_seq50.slam_mapper``)
on tiny copies on the CPU: the program agrees with the plain reference, the
control and each fault of the mapper fail a limit, a program without the
map's return fails at once, and the cells' readers read the program's
spans and counts (None without them). The ``box_seq50`` copy is a street
of a few metres, dense enough that no neighbourhood is a bare three
points, with a map capacity below its scans' union, so that it evicts."""
from __future__ import annotations

import functools
import time

import pytest

from benchmark import harness
from benchmark.profiling import Profile

from .common import tiny_cell

SEED = 2 ** 31 + 11
CELLS = ["box_r25.slam_mapper", "box_seq50.slam_mapper"]
TINY = {"box_r25.slam_mapper": (None, {}),
        "box_seq50.slam_mapper": ({"n": 4, "density": 150.0, "max_depth": 4.0, "step": 0.5,
                                   "street_width": 6.0, "kerb": 1.0, "building_height": 2.5,
                                   "block": 5.0, "gap": 2.0, "car_every": 5.0,
                                   "car_size": [1.5, 0.8, 0.6]},
                                  {"map_capacity": 6000})}


def _tiny(cell, tmp_path):
    scene, traffic = TINY[cell]
    return tiny_cell(cell, tmp_path, scene=scene, traffic=traffic)


def _run(cell, tmp_path):
    return harness.run_cell(_tiny(cell, tmp_path), SEED, 0.5, False, time.perf_counter(),
                            device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_the_mapper_agrees_with_the_reference(cell, tmp_path):
    out = _run(cell, tmp_path)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(_tiny(cell, tmp_path).limits) == {
        "trans_err", "rot_err", "normal_mean", "map_share"}
    assert set(out["metrics"]) == {"slam_scan_ms", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_each_fault_fail_a_limit(cell, tmp_path):
    c = _tiny(cell, tmp_path)
    got = c.driver.calibrate(c, SEED + 5, "cpu", 0.3, with_control=True)
    lim = c.limits

    def fails(numbers):
        return any(numbers[k] > lim[k] for k in numbers)

    assert not fails(got["program"]), got["program"]
    assert fails(got["control"]) and fails(got["odometry"]) and fails(got["last_wins"])
    if cell == "box_seq50.slam_mapper":
        assert got["evicted"] > 0 and got["largest_map"] == 6000
        assert got["no_evict"]["map_share"] > lim["map_share"]
    else:
        assert got["evicted"] == 0 and got["no_evict"]["map_share"] == 0.0


def test_a_map_that_never_evicts_fails(tmp_path, monkeypatch):
    from depth_correction_tpu_torch import slam_eval

    mapper = slam_eval.slam_mapper

    @functools.wraps(mapper)
    def unbounded(*a, **kw):
        return mapper(*a, **dict(kw, map_capacity=1 << 30))

    monkeypatch.setattr(slam_eval, "slam_mapper", unbounded)
    out = _run("box_seq50.slam_mapper", tmp_path)
    assert not out["correct"]
    assert out["checks"]["map_share"]["value"] > out["checks"]["map_share"]["limit"]


def test_a_pose_altered_where_it_is_produced_fails(tmp_path, monkeypatch):
    from depth_correction_tpu_torch import slam_eval

    mapper = slam_eval.slam_mapper

    @functools.wraps(mapper)
    def altered(*a, **kw):
        est, m = mapper(*a, **kw)
        est[-1, 0, 3] += 0.01
        return est, m

    monkeypatch.setattr(slam_eval, "slam_mapper", altered)
    out = _run("box_r25.slam_mapper", tmp_path)
    assert not out["correct"]
    assert out["checks"]["trans_err"]["value"] > 0.009


def test_a_program_whose_mapper_returns_no_map_fails_at_once(tmp_path, monkeypatch):
    from depth_correction_tpu_torch import slam_eval

    def old(clouds, init_poses, n_iters=8, inlier_ratio=0.8, map_voxel=0.1,
            map_capacity=1 << 19, plain=False):
        raise AssertionError("not reached")

    monkeypatch.setattr(slam_eval, "slam_mapper", old)
    c = _tiny("box_seq50.slam_mapper", tmp_path)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="return_map"):
        c.driver.setup(c, SEED, "cpu")
    assert time.perf_counter() - t0 < 1.0


def _hand_made():
    """Two registrations' records (ns): per scan 10 ms, of which map.target
    0.5, icp.search 4 (x3.knn 1 of it), map.merge 3 (copy.d2h 2 of it),
    map.evict 0.5; a pass's first merge outside the scans."""
    recs = [("map.merge", 0, 1_000_000, None, {})]
    for base in (2_000_000, 22_000_000):
        s = len(recs)
        recs += [("slam.scan", base, base + 10_000_000, None, {"scan": s // 7 + 1}),
                 ("map.target", base, base + 500_000, s, {}),
                 ("icp.search", base + 1_000_000, base + 5_000_000, s, {}),
                 ("x3.knn", base + 2_000_000, base + 3_000_000, s + 2, {}),
                 ("map.merge", base + 6_000_000, base + 9_000_000, s, {}),
                 ("copy.d2h", base + 6_500_000, base + 8_500_000, s + 4, {}),
                 ("map.evict", base + 9_000_000, base + 9_500_000, s, {})]
    return recs


@pytest.mark.parametrize("metric,want", [
    ("mapper_ms.map.merge", 1.0), ("mapper_ms.map.evict", 0.5), ("mapper_ms.icp.search", 3.0),
    ("mapper_ms.copy.d2h", 2.0), ("mapper_syncs", 2.5), ("map_voxels", 75_000.0)])
def test_the_readers_read_the_programs_records(monkeypatch, metric, want):
    from depth_correction_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "records", _hand_made)
    monkeypatch.setitem(trace.COUNTS, "host_syncs", 5)
    monkeypatch.setitem(trace.COUNTS, "map_voxels", 150_000)
    cell = harness.Cell("box_seq50.slam_mapper", harness.load_manifest())
    assert metric in {m["name"] for m in cell.per_layer}
    assert cell.reader(metric)({"cell": cell}) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["mapper_ms.map.merge", "mapper_syncs", "map_voxels",
                                    "x3_map_roofline", "mfu.slam_mapper",
                                    "device_idle_pct.slam_mapper"])
def test_the_readers_find_nothing_without_records(metric):
    from depth_correction_tpu_torch.utils import trace

    trace.reset()
    cell = harness.Cell("box_r25.slam_mapper", harness.load_manifest())
    assert cell.reader(metric)({"cell": cell, "verdict": {}, "window": {}}) is None


def test_x3_map_roofline_prices_each_search_in_the_map():
    """Two registrations of 1,000 queries in maps of 2,000 and 3,000 rows,
    8 searches each: (1,000 + m) * 12 + 1,000 * 8 bytes a search; X3's
    1 ms a registration in the profile."""
    cell = harness.Cell("box_seq50.slam_mapper", harness.load_manifest())
    prof = Profile([("knn_tiles_kernel", 0.0, 1000.0), ("knn_tiles_kernel", 5000.0, 6000.0),
                    ("other", 1000.0, 5000.0)], 0.01, 2)
    ctx = {"cell": cell, "profile": prof,
           "verdict": {"work": {"registrations": [(1000, 2000), (1000, 3000)]}}}
    need = 8 * ((1000 + 2000) * 12 + 8000 + (1000 + 3000) * 12 + 8000) / 2
    assert cell.reader("x3_map_roofline")(ctx) == pytest.approx(100 * need / 3.35e12 / 1e-3)
