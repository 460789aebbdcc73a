"""The port's spans and host-sync counts (``utils/trace.py``): off they
record nothing; on they nest, land in a profiler's trace under their names
and give self times; ``idle_by_span`` gives each device-idle gap to the
span open across it; the SLAM, node and prep paths record their spans;
the benchmark's ``span_ms`` and ``host_syncs`` readers read them. The test
marked ``cuda`` runs a SLAM pass and a node scan with every uncounted host
sync an error; on the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_trace.py``."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from benchmark import harness
from depth_correction_tpu_torch import slam_eval
from depth_correction_tpu_torch.config import Config
from depth_correction_tpu_torch.datasets import create_dataset
from depth_correction_tpu_torch.preproc import local_feature_cloud
from depth_correction_tpu_torch.train import prepare_sequences
from depth_correction_tpu_torch.utils import trace

SCENE = "open_box/n_4_size_6_6_3_height_1_density_50"
SLAM_CHILDREN = {"slam.prior", "copy.h2d", "icp.search", "icp.gate", "icp.solve", "copy.d2h"}


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


class _Clock:
    """A fake ``time`` module whose ``perf_counter_ns`` steps by 1 ms."""

    def __init__(self):
        self.now = 0

    def perf_counter_ns(self):
        self.now += 1_000_000
        return self.now


def test_off_records_nothing_and_shares_one_context():
    a, b = trace.span("slam.scan", scan=1), trace.span("icp.gate")
    assert a is b
    with a:
        trace.to_host(torch.ones(2))
        trace.to_device(np.ones(2), dtype=torch.float64, device="cpu")
    assert trace.records() == [] and trace.COUNTS == {"host_syncs": 0, "dropped": 0}


def test_nesting_parents_and_self_time_on_a_fake_clock(monkeypatch):
    monkeypatch.setattr(trace, "time", _Clock())
    with trace.recording():
        assert trace.span("icp.gate") is not trace.span("icp.gate")
        for i in (1, 2):
            with trace.span("slam.scan", scan=i):  # opens at 1, closes at 8 (ms)
                with trace.span("slam.prior"):  # 2 .. 5
                    with trace.span("copy.h2d"):  # 3 .. 4
                        pass
                with trace.span("icp.search"):  # 6 .. 7
                    pass
    assert trace.span("icp.gate") is trace.span("icp.solve")
    recs = trace.records()
    assert [(r[0], r[3], r[4]) for r in recs[:4]] == [
        ("slam.scan", None, {"scan": 1}), ("slam.prior", 0, {}), ("copy.h2d", 1, {}),
        ("icp.search", 0, {})]
    assert recs[4][3] is None and recs[5][3] == 4
    assert [r[2] - r[1] for r in recs[:4]] == [7_000_000, 3_000_000, 1_000_000, 1_000_000]
    got = trace.self_ms(recs, "slam.scan")
    assert got == {"slam.scan": 3.0, "slam.prior": 2.0, "copy.h2d": 1.0, "icp.search": 1.0}
    assert sum(got.values()) == 7.0  # the item's duration
    assert trace.self_ms(recs, "fit.step") == {}


def test_records_past_the_cap_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 3)
    with trace.recording():
        for _ in range(5):
            with trace.span("icp.gate"):
                pass
    assert len(trace.records()) == 3 and trace.COUNTS["dropped"] == 2


def test_cpu_copies_are_spans_but_not_host_syncs():
    with trace.recording():
        t = trace.to_device(np.arange(3.0), dtype=torch.float32, device="cpu")
        assert t.dtype == torch.float32 and trace.to_host(t) is t
        assert trace.to_device(t, like=torch.zeros(1, dtype=torch.float64)).dtype == \
            torch.float64
    assert [r[0] for r in trace.records()] == ["copy.h2d", "copy.d2h", "copy.h2d"]
    assert trace.COUNTS["host_syncs"] == 0


def test_spans_are_record_function_events_of_a_profile():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("fit.step", it=0):
            with trace.span("step.forward"):
                torch.ones(4).sum()
    assert trace.span("fit.step") is trace.span("step.forward")
    notes = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    assert {"fit.step", "step.forward"} <= notes
    assert [r[0] for r in trace.records()] == ["fit.step", "step.forward"]


def _event(name, start, end, device=DeviceType.CUDA, note=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=note,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_idle_by_span_gives_each_gap_to_the_innermost_open_span():
    cpu = DeviceType.CPU
    events = [
        _event("A", 0, 100, cpu, True), _event("B", 10, 40, cpu, True),
        _event("C", 50, 90, cpu, True), _event("aten::add", 0, 100, cpu),
        _event("k0", 0, 5), _event("k1", 20, 30), _event("k2", 45, 60),
        _event("k3", 95, 100), _event("k4", 200, 210),
        _event("C", 50, 90, DeviceType.CUDA, True),  # a device-side annotation: no operation
    ]
    got = trace.idle_by_span(events)
    want = {"A": 15e-6, "B": 20e-6, "C": 30e-6, "": 100e-6}
    assert set(got) == set(want) and list(got)[0] == ""
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12)


@pytest.fixture(scope="module")
def box():
    """Four tiny open-box scans' feature clouds (float64, CPU) and a
    perturbed odometry chain."""
    cfg = Config()
    cfg.float_type, cfg.device = "float64", "cpu"
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 30.0, 0.3
    cfg.nn_r, cfg.nn_k, cfg.nn_backend = 0.6, 0, "scipy"
    cfg.vp_dispersion_bounds, cfg.eigenvalue_ratio_bounds = [], []
    cfg.min_valid_neighbors = 3
    clouds, poses = [], []
    for scan, pose in create_dataset(SCENE, cfg):
        clouds.append(local_feature_cloud(scan, cfg))
        poses.append(np.asarray(pose))
    odom = slam_eval.perturb_odometry(np.stack(poses), [1e-5] * 3 + [4e-3] * 3, seed=3)
    return clouds, odom


@pytest.mark.parametrize("pipeline", ["slam_odometry", "slam_mapper"])
def test_slam_records_a_scan_span_a_registration(box, pipeline):
    clouds, odom = box
    n_iters = 2
    off = getattr(slam_eval, pipeline)(clouds, odom, n_iters=n_iters, plain=True)
    with trace.recording():
        on = getattr(slam_eval, pipeline)(clouds, odom, n_iters=n_iters, plain=True)
    np.testing.assert_array_equal(on, off)
    recs = trace.records()
    scans = [i for i, r in enumerate(recs) if r[0] == "slam.scan"]
    assert len(scans) == len(clouds) - 1
    assert [recs[i][4] for i in scans] == [{"scan": s} for s in range(1, len(clouds))]
    for i in scans:
        kids = [r[0] for r in recs if r[3] == i]
        assert set(kids) == SLAM_CHILDREN
        for name in ("icp.search", "icp.gate", "icp.solve"):
            assert kids.count(name) == n_iters
    assert trace.COUNTS["host_syncs"] == 0  # CPU tensors: no copy crosses


def test_node_scan_records_its_parts():
    from depth_correction_tpu_torch.datasets.synthetic import OpenBoxDataset
    from depth_correction_tpu_torch.node import DepthCorrector

    cfg = Config()
    cfg.device = "cpu"
    cfg.min_depth, cfg.max_depth, cfg.grid_res, cfg.nn_r = 1.0, 25.0, 0.1, 0.25
    cfg.min_valid_neighbors = 5
    cfg.model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    scan = OpenBoxDataset(name="open_box/n_6_size_10_10_5_height_1_density_20").local_cloud(0)
    node = DepthCorrector(cfg)
    off = node.process(scan)
    with trace.recording():
        on = node.process(scan)
    assert on.tobytes() == off.tobytes()
    recs = trace.records()
    assert recs[0][0] == "node.scan" and recs[0][4] == {"scan": 2}
    kids = [r[0] for r in recs if r[3] == 0]
    assert set(kids) == {"copy.h2d", "node.correct", "copy.d2h"}
    assert kids.count("copy.d2h") == 5


# The parts of prep_seconds that each prep records, as the port recorded
# them before its spans took over the timing.
PREP_PARTS = {
    "cellwin": ({}, ["cellwin_build", "global_features", "global_neighbors", "load_scans",
                     "local_features", "transpose"]),
    "offset": ({"loss_offset": True}, ["cellwin_build", "global_features", "global_neighbors",
                                       "load_scans", "local_features", "offset_graph",
                                       "transpose"]),
    "icp": ({"loss": "icp_loss", "moments_backend": None},
            ["icp_correspondences", "load_scans", "local_features", "transpose"]),
    "gather": ({"moments_backend": None}, ["global_features", "global_neighbors", "load_scans",
                                           "local_features", "transpose"]),
}


@pytest.mark.parametrize("case", sorted(PREP_PARTS))
def test_prep_seconds_keeps_its_parts(tmp_path, case):
    kw, parts = PREP_PARTS[case]
    cfg = Config()
    cfg.float_type, cfg.device = "float64", "cpu"
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k, cfg.nn_backend = 0.4, 0, "scipy"
    cfg.vp_dispersion_bounds, cfg.eigenvalue_ratio_bounds = [], []
    cfg.min_valid_neighbors = 3
    cfg.moments_backend = "cellwin"
    cfg.cellwin_row_cap = cfg.cellwin_pt_cap = 32
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    for k, v in kw.items():
        setattr(cfg, k, v)
    with trace.recording():
        data = prepare_sequences([create_dataset("ground_plane/4", cfg)], cfg)
    assert sorted(data.prep_seconds) == parts
    assert all(s > 0 for s in data.prep_seconds.values())
    spans = {r[0] for r in trace.records() if r[0].startswith("prep.")}
    assert spans == {"prep." + p for p in parts}
    cfg.prep_cache_dir = str(tmp_path)
    built = prepare_sequences([create_dataset("ground_plane/4", cfg)], cfg)
    loaded = prepare_sequences([create_dataset("ground_plane/4", cfg)], cfg)
    assert sorted(built.prep_seconds) == sorted(parts + ["cache_save"])
    assert sorted(loaded.prep_seconds) == ["cache_load", "load_scans", "transpose"]


def _hand_made():
    """Two registrations' records (ns) and their counts: per scan 10 ms, of
    which slam.prior 2 (copy.h2d 0.5 of it), icp.search 4 (x3.knn 1 of
    it), copy.d2h 1; a span outside the scans that no metric reads."""
    recs = []
    for base in (0, 20_000_000):
        s = len(recs)
        recs += [("slam.scan", base, base + 10_000_000, None, {"scan": s // 6 + 1}),
                 ("slam.prior", base, base + 2_000_000, s, {}),
                 ("copy.h2d", base + 500_000, base + 1_000_000, s + 1, {}),
                 ("icp.search", base + 2_000_000, base + 6_000_000, s, {}),
                 ("x3.knn", base + 3_000_000, base + 4_000_000, s + 3, {}),
                 ("copy.d2h", base + 9_000_000, base + 10_000_000, s, {})]
    recs.append(("prep.load_scans", 50_000_000, 60_000_000, None, {}))
    return recs


@pytest.mark.parametrize("metric,want", [
    ("span_ms.slam.scan", 3.0), ("span_ms.slam.prior", 1.5), ("span_ms.copy.h2d", 0.5),
    ("span_ms.icp.search", 3.0), ("span_ms.x3.knn", 1.0), ("span_ms.copy.d2h", 1.0),
    ("span_ms.icp.gate", None), ("host_syncs.slam", 3.0)])
def test_benchmark_readers_read_the_records(monkeypatch, metric, want):
    monkeypatch.setattr(trace, "records", _hand_made)
    monkeypatch.setitem(trace.COUNTS, "host_syncs", 6)
    cell = harness.Cell("box_r25.slam", harness.load_manifest())
    assert metric in {m["name"] for m in cell.per_layer}
    assert cell.reader(metric)({"cell": cell}) == want


@pytest.mark.parametrize("metric", ["span_ms.slam.scan", "host_syncs.slam"])
def test_benchmark_readers_find_nothing_without_records(metric):
    cell = harness.Cell("box_r25.slam", harness.load_manifest())
    assert cell.reader(metric)({"cell": cell}) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run this file with -m cuda on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_host_sync_is_counted_on_the_card(cuda_device):
    """A SLAM pass (X3, X6) and a node scan (slab engine, X1) with every host
    sync an error but the counted copies: the count is the copies, and the
    results are those of the untraced calls."""
    from depth_correction_tpu_torch.datasets.synthetic import OpenBoxDataset
    from depth_correction_tpu_torch.node import DepthCorrector

    cfg = Config()
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 1.0, 25.0, 0.1
    cfg.nn_r, cfg.nn_k, cfg.min_valid_neighbors = 0.25, 0, 5
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = [[0, 1, 0, 0.25], [1, 2, 0.25, 1.0]]
    cfg.model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.nn_backend = "slab"
    ds = OpenBoxDataset(name="open_box/n_4_size_10_10_5_height_1_density_60")
    with torch.no_grad():
        clouds = [local_feature_cloud(ds.local_cloud(i), cfg) for i in range(len(ds))]
    poses = np.stack([np.asarray(ds.cloud_pose(i)) for i in range(len(ds))])
    odom = slam_eval.perturb_odometry(poses, [1e-5] * 3 + [4e-3] * 3, seed=3)
    node = DepthCorrector(cfg)
    scan = ds.local_cloud(0)
    want = (slam_eval.slam_odometry(clouds, odom), node.process(scan))  # warm-up
    torch.cuda.synchronize()
    trace.reset()
    with trace.recording():
        torch.cuda.set_sync_debug_mode("error")
        try:
            est = slam_eval.slam_odometry(clouds, odom)
            slam_syncs = trace.COUNTS["host_syncs"]
            out = node.process(scan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(est, want[0])
    assert out.tobytes() == want[1].tobytes()
    # A registration: the prior's pose and T0 up, T back; its 8 steps (X3
    # and X6) read nothing back.
    assert slam_syncs == 3 * (len(clouds) - 1)
    copies = sum(1 for r in trace.records() if r[0].startswith("copy."))
    assert trace.COUNTS["host_syncs"] == copies
