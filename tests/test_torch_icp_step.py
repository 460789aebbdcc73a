"""The ICP step after its search (``ops/icp.py``): X6's pick of the inlier
threshold in plain torch against ``masked_quantile``, the plain twin against
the step as the port took it before X6, the routing of CPU and other
tensors and the spans around X6's launches. No JAX; X6 itself is held to
the twin on the card by ``tests/test_torch_kernels.py`` (``-m cuda``)."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from depth_correction_tpu_torch import slam_eval
from depth_correction_tpu_torch.ops import _kernels
from depth_correction_tpu_torch.ops import icp as ticp
from depth_correction_tpu_torch.ops.knn import knn_d2, nearest_neighbors
from depth_correction_tpu_torch.ops.reduce import masked_mean, masked_quantile
from depth_correction_tpu_torch.ops.se3 import transform_points, xyz_axis_angle_to_matrix

INF = float("inf")


def _distances(case: str, dtype):
    """(d2, ok) of 300 rows: ``plain`` (a fifth masked), ``inf_rows`` (some
    unmasked rows at +inf, others masked), ``all_masked``, ``one_row``,
    ``ties`` (eight distinct values), ``empty_mask`` (every row unmasked)."""
    rng = np.random.default_rng(11)
    d2 = rng.uniform(0.0, 0.04, 300)
    ok = rng.uniform(size=300) > 0.2
    if case == "inf_rows":
        d2[rng.choice(300, 30, replace=False)] = INF
    elif case == "all_masked":
        ok[:] = False
    elif case == "one_row":
        ok[:] = False
        ok[123] = True
    elif case == "ties":
        d2 = rng.integers(0, 8, 300) * 1e-3
    elif case == "empty_mask":
        ok[:] = True
    return torch.as_tensor(d2, dtype=dtype), torch.as_tensor(ok)


def inlier_threshold_plain(d2: torch.Tensor, ok: torch.Tensor, q: float) -> torch.Tensor:
    """``masked_quantile(sqrt(d2), ok, q)`` as X6 takes it, in plain torch:
    ``d2`` sorted with the masked rows at +inf, the order statistics at
    floor and ceil of q (n - 1) (n the unmasked rows) picked on the device
    and their square roots interpolated. sqrt is monotone, so the square
    roots of the sorted ``d2`` are the sorted distances."""
    x = d2.reshape(-1)
    ok = ok.reshape(-1)
    xs = torch.sort(torch.where(ok, x, torch.full_like(x, INF))).values
    n = ok.sum()
    pos = q * torch.clamp(n - 1, min=0).to(x.dtype)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.to(x.dtype)
    v_lo, v_hi = torch.sqrt(xs[torch.stack([lo, hi]).clamp(0, x.shape[0] - 1)])
    return v_lo * (1.0 - frac) + v_hi * frac


def _same(a, b) -> bool:
    """Equal, NaN included."""
    a, b = a.double(), b.double()
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("q", [0.0, 0.37, 0.8, 1.0])
@pytest.mark.parametrize("case", ["plain", "inf_rows", "all_masked", "one_row", "ties",
                                  "empty_mask"])
def test_inlier_threshold_pick_equals_masked_quantile(case, q, dtype):
    """Sorting d2 and taking the square roots of the two picks gives
    masked_quantile over the distances, bit for bit: NaN where no row is
    unmasked (inf * 0), inf where a pick lands on an infinite row."""
    d2, ok = _distances(case, dtype)
    d = torch.sqrt(d2)
    want = masked_quantile(d, ok, q)
    got = inlier_threshold_plain(d2, ok, q)
    assert got.dtype == dtype and _same(got, want)
    if case == "all_masked":
        assert torch.isnan(got)


def _box(dtype):
    """Scan 1 of a small open box placed by its noisy prior, and scan 0
    posed at ground truth, on the CPU."""
    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.preproc import local_feature_cloud

    cfg = Config()
    cfg.device = "cpu"
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 30.0, 0.3
    cfg.nn_r, cfg.nn_k, cfg.nn_backend = 0.6, 0, "scipy"
    cfg.vp_dispersion_bounds, cfg.eigenvalue_ratio_bounds = [], []
    cfg.min_valid_neighbors, cfg.depth_noise = 3, 0.005
    cfg.depth_bias_model_kwargs = {"w": [0.0], "exponent": [4.0]}
    (s0, p0), (s1, p1) = list(create_dataset("open_box/n_2_size_6_6_3_height_1_density_50",
                                             cfg))
    src, tgt = (local_feature_cloud(s, cfg).to(dtype=dtype) for s in (s0, s1))
    tgt = tgt.transform(torch.as_tensor(p0, dtype=dtype)).with_points()
    prior = slam_eval.perturb_odometry(np.stack([p0, p1]), [1e-5] * 3 + [4e-3] * 3, seed=3)[1]
    return src, tgt, torch.as_tensor(prior, dtype=dtype)


def _step_before_x6(T, src_pts, src_valid, tgt_pts, tgt_normals, tgt_valid, q):
    """The port's step before X6 (the JAX package's, slam_eval.py:48-71)."""
    dists, idx = nearest_neighbors(tgt_pts, src_pts, k=1, valid_points=tgt_valid)
    d = dists[:, 0]
    ok = (idx[:, 0] >= 0) & src_valid
    thr = masked_quantile(d, ok, q)
    w = (ok & (d <= thr)).to(src_pts.dtype)
    i = torch.clamp(idx[:, 0], min=0).long()
    qp, n = tgt_pts[i], tgt_normals[i]
    r = (n * (qp - src_pts)).sum(-1)
    J = torch.cat([torch.linalg.cross(src_pts, n), n], -1)
    Jw = J * w[:, None]
    H = Jw.T @ J + 1e-9 * torch.eye(6, dtype=src_pts.dtype)
    dx = torch.linalg.solve_ex(H, Jw.T @ r)[0]
    delta = xyz_axis_angle_to_matrix(torch.cat([dx[3:], dx[:3]]))
    return delta @ T, masked_mean(r.abs(), w > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("q", [0.8, 1.0])
def test_plain_step_equals_the_step_before_x6(dtype, q):
    """On the CPU the step (X3's and X6's plain twins) gives the step the
    port took before X6, bit for bit, three iterations on."""
    src, tgt, T = _box(dtype)
    Ta = Tb = T
    for _ in range(3):
        pts = transform_points(Ta, src.get_points())
        Ta, ea = slam_eval._icp_step(Ta, pts, src.valid, tgt.points, tgt.normals, tgt.valid, q,
                                     False)
        Tb, eb = _step_before_x6(Tb, transform_points(Tb, src.get_points()), src.valid,
                                 tgt.points, tgt.normals, tgt.valid, q)
        assert torch.equal(Ta, Tb) and torch.equal(ea, eb)
    assert not torch.equal(Ta, T)


def test_icp_update_takes_the_plain_twin_on_cpu(monkeypatch):
    """CPU tensors, or ``plain=True`` anywhere, take the twin; X6's
    launchers are never called and nothing is counted. The twin fills no
    stats and refuses a tensor for them."""
    calls = []

    def refuse(*args, **kw):
        raise AssertionError("launched X6")

    def twin(*args):
        calls.append(args[0].device.type)
        return args[0], None

    src, tgt, T = _box(torch.float64)
    pts = transform_points(T, src.get_points())
    d2, idx = knn_d2(tgt.points, pts, k=1, valid_points=tgt.valid)
    args = (T, d2[:, 0], idx[:, 0], pts, src.valid, tgt.points, tgt.normals, 0.8)
    want = ticp.icp_update_plain(*args)
    monkeypatch.setattr(_kernels, "launch_icp_gate", refuse)
    monkeypatch.setattr(_kernels, "launch_icp_solve", refuse)
    before = _kernels.ICP_SOLVE_LAUNCHES
    got = ticp.icp_update(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="stats"):
        ticp.icp_update(*args, stats=torch.zeros(_kernels.ICP_STATS, dtype=torch.float64))
    monkeypatch.setattr(ticp, "icp_update_plain", twin)
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    ticp.icp_update(*meta, plain=True)
    assert calls == ["meta"] and _kernels.ICP_SOLVE_LAUNCHES == before


def _x6_args(n: int = 16, m: int = 32):
    return (torch.eye(4), torch.zeros(n), torch.zeros(n, dtype=torch.int32), torch.zeros(n, 3),
            torch.ones(n, dtype=torch.bool), torch.zeros(m, 3), torch.zeros(m, 3))


def test_icp_update_sends_other_tensors_to_x6(monkeypatch):
    """A tensor off the CPU goes to X6's launchers (which validate and
    raise), never silently to the twin; the launchers refuse CPU tensors
    and count nothing then."""
    calls = []

    def fake_launch(*args):
        calls.append(args)
        raise RuntimeError("launched")

    def refuse(*args, **kw):
        raise AssertionError("took the plain twin")

    args = _x6_args()
    monkeypatch.setattr(_kernels, "launch_icp_gate", fake_launch)
    monkeypatch.setattr(ticp, "icp_update_plain", refuse)
    with pytest.raises(RuntimeError, match="launched"):
        ticp.icp_update(*(a.to("meta") for a in args), 0.8)
    assert len(calls) == 1
    monkeypatch.undo()
    before = _kernels.ICP_SOLVE_LAUNCHES
    T, d2, idx, pts, valid, tgt, nrm = args
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.launch_icp_gate(d2, idx, valid)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.launch_icp_solve(d2, torch.zeros(64, dtype=torch.uint8), *args, 0.8)
    assert _kernels.ICP_SOLVE_LAUNCHES == before


def test_icp_update_opens_the_step_spans_around_x6(monkeypatch):
    """On X6's path the SLAM layer's spans hold the launchers' own: the gate
    launch and the sort of its keys in ``icp.gate``, the solve launch in
    ``icp.solve``; the solve gets the keys sorted and the gate's scratch."""
    from depth_correction_tpu_torch.utils import trace

    seen = {}

    def gate(d2, idx, src_valid):
        with trace.span("x6.icp_gate"):
            return torch.tensor([3.0, 1.0, 2.0]), "scratch"

    def solve(key, scratch, T, *args):
        with trace.span("x6.icp_solve"):
            seen["key"], seen["scratch"], seen["stats"] = key, scratch, args[-1]
            return T, torch.zeros(())

    monkeypatch.setattr(_kernels, "launch_icp_gate", gate)
    monkeypatch.setattr(_kernels, "launch_icp_solve", solve)
    args = tuple(a.to("meta") for a in _x6_args(3))
    trace.reset()
    try:
        with trace.recording():
            ticp.icp_update(*args, 0.8, stats="stats")
        recs = trace.records()
    finally:
        trace.reset()
    names = [r[0] for r in recs]
    assert names == ["icp.gate", "x6.icp_gate", "icp.solve", "x6.icp_solve"]
    assert [r[3] for r in recs] == [None, 0, None, 2]
    assert seen["key"].tolist() == [1.0, 2.0, 3.0] and seen["scratch"] == "scratch"
    assert seen["stats"] == "stats"


def test_x6_source_is_built_and_defines_what_load_binds(monkeypatch):
    """``csrc/icp_solve.cu`` is one of the library's sources, defines the C
    entries ``load`` binds, and its launch count is zeroed with the rest."""
    names = [os.path.basename(p) for p in _kernels.SOURCES]
    assert names.count("icp_solve.cu") == 1
    src = open(os.path.join(os.path.dirname(_kernels.SOURCES[0]), "icp_solve.cu")).read()
    for entry in ("dc_icp_scratch", "dc_icp_gate", "dc_icp_solve"):
        assert "%s(" % entry in src
    assert "kStats = %d;" % _kernels.ICP_STATS in src
    monkeypatch.setattr(_kernels, "ICP_SOLVE_LAUNCHES", 7)
    _kernels.reset_launch_counts()
    assert _kernels.ICP_SOLVE_LAUNCHES == 0


@pytest.mark.parametrize("q", [0.37, 0.8])
@pytest.mark.parametrize("case", ["plain", "inf_rows", "all_masked", "one_row", "ties",
                                  "empty_mask"])
def test_device_quantile_equals_masked_quantile(case, q):
    """The study's step without X6 and without the host read
    (``scripts/exp_icp_solve.py``'s ``device_pick``) takes the same
    threshold as masked_quantile, bit for bit."""
    from depth_correction_tpu_torch.scripts.exp_icp_solve import device_quantile

    d2, ok = _distances(case, torch.float32)
    d = torch.sqrt(d2)
    assert _same(device_quantile(d, ok, q), masked_quantile(d, ok, q))


def test_step_variants_route_slam_odometry_and_restore():
    """Under ``step_variant`` slam_odometry steps by the plain twin
    (``twin``) or the twin with the device pick (``device_pick``), the
    same poses on the CPU, and both module attributes come back after."""
    from depth_correction_tpu_torch.scripts.exp_icp_solve import step_variant

    src, tgt, T = _box(torch.float32)
    prior = np.stack([np.eye(4), T.double().numpy()])
    update, quantile = slam_eval.icp_update, ticp.masked_quantile
    want = slam_eval.slam_odometry([tgt, src], prior, n_iters=3)
    for name in ("twin", "device_pick", "x6"):
        with step_variant(name):
            assert (slam_eval.icp_update is update) == (name == "x6")
            assert (ticp.masked_quantile is quantile) == (name != "device_pick")
            got = slam_eval.slam_odometry([tgt, src], prior, n_iters=3)
        np.testing.assert_array_equal(got, want)
    assert slam_eval.icp_update is update and ticp.masked_quantile is quantile
