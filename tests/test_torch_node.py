"""The port's online corrector (``node.py``) against the JAX package's, on
the CPU in float64: ``correct_cloud`` on the three engines,
``DepthCorrector`` and the engines against each other. Scans are small synthetic ones with
seeded sensor noise (exact planes would leave the planar mask to the sign
of rounding)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depth_correction_tpu.cloud import Cloud as JCloud
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.datasets.synthetic import GroundPlaneDataset, OpenBoxDataset
from depth_correction_tpu.models import ScaledPolynomial as JScaledPolynomial
from depth_correction_tpu.node import DepthCorrector as JDepthCorrector
from depth_correction_tpu.node import correct_cloud as j_correct_cloud
from depth_correction_tpu.preproc import pad_size
from depth_correction_tpu_torch.cloud import Cloud as TCloud
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.node import CloudFilter, DepthCorrector, correct_cloud
from depth_correction_tpu_torch.utils.params import params_from_jax

SCANS = {
    # name -> (scan source, config)
    "open_box": ("open_box/n_6_size_10_10_5_height_1_density_20", "bench"),
    "ground_plane": ("ground_plane/4", "small"),
}


def _cfg(cls, kind):
    cfg = cls()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    if kind == "bench":  # bench.py:bench_config(True), the node's bench workload
        cfg.min_depth, cfg.max_depth, cfg.grid_res = 1.0, 25.0, 0.1
        cfg.nn_r = 0.25
        cfg.min_valid_neighbors = 5
        cfg.eigenvalue_ratio_bounds = [[0, 1, 0, 0.25], [1, 2, 0.25, 1.0]]
    else:  # tests/test_eval_node_cli.py:small_cfg
        cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
        cfg.nn_r = 0.4
        cfg.min_valid_neighbors = 3
        cfg.eigenvalue_ratio_bounds = []
    cfg.vp_dispersion_bounds = []
    cfg.nn_max_neighbors = None
    cfg.model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    return cfg


def _scan(name):
    src = SCANS[name][0]
    ds = OpenBoxDataset(name=src) if src.startswith("open_box") else GroundPlaneDataset(name=src)
    scan = ds.local_cloud(0)
    rng = np.random.default_rng(7)
    for f in "xyz":
        scan[f] += 0.005 * rng.standard_normal(len(scan))
    return scan


def _models():
    jm = JScaledPolynomial(w=jnp.asarray([-0.002]), exponent=jnp.asarray([4.0]))
    return jm, params_from_jax(jax.tree_util.tree_map(np.asarray, jm))


def _clouds(scan):
    jc = JCloud.from_structured_array(scan, dtype=jnp.float64)
    tc = TCloud.from_structured_array(scan, dtype=torch.float64)
    return jc.pad(pad_size(jc.size)), tc.pad(pad_size(tc.size))


@pytest.fixture(scope="module", params=sorted(SCANS))
def scene(request):
    return request.param, _scan(request.param)


@pytest.mark.parametrize("backend", ["brute", "slab", "grid"])
def test_correct_cloud_matches_jax(scene, backend):
    name, scan = scene
    jm, tm = _models()
    jc, tc = _clouds(scan)
    jcfg, tcfg = _cfg(JConfig, SCANS[name][1]), _cfg(TConfig, SCANS[name][1])
    jcfg.nn_backend = tcfg.nn_backend = backend
    ref = [np.asarray(x) for x in j_correct_cloud(jm, jc, jcfg)]
    got = [x.numpy() for x in correct_cloud(tm, tc, tcfg)]
    valid, mask = ref[4], ref[3]
    np.testing.assert_array_equal(got[4], valid)
    np.testing.assert_array_equal(got[3], mask)
    assert valid.sum() > 300 and mask.sum() > 100
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[2][mask], ref[2][mask], rtol=0, atol=1e-6)


def test_depth_corrector_matches_jax(scene):
    name, scan = scene
    jm, tm = _models()
    kind = SCANS[name][1]
    ref = JDepthCorrector(_cfg(JConfig, kind), model=jm).process(scan)
    got = DepthCorrector(_cfg(TConfig, kind), model=tm).process(scan)
    assert got.dtype == ref.dtype and len(got) == len(ref) > 300
    # Float32 fields cast from float64 values that agree to ~1e-12: equal up
    # to one float32 ulp where the two values straddle a rounding boundary.
    # Normals are compared on corrected rows: below min_valid_neighbors a
    # covariance is degenerate and its eigenvector arbitrary.
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    for f in "xyz":
        np.testing.assert_array_max_ulp(got[f], ref[f], maxulp=1)
    m = ref["mask"] > 0
    for f in ("normal_x", "normal_y", "normal_z"):
        np.testing.assert_allclose(got[f][m], ref[f][m], rtol=0, atol=1e-6, err_msg=f)
    # Stale scans are dropped by age gating; the default model is cfg's.
    aged = DepthCorrector(_cfg(TConfig, kind), max_age=0.001)
    assert aged.process(scan, stamp=0.0) is None
    assert float(aged.model.w.detach()[0]) == -0.002


def test_slab_matches_brute(scene):
    """The slab engine is uncapped; with k above the largest within-r count
    the brute engine finds the same sets (tests/test_eval_node_cli.py:
    106-129)."""
    name, scan = scene
    _, tm = _models()
    _, tc = _clouds(scan)
    cfg = _cfg(TConfig, SCANS[name][1])
    cfg.nn_backend = "brute"
    ref = correct_cloud(tm, tc, cfg, k=128)
    cfg.nn_backend = "slab"
    got = correct_cloud(tm, tc, cfg)
    np.testing.assert_array_equal(got[4].numpy(), ref[4].numpy())
    np.testing.assert_array_equal(got[3].numpy(), ref[3].numpy())
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=1e-9, atol=1e-12)
    m = ref[3].numpy()
    np.testing.assert_allclose(got[2].numpy()[m], ref[2].numpy()[m], rtol=0, atol=1e-6)


def test_routing_and_grid_engine():
    """'grid' runs the K-capped gather-window engine (the brute engine's
    sets at the same k, plain twins and wrappers alike on the CPU); None
    routes by padded size."""
    _, tm = _models()
    scan = _scan("ground_plane")
    _, tc = _clouds(scan)
    cfg = _cfg(TConfig, "small")
    cfg.nn_backend = "grid"
    grid = correct_cloud(tm, tc, cfg, k=8)
    assert torch.equal(grid[3], correct_cloud(tm, tc, cfg, k=8, plain=True)[3])
    cfg.nn_backend = "brute"
    brute = correct_cloud(tm, tc, cfg, k=8)
    np.testing.assert_array_equal(grid[3].numpy(), brute[3].numpy())
    np.testing.assert_allclose(grid[0].numpy(), brute[0].numpy(), rtol=1e-12, atol=1e-12)
    # Below GRID_NN_MIN_POINTS the default engine is brute, capped at k.
    cfg.nn_backend = None
    capped = correct_cloud(tm, tc, cfg, k=2)
    assert not capped[3].any()  # 2 neighbours never reach min_valid 3
    # CloudFilter keeps the host-filtered points of the training prep.
    out = CloudFilter(cfg).process(scan)
    assert set(out.dtype.names) >= {"x", "y", "z", "normal_x"} and 0 < len(out) < len(scan)
