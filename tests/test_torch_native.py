"""The port's native KD-tree (``utils/native.py`` over its copy of
``csrc/dc_native.cpp``) against scipy and the JAX package's native path.

Mirrors tests/test_native.py: kNN and radius queries against cKDTree,
``nn_backend = 'native'`` through ``preproc`` (the same sets as scipy's
and as the JAX package's native establishment), an empty tree; a failed
build raises, naming the compiler's error, with no fallback to scipy; and
the build is keyed by the host's machine type and tuned for no host CPU.
"""
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from depth_correction_tpu_torch.utils import native


def test_native_knn_matches_scipy():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 10, (800, 3))
    q = rng.uniform(0, 10, (200, 3))
    dist, idx = native.KDTree(pts).query(q, k=6)
    d_ref, _ = cKDTree(pts).query(q, k=6)
    np.testing.assert_allclose(dist, d_ref, atol=1e-12)
    got = np.linalg.norm(pts[idx] - q[:, None], axis=-1)
    np.testing.assert_allclose(np.sort(got, 1), np.sort(d_ref, 1), atol=1e-12)


def test_native_knn_radius_bound():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 5, (400, 3))
    q = rng.uniform(0, 5, (100, 3))
    dist, idx = native.KDTree(pts).query(q, k=4, distance_upper_bound=0.6)
    ref = cKDTree(pts)
    d_ref, i_ref = ref.query(q, k=4, distance_upper_bound=0.6)
    miss = i_ref == ref.n
    np.testing.assert_array_equal(idx < 0, miss)
    np.testing.assert_allclose(dist[~miss], d_ref[~miss], atol=1e-12)
    assert np.all(np.isinf(dist[miss]))


def test_native_radius_sets_match_scipy():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 4, (300, 3))
    balls = cKDTree(pts).query_ball_point(pts, 0.8)
    k_max = max(len(b) for b in balls)
    idx, counts = native.KDTree(pts).query_ball(pts, 0.8, k_max)
    np.testing.assert_array_equal(counts, [len(b) for b in balls])
    for row, ball in zip(idx, balls):
        assert set(int(i) for i in row if i >= 0) == set(ball)
    d0 = np.linalg.norm(pts[idx[0][idx[0] >= 0]] - pts[0], axis=1)
    assert np.all(np.diff(d0) >= -1e-12)


def test_native_empty_tree():
    t = native.KDTree(np.empty((0, 3)))
    d, i = t.query(np.zeros((4, 3)), k=3)
    assert (i < 0).all() and np.isinf(d).all()
    idx, cnt = t.query_ball(np.zeros((4, 3)), 0.5, 8)
    assert (idx < 0).all() and (cnt == 0).all()


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native module, building its library into a
    temporary file (so no other test's build is touched)."""
    from depth_correction_tpu.utils import native as jn

    monkeypatch.setattr(jn, "_LIB", str(tmp_path / "libdcnative.so"))
    monkeypatch.setattr(jn, "_lib", None)
    monkeypatch.setattr(jn, "_build_error", None)
    assert jn.available(), jn._build_error
    return jn


@pytest.mark.parametrize("nn", [{"nn_r": 0.5, "nn_k": 0}, {"nn_r": 0.5, "nn_k": 5},
                                {"nn_r": 0.6, "nn_k": 0, "nn_max_neighbors": 8}])
def test_native_backend_in_preproc(nn, jax_native):
    """establish_scan_neighbors and establish_neighborhoods with the native
    backend: the same sets row by row as the scipy backend and as the JAX
    package's native establishment, padding rows empty."""
    import jax.numpy as jnp

    from depth_correction_tpu.cloud import Cloud as JCloud
    from depth_correction_tpu.config import Config as JConfig
    from depth_correction_tpu.preproc import establish_scan_neighbors as j_est
    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.preproc import (establish_neighborhoods,
                                                    establish_scan_neighbors,
                                                    symmetrize_neighbors)

    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 3, (300, 3))
    cloud = Cloud.from_points(pts, dtype=torch.float64, pad_to=320).with_points()
    cfg = Config()
    cfg.device = "cpu"
    for k, v in nn.items():
        setattr(cfg, k, v)
    cfg.nn_backend = "native"
    idx_n, w_n = establish_scan_neighbors(cloud, cfg)
    idx_g, _ = establish_neighborhoods(cloud, cfg)
    cfg.nn_backend = "scipy"
    idx_s, _ = establish_scan_neighbors(cloud, cfg)
    jcfg = JConfig()
    for k, v in nn.items():
        setattr(jcfg, k, v)
    jcfg.nn_backend = "native"
    jcloud = JCloud.from_points(jnp.asarray(pts)).pad(320).with_points()
    idx_j, _ = j_est(jcloud, jcfg)
    assert w_n.dtype == torch.float64 and torch.equal(w_n > 0, idx_n >= 0)
    capped = nn.get("nn_max_neighbors")
    # A capped radius graph keeps its mutual pairs in establishment.
    np.testing.assert_array_equal(
        (symmetrize_neighbors(idx_n) if capped and not cfg.nn_k else idx_n).numpy(),
        idx_g.numpy())
    np.testing.assert_array_equal(idx_n.numpy(), np.asarray(idx_j))
    for i, (a, b) in enumerate(zip(idx_n.numpy(), idx_s.numpy())):
        if i >= 300:
            assert (a < 0).all()
        elif not capped:
            assert set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
        else:
            # The capped rows keep the nearest, as scipy's backend does.
            d = np.linalg.norm(pts[a[a >= 0]] - pts[i], axis=1)
            ds = np.linalg.norm(pts[b[b >= 0]] - pts[i], axis=1)
            np.testing.assert_allclose(np.sort(d), np.sort(ds), atol=1e-12)


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    """A source that does not compile, or a missing compiler, raises
    NativeBuildError naming the error; prep with nn_backend 'native' raises
    too instead of taking scipy."""
    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.preproc import establish_scan_neighbors

    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="native build failed.*broken.cpp"):
        native.load()
    assert not os.listdir(tmp_path / "build")
    cfg = Config()
    cfg.device = "cpu"
    cfg.nn_r, cfg.nn_k, cfg.nn_backend = 0.5, 0, "native"
    cloud = Cloud.from_points(np.random.default_rng(0).uniform(0, 1, (64, 3))).with_points()
    with pytest.raises(native.NativeBuildError):
        establish_scan_neighbors(cloud, cfg)
    monkeypatch.setattr(native, "COMPILER", "no-such-compiler-dc")
    with pytest.raises(native.NativeBuildError, match="no-such-compiler-dc"):
        native.load()


def test_build_is_keyed_and_reused():
    """The library sits in the package's _build/ under a name keyed by the
    source and flags, and a second build reuses it."""
    native.load()
    path = native.library_path()
    assert os.path.exists(path) and os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert native.build() == path and native.BUILD_SECONDS == 0.0


def test_build_key_names_the_machine_and_no_host_cpu(monkeypatch):
    """A build directory copied to another kind of host is not reused: the
    key changes with the machine type. The flags tune for no host CPU, so a
    library built on one x86-64 host runs on another."""
    import platform

    key = native.library_path()
    monkeypatch.setattr(platform, "machine", lambda: "another-machine")
    assert native.library_path() != key
    assert not any(f.startswith(("-march", "-mtune", "-mcpu")) for f in native.FLAGS)
