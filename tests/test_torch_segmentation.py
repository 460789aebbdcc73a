"""The port's plane neighbourhoods against the JAX package's, on the CPU.

- ``ops/prng.randint`` bit for bit against ``jax.random.randint`` at 32
  bits (x64 off, as a float32 run) and 64 bits (x64 on, as conftest sets
  it), and the key API (``PRNGKey``, ``split``);
- RANSAC: the hypotheses' triples, the plane and its support, the
  "no plane" branch, ``cluster_voxel_graph``'s labels and ``fit_planes``
  on seeded noisy ground-plane and open-box scans (5 mm, as
  tests/test_torch_node.py adds);
- plane mode in float64: prep gives the same planes; the loss, its w
  gradient and its pose-delta gradient within rtol 1e-9 and six Adam steps
  within 1e-8 (on the JAX side's planes, see :func:`_jax_planes`);
  ``eval_loss``'s CSV row; the losses take a ``Planes``; the prep cache.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu import eval as jeval
from depth_correction_tpu import segmentation as jseg
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.datasets import create_dataset as j_create_dataset
from depth_correction_tpu.models import load_model as j_load_model
from depth_correction_tpu.train import _grad_mask
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import make_optimizer as j_make_optimizer
from depth_correction_tpu.train import prepare_sequences as j_prepare_sequences
from depth_correction_tpu_torch import eval as teval
from depth_correction_tpu_torch import segmentation as tseg
from depth_correction_tpu_torch.cloud import Cloud as TCloud
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import GroundPlaneDataset, OpenBoxDataset
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.loss import min_eigval_loss, trace_loss
from depth_correction_tpu_torch.models import load_model as t_load_model
from depth_correction_tpu_torch.ops import prng
from depth_correction_tpu_torch.preproc import global_cloud
from depth_correction_tpu_torch.train import TrainCallbacks, check_slice
from depth_correction_tpu_torch.train import fit as t_fit
from depth_correction_tpu_torch.train import make_loss_fn as t_make_loss_fn
from depth_correction_tpu_torch.train import prepare_sequences as t_prepare_sequences

SEQ = "open_box/n_2_size_6_6_3_height_1_density_40"
STEPS = 6


# ---------------------------------------------------------------- randint

@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("shape", [(500, 3), (1, 3)])
@pytest.mark.parametrize("maxval", [1, 7, 65_539, 390_144])
def test_randint_matches_jax(bits, shape, maxval):
    """randint is jax.random.randint bit for bit, in JAX's dtype of each
    width (x64 switched off only inside the 32-bit case)."""
    for seed in (135, 140):
        if bits == 64:
            ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, maxval))
        else:
            with jax.enable_x64(False):
                ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, maxval))
        got = prng.randint(prng.PRNGKey(seed), shape, 0, maxval, bits)
        assert got.dtype == ref.dtype == (np.int32 if bits == 32 else np.int64)
        np.testing.assert_array_equal(got, ref)
    assert jax.config.jax_enable_x64


def test_key_api_matches_jax():
    """PRNGKey, split and random_bits (a key or an integer seed) against
    JAX's."""
    for seed in (0, 135, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        assert prng.PRNGKey(seed) == tuple(int(v) for v in np.asarray(key))
        for num in (2, 3):
            assert prng.split(seed, num) == [tuple(int(v) for v in k)
                                             for k in np.asarray(jax.random.split(key, num))]
        sub = prng.split(seed)[1]
        ref = np.asarray(jax.random.bits(jax.random.split(key)[1], (4, 5), jnp.uint64))
        np.testing.assert_array_equal(prng.random_bits(sub, (4, 5), 64), ref)
        np.testing.assert_array_equal(prng.random_bits(seed, 7, 32),
                                      np.asarray(jax.random.bits(key, (7,), jnp.uint32)))


def test_argmax_returns_first_maximum():
    """RANSAC's winner is the first of equal counts in both packages:
    torch.argmax returns the first maximum, as jnp.argmax does."""
    counts = [3, 9, -1, 9, 9, 2]
    assert int(torch.argmax(torch.tensor(counts))) == int(jnp.argmax(jnp.asarray(counts))) == 1


# ----------------------------------------------------------------- RANSAC

def _noisy_scan(name, seed=7):
    ds = OpenBoxDataset(name=name) if name.startswith("open_box") else GroundPlaneDataset(name=name)
    scan = ds.local_cloud(0)
    rng = np.random.default_rng(seed)
    for f in "xyz":
        scan[f] += 0.005 * rng.standard_normal(len(scan))
    return scan


SCANS = {"ground_plane": "ground_plane/2", "open_box": "open_box/n_2_size_6_6_3_height_1_density_40"}


def _points32(name):
    from numpy.lib.recfunctions import structured_to_unstructured

    scan = _noisy_scan(SCANS[name])
    return structured_to_unstructured(scan[["x", "y", "z"]]).astype(np.float32)


@pytest.mark.parametrize("bits", [32, 64])
def test_ransac_matches_jax(bits):
    """The triples equal JAX's draws; the plane and its support equal the
    JAX package's on the same float32 points with a fifth of them invalid."""
    pts = _points32("open_box")
    valid = np.random.default_rng(1).random(len(pts)) > 0.2
    idx = tseg.ransac_indices(len(pts), 500, 135, bits)
    ctx = jax.enable_x64(bits == 64)
    with ctx:
        ref_idx = np.asarray(jax.random.randint(jax.random.PRNGKey(135), (500, 3), 0, len(pts)))
        jplane, jsupport = jseg.fit_plane_ransac(pts, valid=jnp.asarray(valid),
                                                 distance_threshold=0.03, max_iterations=500,
                                                 seed=135)
    np.testing.assert_array_equal(idx, ref_idx)
    tplane, tsupport = tseg.fit_plane_ransac(pts, valid=valid, distance_threshold=0.03,
                                             max_iterations=500, seed=135, bits=bits)
    assert tplane.dtype == np.float32
    # XLA's compiled normal may round an ulp apart from torch's.
    np.testing.assert_allclose(tplane, np.asarray(jplane), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tsupport, jsupport)
    assert len(tsupport) > 100 and valid[tsupport].all()


def test_ransac_block_changes_no_result():
    """Scoring the hypotheses in blocks of any size gives the same plane,
    mask and count."""
    pts = torch.as_tensor(_points32("open_box"))
    valid = torch.ones(len(pts), dtype=torch.bool)
    idx = torch.as_tensor(tseg.ransac_indices(len(pts), 500, 3, 64))
    ref = tseg._ransac_score(pts, valid, idx, 0.03, block=len(pts) * 500)
    for block in (1, len(pts) * 7, len(pts) * 128):
        got = tseg._ransac_score(pts, valid, idx, 0.03, block=block)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert int(got[2]) == int(ref[2])


def test_ransac_without_usable_triple_finds_no_plane():
    """Two valid points: every triple is invalid, so both packages report
    no support (JAX package, segmentation.py:76-82)."""
    pts = _points32("ground_plane")[:400]
    valid = np.zeros(len(pts), bool)
    valid[[3, 7]] = True
    _, jsupport = jseg.fit_plane_ransac(pts, valid=jnp.asarray(valid), max_iterations=50)
    _, tsupport = tseg.fit_plane_ransac(pts, valid=valid, max_iterations=50, bits=64)
    assert len(jsupport) == len(tsupport) == 0


def test_cluster_voxel_graph_matches_jax():
    """Labels of three blobs (one below min_points) equal the JAX
    package's."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(0, 0.2, (200, 3)), rng.normal(5, 0.2, (150, 3)),
                          rng.normal(-5, 0.05, (4, 3))]).astype(np.float32)
    got = tseg.cluster_voxel_graph(pts, 0.35, min_points=10)
    np.testing.assert_array_equal(got, jseg.cluster_voxel_graph(pts, 0.35, min_points=10))
    a, b = set(got[:200]), set(got[200:350])
    assert len(a) == len(b) == 1 and a != b and min(a | b) >= 0 and set(got[350:]) == {-1}


@pytest.mark.parametrize("name", sorted(SCANS))
def test_fit_planes_matches_jax(name):
    """fit_planes on a noisy scan: the same planes (params within float32
    ulps, members equal, padded to a multiple of 8) and the same oriented
    normals."""
    pts = _points32(name).astype(np.float64)
    kw = dict(min_support=5, max_iterations=500, max_models=10, eps=2 * np.sqrt(3) * 0.1,
              seed=135)
    jp = jseg.fit_planes(pts, 0.03, **kw)
    tp = tseg.fit_planes(pts, 0.03, **kw)
    assert len(tp) == len(jp) >= (1 if name == "ground_plane" else 3)
    np.testing.assert_allclose(tp.params.numpy(), np.asarray(jp.params), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tp.member_idx.numpy(), np.asarray(jp.member_idx))
    assert tp.member_idx.dtype == torch.int32 and tp.member_idx.shape[1] % 8 == 0
    np.testing.assert_array_equal(tp.member_weights.numpy(), np.asarray(jp.member_weights))
    vps = np.zeros((10, 3))
    vps[:, 2] = 1.0 + np.arange(10)
    np.testing.assert_array_equal(np.sign(tp.orient(torch.as_tensor(vps)).params.numpy()),
                                  np.sign(np.asarray(jp.orient(jnp.asarray(vps)).params)))
    # Plane features of the member points against the JAX package's.
    tf = tseg.compute_plane_features(tp, torch.as_tensor(pts))
    jf = jseg.compute_plane_features(jp, jnp.asarray(pts))
    np.testing.assert_allclose(tf.cov.numpy(), np.asarray(jf.cov), rtol=1e-10, atol=1e-16)
    np.testing.assert_allclose(tf.eigvals.numpy(), np.asarray(jf.eigvals), rtol=1e-9, atol=1e-15)


# ------------------------------------------------------------ plane mode

def _cfg(cls, **kw):
    """Plane mode on a small noisy open box (5 mm depth noise, no depth
    bias: the wrappers then give both packages the same scans), float64."""
    cfg = cls()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.train_names = [SEQ]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.1
    cfg.nn_type = "plane"
    cfg.depth_noise = 0.005
    cfg.model_kwargs = {"w": [-1e-3], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.lr = 5e-4
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _jax_planes(jplanes):
    """The JAX side's planes as the port's. The two packages' float64
    global clouds differ in the last bits (their pose products), so a
    point's float32 cast may differ by an ulp and move a plane's params by
    ~5e-10; the loss tests take the JAX side's planes so that they hold the
    features and the loss alone (the planes are held in
    :func:`test_plane_prep_matches_jax`)."""
    return tseg.Planes(**{f: torch.as_tensor(np.array(getattr(jplanes, f)))
                          for f in ("params", "member_idx", "member_weights", "valid")})


@pytest.fixture(scope="module")
def prepared():
    jcfg, tcfg = _cfg(JConfig), _cfg(TConfig)
    jdata = j_prepare_sequences([j_create_dataset(SEQ, jcfg)], jcfg)
    tdata = t_prepare_sequences([t_create_dataset(SEQ, tcfg)], tcfg)
    shared = dataclasses.replace(
        tdata, neighbors=tuple(_jax_planes(p) for p in jdata.neighbors))
    return jdata, tdata, shared


def test_check_slice_accepts_planes_and_native():
    check_slice(_cfg(TConfig))
    check_slice(_cfg(TConfig, nn_type="ball", nn_backend="native"))


def test_plane_prep_matches_jax(prepared):
    """The raw padded scans, the planes (members equal, params within an
    f32 ulp of the float64 clouds' last bits) and the masks."""
    jdata, tdata, _ = prepared
    jb, tb = jdata.batches[0], tdata.batches[0]
    np.testing.assert_allclose(tb.cloud.depth.numpy(), np.asarray(jb.cloud.depth), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(tb.cloud.valid.numpy(), np.asarray(jb.cloud.valid))
    assert tdata.cellwin == (None,) and tdata.weights == (None,)
    jp, tp = jdata.neighbors[0], tdata.neighbors[0]
    assert isinstance(tp, tseg.Planes) and len(tp) == len(jp) >= 3
    np.testing.assert_array_equal(tp.member_idx.numpy(), np.asarray(jp.member_idx))
    np.testing.assert_allclose(tp.params.numpy(), np.asarray(jp.params), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tdata.masks[0].numpy(), np.asarray(jdata.masks[0]))


def _jax_value_grad(jdata, mode, deltas, w):
    jcfg = _cfg(JConfig, pose_correction=mode, model_kwargs={"w": [w], "exponent": [4.0]})
    params = {"model": j_load_model(cfg=jcfg)}
    if deltas is not None:
        params["pose_deltas"] = tuple(jnp.asarray(d) for d in deltas)
    value, grads = jax.jit(jax.value_and_grad(j_make_loss_fn(jcfg)))(params, jdata)
    return float(value), grads


@pytest.mark.parametrize("mode", ["none", "sequence", "pose"])
def test_plane_loss_and_gradients_match_jax(prepared, mode):
    """The loss, its w gradient and its pose-delta gradient (nonzero deltas
    of a few mm and mrad) within rtol 1e-9 of the JAX package's, at w 0
    and -1e-3."""
    jdata, _, shared = prepared
    rng = np.random.default_rng(0)
    n = shared.batches[0].num_scans
    deltas = None if mode == "none" else [1e-3 * rng.standard_normal(
        (1 if mode == "sequence" else n, 6))]
    for w in (0.0, -1e-3):
        jv, jg = _jax_value_grad(jdata, mode, deltas, w)
        tcfg = _cfg(TConfig, pose_correction=mode, model_kwargs={"w": [w], "exponent": [4.0]})
        model = t_load_model(cfg=tcfg)
        leaves = None if deltas is None else tuple(torch.tensor(d, requires_grad=True)
                                                   for d in deltas)
        value = t_make_loss_fn(tcfg)(model, shared, leaves)
        value.backward()
        np.testing.assert_allclose(float(value.detach()), jv, rtol=1e-9)
        np.testing.assert_allclose(model.w.grad.numpy(), np.asarray(jg["model"].w), rtol=1e-9)
        for a, b in zip(leaves or (), jg.get("pose_deltas", ())):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-9, atol=1e-15)


def test_plane_adam_trajectory_matches_jax(prepared):
    """Six Adam steps of w in plane mode within 1e-8 of the JAX package's
    step (its optimizer and gradient mask)."""
    jdata, _, shared = prepared
    jcfg = _cfg(JConfig)
    grad_fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jcfg)))
    params = {"model": j_load_model(cfg=jcfg)}
    tx, gmask = j_make_optimizer(jcfg), _grad_mask(params, jcfg)
    state = tx.init(params)
    jtraj = []
    for _ in range(STEPS):
        _, grads = grad_fn(params, jdata)
        grads = jax.tree_util.tree_map(lambda g, m: g * m, grads, gmask)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        jtraj.append(np.asarray(params["model"].w))

    class Record(TrainCallbacks):
        w = []

        def train_loss(self, it, model, pose_deltas, loss):
            self.w.append(model.w.detach().numpy().copy())

    tcfg = _cfg(TConfig, n_opt_iters=STEPS + 1)
    rec = Record(tcfg)
    t_fit(tcfg, shared, callbacks=rec)
    assert len(rec.w) == STEPS + 1
    np.testing.assert_allclose(np.stack(rec.w[1:]), np.stack(jtraj), rtol=1e-8)
    assert abs(rec.w[-1][0] - rec.w[0][0]) > 1e-6


def test_plane_eval_loss_row_matches_jax(tmp_path):
    """eval_loss in plane mode writes the JAX package's CSV row (each
    package on its own planes)."""
    rows = {}
    for pkg, cls, ev in (("jax", JConfig, jeval), ("port", TConfig, teval)):
        csv = tmp_path / ("%s.csv" % pkg)
        cfg = _cfg(cls, test_names=[SEQ], loss_eval_csv=str(csv))
        ev.eval_loss(cfg)
        rows[pkg] = csv.read_text().split()
    assert rows["port"][0] == rows["jax"][0] == SEQ
    np.testing.assert_allclose(float(rows["port"][1]), float(rows["jax"][1]), rtol=1e-9)


def test_losses_take_planes(prepared):
    """min_eigval_loss and trace_loss over a Planes (cov and eigvals, no
    trace field): the mean of each plane's smallest eigenvalue and of its
    covariance trace over the valid planes."""
    _, _, shared = prepared
    tcfg = _cfg(TConfig)
    gcloud = global_cloud(shared.batches[0])
    feat = tseg.plane_neighborhood_features(gcloud, shared.neighbors[0], t_load_model(cfg=tcfg))
    value, out = min_eigval_loss(feat, mask=feat.valid)
    np.testing.assert_allclose(float(value.detach()), float(feat.eigvals[:, 0].detach().mean()),
                               rtol=1e-12)
    assert isinstance(out, tseg.Planes) and out.loss.shape == (len(feat),)
    value, _ = trace_loss(feat)
    trace = feat.cov.diagonal(dim1=-2, dim2=-1).sum(-1)
    np.testing.assert_allclose(float(value), float(trace.mean()), rtol=1e-12)


def test_plane_prep_cache_round_trip(tmp_path):
    """The prep cache keeps plane mode's record: a second prep reloads the
    planes bit for bit."""
    tcfg = _cfg(TConfig, prep_cache_dir=str(tmp_path / "cache"))
    first = t_prepare_sequences([t_create_dataset(SEQ, tcfg)], tcfg)
    second = t_prepare_sequences([t_create_dataset(SEQ, tcfg)], tcfg)
    assert "cache_load" in second.prep_seconds and "planes" not in second.prep_seconds
    a, b = first.neighbors[0], second.neighbors[0]
    assert isinstance(b, tseg.Planes)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None and y is None) or (x.dtype == y.dtype and torch.equal(x, y))


def test_plane_cloud_from_cloud_uses_its_device_and_bits():
    """fit_planes on a float64 Cloud draws 64-bit triples, as on float64
    points, and returns its planes on the cloud's device."""
    pts = _points32("ground_plane").astype(np.float64)
    cloud = TCloud.from_points(pts, dtype=torch.float64)
    got = tseg.fit_planes(cloud, 0.03, min_support=5, max_iterations=200, max_models=2)
    ref = tseg.fit_planes(pts, 0.03, min_support=5, max_iterations=200, max_models=2)
    assert torch.equal(got.params, ref.params) and torch.equal(got.member_idx, ref.member_idx)
    assert got.params.device.type == "cpu"
