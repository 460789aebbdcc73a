"""The port's ICP losses, ICP training and ICP evaluation against the JAX
package's, float64 on the CPU.

The frozen correspondences (scipy's cKDTree on the host) bit for bit,
including a pair with an empty scan; the batched pair loss, point-to-plane
and point-to-point, value and gradient in the points; the unmasked pair
distances over the 1-NN search (the port's plain twin of kernel X3 against
the JAX package's brute search); the training loss of ``icp_loss`` on
ground_plane/4 (value and gradients in w and in sequence deltas), three
Adam steps of fit() against optax's; eval_icp's value and CSV line, and
eval_loss_all with icp_loss among the losses.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu import loss as jloss
from depth_correction_tpu import models as jmodels
from depth_correction_tpu.cloud import Cloud as JCloud
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.datasets import create_dataset as j_create_dataset
from depth_correction_tpu.eval import eval_icp as j_eval_icp
from depth_correction_tpu.eval import eval_loss_all as j_eval_loss_all
from depth_correction_tpu.ops import knn as jknn
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import prepare_sequences as j_prepare_sequences
from depth_correction_tpu_torch import loss as tloss
from depth_correction_tpu_torch import models as tmodels
from depth_correction_tpu_torch.cloud import Cloud as TCloud
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.eval import eval_icp as t_eval_icp
from depth_correction_tpu_torch.eval import eval_loss_all as t_eval_loss_all
from depth_correction_tpu_torch.train import TrainCallbacks
from depth_correction_tpu_torch.train import fit as t_fit
from depth_correction_tpu_torch.train import make_loss_fn as t_make_loss_fn
from depth_correction_tpu_torch.train import prepare_sequences as t_prepare_sequences

SEQ = "ground_plane/4"
STEPS = 3


@pytest.fixture(autouse=True)
def _small_jax_chunks(monkeypatch):
    """The JAX brute search pads queries to 8192-row chunks; results do not
    depend on the chunk (tests/test_torch_knn.py)."""
    monkeypatch.setattr(jknn, "_QUERY_CHUNK", 1024)


def _cfg(cls, **kw):
    """tests/test_icp_train.py's configuration, scipy establishment."""
    cfg = cls()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.train_names = [SEQ]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.2
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.nn_backend = "scipy"
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [-0.004], "exponent": [4.0]}
    cfg.loss = "icp_loss"
    cfg.loss_kwargs = {"icp_point_to_plane": True, "icp_inlier_ratio": 0.5}
    cfg.lr = 5e-4
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def prepared():
    jcfg, tcfg = _cfg(JConfig), _cfg(TConfig)
    jdata = j_prepare_sequences([j_create_dataset(SEQ, jcfg)], jcfg)
    tdata = t_prepare_sequences([t_create_dataset(SEQ, tcfg)], tcfg)
    return jdata, tdata


def _scans(seed, s=3, n=400, empty=None):
    """(S, N, 3) points of a noisy tilted plane seen from three poses'
    worth of jitter, and (S, N) validity with padding (and with scan
    ``empty`` fully invalid)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2.0, 2.0, (s, n, 2))
    z = 0.3 * xy[..., 0] + 0.01 * rng.standard_normal((s, n))
    pts = np.concatenate([xy, z[..., None]], -1) + 0.02 * rng.standard_normal((s, 1, 3))
    valid = rng.uniform(size=(s, n)) < 0.9
    if empty is not None:
        valid[empty] = False
    return pts, valid


@pytest.mark.parametrize("empty", [None, 0, 2], ids=["all", "first_empty", "last_empty"])
def test_pair_correspondences_bit_equal(empty):
    """Equal index and weight tables; the pair with an empty scan has no
    inliers."""
    pts, valid = _scans(1, empty=empty)
    ji, jw = jloss.icp_pair_correspondences(pts, valid, 0.4)
    ti, tw = tloss.icp_pair_correspondences(pts, valid, 0.4)
    assert ti.dtype == ji.dtype and tw.dtype == jw.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    for i in range(len(tw)):
        assert tw[i].any() != (empty in (i, i + 1))


@pytest.mark.parametrize("p2plane", [True, False], ids=["point_to_plane", "point_to_point"])
def test_pair_loss_batched_matches_jax(p2plane):
    """Value and gradient in the points and normals, rtol 1e-9."""
    pts, valid = _scans(2)
    rng = np.random.default_rng(3)
    normals = rng.standard_normal(pts.shape)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    idx, w = jloss.icp_pair_correspondences(pts, valid, 0.5)

    def jfun(p, nrm):
        return jloss.icp_pair_loss_batched(p, nrm, jnp.asarray(idx), jnp.asarray(w),
                                           point_to_plane=p2plane)

    jv, (jgp, jgn) = jax.value_and_grad(jfun, argnums=(0, 1))(jnp.asarray(pts),
                                                                 jnp.asarray(normals))
    tp = torch.tensor(pts, requires_grad=True)
    tn = torch.tensor(normals, requires_grad=True)
    tv = tloss.icp_pair_loss_batched(tp, tn, torch.as_tensor(idx), torch.as_tensor(w),
                                     point_to_plane=p2plane)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-9)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp), rtol=1e-9, atol=1e-18)
    if p2plane:
        np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jgn), rtol=1e-9, atol=1e-18)


@pytest.mark.parametrize("p2plane", [True, False], ids=["point_to_plane", "point_to_point"])
def test_pair_dist_unmasked_matches_jax(p2plane):
    """The pair distances with 1-NN correspondences found per call: the
    port's plain search against the JAX package's brute search, the same
    correspondences and the value within rtol 1e-9."""
    pts, valid = _scans(4, n=300)
    rng = np.random.default_rng(5)
    normals = rng.standard_normal(pts.shape)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    jclouds = [JCloud.from_points(p, normals=nrm, valid=v)
               for p, nrm, v in zip(pts, normals, valid)]
    tclouds = [TCloud.from_points(p, normals=nrm, valid=torch.as_tensor(v),
                                  dtype=torch.float64)
               for p, nrm, v in zip(pts, normals, valid)]
    jfun = jloss.point_to_plane_dist if p2plane else jloss.point_to_point_dist
    tfun = tloss.point_to_plane_dist if p2plane else tloss.point_to_point_dist
    jv = jfun([c.with_points() for c in jclouds], icp_inlier_ratio=0.3)
    tv = tfun([c.with_points() for c in tclouds], icp_inlier_ratio=0.3)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-9)
    ji, jw = jloss._pair_correspondence(jnp.asarray(pts[0]), jnp.asarray(valid[0]),
                                        jnp.asarray(pts[1]), jnp.asarray(valid[1]), 0.3)
    ti, tw = tloss._pair_correspondence(torch.as_tensor(pts[0]), torch.as_tensor(valid[0]),
                                        torch.as_tensor(pts[1]), torch.as_tensor(valid[1]), 0.3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_icp_prep_matches_jax(prepared):
    """The frozen correspondences equal, the scans' normals kept and equal
    within 1e-9, no global graph."""
    jdata, tdata = prepared
    np.testing.assert_array_equal(tdata.icp_idx[0].numpy(), np.asarray(jdata.icp_idx[0]))
    np.testing.assert_array_equal(tdata.icp_w[0].numpy(), np.asarray(jdata.icp_w[0]))
    np.testing.assert_allclose(tdata.batches[0].cloud.normals.numpy(),
                               np.asarray(jdata.batches[0].cloud.normals), atol=1e-9)
    assert tdata.neighbors == (None,) and tdata.cellwin == (None,)
    assert 0 < int(tdata.icp_w[0].sum()) < int(tdata.batches[0].cloud.valid[:-1].sum())


def _jax_params(w, delta=None):
    params = {"model": jmodels.ScaledPolynomial(w=jnp.asarray([w]),
                                                exponent=jnp.asarray([4.0]))}
    if delta is not None:
        params["pose_deltas"] = (jnp.asarray(delta),)
    return params


@pytest.mark.parametrize("mode", ["none", "sequence"])
def test_icp_loss_fn_matches_jax(prepared, mode):
    """make_loss_fn for icp_loss: the value and the gradients in w and in
    a nonzero sequence delta, rtol 1e-9."""
    jdata, tdata = prepared
    delta = (None if mode == "none"
             else 1e-3 * np.random.default_rng(6).standard_normal((1, 6)))
    jcfg, tcfg = _cfg(JConfig, pose_correction=mode), _cfg(TConfig, pose_correction=mode)
    jv, jg = jax.value_and_grad(j_make_loss_fn(jcfg))(_jax_params(-1e-3, delta), jdata)
    model = tmodels.ScaledPolynomial(w=[-1e-3], exponent=[4.0], dtype=torch.float64)
    leaves = None if delta is None else (torch.tensor(delta, requires_grad=True),)
    tv = t_make_loss_fn(tcfg)(model, tdata, leaves)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-9)
    np.testing.assert_allclose(model.w.grad.numpy(), np.asarray(jg["model"].w), rtol=1e-9)
    if leaves is not None:
        # A sequence delta moves every scan alike, so its translation
        # gradient is zero up to rounding: held to 1e-9 of the largest.
        jgd = np.asarray(jg["pose_deltas"][0])
        np.testing.assert_allclose(leaves[0].grad.numpy(), jgd, rtol=1e-9,
                                   atol=1e-9 * np.abs(jgd).max())
        assert np.abs(jgd[0, 3:]).min() > 1e6 * np.abs(jgd[0, :3]).max()


def test_icp_adam_steps_match_optax(prepared):
    """fit() with icp_loss: three Adam steps' losses and w within 1e-8 of
    optax.adam on the JAX package's loss."""
    jdata, tdata = prepared
    jcfg = _cfg(JConfig)
    grad_fn = jax.jit(jax.value_and_grad(j_make_loss_fn(jcfg)))
    params = _jax_params(0.0)
    tx = optax.adam(jcfg.lr)
    state = tx.init(params)
    jloss_vals, jw = [], []
    for _ in range(STEPS):
        value, g = grad_fn(params, jdata)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        jloss_vals.append(float(value))
        jw.append(float(np.asarray(params["model"].w)[0]))

    tcfg = _cfg(TConfig, n_opt_iters=STEPS + 1)

    class Record(TrainCallbacks):
        w = []

        def train_loss(self, it, model, pose_deltas, loss):
            self.w.append(float(model.w.detach()[0]))

    rec = Record(tcfg)
    _, history = t_fit(tcfg, tdata, callbacks=rec)
    np.testing.assert_allclose([h[1] for h in history[:STEPS]], jloss_vals, rtol=1e-8)
    np.testing.assert_allclose(rec.w[1:], jw, rtol=1e-8)
    assert history[STEPS - 1][1] < history[0][1]


def _read(path):
    with open(path) as f:
        return f.read()


def test_eval_icp_matches_jax(tmp_path):
    """eval_icp at a nonzero model: the value within rtol 1e-9 and the same
    CSV line."""
    kw = {"test_names": [SEQ], "model_kwargs": {"w": [-2e-3], "exponent": [4.0]},
          "loss_kwargs": {"icp_point_to_plane": True}}
    jcfg = _cfg(JConfig, loss_eval_csv=str(tmp_path / "jax.csv"), **kw)
    tcfg = _cfg(TConfig, loss_eval_csv=str(tmp_path / "port.csv"), **kw)
    jv, tv = j_eval_icp(jcfg), t_eval_icp(tcfg)
    np.testing.assert_allclose(tv, jv, rtol=1e-9)
    assert _read(tcfg.loss_eval_csv) == _read(jcfg.loss_eval_csv)
    assert _read(tcfg.loss_eval_csv).startswith(SEQ + " ")


def test_eval_loss_all_with_icp_matches_jax(tmp_path):
    """eval_loss_all with icp_loss and min_eigval_loss on the training
    sequence: both packages' files and values (the consistency loss under
    its own configuration, the ICP loss at ground-truth poses)."""
    kw = {"loss": "min_eigval_loss", "eval_losses": ["icp_loss", "min_eigval_loss"],
          "eval_slams": [], "loss_kwargs": {"sqrt": False, "normalization": True}}
    jcfg = _cfg(JConfig, log_dir=str(tmp_path / "jax"), **kw)
    tcfg = _cfg(TConfig, log_dir=str(tmp_path / "port"), **kw)
    os.makedirs(jcfg.log_dir)
    os.makedirs(tcfg.log_dir)
    jres, tres = j_eval_loss_all(jcfg), t_eval_loss_all(tcfg)
    assert sorted(tres) == sorted(jres) == [("train", "icp_loss"), ("train", "min_eigval_loss")]
    for key in jres:
        np.testing.assert_allclose(tres[key], jres[key], rtol=1e-9)
    assert sorted(os.listdir(tcfg.log_dir)) == sorted(os.listdir(jcfg.log_dir))
    for name in os.listdir(jcfg.log_dir):
        assert _read(os.path.join(tcfg.log_dir, name)).split()[0] == SEQ
