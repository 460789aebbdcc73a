"""The port's dynamic loss offset and Gaussian re-weighting (nn_scale)
against the JAX package's, float64 on the CPU.

On ground_plane/4 (the JAX package's tests/test_loss_offset_lbfgs.py
configuration): the offset's frozen graph, the loss and its gradient in w
on the gather path and three Adam steps; the offset on a cell-window graph
(its rows re-indexed through row_map; the JAX side's Pallas kernels in
interpret mode); nn_scale's features on a seeded cloud, its loss and
gradient, and nn_scale with the offset, whose local features stay
unscaled. The JAX side's gradients are its autodiff ones (its transpose
graphs removed).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.datasets import create_dataset as j_create_dataset
from depth_correction_tpu.models import ScaledPolynomial as JScaledPolynomial
from depth_correction_tpu.ops import features as jfeat
from depth_correction_tpu.train import bind_cellwin_static
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import prepare_sequences as j_prepare_sequences
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.models import ScaledPolynomial as TScaledPolynomial
from depth_correction_tpu_torch.ops import features as tfeat
from depth_correction_tpu_torch.preproc import offset_cloud
from depth_correction_tpu_torch.train import TrainCallbacks
from depth_correction_tpu_torch.train import fit as t_fit
from depth_correction_tpu_torch.train import make_loss_fn as t_make_loss_fn
from depth_correction_tpu_torch.train import prepare_sequences as t_prepare_sequences

SEQ = "ground_plane/4"
STEPS = 3
W = -1e-3


def _cfg(cls, **kw):
    """tests/test_loss_offset_lbfgs.py's configuration, scipy
    establishment."""
    cfg = cls()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.train_names = [SEQ]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.nn_backend = "scipy"
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": False}
    cfg.loss_offset = True
    cfg.lr = 5e-4
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


# Each variant's options: the gather path; nn_scale alone and with the
# offset; the cell-window graph with the normalised loss (row_cap / pt_cap
# 32 keep the JAX side's interpret-mode kernels small).
VARIANTS = {
    "offset": {},
    "nn_scale": {"loss_offset": False, "nn_scale": 0.3},
    "nn_scale_offset": {"nn_scale": 0.3},
    "offset_cellwin": {"moments_backend": "cellwin", "cellwin_row_cap": 32,
                       "cellwin_pt_cap": 32, "loss_kwargs": {"sqrt": False,
                                                             "normalization": True}},
}


@pytest.fixture(scope="module")
def prepared():
    """Both packages' data for each variant, prepared on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = VARIANTS[name]
            jcfg, tcfg = _cfg(JConfig, **kw), _cfg(TConfig, **kw)
            jdata = j_prepare_sequences([j_create_dataset(SEQ, jcfg)], jcfg)
            tdata = t_prepare_sequences([t_create_dataset(SEQ, tcfg)], tcfg)
            # The JAX side's gradient by autodiff, its transpose graphs
            # removed (jitted, the offset's bucketed transpose moves the w
            # gradient by ~5e-6 relative from the autodiff one on this
            # graph); the port's runs through its own CSR transposes.
            none = tuple(None for _ in jdata.batches)
            jdata = dataclasses.replace(jdata, t_neighbors=none, t_slots=none,
                                        off_transpose=none)
            loss_fn, jd = bind_cellwin_static(j_make_loss_fn(jcfg), jdata)
            cache[name] = (jcfg, jdata, jax.jit(jax.value_and_grad(loss_fn)), jd, tcfg, tdata)
        return cache[name]

    return get


def _jparams(w):
    return {"model": JScaledPolynomial(w=jnp.asarray([w]), exponent=jnp.asarray([4.0]))}


def _port_value_grad(tcfg, tdata, w):
    model = TScaledPolynomial(w=[w], exponent=[4.0], dtype=torch.float64)
    value = t_make_loss_fn(tcfg)(model, tdata)
    value.backward()
    return float(value.detach()), float(model.w.grad[0])


def test_offset_graph_matches_jax(prepared):
    """The offset graph: the same per-row local neighbours (in the
    compacted rows' order) and weights."""
    _, jdata, _, _, _, tdata = prepared("offset")
    np.testing.assert_array_equal(tdata.off_neighbors[0].numpy(),
                                  np.asarray(jdata.off_neighbors[0]))
    np.testing.assert_array_equal(tdata.off_weights[0].numpy(),
                                  np.asarray(jdata.off_weights[0]))
    assert int(tdata.off_neighbors[0].max()) > tdata.batches[0].cloud.depth.shape[1]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_and_gradient_match_jax(prepared, name):
    """The loss and its gradient in w at w = 0 and at a nonzero w, rtol
    1e-9."""
    _, _, jgrad, jd, tcfg, tdata = prepared(name)
    if name == "offset_cellwin":
        assert tdata.cellwin[0] is not None and tdata.off_neighbors[0] is not None
        assert tdata.off_neighbors[0].shape[0] == tdata.cellwin[0].row_map.shape[0]
    for w in (0.0, W):
        jv, jg = jgrad(_jparams(w), jd)
        tv, tg = _port_value_grad(tcfg, tdata, w)
        np.testing.assert_allclose(tv, float(jv), rtol=1e-9)
        np.testing.assert_allclose(tg, float(np.asarray(jg["model"].w)[0]), rtol=1e-9)


def test_offset_lowers_the_loss(prepared):
    """The offset takes the single-scan floor away: at w = 0 the offset
    loss is below the raw loss and not negative."""
    _, _, _, _, tcfg, tdata = prepared("offset")
    raw_cfg = _cfg(TConfig, loss_offset=False)
    raw = t_prepare_sequences([t_create_dataset(SEQ, raw_cfg)], raw_cfg)
    off, _ = _port_value_grad(tcfg, tdata, 0.0)
    base, _ = _port_value_grad(raw_cfg, raw, 0.0)
    assert 0.0 <= off < base


def test_offset_is_unscaled_under_nn_scale(prepared):
    """With nn_scale the offset's local features are unscaled (JAX package,
    tests/test_loss_offset_lbfgs.py:144): the offset equals the plain local
    lambda_1 over the frozen local graph."""
    _, _, _, _, tcfg, tdata = prepared("nn_scale_offset")
    model = TScaledPolynomial(w=[W], exponent=[4.0], dtype=torch.float64)
    pts = offset_cloud(tdata.batches[0], model).get_points()
    otg = tdata.off_transposes[0]
    f = tfeat.neighborhood_features(pts, tdata.off_neighbors[0], tdata.off_weights[0],
                                    compute_normals=False, tg=otg)
    scaled = tfeat.neighborhood_features(pts, tdata.off_neighbors[0], tdata.off_weights[0],
                                         scale=0.3, compute_normals=False,
                                         query_rows=tdata.query_rows[0], tg=otg)
    assert not torch.allclose(f["eigvals"], scaled["eigvals"])
    # The loss with the unscaled offset, by hand.
    from depth_correction_tpu_torch.preproc import global_cloud

    g = tfeat.neighborhood_features(global_cloud(tdata.batches[0], model=model).get_points(),
                                    tdata.neighbors[0], tdata.weights[0], scale=0.3,
                                    compute_normals=False, query_rows=tdata.query_rows[0],
                                    tg=tdata.transposes[0])
    mask = tdata.masks[0]
    manual = torch.relu(g["eigvals"][:, 0] - f["eigvals"][:, 0])[mask].mean()
    got, _ = _port_value_grad(tcfg, tdata, W)
    np.testing.assert_allclose(got, float(manual.detach()), rtol=1e-12)


@pytest.mark.parametrize("name", ["offset", "nn_scale"])
def test_adam_steps_match_optax(prepared, name):
    """fit(): three Adam steps' losses and w within 1e-8 of optax.adam on
    the JAX package's loss."""
    jcfg, _, jgrad, jd, tcfg, tdata = prepared(name)
    params = _jparams(0.0)
    tx = optax.adam(jcfg.lr)
    state = tx.init(params)
    jl, jw = [], []
    for _ in range(STEPS):
        value, g = jgrad(params, jd)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        jl.append(float(value))
        jw.append(float(np.asarray(params["model"].w)[0]))

    class Record(TrainCallbacks):
        w = []

        def train_loss(self, it, model, pose_deltas, loss):
            self.w.append(float(model.w.detach()[0]))

    cfg = tcfg.copy()
    cfg.n_opt_iters = STEPS + 1
    rec = Record(cfg)
    _, history = t_fit(cfg, tdata, callbacks=rec)
    np.testing.assert_allclose([h[1] for h in history[:STEPS]], jl, rtol=1e-8)
    np.testing.assert_allclose(rec.w[1:], jw, rtol=1e-8)


@pytest.mark.parametrize("query", ["full_table", "query_rows"])
def test_nn_scale_features_match_jax(query):
    """neighborhood_features with scale on a seeded cloud: the re-weighted
    weights, mean, trace and eigenvalues, with and without a gradient, and
    the gradient of sum lambda_1 in the points, rtol 1e-9."""
    from scipy.spatial import cKDTree

    n = 300
    rng = np.random.default_rng(7)
    pts = np.c_[rng.uniform(-1, 1, (n, 2)), 0.05 * rng.standard_normal(n)]
    lists = cKDTree(pts).query_ball_point(pts, 0.3)
    nn = np.full((n, max(map(len, lists))), -1, np.int64)
    for i, l in enumerate(lists):
        nn[i, :len(l)] = l
    rows = np.arange(n) if query == "full_table" else np.flatnonzero(rng.uniform(size=n) < .6)
    qr = None if query == "full_table" else rows
    nn_q = nn[rows]
    w = (nn_q >= 0).astype(np.float64)

    def jfun(p):
        f = jfeat.neighborhood_features(p, jnp.asarray(nn_q), jnp.asarray(w), scale=0.15,
                                        compute_normals=False,
                                        query_rows=None if qr is None else jnp.asarray(qr))
        return f["eigvals"][:, 0].sum(), f

    (_, jf), jg = jax.jit(jax.value_and_grad(jfun, has_aux=True))(jnp.asarray(pts))
    tq = None if qr is None else torch.as_tensor(qr)
    tp = torch.tensor(pts, requires_grad=True)
    tg = tfeat.build_transpose_graph(torch.as_tensor(nn_q), torch.as_tensor(pts),
                                     torch.as_tensor(w))
    tf = tfeat.neighborhood_features(tp, torch.as_tensor(nn_q), torch.as_tensor(w), scale=0.15,
                                     compute_normals=False, query_rows=tq, tg=tg)
    tf["eigvals"][:, 0].sum().backward()
    with torch.no_grad():
        tf_ng = tfeat.neighborhood_features(torch.as_tensor(pts), torch.as_tensor(nn_q),
                                            torch.as_tensor(w), scale=0.15,
                                            compute_normals=False, query_rows=tq)
    for f in (tf, tf_ng):
        for key in ("weights", "mean", "trace", "eigvals"):
            np.testing.assert_allclose(f[key].detach().numpy(), np.asarray(jf[key]),
                                       rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-14)
    assert (tf["weights"].detach().numpy() < w).any()
