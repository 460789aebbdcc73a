"""The gather engine's analytic backward over a transpose graph, the port
against the JAX package, float64 on the CPU.

The port keeps each point's referencing (row, slot) pairs as a CSR
(``ops.features.build_transpose_graph``); the JAX package as padded
(M, Kt) tables (``build_transpose_graph``, ``build_transpose_graph_device``).
On the CPU the backward kernels X4 (the moments' VJP) and X5 (the pair
gather's VJP) run as their plain versions, whose sums these tests hold
against ``jax.vjp`` of the JAX package's custom VJPs. Inputs are made with
numpy from a seed and handed to both packages.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import depth_correction_tpu.ops.features  # noqa: F401
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.models import ScaledPolynomial as TScaledPolynomial
from depth_correction_tpu_torch.ops import cellwin as tcw
from depth_correction_tpu_torch.ops import features as tfeat
from depth_correction_tpu_torch.train import make_loss_fn as t_make_loss_fn
from depth_correction_tpu_torch.train import prepare_sequences as t_prepare_sequences

# The JAX package's ops/__init__ re-exports functions named like its
# submodules, so take the submodule from sys.modules.
jfeat = sys.modules["depth_correction_tpu.ops.features"]

GRAD_RTOL = 1e-9  # of max |grad|


def _ball_graph(pts, r, k_cap=None):
    """(N, K) within-r neighbour table, -1 padded, optionally cut to
    ``k_cap`` columns."""
    from scipy.spatial import cKDTree

    lists = cKDTree(pts).query_ball_point(pts, r)
    k = max(map(len, lists)) if k_cap is None else k_cap
    nn = np.full((len(pts), k), -1, np.int64)
    for i, l in enumerate(lists):
        l = l[:k]
        nn[i, :len(l)] = l
    return nn


def _positions(m):
    """(M, 3) float64 positions seeded in a 10 m box: the cell order of a
    graph case's transpose."""
    return torch.as_tensor(np.random.default_rng(3).uniform(-5, 5, (m, 3)))


def _graph_case(case):
    """(neighbors, num_points, weights) of one CSR case."""
    rng = np.random.default_rng(5)
    if case == "padded":
        nn = rng.integers(0, 300, (200, 12))
        nn[rng.uniform(size=nn.shape) < 0.3] = -1
        return nn, 300, rng.uniform(0.5, 1.5, nn.shape) * (nn >= 0)
    if case == "in_degree_0":
        # Points 400..599 are referenced by no row.
        nn = rng.integers(0, 400, (250, 8))
        nn[:, 6:] = -1
        return nn, 600, (nn >= 0).astype(np.float64)
    if case == "hub":
        nn = rng.integers(0, 100, (300, 16))
        nn[:, 3] = 7  # point 7 in every row: in-degree >= 300
        nn[::3, 9] = 7
        return nn, 100, (nn >= 0).astype(np.float64)
    if case == "out_of_range":
        nn = rng.integers(-1, 130, (90, 10))  # indices 120..129 lie outside 120 points
        return nn, 120, (nn >= 0).astype(np.float64)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["padded", "in_degree_0", "hub", "out_of_range"])
def test_csr_matches_jax_transpose(case):
    """Each point's run of (row, slot, weight) equals the JAX table row
    ``t_idx[j, :deg]``, ``t_slot[j, :deg]``, ``t_w[j, :deg]`` bit for bit,
    and the JAX row is padding past ``deg``. Out-of-range indices are held
    against ``build_transpose_graph_device`` (``build_transpose_graph``
    does not take them)."""
    nn, m, w = _graph_case(case)
    tg = tfeat.build_transpose_graph(torch.as_tensor(nn), _positions(m), torch.as_tensor(w))
    csr = tfeat.point_csr(tg)
    build = (jfeat.build_transpose_graph_device if case == "out_of_range"
             else jfeat.build_transpose_graph)
    t_idx, t_slot, t_w = (np.asarray(a) for a in build(jnp.asarray(nn), m, jnp.asarray(w)))
    start = csr.start.numpy()
    pair = csr.pair.numpy().astype(np.int64)
    assert start.shape == (m + 1,) and start[0] == 0
    assert csr.pair.dtype == torch.int32 and csr.start.dtype == torch.int32
    k = nn.shape[1]
    for j in range(m):
        run = pair[start[j]:start[j + 1]]
        deg = len(run)
        np.testing.assert_array_equal(run // k, t_idx[j, :deg])
        np.testing.assert_array_equal(run % k, t_slot[j, :deg])
        np.testing.assert_array_equal(csr.w.numpy()[start[j]:start[j + 1]], t_w[j, :deg])
        assert (t_idx[j, deg:] == -1).all()
    assert start[-1] == int(((nn >= 0) & (nn < m)).sum())
    if case == "in_degree_0":
        assert (np.diff(start)[400:] == 0).all()
    if case == "hub":
        assert np.diff(start)[7] >= 400


def _moments_case(case):
    """(points, neighbors, weights) of one gradient case."""
    rng = np.random.default_rng(11)
    n = 400
    pts = np.c_[rng.uniform(-2, 2, (n, 2)), 0.1 * rng.standard_normal(n)]
    nn = _ball_graph(pts, 0.45, k_cap=24)
    w = (nn >= 0).astype(np.float64)
    if case == "translated_500m":
        pts = pts + np.array([500.0, -350.0, 20.0])
    elif case == "weighted":
        w = w * rng.uniform(0.3, 1.7, w.shape)
    elif case == "one_neighbour":
        # Rows 0..39 keep only their first neighbour: the normaliser clamps
        # at 1e-6, S is huge and x_j - mu_i is 0.
        nn[:40, 1:] = -1
        w[:40, 1:] = 0.0
    return pts, nn, w


@pytest.mark.parametrize("case", ["origin", "translated_500m", "weighted", "one_neighbour"])
def test_moments_vjp_matches_jax(case):
    """The port's neighborhood_moments gradient (X4's plain version) against
    ``jax.vjp`` of the JAX package's neighborhood_moments custom VJP and
    against the port's own autograd of ``_moments_impl``, rtol 1e-9 of
    max |grad|, with seeded cotangents."""
    pts, nn, w = _moments_case(case)
    m = len(pts)
    rng = np.random.default_rng(3)
    g_mean = rng.standard_normal((3, nn.shape[0]))
    g_comps = rng.standard_normal((6, nn.shape[0]))

    t_idx, _, t_w = jfeat.build_transpose_graph(jnp.asarray(nn), m, jnp.asarray(w))
    _, vjp = jax.vjp(lambda p: jfeat.neighborhood_moments(p, jnp.asarray(nn), jnp.asarray(w),
                                                          t_idx, t_w), jnp.asarray(pts))
    (jg,) = vjp((jnp.asarray(g_mean), tuple(jnp.asarray(c) for c in g_comps)))
    jg = np.asarray(jg)

    def objective(mean, comps):
        return ((mean * torch.as_tensor(g_mean)).sum()
                + sum((c * torch.as_tensor(gc)).sum() for c, gc in zip(comps, g_comps)))

    tg = tfeat.build_transpose_graph(torch.as_tensor(nn), torch.as_tensor(pts),
                                     torch.as_tensor(w))
    p = torch.tensor(pts, requires_grad=True)
    mean, comps = tfeat.neighborhood_moments(p, torch.as_tensor(nn), torch.as_tensor(w), tg)
    objective(mean, comps).backward()
    pa = torch.tensor(pts, requires_grad=True)
    amean, acomps, _ = tfeat._moments_impl(pa, torch.as_tensor(nn), torch.as_tensor(w))
    objective(amean, acomps).backward()

    scale = np.abs(pa.grad.numpy()).max()
    assert np.abs(p.grad.numpy() - pa.grad.numpy()).max() <= GRAD_RTOL * scale
    if case == "one_neighbour":
        # The JAX form S x_j + (h - S mu) cancels |S| |x| with S ~ 1e6 on
        # these rows; the port's centred form gives autograd's 0 there. The
        # bar holds for JAX's form only away from them: held on the rows'
        # lone neighbours' complement.
        lone = np.unique(nn[:40, 0])
        keep = np.setdiff1d(np.arange(m), lone)
        assert np.abs(p.grad.numpy()[keep] - jg[keep]).max() <= GRAD_RTOL * scale
    else:
        assert np.abs(p.grad.numpy() - jg).max() <= GRAD_RTOL * scale
    np.testing.assert_array_equal(mean.detach().numpy(), amean.detach().numpy())


def test_one_neighbour_rows_contribute_nothing():
    """A row with one neighbour gives that neighbour exactly 0 through X4's
    plain version (autograd's value), whatever its cotangent."""
    pts = np.array([[3.0, 1.0, 2.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]) + 1000.0
    nn = np.array([[0, -1], [1, 2]])
    w = (nn >= 0).astype(np.float64)
    tg = tfeat.build_transpose_graph(torch.as_tensor(nn), torch.as_tensor(pts),
                                     torch.as_tensor(w))
    p = torch.tensor(pts, requires_grad=True)
    mean, comps = tfeat.neighborhood_moments(p, torch.as_tensor(nn), torch.as_tensor(w), tg)
    (1e3 * comps[0][0] + 7.0 * comps[3][0] + 0.0 * mean.sum()).backward()
    assert torch.equal(p.grad[0], torch.zeros(3, dtype=torch.float64))


@pytest.mark.parametrize("dim", [1, 3])
def test_gather_transposed_vjp_matches_jax(dim):
    """gather_neighbors_transposed: the forward equals the JAX gather on
    real slots and the backward (X5's plain version) ``jax.vjp`` of the JAX
    package's gather_neighbors_transposed, rtol 1e-9."""
    rng = np.random.default_rng(2)
    m = 150
    nn = rng.integers(-1, m, (120, 10))
    values = rng.standard_normal((m, dim)) if dim == 3 else rng.standard_normal(m)
    g = rng.standard_normal(nn.shape + ((dim,) if dim == 3 else ()))
    t_idx, t_slot = jfeat.build_transpose_graph(jnp.asarray(nn), m)
    out, vjp = jax.vjp(lambda v: jfeat.gather_neighbors_transposed(v, jnp.asarray(nn), t_idx,
                                                                   t_slot), jnp.asarray(values))
    (jg,) = vjp(jnp.asarray(g))
    tg = tfeat.build_transpose_graph(torch.as_tensor(nn), _positions(m))
    assert tg.w is None
    v = torch.tensor(values, requires_grad=True)
    got = tfeat.gather_neighbors_transposed(v, torch.as_tensor(nn), tg)
    real = nn >= 0
    np.testing.assert_array_equal(got.detach().numpy()[real], np.asarray(out)[real])
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=GRAD_RTOL * np.abs(np.asarray(jg)).max())


@pytest.mark.parametrize("query", ["full_table", "query_rows"])
def test_scaled_features_vjp_matches_jax(query):
    """neighborhood_features(scale=...) with the transpose: the gradient of
    sum lambda_1 in the points against the JAX package's
    neighborhood_features(scale, t_idx, t_slot) (its ``_gather_T`` path),
    rtol 1e-9 of max |grad|."""
    rng = np.random.default_rng(8)
    n = 300
    pts = np.c_[rng.uniform(-1, 1, (n, 2)), 0.05 * rng.standard_normal(n)] + 200.0
    nn = _ball_graph(pts, 0.3)
    rows = np.arange(n) if query == "full_table" else np.flatnonzero(rng.uniform(size=n) < .6)
    nn_q = nn[rows]
    w = (nn_q >= 0).astype(np.float64)
    qr = None if query == "full_table" else rows
    t_idx, t_slot = jfeat.build_transpose_graph(jnp.asarray(nn_q), n)

    def jfun(p):
        f = jfeat.neighborhood_features(p, jnp.asarray(nn_q), jnp.asarray(w), scale=0.15,
                                        compute_normals=False, t_idx=t_idx, t_slot=t_slot,
                                        query_rows=None if qr is None else jnp.asarray(qr))
        return f["eigvals"][:, 0].sum()

    jg = np.asarray(jax.grad(jfun)(jnp.asarray(pts)))
    tg = tfeat.build_transpose_graph(torch.as_tensor(nn_q), torch.as_tensor(pts),
                                     torch.as_tensor(w))
    tp = torch.tensor(pts, requires_grad=True)
    f = tfeat.neighborhood_features(tp, torch.as_tensor(nn_q), torch.as_tensor(w), scale=0.15,
                                    compute_normals=False, tg=tg,
                                    query_rows=None if qr is None else torch.as_tensor(qr))
    f["eigvals"][:, 0].sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), jg, rtol=0, atol=GRAD_RTOL * np.abs(jg).max())


def test_gradient_path_without_transpose_raises():
    """Without a transpose the gradient path raises, for the moments and
    for nn_scale; without a gradient no transpose is needed."""
    pts, nn, w = _moments_case("origin")
    p = torch.tensor(pts, requires_grad=True)
    args = (torch.as_tensor(nn), torch.as_tensor(w))
    with pytest.raises(ValueError, match="transpose"):
        tfeat.neighborhood_moments(p, *args)
    with pytest.raises(ValueError, match="transpose"):
        tfeat.neighborhood_features(p, *args, scale=0.2, compute_normals=False)
    pair_only = tfeat.build_transpose_graph(args[0], torch.as_tensor(pts))
    with pytest.raises(ValueError, match="weights"):
        tfeat.neighborhood_moments(p, *args, tg=pair_only)
    with torch.no_grad():
        mean, _ = tfeat.neighborhood_moments(p, *args)
    assert mean.shape == (3, len(pts))


# ---------------------------------------------------------------------------
# Routing: each gradient path of the gather engine goes through the new
# Functions' plain backward on the CPU.


def _train_cfg(**kw):
    """tests/test_torch_offset.py's configuration, scipy establishment."""
    cfg = TConfig()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.train_names = ["ground_plane/4"]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.nn_backend = "scipy"
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": False}
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture
def count_backwards(monkeypatch):
    """Counts of X4's and X5's plain versions' calls."""
    calls = {"moments": 0, "gather": 0}
    moments, gather = tfeat.transpose_moments_plain, tfeat.transpose_gather_plain

    def counted_moments(*a, **kw):
        calls["moments"] += 1
        return moments(*a, **kw)

    def counted_gather(*a, **kw):
        calls["gather"] += 1
        return gather(*a, **kw)

    monkeypatch.setattr(tfeat, "transpose_moments_plain", counted_moments)
    monkeypatch.setattr(tfeat, "transpose_gather_plain", counted_gather)
    return calls


ROUTES = {
    # options, (X4 calls, X5 calls) a loss gradient
    "capped": ({"nn_max_neighbors": 8}, (1, 0)),
    "offset": ({"loss_offset": True}, (2, 0)),
    "nn_scale": ({"nn_scale": 0.3}, (0, 1)),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_loss_gradients_take_the_transpose_backward(route, count_backwards):
    """A capped, an offset and an nn_scale loss gradient: prep builds the
    transposes, the backward calls X4's / X5's plain version once a gather
    graph, and without the transposes the gradient raises."""
    import dataclasses

    opts, expected = ROUTES[route]
    cfg = _train_cfg(**opts)
    data = t_prepare_sequences([t_create_dataset(cfg.train_names[0], cfg)], cfg)
    assert data.cellwin == (None,) and data.transposes[0] is not None
    assert "transpose" in data.prep_seconds
    assert (data.off_transposes[0] is not None) == bool(cfg.loss_offset)
    if route == "capped":
        assert data.neighbors[0].shape[1] <= 8
    model = TScaledPolynomial(w=[-1e-3], exponent=[4.0], dtype=torch.float64)
    t_make_loss_fn(cfg)(model, data).backward()
    assert (count_backwards["moments"], count_backwards["gather"]) == expected
    assert model.w.grad is not None and torch.isfinite(model.w.grad).all()
    bare = dataclasses.replace(data, transposes=(None,), off_transposes=(None,))
    with pytest.raises(ValueError, match="transpose"):
        t_make_loss_fn(cfg)(model, bare)
    evaluation = t_prepare_sequences([t_create_dataset(cfg.train_names[0], cfg)], cfg,
                                     for_grad=False)
    assert evaluation.transposes == (None,) and evaluation.off_transposes == (None,)


def test_exception_rows_take_the_transpose_backward(count_backwards):
    """A loss over a cell-window graph with exception rows: K1 / K2's plain
    versions for the tiles and X4's plain version once for the exception
    rows, whose transpose the device graph carries (over m_pad points)."""
    rng = np.random.default_rng(7)
    r = 0.5
    pts = rng.uniform(-1, 1, (400, 3))
    pts[1] = pts[0] + np.array([r, 0.0, 0.0])  # a pair exactly at r: exception rows
    nn = _ball_graph(pts, r)
    g = tcw.build_cellwin_graph(pts, np.ones(len(pts), bool), np.arange(len(pts)), nn, r,
                                row_cap=32, pt_cap=32, span_limit=256)
    assert g is not None and g.n_exc >= 1
    dev = tcw.graph_to_device(g)
    assert dev.exc_tg.num_points == dev.perm.shape[0]
    assert int(dev.exc_tg.start[-1]) == int((dev.exc_nn >= 0).sum())
    p = torch.tensor(pts, requires_grad=True)
    f = tcw.cellwin_features(tfeat.permute_rows(p, dev.perm, dev.inv), dev)
    f["eigvals"][:, 0][dev.row_map >= 0].sum().backward()
    assert count_backwards == {"moments": 1, "gather": 0}
    assert torch.isfinite(p.grad).all()
