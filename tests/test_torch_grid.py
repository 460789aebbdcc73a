"""The port's grid-hash search (``ops/grid_hash.py``) against the JAX
package's, on the CPU: the host-sized grid (``grid_radius_neighbors``,
``grid_neighbor_counts``) and the device-sized one (``grid_establish_traced``
+ the query twin) on the cases of tests/test_grid_hash.py. In float64 the
index tables are equal, order included, and distances agree to 1e-12; in
float32 the neighbour sets are equal except pairs within 1e-6 r of the
radius. The port's wrappers run the plain twin on CPU tensors."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depth_correction_tpu.ops import grid_hash as jg
from depth_correction_tpu.ops import knn as jknn
from depth_correction_tpu_torch.ops import grid_hash as tg
from depth_correction_tpu_torch.ops import knn as tknn


def _both(pts, dtype=np.float64, **kw):
    """(JAX, port) results of grid_radius_neighbors on the same inputs."""
    conv_j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    conv_t = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    dj, ij = jg.grid_radius_neighbors(jnp.asarray(pts.astype(dtype)), **conv_j)
    dt, it = tg.grid_radius_neighbors(torch.as_tensor(pts.astype(dtype)), **conv_t)
    return (np.asarray(dj), np.asarray(ij)), (dt.numpy(), it.numpy())


def _assert_same(ref, got, tol=1e-12):
    (dj, ij), (dt, it) = ref, got
    assert it.shape == ij.shape and (it >= 0).any()
    np.testing.assert_array_equal(it, ij)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=0, atol=tol)


def _sets(idx):
    return [set(int(j) for j in row if j >= 0) for row in idx]


@pytest.mark.parametrize("seed,n,r", [(0, 3000, 0.25), (1, 5000, 0.4)])
def test_uniform_clouds_match_jax(seed, n, r):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, (n, 3))
    ref, got = _both(pts, r=r, k=48)
    _assert_same(ref, got)
    # Counts: exact, also past k.
    cj = np.asarray(jg.grid_neighbor_counts(jnp.asarray(pts), r=r))
    ct = tg.grid_neighbor_counts(torch.as_tensor(pts), r=r).numpy()
    np.testing.assert_array_equal(ct, cj)


def test_validity_padding_and_query_differs():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-2, 2, (1500, 3))
    valid = rng.uniform(size=1500) > 0.3
    pts_pad = np.concatenate([pts, np.zeros((100, 3))])
    valid_pad = np.concatenate([valid, np.zeros(100, bool)])
    ref, got = _both(pts_pad, r=0.5, k=40, valid_points=valid_pad, valid_query=valid_pad)
    _assert_same(ref, got)
    assert (got[1][len(pts):] == -1).all()
    q = rng.uniform(-2.5, 2.5, (700, 3))  # some queries outside the grid
    ref, got = _both(pts, r=0.45, k=30, query=q)
    _assert_same(ref, got)


@pytest.mark.parametrize("case", ["k_past_window", "bucket_cap", "static_shapes"])
def test_window_options_match_jax(case):
    rng = np.random.default_rng(7)
    if case == "k_past_window":  # sparse: k pads past the 9-window width
        pts = rng.uniform(-20, 20, (2000, 3))
        ref, got = _both(pts, r=0.25, k=128)
        assert (got[1][:, -1] == -1).all()
    elif case == "bucket_cap":  # an undersized cap cuts runs as the window does
        pts = rng.uniform(-1, 1, (800, 3))
        ref, got = _both(pts, r=0.5, k=64, bucket_cap=6)
    else:
        pts = rng.uniform(-3, 3, (1200, 3))
        ref, got = _both(pts, r=0.35, k=40, static_shapes=True)
    _assert_same(ref, got)


@pytest.mark.parametrize("thickness,axis", [(0.0, 2), (0.3, 2), (0.0, 0), (0.45, 1)])
def test_thin_slabs_match_jax(thickness, axis):
    """Grids with <= 2 cells along an axis (tests/test_grid_hash.py:129)."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-4, 4, (4000, 3))
    pts[:, axis] = rng.uniform(0, thickness, 4000)
    ref, got = _both(pts, r=0.25, k=64)
    _assert_same(ref, got)


def test_searched_branch_matches_jax(monkeypatch):
    """Past the dense start table (forced low in both packages) the query
    searches each column's run; with and without a bucket cap."""
    monkeypatch.setattr(jg, "_DENSE_STARTS_MAX_CELLS", 16)
    monkeypatch.setattr(tg, "_DENSE_STARTS_MAX_CELLS", 16)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, (1500, 3))
    valid = rng.uniform(size=1500) > 0.2
    ref, got = _both(pts, r=0.4, k=40, valid_points=valid, valid_query=valid)
    _assert_same(ref, got)
    ref, got = _both(pts, r=0.4, k=40, bucket_cap=3)
    _assert_same(ref, got)


def test_float32_sets_match_jax_up_to_the_boundary():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-3, 3, (3000, 3))
    r = 0.3
    ref, got = _both(pts, dtype=np.float32, r=r, k=48)
    p64 = pts.astype(np.float32).astype(np.float64)
    for i, (a, b) in enumerate(zip(_sets(ref[1]), _sets(got[1]))):
        for j in a ^ b:
            assert abs(np.linalg.norm(p64[i] - p64[j]) - r) <= 1e-6 * r


@pytest.mark.parametrize("n_cells_pad,width,extent", [(1 << 15, 64, 3.0), (1 << 9, 128, 40.0)])
def test_establish_traced_matches_jax(n_cells_pad, width, extent):
    """The device-sized grid (the node's) and the query twin against
    grid_establish_traced + _grid_query_chunk_impl; the second case
    coarsens the cell to fit a small table."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-extent, extent, (2000, 3))
    valid = rng.uniform(size=2000) > 0.2
    r, k = 0.4 if extent < 10 else 0.6, 24

    @jax.jit
    def program(p, v):
        est = jg.grid_establish_traced(p, v, r, n_cells_pad)
        (pts_T, val_s, ids_s, order, mins, dims, cell, starts, true_win) = est
        d, idx = jg._grid_query_chunk_impl(p, v, pts_T, val_s, ids_s, order, mins, dims,
                                           jnp.asarray(r, p.dtype) ** 2, k, width, cell,
                                           starts)
        return d, idx, true_win, cell, ids_s

    dj, ij, true_win, cell, ids_j = program(jnp.asarray(pts), jnp.asarray(valid))
    assert int(true_win) <= width
    tp, tv = torch.as_tensor(pts), torch.as_tensor(valid)
    est = tg.grid_establish_traced(tp, tv, r, n_cells_pad)
    (pts_T, val_s, ids_s, order, mins, dims, tcell, starts, twin) = est
    assert int(twin) == int(true_win) and float(tcell) == float(cell)
    np.testing.assert_array_equal(ids_s.numpy(), np.asarray(ids_j))
    r2 = torch.full((), r, dtype=torch.float64) ** 2
    dt, it = tg._grid_query_chunk_plain(tp, tv, pts_T, val_s, ids_s, order, mins, dims, r2, k,
                                        width, tcell, starts)
    _assert_same((np.asarray(dj), np.asarray(ij)), (dt.numpy(), it.numpy()))
    # The wrapper without a window (the node's kernel form) gives the same.
    dw, iw = tg.grid_query(tp, tv, pts_T, val_s, ids_s, order, mins, dims, r2, k, None, tcell,
                           starts)
    assert torch.equal(iw, it) and torch.equal(dw, dt)
    if extent > 10:
        assert float(tcell) > r


@pytest.mark.parametrize("n", [3000, 70000])
def test_suggest_k_max_matches_jax(n):
    """K sizing on both sides of GRID_NN_MIN_POINTS (tiled counts below,
    grid counts above)."""
    rng = np.random.default_rng(8)
    side = 4.0 if n < tg.GRID_NN_MIN_POINTS else 12.0
    pts = rng.uniform(0, side, (n, 3))
    valid = rng.uniform(size=n) > 0.1
    kj = jknn.suggest_k_max(jnp.asarray(pts), r=0.25, valid_points=jnp.asarray(valid))
    kt = tknn.suggest_k_max(torch.as_tensor(pts), r=0.25, valid_points=torch.as_tensor(valid))
    assert kt == kj and kt % 8 == 0
    counts = tknn.neighbor_counts(torch.as_tensor(pts[:2000]), torch.as_tensor(pts[:2000]),
                                  r=0.25).numpy()
    want = np.asarray(jknn.neighbor_counts(jnp.asarray(pts[:2000]), r=0.25))
    np.testing.assert_array_equal(counts, want)


def test_scipy_pairs_differ_finds_pairs_off_the_sets():
    """The comparison with scipy's float64 sets (chip_smoke.py phase 7 and
    scripts/exp_grid_prep_diff.py): none on the port's float64 table; one
    dropped neighbour is one ordered pair, at its own |d - r|."""
    from depth_correction_tpu_torch.scripts.exp_grid_prep_diff import scipy_pairs_differ

    rng = np.random.default_rng(9)
    pts = torch.as_tensor(rng.uniform(-2, 2, (2000, 3)))
    valid = torch.as_tensor(rng.uniform(size=2000) > 0.1)
    d, idx = tg.grid_radius_neighbors(pts, r=0.4, k=64, valid_points=valid, valid_query=valid)
    assert int((idx >= 0).sum(1).max()) < 64
    assert scipy_pairs_differ(pts, valid, idx, 0.4) == (0, 0.0)
    counts = (idx >= 0).sum(1)
    row = int(torch.nonzero(counts > 1)[0])
    last = int(counts[row]) - 1  # the farthest neighbour, not the row itself
    idx = idx.clone()
    idx[row, last] = -1
    differ, worst = scipy_pairs_differ(pts, valid, idx, 0.4)
    assert differ == 1 and worst == pytest.approx(abs(float(d[row, last]) - 0.4), abs=1e-12)


@pytest.mark.parametrize("sort_axes", [False, True, "second"])
def test_grid_sort_traced_matches_jax(sort_axes):
    """The device-sized sort with its axis relabelings: the same order,
    ids, dims and cell as the JAX package's."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-3, 3, (1500, 3)) * [2.0, 1.0, 0.2]
    valid = rng.uniform(size=1500) > 0.1
    ref = jg.grid_sort_traced(jnp.asarray(pts), jnp.asarray(valid), 0.3, 1 << 15,
                              sort_axes=sort_axes)
    got = tg.grid_sort_traced(torch.as_tensor(pts), torch.as_tensor(valid), 0.3, 1 << 15,
                              sort_axes=sort_axes)
    for name, a, b in zip(("pts_T", "valid", "ids", "order", "mins", "dims", "cell"), got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
