"""The online corrector's ops in the port against the JAX package, on the
CPU: threefry uniforms, the depth and voxel-grid masks, the column-aligned
cell sort, slab-window moments, gather moments and the brute-force radius
search. Inputs come from seeded numpy generators; float64 unless a case
says otherwise."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depth_correction_tpu.cloud import Cloud as JCloud
from depth_correction_tpu.ops import features as jfeatures
from depth_correction_tpu.ops import filters as jfilters
from depth_correction_tpu.ops import grid_hash as jgrid
from depth_correction_tpu.ops import knn as jknn
from depth_correction_tpu.ops import slabwin as jslab
from depth_correction_tpu_torch.cloud import Cloud as TCloud
from depth_correction_tpu_torch.ops import features as tfeatures
from depth_correction_tpu_torch.ops import filters as tfilters
from depth_correction_tpu_torch.ops import grid_hash as tgrid
from depth_correction_tpu_torch.ops import knn as tknn
from depth_correction_tpu_torch.ops import prng
from depth_correction_tpu_torch.ops import slabwin as tslab

N_CELLS = 1 << 21


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed, n, flat=0.2, extent=3.0):
    """A slab of uniform points (z squeezed by ``flat``) with ~20% invalid
    rows."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-extent, extent, (n, 3))
    p[:, 2] *= flat
    return p, rng.uniform(size=n) > 0.2


@pytest.mark.parametrize("seed", [0, 135])
@pytest.mark.parametrize("n", [1, 2, 3, 4097, 129024])
def test_uniform_bit_equal(seed, n):
    key = jax.random.PRNGKey(seed)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        ref = np.asarray(jax.random.uniform(key, (n,), dtype=jdt))
        got = prng.uniform(seed, n, tdt).numpy()
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def _filter_cloud(seed, n, dtype):
    """Scan-like cloud with duplicate points, invalid rows and depths both
    sides of the bounds."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4.0, 4.0, (n, 3))
    pts[n // 2: n // 2 + 40] = pts[:40]  # duplicates
    vps = np.zeros_like(pts)
    valid = rng.uniform(size=n) > 0.1
    return pts.astype(dtype), vps.astype(dtype), valid


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_depth_and_grid_masks_bit_equal(dtype):
    import contextlib

    # JAX draws its ranks in its default float type: float32 clouds are
    # compared with x64 off, as the JAX package runs them.
    ctx = jax.enable_x64(False) if dtype == np.float32 else contextlib.nullcontext()
    pts, vps, valid = _filter_cloud(3, 6000, dtype)
    with ctx:
        jc = JCloud.from_points(pts, vps=vps, valid=valid, dtype=dtype)
        depth_j = np.asarray(jfilters.filter_depth_mask(jc, 1.0, 5.0))
        grid_j = np.asarray(jfilters.filter_grid_mask(jc.to_points(), jnp.asarray(depth_j), 0.25))
        # A 1024-slot table for 6000 points: distinct voxels share slots.
        small_j = np.asarray(jfilters.filter_grid_mask(jnp.asarray(pts), jnp.asarray(valid), 0.25,
                                                       table_size=1024))
        tc = TCloud(vps=_t(np.asarray(jc.vps)), dirs=_t(np.asarray(jc.dirs)),
                    depth=_t(np.asarray(jc.depth)), valid=_t(np.asarray(jc.valid)))
        pts_j = _t(np.asarray(jc.to_points()))
    depth_t = tfilters.filter_depth_mask(tc, 1.0, 5.0)
    grid_t = tfilters.filter_grid_mask(pts_j, depth_t, 0.25)
    small_t = tfilters.filter_grid_mask(_t(pts), _t(valid), 0.25, table_size=1024)
    np.testing.assert_array_equal(depth_t.numpy(), depth_j)
    np.testing.assert_array_equal(grid_t.numpy(), grid_j)
    np.testing.assert_array_equal(small_t.numpy(), small_j)
    # The cases the masks must cover: duplicates keep one point, invalid
    # rows never win, and hash collisions merge voxels.
    assert depth_j.sum() > 1000 and grid_j.sum() < depth_j.sum()
    assert not small_j[~valid].any()
    voxels = {tuple(v) for v in np.floor(pts[valid] / 0.25).astype(np.int64)}
    assert small_j.sum() < len(voxels)


@pytest.mark.parametrize("x_cols", [4, 64])
def test_colpad_sort_layout_equal(x_cols):
    p, v = _scene(0, 4096)
    ref = jgrid.grid_sort_colpad_traced(jnp.asarray(p), jnp.asarray(v), 0.3, N_CELLS,
                                        x_cols_pad=x_cols)
    got = tgrid.grid_sort_colpad_traced(_t(p), _t(v), 0.3, N_CELLS, x_cols_pad=x_cols)
    names = ("pts_pad_T", "valid_pad", "ids_pad", "slot_of_orig", "mins", "dims", "cell",
             "dims0_ideal")
    for name, a, b in zip(names, ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    # The node computes the candidates once and passes them on.
    cand = tgrid.cell_candidates(_t(p), _t(v), 0.3, N_CELLS)
    assert int(got[7]) == int(tgrid.colpad_dims0_ideal(cand))
    again = tgrid.grid_sort_colpad_traced(_t(p), _t(v), 0.3, N_CELLS, x_cols_pad=x_cols,
                                          candidates=cand)
    for name, a, b in zip(names, got, again):
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=name)


def _slab_layouts():
    """(name, pts_T, valid, ids, dims) sorted layouts: column-aligned at
    two column bounds, and the plain cell sort, whose tiles straddle
    columns."""
    p, v = _scene(1, 4096)
    out = []
    for x_cols in (8, 64):
        a = jgrid.grid_sort_colpad_traced(jnp.asarray(p), jnp.asarray(v), 0.3, N_CELLS,
                                          x_cols_pad=x_cols)
        out.append(("colpad%d" % x_cols, a[0], a[1], a[2], a[5]))
    a = jgrid.grid_sort_traced(jnp.asarray(p), jnp.asarray(v), 0.3, N_CELLS, sort_axes=True)
    out.append(("straddling", a[0], a[1], a[2], a[5]))
    return out


def test_slab_window_moments_plain_matches_jax():
    """Mean on valid slots, comps on slots with >= 2 members (a lone member
    divides the rounding residue of the one-pass sums by the 1e-6
    normaliser), w_sum everywhere; rtol 1e-9, atol 1e-12."""
    straddles = 0
    for name, pts_T, valid, ids, dims in _slab_layouts():
        mean, comps, w_sum, widths = jslab.slab_window_moments(pts_T, valid, ids, dims, 0.09,
                                                               4096, N_CELLS)
        pts_t, val_t, ids_t, dims_t = (_t(np.asarray(x)) for x in (pts_T, valid, ids, dims))
        lo, width, ctr, has = tslab.slab_tile_spans(pts_t, val_t, ids_t, dims_t, N_CELLS)
        out = tslab.slab_window_moments_plain(pts_t, val_t, lo, width, ctr, 0.09)
        val = np.asarray(valid)
        many = np.asarray(w_sum) >= 2
        np.testing.assert_allclose(out[0:3].numpy()[:, val], np.asarray(mean)[:, val],
                                   rtol=1e-9, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(out[3:9].numpy()[:, many], np.stack(comps)[:, many],
                                   rtol=1e-9, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(out[9].numpy(), np.asarray(w_sum), rtol=1e-9, atol=1e-12,
                                   err_msg=name)
        np.testing.assert_array_equal(width.amax(1).numpy(), np.asarray(widths), err_msg=name)
        # The full entry point agrees with its parts.
        m2, c2, w2, _ = tslab.slab_window_moments(pts_t, val_t, ids_t, dims_t, 0.09, N_CELLS)
        np.testing.assert_array_equal(torch.cat([m2, torch.stack(c2), w2[None]]).numpy(),
                                      out.numpy())
        straddles += int((has & (width[:, 1:] == 0).all(1) & (width[:, 0] > 0)).sum())
    assert straddles > 0  # the straddling layout took the whole-slab range


# K 88 and 168 (the shadow filter's k_dir, prep's global top-168) take
# the kernel's warp-a-row grouping on the card.
@pytest.mark.parametrize("k", [8, 32, 88, 168])
def test_gather_moments_plain_matches_jax(k):
    rng = np.random.default_rng(k)
    pts = rng.normal(size=(3000, 3))
    idx = rng.integers(0, 3000, (1500, k))
    idx[rng.uniform(size=idx.shape) < 0.2] = -1
    w = np.where(idx >= 0, rng.uniform(0.5, 1.5, idx.shape), 0.0)
    w[:3] = 0.0  # rows with no weight
    mean, comps, w_sum = jfeatures._moments_impl(jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(w))
    m, c, ws = tfeatures.gather_moments(_t(pts), _t(idx), _t(w))
    np.testing.assert_allclose(m.numpy(), np.asarray(mean), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.stack(comps), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ws.numpy(), np.asarray(w_sum), rtol=1e-9, atol=1e-12)


def test_radius_neighbors_same_sets():
    p, v = _scene(2, 5000, flat=0.3, extent=2.0)
    _, ref = jknn.radius_neighbors(jnp.asarray(p), jnp.asarray(p), r=0.3, k=16,
                                   valid_points=jnp.asarray(v), valid_query=jnp.asarray(v))
    d, got = tknn.radius_neighbors(_t(p), _t(p), r=0.3, k=16, valid_points=_t(v),
                                   valid_query=_t(v))
    ref = np.sort(np.asarray(ref), 1)
    np.testing.assert_array_equal(np.sort(got.numpy(), 1), ref)
    assert got.dtype == torch.int32 and (ref >= 0).sum(1).max() == 16  # the cap binds
    assert torch.isinf(d[got < 0]).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cloud_from_structured_and_pad_match_jax(dtype):
    """The node's input: a structured scan (x/y/z, viewpoints, normals, a
    zero-depth point) padded with invalid zero rows."""
    from depth_correction_tpu_torch.datasets.synthetic import make_structured

    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (700, 3))
    vps = np.tile(rng.uniform(-1, 1, 3), (700, 1))
    pts[5] = vps[5]  # zero depth: zero direction, still valid
    normals = rng.normal(size=(700, 3))
    scan = make_structured(pts, normals=normals, vps=vps)
    ref = JCloud.from_structured_array(scan, dtype=getattr(jnp, dtype)).pad(1024)
    got = TCloud.from_structured_array(scan, dtype=getattr(torch, dtype)).pad(1024)
    for name in ("vps", "dirs", "depth", "valid", "normals"):
        a, b = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(b, a, rtol=1e-6 if dtype == "float32" else 1e-12,
                                   atol=0, err_msg=name)
    assert got.valid[:700].all() and not got.valid[700:].any()
    assert float(got.depth[5]) == 0.0 and not got.dirs[5].any()
