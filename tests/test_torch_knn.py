"""The port's brute-force search (``ops/knn.py``, kernel X3's plain twin on
the CPU) and the mutual trimming of capped graphs
(``preproc.symmetrize_neighbors``) against the JAX package, on the same
seeded numpy inputs.

In float64 the index tables are equal, order included (ties keep the lower
index, as ``lax.top_k`` does), and distances agree to 1e-12 relative; the
cases cover k above and below the largest within-r count, no radius,
invalid points, duplicated points and points snapped to a grid (exact ties
in d2). In float32 the neighbour sets are equal except pairs within 1e-6 r
of the radius, where the two packages' roundings may decide differently.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from depth_correction_tpu.cloud import Cloud as JCloud
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.ops import knn as jknn
from depth_correction_tpu.preproc import establish_neighborhoods as j_establish
from depth_correction_tpu.preproc import symmetrize_neighbors as j_symmetrize
from depth_correction_tpu_torch.cloud import Cloud as TCloud
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.ops import knn as tknn
from depth_correction_tpu_torch.preproc import establish_neighborhoods as t_establish
from depth_correction_tpu_torch.preproc import symmetrize_neighbors as t_symmetrize


def _cloud(seed, n, dup=0, quantum=0.0, invalid=0.0):
    """Half a noisy plane, half a volume; ``dup`` rows repeat earlier
    points exactly, ``quantum`` snaps every point to a grid of that step,
    ``invalid`` marks that share of the points invalid. A power-of-two
    quantum keeps every coordinate, difference and d2 exact in float32 and
    float64, so equal distances are equal in any summation order and only
    the index breaks the tie (a decimal step would leave last-ulp
    differences that each package's rounding decides)."""
    rng = np.random.default_rng(seed)
    n1 = n // 2
    p = np.vstack([np.c_[rng.uniform(-2, 2, (n1, 2)), 0.01 * rng.standard_normal(n1)],
                   rng.uniform(-2, 2, (n - n1, 3)) * [1.0, 1.0, 0.4]]) + [5.0, -3.0, 1.0]
    if dup:
        p[-dup:] = p[rng.integers(0, n - dup, dup)]
    if quantum:
        p = np.round(p / quantum) * quantum
    valid = rng.uniform(size=n) >= invalid
    return p, valid


def _assert_same(ref, got, rtol=1e-12):
    (dj, ij), (dt, it) = ref, got
    assert it.shape == ij.shape and (it >= 0).any()
    np.testing.assert_array_equal(it, ij)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=rtol, atol=0)


@pytest.fixture(autouse=True)
def _small_query_chunks(monkeypatch):
    """The JAX package pads queries to chunks of 8192 rows, a memory bound
    that does not change its results; at these sizes its top_k over the
    padding would take most of this file's time on the CPU."""
    monkeypatch.setattr(jknn, "_QUERY_CHUNK", 2048)


# 2048 points: one tile of the JAX package's scan.
CASES = {
    # name: (cloud kwargs, k, r, query stride)
    "k_above_counts": (dict(seed=0, n=2048), 96, 0.35, 1),
    "k_below_counts": (dict(seed=1, n=2048), 8, 0.35, 1),
    "no_radius": (dict(seed=2, n=2048), 12, None, 1),
    "invalid_points": (dict(seed=3, n=2048, invalid=0.3), 32, 0.35, 2),
    "duplicates": (dict(seed=4, n=2048, dup=600), 24, 0.3, 1),
    "grid_ties": (dict(seed=5, n=2048, quantum=0.0625), 32, 0.3, 1),
    "grid_ties_no_radius": (dict(seed=6, n=2048, quantum=0.0625), 20, None, 3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_nearest_and_radius_neighbors_match_jax(name):
    kw, k, r, stride = CASES[name]
    p, valid = _cloud(**kw)
    q, qv = p[::stride], valid[::stride]
    dj, ij = jknn.nearest_neighbors(jnp.asarray(p), jnp.asarray(q), k=k, r=r,
                                    valid_points=jnp.asarray(valid),
                                    valid_query=jnp.asarray(qv))
    dt, it = tknn.nearest_neighbors(torch.as_tensor(p), torch.as_tensor(q), k=k, r=r,
                                    valid_points=torch.as_tensor(valid),
                                    valid_query=torch.as_tensor(qv))
    _assert_same((np.asarray(dj), np.asarray(ij)), (dt.numpy(), it.numpy()))
    assert it.dtype == torch.int32
    if r is not None:
        # radius_neighbors is the same search; the counts say whether k cut.
        d2, i2 = tknn.radius_neighbors(torch.as_tensor(p), torch.as_tensor(q), r=r, k=k,
                                       valid_points=torch.as_tensor(valid),
                                       valid_query=torch.as_tensor(qv))
        assert torch.equal(i2, it) and torch.equal(d2, dt)
        counts = tknn.neighbor_counts(torch.as_tensor(p), torch.as_tensor(q), r,
                                      torch.as_tensor(valid)).numpy()
        largest = int(counts[qv].max())
        if name in ("k_above_counts", "k_below_counts"):
            assert (largest > k) == (name == "k_below_counts"), largest
    if name.startswith("grid_ties") or name == "duplicates":
        # Ties in d2 really occur among the kept neighbours.
        d = dt.numpy()
        same = (d[:, 1:] == d[:, :-1]) & np.isfinite(d[:, 1:])
        assert same.any()


@pytest.mark.parametrize("name", ["k_above_counts", "invalid_points", "duplicates",
                                  "grid_ties"])
def test_neighbor_counts_match_jax(name):
    kw, _, r, stride = CASES[name]
    p, valid = _cloud(**kw)
    q = p[::stride]
    cj = np.asarray(jknn.neighbor_counts(jnp.asarray(p), jnp.asarray(q), r=r,
                                         valid_points=jnp.asarray(valid)))
    ct = tknn.neighbor_counts(torch.as_tensor(p), torch.as_tensor(q), r=r,
                              valid_points=torch.as_tensor(valid))
    assert ct.dtype == torch.int32
    np.testing.assert_array_equal(ct.numpy(), cj)
    assert tknn.suggest_k_max(torch.as_tensor(p), torch.as_tensor(q), r=r,
                              valid_points=torch.as_tensor(valid)) == \
        jknn.suggest_k_max(jnp.asarray(p), jnp.asarray(q), r=r, valid_points=jnp.asarray(valid))


def test_plain_flag_is_the_cpu_path():
    """On CPU tensors the wrappers already run the twins: ``plain`` changes
    nothing."""
    p, valid = _cloud(7, 1500, invalid=0.2)
    t, v = torch.as_tensor(p), torch.as_tensor(valid)
    a = tknn.knn_d2(t, t, 16, 0.3, v, v)
    b = tknn.knn_d2(t, t, 16, 0.3, v, v, plain=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(tknn.neighbor_counts(t, r=0.3, valid_points=v),
                       tknn.neighbor_counts(t, r=0.3, valid_points=v, plain=True))


def test_float32_sets_match_jax_up_to_the_boundary():
    p, valid = _cloud(8, 2048)
    p = p.astype(np.float32)
    r = 0.3
    _, ij = jknn.radius_neighbors(jnp.asarray(p), r=r, k=96, valid_points=jnp.asarray(valid))
    _, it = tknn.radius_neighbors(torch.as_tensor(p), r=r, k=96,
                                  valid_points=torch.as_tensor(valid))
    p64 = p.astype(np.float64)
    differ = 0
    for i, (a, b) in enumerate(zip(np.asarray(ij), it.numpy())):
        for j in set(int(x) for x in a if x >= 0) ^ set(int(x) for x in b if x >= 0):
            differ += 1
            assert abs(np.linalg.norm(p64[i] - p64[j]) - r) <= 1e-6 * r
    assert (it >= 0).sum() > 10 * len(p)
    assert differ <= 10


def test_symmetrize_matches_jax_on_a_capped_graph():
    """A K = 8 radius graph of a dense cloud (most rows hold more than 8
    within r): the mutual trimming keeps the same pairs in both packages,
    chunked or not."""
    p, valid = _cloud(9, 2048, dup=200)
    _, idx = jknn.radius_neighbors(jnp.asarray(p), r=0.35, k=8, valid_points=jnp.asarray(valid),
                                   valid_query=jnp.asarray(valid))
    idx = np.asarray(idx)
    want = np.asarray(j_symmetrize(jnp.asarray(idx)))
    got = t_symmetrize(torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_symmetrize(torch.as_tensor(idx), chunk=97).numpy(), want)
    dropped = (idx >= 0).sum() - (want >= 0).sum()
    assert dropped > 0.05 * (idx >= 0).sum()


@pytest.mark.parametrize("backend", [None, "scipy"])
def test_capped_establishment_matches_jax(backend):
    """establish_neighborhoods on a capped radius config (nn_max_neighbors
    = 12, nn_symmetrize by default): the brute search (or scipy) and the
    mutual trimming give the JAX package's tables and weights."""
    p, valid = _cloud(10, 2048, invalid=0.1)

    def cfg(cls):
        c = cls()
        c.nn_r, c.nn_k, c.nn_max_neighbors, c.nn_backend = 0.35, 0, 12, backend
        return c

    jc = JCloud.from_points(jnp.asarray(p)).replace(valid=jnp.asarray(valid))
    tc = TCloud.from_points(torch.as_tensor(p), valid=torch.as_tensor(valid))
    nj, wj = j_establish(jc, cfg(JConfig))
    nt, wt = t_establish(tc, cfg(TConfig))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert (nt.numpy() >= 0).sum(1).max() <= 12
