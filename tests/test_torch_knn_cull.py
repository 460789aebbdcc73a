"""The host model of kernel X3's cell order and tile cull
(``depth_correction_tpu_torch/scripts/knn_cull.py``) on the CPU: the cull
keeps every tile that holds a within-r pair (seeded clouds, points one
float32 ulp either side of the radius from a box corner, duplicates), and
ordering points and queries by the cell key changes no result of the
plain twins once each row and index is mapped back. No JAX here.
"""
import numpy as np
import pytest
import torch

from depth_correction_tpu_torch.ops import knn as tknn
from depth_correction_tpu_torch.scripts import knn_cull as kc


def _cloud(seed, n, dup=0, quantum=0.0, invalid=0.1):
    """Half a noisy plane, half a volume, in random order; ``dup`` rows
    repeat earlier points, ``quantum`` snaps to a grid (exact d2 ties)."""
    rng = np.random.default_rng(seed)
    n1 = n // 2
    p = np.vstack([np.c_[rng.uniform(-3, 3, (n1, 2)), 0.01 * rng.standard_normal(n1)],
                   rng.uniform(-3, 3, (n - n1, 3)) * [1.0, 1.0, 0.3]]) + [4.0, -2.0, 1.0]
    if dup:
        p[-dup:] = p[rng.integers(0, n - dup, dup)]
    if quantum:
        p = np.round(p / quantum) * quantum
    p = p[rng.permutation(n)].astype(np.float32)
    return p, rng.uniform(size=n) >= invalid


def _at_radius(q, u, r):
    """The two points one float32 ulp apart across the radius near
    q + r u: the last whose float32 d2 to q (the pair test's operations)
    is at most r2 and the first beyond it, walking the first non-zero
    coordinate of u ulp by ulp outwards (d2 == r2 exactly where a step
    lands on it)."""
    r2 = np.float32(r) ** 2
    a = int(np.flatnonzero(np.asarray(u) != 0)[0])
    out = np.float32(np.inf) if u[a] > 0 else np.float32(-np.inf)
    p = (q + np.float32(r) * np.asarray(u, np.float32)).astype(np.float32)
    while kc.d2_f32(q[None], p[None])[0, 0] > r2:
        p[a] = np.nextafter(p[a], -out)
    while True:
        nxt = p.copy()
        nxt[a] = np.nextafter(p[a], out)
        if kc.d2_f32(q[None], nxt[None])[0, 0] > r2:
            return [p, nxt]
        p = nxt


def _corner_cloud(seed, r):
    """Adversarial: clusters of queries, and around each cluster's box
    corners (each a point of the cluster) points whose float32 d2 to the
    corner is r2 or one ulp either side, along an axis and along
    diagonals, so members sit exactly at the radius."""
    rng = np.random.default_rng(seed)
    pts = []
    for c in rng.uniform(-20, 20, (30, 3)).astype(np.float32):
        cluster = c + rng.uniform(0, 0.2, (40, 3)).astype(np.float32)
        lo, hi = cluster.min(0), cluster.max(0)
        pts += [cluster, lo[None], hi[None]]
        for corner, sign in ((lo, -1.0), (hi, 1.0)):
            for u in (np.eye(3).tolist() + [[0.6, 0.8, 0.0], [0.0, 0.6, 0.8],
                                            [2 / 3, 2 / 3, 1 / 3]]):
                pts += [p[None] for p in _at_radius(corner, sign * np.asarray(u), r)]
    p = np.vstack(pts).astype(np.float32)
    return p[rng.permutation(len(p))], np.ones(len(p), bool)


def _member_chunks(q_sorted, active, p_sorted, p_valid, r, block_q):
    """(B, C) bool: the (block, chunk) pairs holding a within-r pair, by
    brute force in the pair test's float32 operations."""
    d2 = kc.d2_f32(q_sorted, p_sorted)
    inside = (d2 <= np.float32(r) ** 2) & active[:, None] & p_valid[None, :]
    nb = -(-len(q_sorted) // block_q)
    nc = -(-len(p_sorted) // kc.TILE) * (kc.TILE // kc.CHUNK)
    out = np.zeros((nb, nc), bool)
    rows, cols = np.nonzero(inside)
    out[rows // block_q, cols // kc.CHUNK] = True
    return out, int(inside.sum())


CLOUDS = {
    "plane_volume": lambda: (*_cloud(0, 3000), 0.3),
    "duplicates": lambda: (*_cloud(1, 2500, dup=800), 0.25),
    "snapped": lambda: (*_cloud(2, 2500, quantum=0.125), 0.25),
    "corners_r025": lambda: (*_corner_cloud(3, 0.25), 0.25),
    "corners_r0017": lambda: (*_corner_cloud(4, 0.0174528), 0.0174528),
}


@pytest.mark.parametrize("k,queries", [(0, "every_row"), (32, "valid"), (88, "valid"),
                                       (32, "every_row")])
@pytest.mark.parametrize("name", list(CLOUDS))
def test_cull_keeps_every_member(name, k, queries):
    """Every (block, chunk) pair with a within-r pair is kept by both steps
    of the cull; the cull also drops some, and each step keeps a subset of
    what the step before kept."""
    pts, valid, r = CLOUDS[name]()
    # The launcher's one order for points that query themselves, keyed by
    # the active queries: every row for the counts and for a top-k without
    # query validity, the valid ones for a top-k whose queries are the valid
    # points.
    active = np.ones(len(pts), bool) if queries == "every_row" else valid
    order = kc.cell_order(pts, active, r)
    qs, qa = pts[order], active[order]
    ps, pv = pts[order], valid[order]
    tiles, near, chunks = kc.cull_masks(qs, qa, ps, pv, r)
    need, members = _member_chunks(qs, qa, ps, pv, r, kc.BLOCK_Q)
    assert members > 0
    assert not (need & ~chunks).any()
    assert not (chunks & ~near).any()
    per = kc.TILE // kc.CHUNK
    assert not (near.reshape(*tiles.shape, per).any(2) & ~tiles).any()
    assert tiles.sum() < tiles.size and chunks.sum() < tiles.sum() * per
    stats = kc.cull_stats(pts, valid, r, k, q_valid=None if queries == "every_row" else valid)
    assert stats["members"] == members
    assert stats["kept_pairs"] <= stats["all_pairs"]
    if k:
        # Every member enters a list that never fills; fewer enter one that
        # does (the dense corner clusters at k = 32).
        assert stats["insertions"] <= members
        assert (stats["insertions"] == members) == (stats["max_count"] <= k)


@pytest.mark.parametrize("r", [0.25, 0.0174528, 1.0])
def test_box_corner_at_the_radius(r):
    """A tile whose one valid point lies at float32 d2 <= r2 from the
    block box's corner query, one coordinate ulp from leaving the radius,
    is kept (the pair just beyond is no member)."""
    rng = np.random.default_rng(7)
    q = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    corner = q.max(0)
    q[0] = corner
    r2 = np.float32(r) ** 2
    seen = set()
    for u in np.eye(3).tolist() + [[0.6, 0.8, 0.0], [0.0, 0.6, 0.8], [2 / 3, 2 / 3, 1 / 3]]:
        for p in _at_radius(corner, u, r):
            d2 = kc.d2_f32(q, p[None]).min()
            tile = np.zeros((kc.TILE, 3), np.float32)
            tile[0] = p
            valid = np.zeros(kc.TILE, bool)
            valid[0] = True
            tiles, _, chunks = kc.cull_masks(q, np.ones(64, bool), tile, valid, r, 64)
            kept = tiles[0, 0] and chunks[0, 0]
            if d2 <= r2:
                assert kept, (u, d2, r2)
            seen.add(float(np.sign(d2 - r2)))
    assert 1.0 in seen and seen & {-1.0, 0.0}


def test_box_distance_is_at_most_every_pair_distance():
    """The box test's distance never exceeds the float32 d2 of a pair taken
    from the two boxes, also for points one ulp from the box faces."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        q = rng.uniform(-3, 3, (8, 3)).astype(np.float32)
        p = (rng.uniform(-3, 3, (1, 3)) + rng.uniform(-0.5, 0.5, (8, 3))).astype(np.float32)
        p[0] = np.nextafter(q.max(0), np.float32(np.inf))
        p[1] = np.nextafter(q.min(0), np.float32(-np.inf))
        qlo, qhi = kc.boxes(q, np.ones(8, bool), 8)
        plo, phi = kc.boxes(p, np.ones(8, bool), 8)
        assert kc.box_d2_f32(qlo, qhi, plo, phi)[0, 0] <= kc.d2_f32(q, p).min()


def test_empty_boxes_keep_nothing():
    """A block without an active query, or a tile without a valid point,
    reads nothing."""
    pts, valid, r = CLOUDS["plane_volume"]()
    tiles, _, chunks = kc.cull_masks(pts[:200], np.zeros(200, bool), pts, valid, r, 64)
    assert not tiles.any() and not chunks.any()
    tiles, _, chunks = kc.cull_masks(pts, np.ones(len(pts), bool), pts[:300],
                                     np.zeros(300, bool), r, 64)
    assert not tiles.any() and not chunks.any()


def test_cell_keys_interleave_bits_and_put_invalid_last():
    """The key interleaves the cell coordinates' bits x, y, z from the
    lowest; invalid rows get the largest key and sort last, equal keys
    keep their index order."""
    rng = np.random.default_rng(6)
    c = rng.integers(0, 2 ** 10, (50, 3))
    want = np.zeros(50, np.int64)
    for b in range(10):
        for a in range(3):
            want |= ((c[:, a] >> b) & 1) << (3 * b + a)
    got = kc._spread(c[:, 0]) | (kc._spread(c[:, 1]) << 1) | (kc._spread(c[:, 2]) << 2)
    np.testing.assert_array_equal(got, want)
    pts, valid, r = CLOUDS["duplicates"]()
    keys = kc.cell_keys(pts, valid, r)
    assert (keys[~valid] == kc.INVALID_KEY).all() and (keys[valid] < kc.INVALID_KEY).all()
    order = kc.cell_order(pts, valid, r)
    assert valid[order[:valid.sum()]].all()
    ks = keys[order]
    assert (np.diff(ks) >= 0).all()
    same = ks[1:] == ks[:-1]
    assert (order[1:][same] > order[:-1][same]).all()


def _sorted_plain(pts, valid, q, qv, r, k):
    """The plain twin on points and queries in cell order, each row and
    index mapped back to the original positions (rows re-sorted by
    (d2, original index), the kernel's key)."""
    po = kc.cell_order(pts, valid, r)
    qo = kc.cell_order(q, qv if k else np.ones(len(q), bool), r)
    r2 = torch.tensor(np.float32(r) ** 2)
    P, V = torch.as_tensor(pts[po]), torch.as_tensor(valid[po])
    Q, QV = torch.as_tensor(q[qo]), torch.as_tensor(qv[qo])
    inv = np.argsort(qo)
    if k == 0:
        return tknn._counts_plain(P, Q, V, r2).numpy()[inv]
    d2, idx = (x.numpy()[inv] for x in tknn._knn_plain(P, Q, V, QV, r2, k))
    idx = np.where(idx >= 0, po[np.maximum(idx, 0)], -1)
    rows = np.lexsort((np.where(idx >= 0, idx, np.iinfo(np.int64).max), d2), axis=1)
    return np.take_along_axis(d2, rows, 1), np.take_along_axis(idx, rows, 1)


@pytest.mark.parametrize("name,k", [("plane_volume", 8), ("plane_volume", 64),
                                    ("duplicates", 0), ("duplicates", 160),
                                    ("snapped", 0), ("snapped", 160), ("corners_r025", 24)])
def test_cell_order_then_plain_equals_unsorted_plain(name, k):
    """Sorting points and queries by the cell key, the plain twin, then
    mapping back: counts equal, index tables equal and d2 bit for bit.
    With exact ties (duplicates, snapped points) k holds every member, so
    no tie falls at the cut (the sorted run breaks ties by sorted position,
    the kernel by original index)."""
    pts, valid, r = CLOUDS[name]()
    q, qv = pts[::2].copy(), valid[::2].copy()
    r2 = torch.tensor(np.float32(r) ** 2)
    P, V, Q, QV = map(torch.as_tensor, (pts, valid, q, qv))
    if k == 0:
        np.testing.assert_array_equal(_sorted_plain(pts, valid, q, qv, r, 0),
                                      tknn._counts_plain(P, Q, V, r2).numpy())
        return
    wd, wi = tknn._knn_plain(P, Q, V, QV, r2, k)
    if name != "plane_volume" and name != "corners_r025":
        assert int(tknn._counts_plain(P, Q, V, r2).max()) <= k
    gd, gi = _sorted_plain(pts, valid, q, qv, r, k)
    np.testing.assert_array_equal(gi, wi.numpy())
    np.testing.assert_array_equal(gd.view(np.int32), wd.numpy().view(np.int32))


# The nearest search (k = 1, no radius): the host model of its order, seed
# and cull (knn_cull.nearest_cull) against the all-pairs search.

def _nearest_brute(pts, valid, q, q_valid=None):
    """(d2 (Q,) float32, idx (Q,) int64): the least key (d2, index) over the
    valid points whose float32 d2 is a number, by testing every pair; -1 /
    inf where there is none or the query is invalid."""
    d2 = kc.d2_f32(q, np.where(valid[:, None], pts, np.float32(np.nan)))
    top = np.iinfo(np.uint64).max
    keys = (d2.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | np.arange(len(pts), dtype=np.uint64)[None, :]
    keys = np.where(d2 <= np.float32(np.inf), keys, top)
    best = keys.min(1, initial=top)
    if q_valid is not None:
        best = np.where(q_valid, best, top)
    found = best != top
    return (np.where(found, (best >> np.uint64(32)).astype(np.uint32).view(np.float32),
                     np.float32(np.inf)),
            np.where(found, (best & np.uint64(0xFFFFFFFF)).astype(np.int64), -1))


def _nearest_equidistant():
    """Points on a 0.25 m grid (exact in float32) and queries at the
    midpoints of grid neighbours, so each query has two points at the same
    d2; many such pairs lie in different tiles of the cell order."""
    rng = np.random.default_rng(11)
    g = np.stack(np.meshgrid(np.arange(24), np.arange(24), np.arange(6), indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32) * np.float32(0.25)
    pts = g[rng.permutation(len(g))]
    pick = pts[rng.integers(0, len(pts), 2500)]
    axis = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 2500)] * np.float32(0.125)
    return pts, np.ones(len(pts), bool), (pick + axis).astype(np.float32), None


def _nearest_slam_padding():
    """The rows a SLAM step searches: the target scan placed at its
    estimate, its filtered rows and its zero padding invalid (the padding at
    the scan's sensor), and every row of the next scan as a query, its
    padding rows all at that scan's sensor position."""
    pts, valid = _cloud(12, 3000, invalid=0.08)
    pts[-200:] = np.float32([1.0, 2.0, 0.5])
    valid[-200:] = False
    q, _ = _cloud(13, 3000)
    q = (q + np.float32([0.03, -0.02, 0.01])).astype(np.float32)
    q[-300:] = np.float32([1.5, 2.0, 0.5])
    return pts, valid, q, None


def _nearest_invalid_nan():
    pts, valid = _cloud(14, 2500, invalid=0.3)
    q, _ = _cloud(15, 2000)
    q[::9, 1] = np.nan
    q[5::31] = np.nan
    q_valid = np.random.default_rng(16).uniform(size=len(q)) > 0.2
    return pts, valid, q, q_valid


def _nearest_single_valid():
    pts, _ = _cloud(17, 2000)
    valid = np.zeros(len(pts), bool)
    valid[1234] = True
    q, _ = _cloud(18, 700)
    return pts, valid, q, None


def _nearest_outliers():
    pts, valid = _cloud(19, 3000)
    q, _ = _cloud(20, 2000)
    rng = np.random.default_rng(21)
    far = rng.choice(len(q), 300, replace=False)
    q[far] = (q[far] * np.float32(40.0) + np.float32(1e3) * rng.standard_normal((300, 3))
              ).astype(np.float32)
    return pts, valid, q, None


def _nearest_outside_box():
    pts, valid = _cloud(22, 3000)
    q, _ = _cloud(23, 2000)
    q[:1000] += np.float32([9.0, 0.0, 0.0])
    q[1000:1500] -= np.float32([0.0, 0.0, 4.0])
    return pts, valid, q.astype(np.float32), None


def _nearest_duplicates():
    pts, valid = _cloud(24, 3000, dup=900, quantum=0.125)
    q, _ = _cloud(25, 2500, quantum=0.0625)
    return pts, valid, q, None


def _nearest_empty_slab():
    """A plane of points with an empty slab 3 m wide across its middle and
    queries inside the slab: their nearest points lie beyond 16 cells, so
    their warps walk in sweeps of a growing reach (some queries also fall
    in the point order beside points metres from them)."""
    rng = np.random.default_rng(27)
    p = np.c_[rng.uniform(0, 10, (6000, 2)), 0.01 * rng.standard_normal(6000)]
    p = p[np.abs(p[:, 0] - 5.0) > 1.5].astype(np.float32)
    q = np.c_[rng.uniform(3.5, 6.5, 800), rng.uniform(0, 10, 800),
              0.01 * rng.standard_normal(800)].astype(np.float32)
    return p, np.ones(len(p), bool), q, None


NEAREST_CASES = {
    "empty_slab": _nearest_empty_slab,
    "outliers": _nearest_outliers,
    "duplicates": _nearest_duplicates,
    "equidistant_tiles": _nearest_equidistant,
    "invalid_points_nan_queries": _nearest_invalid_nan,
    "single_valid_point": _nearest_single_valid,
    "outside_the_box": _nearest_outside_box,
    "slam_padding": _nearest_slam_padding,
}


@pytest.mark.parametrize("name", list(NEAREST_CASES))
def test_nearest_cull_equals_all_pairs(name):
    """The model's nearest keys equal the all-pairs search's and the plain
    twin's (k = 1, no radius) bit for bit: the seed's limits and the cull by
    them skip no point whose key is below a query's limit, ties go to the
    lower index, and an invalid or NaN query finds nothing. The cull reads
    fewer tiles than all."""
    pts, valid, q, qv = NEAREST_CASES[name]()
    got = kc.nearest_cull(pts, valid, q, qv)
    want_d2, want_idx = _nearest_brute(pts, valid, q, qv)
    np.testing.assert_array_equal(got["idx"], want_idx)
    np.testing.assert_array_equal(got["d2"].view(np.int32), want_d2.view(np.int32))
    pd2, pidx = tknn._knn_plain(torch.as_tensor(pts), torch.as_tensor(q), torch.as_tensor(valid),
                                None if qv is None else torch.as_tensor(qv),
                                torch.tensor(np.float32(np.inf)), 1)
    np.testing.assert_array_equal(pidx[:, 0].numpy(), want_idx)
    np.testing.assert_array_equal(pd2[:, 0].numpy().view(np.int32), want_d2.view(np.int32))
    busy = got["seed_tiles"] > 0
    assert (got["tiles_read"][~busy] == 0).all()
    assert got["tiles_read"].sum() < busy.sum() * got["tiles"]
    assert ((got["sweeps"] >= 1) == busy).all() and got["sweeps"].max() <= kc.SWEEPS
    if name == "empty_slab":
        assert (got["sweeps"] > 1).any()


def test_nearest_cull_ties_span_tiles():
    """The equidistant case holds what it is for: queries whose two nearest
    points, at equal d2, lie in different tiles of the point order, where
    the lower original index wins."""
    pts, valid, q, _ = _nearest_equidistant()
    d2 = kc.d2_f32(q, pts)
    least = d2.min(1)
    pk, _ = kc.nearest_keys(pts, valid, q)
    pos = np.empty(len(pts), np.int64)
    pos[np.argsort(pk, kind="stable")] = np.arange(len(pts))
    spans = 0
    for i in np.flatnonzero((d2 == least[:, None]).sum(1) >= 2):
        tiles = np.unique(pos[np.flatnonzero(d2[i] == least[i])] // kc.TILE)
        spans += len(tiles) >= 2
    assert spans >= 50
    got = kc.nearest_cull(pts, valid, q)
    np.testing.assert_array_equal(got["idx"], np.argmax(d2 == least[:, None], axis=1))


def test_nearest_keys_share_the_points_grid():
    """Queries are keyed on the points' grid: a query at a point's place
    takes its key, one outside the points' box falls in an edge cell, and an
    invalid or NaN row takes the invalid key."""
    pts, valid = _cloud(26, 500)
    q = np.vstack([pts[:50], pts[:5] + np.float32(100.0), pts[:5] - np.float32(100.0),
                   np.full((2, 3), np.nan, np.float32)]).astype(np.float32)
    pk, qk = kc.nearest_keys(pts, valid, q)
    np.testing.assert_array_equal(qk[:50], np.where(valid[:50], pk[:50], qk[:50]))
    top = kc._spread(np.full(1, 127)) * 7
    np.testing.assert_array_equal(qk[50:55], np.full(5, top[0]))
    np.testing.assert_array_equal(qk[55:60], np.zeros(5))
    assert (qk[60:] == kc.INVALID_KEY).all() and (pk[~valid] == kc.INVALID_KEY).all()
    _, qk = kc.nearest_keys(pts, valid, q, np.zeros(len(q), bool))
    assert (qk == kc.INVALID_KEY).all()


def test_nearest_cull_reads_a_few_tiles_of_a_scan_pair():
    """box_r25's first two scans in the world frame (the benchmark's scene
    on the CPU, ~62k points and ~64k queries): the seeded cull reads under
    5% of the (warp, tile) pairs, where the search without a bound reads
    them all."""
    import json
    import os

    from benchmark.scene import open_box

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "box_r25.json")) as f:
        scene = json.load(f)["scene"]
    (s0, T0), (s1, T1) = open_box(scene, 2 ** 33 + 12345, "cpu", ids=[0, 1])

    def world(s, T):
        p = np.stack([s["x"], s["y"], s["z"]], 1)
        return (p @ T[:3, :3].T + T[:3, 3]).astype(np.float32)

    pts, q = world(s0, T0), world(s1, T1)
    stats = kc.nearest_cull_stats(pts, np.ones(len(pts), bool), q)
    assert stats["tiles"] == -(-len(pts) // kc.TILE) and stats["warps"] == -(-len(q) // 32)
    assert stats["pair_share"] < 0.05, stats
    assert stats["tiles_per_warp"] >= 3
