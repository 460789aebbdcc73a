"""The host model of kernel X1's warp cull
(``depth_correction_tpu_torch/scripts/slab_cull.py``) and a numpy model of
kernel X2's neighbour-list policy (``csrc/grid_query.cu``), on the CPU.

X1: the cull keeps every member on seeded slab layouts, on entries at
exactly d2 = r2 (and one float32 ulp outside) from a corner row of a
warp's box, and when a warp's rows are all padding; it keeps at most the
pair tests made without it. X2: appending while the list has room, sorting
once at the end or at the first overflow (runs of 32, then merges by
rank) and merging after it gives the stable sort of the members truncated
to k, for k below and above the count; the warp sorts, the merges and the
register list's bitonic merge are modelled lane by lane as the kernel runs
them. No JAX here.
"""
import numpy as np
import pytest
import torch

from depth_correction_tpu_torch.ops import slabwin as tslab
from depth_correction_tpu_torch.ops.grid_hash import grid_sort_colpad_traced
from depth_correction_tpu_torch.scripts import slab_cull as sc

N_CELLS = 1 << 21
PAD = np.float32(1e15)  # the colpad sort's padding slots


def _seeded_layout(seed, n, r, plane_frac=0.5, invalid=0.1):
    """A column-aligned slab layout of a noisy plane and a volume."""
    rng = np.random.default_rng(seed)
    n1 = int(n * plane_frac)
    p = np.vstack([np.c_[rng.uniform(-3, 3, (n1, 2)), 0.01 * rng.standard_normal(n1)],
                   rng.uniform(-3, 3, (n - n1, 3)) * [1.0, 1.0, 0.3]]) + [12.0, -7.0, 1.5]
    pts = torch.as_tensor(p, dtype=torch.float32)
    valid = torch.as_tensor(rng.uniform(size=n) >= invalid)
    pts_T, val, ids, _, _, dims, _, _ = grid_sort_colpad_traced(pts, valid, r, N_CELLS,
                                                                x_cols_pad=32)
    lo, width, ctr, _ = tslab.slab_tile_spans(pts_T, val, ids, dims, N_CELLS)
    return pts_T, val, lo, width, ctr


def _members_kept(pts_T, valid, lo, width, ctr, r2):
    """Asserts that every warp keeps every entry within r2 of one of its
    valid rows (the pair test's float32 operations); returns the members
    counted per chunk."""
    r2 = np.float32(r2)
    members = 0
    for tiles, v, qv, e, ev, kept in sc.cull_windows(pts_T, valid, lo, width, ctr, r2):
        d = e[:, :, None, :] - v[:, :, :, None]  # (3, c, TILE, W): fl(e - q)
        member = (sc.d2_f32(d[0], d[1], d[2]) <= r2) & qv[:, :, None] & ev[:, None, :]
        by_warp = member.reshape(len(tiles), sc.TILE // sc.WARP, sc.WARP, -1).any(2)
        assert not (by_warp & ~kept).any()
        members += int(member.sum())
    return members


@pytest.mark.parametrize("seed,n,r", [(0, 6016, 0.25), (1, 8960, 0.3), (2, 3072, 0.5),
                                      (3, 11904, 0.2)])
def test_cull_keeps_every_member_on_seeded_layouts(seed, n, r):
    """Every member of the plain version (its w_sum, float32) is kept, and
    the cull drops some of the pair tests made without it."""
    pts_T, val, lo, width, ctr = _seeded_layout(seed, n, r)
    members = _members_kept(pts_T, val, lo, width, ctr, r * r)
    plain = tslab.slab_window_moments_plain(pts_T, val, lo, width, ctr, r * r)
    assert members == int(plain[9].sum()) > 0
    kept, all_pairs, box = sc.cull_pair_tests(pts_T, val, lo, width, ctr, r * r)
    live = val.reshape(-1, sc.TILE).any(1)
    assert all_pairs == int((width.long().sum(1) * live).sum()) * sc.TILE
    assert members <= kept < all_pairs and box > 0


def _at_radius(q, u, r2):
    """The two float32 points one ulp apart across the radius from q along
    the direction u (non-negative steps): the last whose X1 d2 to q is at
    most r2 and the first beyond it, walked ulp by ulp on the first non-zero
    coordinate of u."""
    a = int(np.flatnonzero(np.asarray(u) != 0)[0])
    out = np.float32(np.inf) if u[a] > 0 else np.float32(-np.inf)

    def d2(p):
        d = (p - q).astype(np.float32)
        return sc.d2_f32(d[0], d[1], d[2])

    p = (q + np.float32(np.sqrt(r2)) * np.asarray(u, np.float32)).astype(np.float32)
    while d2(p) > r2:
        p[a] = np.nextafter(p[a], -out)
    while True:
        nxt = p.copy()
        nxt[a] = np.nextafter(p[a], out)
        if d2(nxt) > r2:
            return p, nxt
        p = nxt


def _centred_d2(e, q, ctr_offset):
    """X1's d2 between e and q on values centred at ``ctr_offset``."""
    c = np.float32(ctr_offset)
    return sc.d2_f32(*((e - c) - (q - c)))


def _corner_layout(seed, r, ctr_offset):
    """Tiles whose warps hold clusters of rows; around each warp's box
    corner (a row that is the minimum or maximum on every axis) entries at
    d2 = r2 exactly or one ulp outside, along an axis and along diagonals.
    The spans of every tile cover the whole entry table. Warp 1 of every
    cluster tile is all padding (1e15, invalid), and the last of the four
    has no valid row; the entries fill the tiles after them.
    ``ctr_offset`` is added to the tile centres, a power of two so that the
    tile-centred values stay exact."""
    rng = np.random.default_rng(seed)
    r2 = np.float32(r) ** 2
    n_tiles = 4
    rows = np.full((3, n_tiles * sc.TILE), PAD, np.float32)
    valid = np.zeros(n_tiles * sc.TILE, bool)
    entries, exact = [], []
    ctr = np.zeros((n_tiles, 3), np.float32) + np.float32(ctr_offset)
    for t in range(n_tiles - 1):
        for w in (0, 2, 3):
            base = (rng.uniform(-3, 3, 3) + ctr_offset).astype(np.float32)
            cluster = base + rng.uniform(0, 0.15, (sc.WARP, 3)).astype(np.float32)
            cluster[0] = base  # the box's low corner: a row
            cluster[1] = base + np.float32(0.15)  # and its high corner
            sl = slice(t * sc.TILE + w * sc.WARP, t * sc.TILE + (w + 1) * sc.WARP)
            rows[:, sl] = cluster.T
            valid[sl] = rng.uniform(size=sc.WARP) > 0.2
            valid[sl.start:sl.start + 2] = True
            lo_c, hi_c = cluster[0], cluster[1]
            for u in ([-1, 0, 0], [0, -1, 0], [0, 0, -1], [-1, -1, 0], [-1, -1, -1]):
                inside, outside = _at_radius(lo_c, np.asarray(u, np.float32) / np.linalg.norm(u),
                                             r2)
                entries += [inside, outside]
                exact.append(_centred_d2(inside, lo_c, ctr_offset) == r2)
            for u in ([1, 0, 0], [0, 1, 1], [1, 1, 1]):
                inside, outside = _at_radius(hi_c, np.asarray(u, np.float32) / np.linalg.norm(u),
                                             r2)
                entries += [inside, outside]
                exact.append(_centred_d2(inside, hi_c, ctr_offset) == r2)
    ent = np.asarray(entries, np.float32).T
    pts_T = np.concatenate([rows, ent], 1)
    pad = -pts_T.shape[1] % sc.TILE
    pts_T = np.concatenate([pts_T, np.full((3, pad), PAD, np.float32)], 1)
    valid = np.concatenate([valid, np.ones(ent.shape[1], bool), np.zeros(pad, bool)])
    t_all = pts_T.shape[1] // sc.TILE
    ctr = np.concatenate([ctr, np.zeros((t_all - n_tiles, 3), np.float32)])
    lo = np.zeros((t_all, 3), np.int32)
    width = np.zeros((t_all, 3), np.int32)
    start = n_tiles * sc.TILE
    third = ent.shape[1] // 3
    for t in range(t_all):  # three spans back to back over the entry table
        lo[t] = [start, start + third, start + 2 * third]
        width[t] = [third, third, ent.shape[1] - 2 * third]
    return (torch.as_tensor(pts_T), torch.as_tensor(valid), torch.as_tensor(lo),
            torch.as_tensor(width), torch.as_tensor(ctr), float(r2), int(np.sum(exact)))


@pytest.mark.parametrize("seed,r,ctr_offset", [(0, 0.25, 0.0), (1, 0.3, 0.0), (2, 0.25, 8.0),
                                               (3, 0.5, -16.0)])
def test_cull_keeps_members_at_the_radius(seed, r, ctr_offset):
    """Entries at exactly d2 = r2 from a box corner row are members and are
    kept; all-padding warps and the tile without a valid row keep nothing."""
    pts_T, val, lo, width, ctr, r2, n_exact = _corner_layout(seed, r, ctr_offset)
    assert n_exact > 0  # some entries sit at d2 == r2 exactly
    members = _members_kept(pts_T, val, lo, width, ctr, r2)
    plain = tslab.slab_window_moments_plain(pts_T, val, lo, width, ctr, r2)
    assert members == int(plain[9].sum()) > 0
    for tiles, _, qv, _, _, kept in sc.cull_windows(pts_T, val, lo, width, ctr, r2):
        real = qv.reshape(len(tiles), -1, sc.WARP).any(-1)
        assert not kept[~real].any()
        assert not real[tiles < 3, 1].any()  # warp 1 of every cluster tile is padding
        assert 3 not in tiles  # the last cluster tile has no valid row: not live
    kept, all_pairs, _ = sc.cull_pair_tests(pts_T, val, lo, width, ctr, r2)
    assert members <= kept <= all_pairs


# --- X2's list policy -------------------------------------------------------

NONE = np.uint64(0xFFFFFFFFFFFFFFFF)
LANE = np.arange(32)


def _half_clean(keys, stride, up):
    other = keys[LANE ^ stride]
    lower = (LANE & stride) == 0
    return np.where(lower == up, np.minimum(keys, other), np.maximum(keys, other))


def _warp_sort(keys):
    for size in (2, 4, 8, 16, 32):
        stride = size // 2
        while stride:
            keys = _half_clean(keys, stride, ((LANE & size) == 0) | (size == 32))
            stride //= 2
    return keys


def _sort_list(buf, b0, b1, m):
    """The kernel's sort_into_buf0: buf[b0:b0 + m] sorted with buf[b1:] as
    scratch; returns the offsets (b0, b1) after it, b0 holding the result.
    32-key runs by the warp sort, then pairwise merges by rank (a key's
    place in its run plus the number of smaller keys in the other run)."""
    for c in range(0, m, 32):
        n = min(32, m - c)
        key = np.full(32, NONE)
        key[:n] = buf[b0 + c:b0 + c + n]
        buf[b0 + c:b0 + c + n] = _warp_sort(key)[:n]
    length = 32
    while length < m:
        a = buf[b0:b0 + m].copy()
        for i in range(m):
            run = i & ~(length - 1)
            other = run ^ length
            pos = (run & ~(2 * length - 1)) + (i - run)
            if other < m:
                pos += int(np.searchsorted(a[other:min(other + length, m)], a[i]))
            buf[b1 + pos] = a[i]
        b0, b1 = b1, b0
        length *= 2
    return b0, b1


def _nth_set_bit(mask: int, r: int) -> int:
    pos = 0
    for w in (16, 8, 4, 2, 1):
        if bin(mask & ((1 << (pos + w)) - 1)).count("1") <= r:
            pos += w
    return pos


def _list_policy(batches, k: int, reg: bool):
    """The kernel's top-k over steps of 32 keys (NONE: not a member)."""
    m, is_sorted = 0, False
    lst = np.full(32, NONE)
    buf = np.full(2 * k + 32, NONE)
    b0, b1 = 0, k
    for key in batches:
        if is_sorted:
            last = lst[k - 1] if reg else buf[b0 + k - 1]
            key = np.where(key > last, NONE, key)
        ball = int(sum(1 << int(i) for i in np.flatnonzero(key != NONE)))
        nb = bin(ball).count("1")
        if nb == 0:
            continue
        if not is_sorted and m + nb <= k:
            if reg:
                for lane in range(m, m + nb):
                    lst[lane] = key[_nth_set_bit(ball, lane - m)]
            else:
                for lane in np.flatnonzero(key != NONE):
                    buf[b0 + m + bin(ball & ((1 << int(lane)) - 1)).count("1")] = key[lane]
            m += nb
            continue
        if not is_sorted:
            if reg:
                lst = _warp_sort(lst)
            else:
                b0, b1 = _sort_list(buf, b0, b1, m)
            is_sorted = True
        key = _warp_sort(key)
        if reg:
            lst = np.minimum(lst, key[31 - LANE])
            for stride in (16, 8, 4, 2, 1):
                lst = _half_clean(lst, stride, True)
            lst[k:] = NONE
        else:
            old = buf[b0:b0 + m].copy()
            for lane in range(nb):
                pos = lane + int(np.searchsorted(old, key[lane]))
                if pos < k:
                    buf[b1 + pos] = key[lane]
            for j in range(m):
                pos = j + int(np.searchsorted(key[:nb], old[j]))
                if pos < k:
                    buf[b1 + pos] = old[j]
            b0, b1 = b1, b0
        m = min(k, m + nb)
    if reg:
        return _warp_sort(lst)[:k] if not is_sorted else lst[:k]
    if not is_sorted:
        b0, b1 = _sort_list(buf, b0, b1, m)
    return np.where(np.arange(k) < m, buf[b0:b0 + k], NONE)


def _member_steps(seed, count, steps):
    """``steps`` steps of 32 candidates with ``count`` members holding
    distinct keys (d2 bits above column and slot, as the kernel builds
    them), in random positions."""
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0x3c000000, 0x3d800000, count, dtype=np.uint64)  # a few float32 d2
    d2[rng.integers(0, count, count // 4)] = d2[0]  # ties in d2: the slot decides
    slot = rng.permutation(1 << 20)[:count].astype(np.uint64)
    col = rng.integers(0, 9, count, dtype=np.uint64)
    keys = (d2 << np.uint64(32)) | (col << np.uint64(28)) | slot
    flat = np.full(32 * steps, NONE)
    flat[np.sort(rng.choice(32 * steps, count, replace=False))] = keys
    return list(flat.reshape(steps, 32)), np.sort(keys)


@pytest.mark.parametrize("k", [1, 16, 31, 32, 33, 64, 100, 168, 300])
@pytest.mark.parametrize("regime", ["below", "equal", "above"])
def test_grid_list_policy_matches_a_truncated_sort(k, regime):
    """Append, sort once, merge after an overflow: the k smallest keys in
    ascending order, NONE-padded, for counts below, at and above k; the
    register list (k <= 32) and the shared-memory list alike."""
    count = {"below": max(k // 2, 1), "equal": k, "above": 3 * k + 7}[regime]
    steps = max(2, -(-count // 8))  # a quarter of the lanes are members on average
    for seed in range(3):
        batches, keys = _member_steps(seed * 101 + k, count, steps)
        want = np.full(k, NONE)
        want[:min(k, count)] = keys[:k]
        got = _list_policy(batches, k, reg=False)
        assert np.array_equal(got, want)
        if k <= 32:
            assert np.array_equal(_list_policy(batches, k, reg=True), want)


@pytest.mark.parametrize("m", [1, 31, 32, 33, 64, 65, 100, 128, 161, 200, 256, 257, 300, 777])
def test_grid_list_sort_sorts(m):
    """The list sort of m keys (runs of 32, then merges by rank between the
    list's two buffers of k >= m keys) leaves a[0, m) ascending in the
    buffer it names."""
    rng = np.random.default_rng(m)
    buf = np.full(2 * m, NONE)
    buf[:m] = rng.choice(1 << 40, m, replace=False).astype(np.uint64)
    want = np.sort(buf[:m])
    b0, _ = _sort_list(buf, 0, m, m)
    assert np.array_equal(buf[b0:b0 + m], want)


def test_nth_set_bit_finds_each_member():
    rng = np.random.default_rng(0)
    for mask in [1, 0xFFFFFFFF, 0x80000000] + list(rng.integers(1, 1 << 32, 50)):
        bits = [i for i in range(32) if int(mask) >> i & 1]
        assert [_nth_set_bit(int(mask), r) for r in range(len(bits))] == bits
