"""A host model of kernel X3's cell order and cull (csrc/knn_brute.cu), for
measurement and tests; no path of the package calls it.

With a finite radius the launcher orders points and queries by the Morton
key of their cell (:func:`cell_keys`), valid points and active queries
first. Each block of :data:`BLOCK_Q` consecutive queries then culls
in two steps, each by a float32 box distance in the pair test's own
operation sequence: the box of its active queries against each tile of
:data:`TILE` points, then the box and each active query against each
chunk of :data:`CHUNK` points of the tiles that passed. It loads the tiles with a
chunk left and tests its queries against the points of those chunks.
:func:`cull_stats` counts that work: it is computed here from the inputs,
not read from the kernel, which counts nothing.

The nearest search (k = 1, no radius) takes its bound from the data
(:func:`nearest_cull`): points and queries are keyed on the points' grid,
each warp seeds its queries' limits from the tiles around each query's
place in the point order and then culls, round after round of
:data:`ROUND_TILES` tiles, with each query's nearest distance so far as
its radius, in sweeps of a growing reach where a limit lies beyond
:data:`SWEEP_CELLS` cells. :func:`nearest_cull_stats` gives the tiles a
warp reads, which the kernel's optional tally counts too.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BLOCK_Q", "CHUNK", "GROWTH", "INVALID_KEY", "REACH_CELLS", "ROUND_TILES",
           "SWEEP_CELLS", "SWEEPS", "TILE", "box_d2_f32", "boxes", "cell_keys", "cell_order",
           "cull_masks", "cull_stats", "d2_f32", "nearest_cull", "nearest_cull_stats",
           "nearest_keys"]

# The kernel's queries per block (one warp, one a lane), points per staged
# tile (kTile) and per culled chunk.
BLOCK_Q = 32
TILE = 128
CHUNK = 32
# Bits of each cell coordinate in the key (kCellBits): cells are clamped to
# [0, 127] and keys stay below the invalid rows' key 2^22 - 1.
CELL_BITS = 7
INVALID_KEY = np.int64(2 ** (3 * CELL_BITS + 1) - 1)
# Tiles whose boxes a warp tests per round (kChunk): the nearest search's
# limits are taken again at the start of each round.
ROUND_TILES = 512
# The nearest search's sweeps (kSweepCells, kReachCells, kGrowth, kSweeps),
# for a warp whose largest limit lies beyond SWEEP_CELLS cell sides: the
# first caps each limit at a reach of REACH_CELLS cell sides, each later
# one at GROWTH times the squared reach before it, sweep SWEEPS - 1 at the
# limit.
SWEEP_CELLS = 16
REACH_CELLS = 4
GROWTH = 4
SWEEPS = 4


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _spread(c: np.ndarray) -> np.ndarray:
    """The low 10 bits of ``c`` moved to every third bit."""
    x = c.astype(np.int64) & 0x3FF
    for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249)):
        x = (x | (x << shift)) & mask
    return x


def boxes(vals, real, size: int) -> tuple:
    """(lo, hi), each (ceil(n / size), 3) float32: per group of ``size``
    consecutive rows the least and largest coordinate over the ``real``
    rows (NaN coordinates left out, as fminf / fmaxf leave them); a group
    with none is (inf, -inf)."""
    v = _host(vals).astype(np.float32).reshape(-1, 3)
    real = _host(real).astype(bool)
    n = v.shape[0]
    g = -(-n // size)
    pad = g * size - n
    v = np.concatenate([v, np.zeros((pad, 3), np.float32)])
    real = np.concatenate([real, np.zeros(pad, bool)])
    lo = np.where(real[:, None], v, np.float32(np.inf)).reshape(g, size, 3)
    hi = np.where(real[:, None], v, np.float32(-np.inf)).reshape(g, size, 3)
    return (np.fmin.reduce(lo, axis=1, initial=np.float32(np.inf)),
            np.fmax.reduce(hi, axis=1, initial=np.float32(-np.inf)))


def _morton(p: np.ndarray, lo: np.ndarray, side: np.float32) -> np.ndarray:
    """The Morton key of floor((p - lo) / side) clamped to [0, 127] per
    axis, in float32 as cell_key computes it (fmax takes the number over a
    NaN, so 0 / 0 falls in cell 0)."""
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        f = np.floor((p - lo) / side)
    c = np.fmin(np.fmax(f, np.float32(0)), np.float32(2 ** CELL_BITS - 1)).astype(np.int64)
    return _spread(c[:, 0]) | (_spread(c[:, 1]) << 1) | (_spread(c[:, 2]) << 2)


def _grid(p: np.ndarray, v: np.ndarray, side_r) -> tuple:
    """(lo (3,), side) float32: the valid points' box corner and the cell
    side max(side_r, extent / 128), as grid_side computes it."""
    lo, hi = boxes(p, v, max(len(p), 1))
    lo, hi = lo[0], hi[0]
    with np.errstate(invalid="ignore", over="ignore"):
        ext = np.fmax(np.fmax(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2])
        return lo, np.fmax(np.float32(side_r), ext / np.float32(2 ** CELL_BITS))


def cell_keys(points, valid, r: float) -> np.ndarray:
    """(N,) int64 keys as knn_keys_kernel makes them: over the box [lo, hi]
    of the valid rows, cells of side max(sqrt(r2), extent / 128) (float32,
    r2 the float32 square of ``r``, 1 for r2 = 0; extent the box's largest
    side), the Morton key of floor((x - lo) / side) clamped to [0, 127] per
    axis; invalid rows :data:`INVALID_KEY`."""
    p = _host(points).astype(np.float32).reshape(-1, 3)
    v = _host(valid).astype(bool)
    r2 = np.float32(r) ** 2
    side_r = np.float32(np.sqrt(np.float64(r2))) if r2 > 0 else np.float32(1)
    lo, side = _grid(p, v, side_r)
    return np.where(v, _morton(p, lo, side), INVALID_KEY)


def cell_order(points, valid, r: float) -> np.ndarray:
    """The launcher's order of points (or queries): a stable sort of
    :func:`cell_keys`, so valid rows come first and equal keys keep their
    index order."""
    return np.argsort(cell_keys(points, valid, r), kind="stable")


def d2_f32(q, p) -> np.ndarray:
    """(Q, P) float32 squared distances, dx*dx + dy*dy + dz*dz with each
    operation rounded on its own (the kernel's and the plain twin's)."""
    q = _host(q).astype(np.float32)
    p = _host(p).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        d = q[:, None, :] - p[None, :, :]
        return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def box_d2_f32(qlo, qhi, plo, phi) -> np.ndarray:
    """(B, T) float32 distance between boxes (B, 3) and (T, 3): per axis the
    gap max(plo - qhi, qlo - phi, 0), then the pair test's sum of squares.
    It is at most the d2 of any pair in the two boxes, since float32
    rounding is monotone: no member is culled. fmax takes the number over
    a NaN, as the kernel's fmaxf does."""
    with np.errstate(invalid="ignore", over="ignore"):
        gap = np.fmax(np.fmax(plo[None] - qhi[:, None], qlo[:, None] - phi[None]),
                      np.float32(0))
        return (gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1]) + gap[..., 2] * gap[..., 2]


def cull_masks(q_sorted, active, p_sorted, p_valid, r: float, block_q: int = BLOCK_Q) -> tuple:
    """The kernel's two-step cull on sorted queries and points.

    :return: (tiles (B, T) bool, the tiles each block's box keeps; near
        (B, T * TILE / CHUNK) bool, the chunks of those tiles within r2 of
        the block's box; chunks, the same shape, the chunks some active query
        of the block keeps, a subset of near). A block without an active
        query, or a chunk without a valid point, keeps nothing.
    """
    q = _host(q_sorted).astype(np.float32).reshape(-1, 3)
    active = _host(active).astype(bool)
    r2 = np.float32(r) ** 2
    qlo, qhi = boxes(q, active, block_q)
    plo, phi = boxes(p_sorted, p_valid, TILE)
    clo, chi = boxes(p_sorted, p_valid, CHUNK)
    tiles = box_d2_f32(qlo, qhi, plo, phi) <= r2
    per = TILE // CHUNK
    near = np.zeros((tiles.shape[0], tiles.shape[1] * per), bool)
    chunks = np.zeros_like(near)
    for b in np.flatnonzero(tiles.any(1)):
        rows = np.arange(b * block_q, min((b + 1) * block_q, len(q)))
        rows = rows[active[rows]]
        cand = (np.flatnonzero(tiles[b])[:, None] * per + np.arange(per)).ravel()
        cand = cand[cand < len(clo)]
        near[b, cand] = box_d2_f32(qlo[b:b + 1], qhi[b:b + 1], clo[cand], chi[cand])[0] <= r2
        d = box_d2_f32(q[rows], q[rows], clo[cand], chi[cand])
        chunks[b, cand] = (d <= r2).any(0)
    return tiles, near, chunks


def cull_stats(points, valid, r: float, k: int = 0, query=None, q_valid=None,
               insertions: bool = True) -> dict:
    """The cull's work on one launch (``query`` None: the points query
    themselves; the active queries are ``q_valid`` for k > 0, and every
    query when it is None or k = 0, as in counts mode).

    :return: {"blocks", "tiles", "tiles_loaded" ((block, tile) pairs with a
        chunk left), "kept_pairs" (active
        queries x valid points of the kept chunks; the kernel also tests the
        invalid points there, as NaN), "all_pairs" (active
        queries x valid points), "pair_share", "box_tests" (the block box
        against every tile and against every chunk of the tiles that pass,
        each active query against every chunk that passes that: at most the
        kernel's, which stops at the first query that keeps a chunk),
        "members" (within-r pairs), "max_count",
        "max_block_pairs" (the most pair tests of one block), and with
        ``insertions`` and k > 0 "insertions" (keys entering a list: a member
        enters when fewer than k smaller keys came before it, in the
        kernel's order) and "max_insertions" (of one query)}.
    """
    block_q = BLOCK_Q
    pts = _host(points).astype(np.float32).reshape(-1, 3)
    pv = _host(valid).astype(bool)
    q = pts if query is None else _host(query).astype(np.float32).reshape(-1, 3)
    qv = (np.ones(q.shape[0], bool) if k == 0 or q_valid is None
          else _host(q_valid).astype(bool))
    r2 = np.float32(r) ** 2
    # The launcher's orders: when the queries are the points and every row
    # queries (counts, or a top-k without q_valid) or the active queries are
    # the valid points, one order keyed by the active queries; else the
    # points by cell, valid first, and the queries by cell, active first.
    if query is None and (k == 0 or q_valid is None or np.array_equal(qv, pv)):
        po = qo = cell_order(pts, qv, r)
    else:
        po, qo = cell_order(pts, pv, r), cell_order(q, qv, r)
    ps, pvs = pts[po], pv[po]
    qs, qvs = q[qo], qv[qo]
    tiles, near, chunks = cull_masks(qs, qvs, ps, pvs, r, block_q)
    nb, nt = tiles.shape
    per = TILE // CHUNK
    q_per_block = np.bincount(np.arange(len(qs)) // block_q, weights=qvs,
                              minlength=nb).astype(np.int64)
    p_per_chunk = np.bincount(np.arange(len(ps)) // CHUNK, weights=pvs,
                              minlength=nt * per).astype(np.int64)
    block_pairs = (chunks * p_per_chunk[None, :]).sum(1) * q_per_block
    members = max_count = ins_total = ins_max = 0
    for b in np.flatnonzero(chunks.any(1)):
        rows = np.arange(b * block_q, min((b + 1) * block_q, len(qs)))
        rows = rows[qvs[rows]]
        cols = (np.flatnonzero(chunks[b])[:, None] * CHUNK + np.arange(CHUNK)).ravel()
        cols = cols[cols < len(ps)]
        cols = cols[pvs[cols]]
        if rows.size == 0 or cols.size == 0:
            continue
        d2 = d2_f32(qs[rows], ps[cols])
        inside = d2 <= r2
        counts = inside.sum(1)
        members += int(counts.sum())
        max_count = max(max_count, int(counts.max()))
        if not (insertions and k > 0):
            continue
        ins = np.minimum(counts, k)
        for i in np.flatnonzero(counts > k):
            # Keys in the kernel's order (kept chunks, then points, ascending):
            # one enters while fewer than k smaller ones came before it.
            keys = (d2[i, inside[i]].view(np.uint32).astype(np.uint64) << np.uint64(32)) \
                | po[cols[inside[i]]].astype(np.uint64)
            before = np.tril(keys[None, :] < keys[:, None], -1).sum(1)
            ins[i] = int((before < k).sum())
        ins_total += int(ins.sum())
        ins_max = max(ins_max, int(ins.max()))
    kept_pairs = int(block_pairs.sum())
    all_pairs = int(qvs.sum()) * int(pvs.sum())
    box_tests = (int((q_per_block > 0).sum()) * nt + int(tiles.sum()) * per
                 + int((near.sum(1) * q_per_block).sum()))
    out = {"blocks": nb, "tiles": nt,
           "tiles_loaded": int(chunks.reshape(nb, nt, per).any(2).sum()),
           "kept_pairs": kept_pairs, "all_pairs": all_pairs,
           "pair_share": kept_pairs / max(all_pairs, 1), "box_tests": box_tests,
           "members": members, "max_count": max_count,
           "max_block_pairs": int(block_pairs.max(initial=0))}
    if insertions and k > 0:
        out.update(insertions=ins_total, max_insertions=ins_max)
    return out



def nearest_keys(points, valid, query, q_valid=None) -> tuple:
    """(point keys (N,), query keys (Q,)) int64, both on the points' grid:
    the box of the valid points, cells of side extent / 128 (float32; no
    radius floor), queries outside the box in the edge cells. A point or
    query that is invalid or has a NaN coordinate (it can be no neighbour
    and finds none) takes :data:`INVALID_KEY`."""
    p = _host(points).astype(np.float32).reshape(-1, 3)
    v = _host(valid).astype(bool)
    q = _host(query).astype(np.float32).reshape(-1, 3)
    qv = np.ones(len(q), bool) if q_valid is None else _host(q_valid).astype(bool)
    lo, side = _grid(p, v, 0)
    pk = np.where(v & ~np.isnan(p).any(1), _morton(p, lo, side), INVALID_KEY)
    qk = np.where(qv & ~np.isnan(q).any(1), _morton(q, lo, side), INVALID_KEY)
    return pk, qk


def _seed_tiles(tile_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """The tiles a warp seeds from, ascending: for each of its active
    queries' ``keys`` the last tile whose first key is at most the key (the
    first tile when there is none) and one tile on either side, within the
    tiles."""
    t = np.maximum(np.searchsorted(tile_keys, keys, side="right") - 1, 0)
    near = (t[:, None] + np.arange(-1, 2)).ravel()
    return np.unique(np.clip(near, 0, len(tile_keys) - 1))


def nearest_cull(points, valid, query, q_valid=None) -> dict:
    """The nearest search's cell order, seed and cull (the k = 1 body of
    csrc/knn_brute.cu), run on the host in float32 with the kernel's keys
    and operation order.

    Each warp of :data:`BLOCK_Q` queries in cell order seeds its active
    queries' keys (d2, point index) from the tiles :func:`_seed_tiles`
    picks at their keys; then, per round of :data:`ROUND_TILES` tiles and
    with the limits (each query's best d2) as they stand at the round's
    start, it reads each other tile with a chunk that some query's cap
    reaches (a float32 box distance at most the cap, the chunk's box not
    empty) and tests all its queries against every point of those chunks.
    A warp whose largest limit lies beyond :data:`SWEEP_CELLS` cell sides
    does so in sweeps: while a limit passes the sweep's squared reach
    (:data:`REACH_CELLS` cell sides, times :data:`GROWTH` a sweep) each
    cap is the least of the limit and that reach; the sweep that caps
    nothing, or the last, caps at the limits; and no chunk is read twice.
    Other warps walk once, at their limits.

    :return: {"d2" (Q,) float32, "idx" (Q,) int64 (-1 / inf where none),
        "tiles_read" (warps,) int64 (the seed tiles and the tiles read after
        them), "chunks_read" (warps,) int64 (after the seed), "tiles" (tiles
        of the points), "seed_tiles" (warps,) int64 (0 for a warp without an
        active query), "sweeps" (warps,) int64}.
    """
    p = _host(points).astype(np.float32).reshape(-1, 3)
    v = _host(valid).astype(bool)
    q = _host(query).astype(np.float32).reshape(-1, 3)
    pk, qk = nearest_keys(p, v, q, q_valid)
    po = np.argsort(pk, kind="stable")
    qo = np.argsort(qk, kind="stable")
    n, nq = len(p), len(q)
    nt = -(-n // TILE)
    nw = -(-nq // BLOCK_Q)
    # The pack: points in cell order, NaN for an invalid one; the boxes over
    # the valid ones (NaN coordinates left out).
    pvs = v[po]
    packed = np.where(pvs[:, None], p[po], np.float32(np.nan))
    clo, chi = boxes(p[po], pvs, CHUNK)
    tlo, thi = boxes(p[po], pvs, TILE)
    tile_keys = pk[po][::TILE]
    nonempty = (clo <= chi).all(1)
    side = _grid(p, v, 0)[1]
    first_reach = (side * side) * np.float32(REACH_CELLS * REACH_CELLS)
    sweep_from = (side * side) * np.float32(SWEEP_CELLS * SWEEP_CELLS)
    per = TILE // CHUNK
    best = np.full(nq, np.iinfo(np.uint64).max, np.uint64)
    tiles_read = np.zeros(nw, np.int64)
    chunks_read = np.zeros(nw, np.int64)
    seed_tiles = np.zeros(nw, np.int64)
    sweeps = np.zeros(nw, np.int64)
    inf = np.float32(np.inf)

    def test(rows, cols):
        """Every query of ``rows`` against the packed points ``cols``: the
        least key of those with d2 at most inf (a NaN d2 is no candidate)."""
        d2 = d2_f32(q[rows], packed[cols])
        hit = d2 <= inf
        keys = (d2.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
            | po[cols].astype(np.uint64)[None, :]
        keys = np.where(hit, keys, np.iinfo(np.uint64).max)
        best[rows] = np.minimum(best[rows], keys.min(1, initial=np.iinfo(np.uint64).max))

    def limits(rows):
        b = best[rows]
        return np.where(b == np.iinfo(np.uint64).max, inf,
                        (b >> np.uint64(32)).astype(np.uint32).view(np.float32))

    for w in range(nw):
        slots = np.arange(w * BLOCK_Q, min((w + 1) * BLOCK_Q, nq))
        act = qk[qo[slots]] != INVALID_KEY
        if nt == 0 or not act.any():
            continue
        rows = qo[slots[act]]
        seeds = _seed_tiles(tile_keys, qk[rows])
        cols = (seeds[:, None] * TILE + np.arange(TILE)).ravel()
        test(rows, cols[cols < n])
        tiles_read[w] = seed_tiles[w] = len(seeds)
        wlo, whi = q[rows].min(0), q[rows].max(0)
        reach = first_reach
        sweeping = sweep_from < limits(rows).max()
        read = np.zeros(len(clo), bool)  # a sweeping warp's chunks read
        for sweep in range(SWEEPS):
            sweeps[w] += 1
            if sweep == 0:
                last = not sweeping
            else:
                reach = reach * np.float32(GROWTH)
                last = sweep == SWEEPS - 1 or reach >= limits(rows).max()
            for c0 in range(0, nt, ROUND_TILES):
                tiles = np.arange(c0, min(c0 + ROUND_TILES, nt))
                tiles = tiles[~np.isin(tiles, seeds)]
                cap = limits(rows) if last else np.minimum(limits(rows), reach)
                # The warp's box at its largest cap first (as the kernel's
                # first step): it keeps every tile with a chunk some query's
                # own cap keeps, so it changes nothing but the time here.
                far = box_d2_f32(wlo[None], whi[None], tlo[tiles], thi[tiles])[0]
                tiles = tiles[far <= cap.max()]
                chunks = (tiles[:, None] * per + np.arange(per)).ravel()
                chunks = chunks[(chunks < len(clo))]
                chunks = chunks[nonempty[chunks] & ~read[chunks]]
                if not len(chunks):
                    continue
                d = box_d2_f32(q[rows], q[rows], clo[chunks], chi[chunks])
                need = chunks[(d <= cap[:, None]).any(0)]
                if not len(need):
                    continue
                read[need] = sweeping
                tiles_read[w] += len(np.unique(need // per))
                chunks_read[w] += len(need)
                cols = (need[:, None] * CHUNK + np.arange(CHUNK)).ravel()
                test(rows, cols[cols < n])
            if last:
                break
    found = best != np.iinfo(np.uint64).max
    d2 = np.where(found, (best >> np.uint64(32)).astype(np.uint32).view(np.float32), inf)
    idx = np.where(found, (best & np.uint64(0xFFFFFFFF)).astype(np.int64), -1)
    return {"d2": d2, "idx": idx, "tiles_read": tiles_read, "chunks_read": chunks_read,
            "tiles": nt, "seed_tiles": seed_tiles, "sweeps": sweeps}


def nearest_cull_stats(points, valid, query, q_valid=None) -> dict:
    """The nearest search's work on one launch, from :func:`nearest_cull`.

    :return: {"warps", "tiles", "tiles_read" (over the warps),
        "tiles_per_warp" (the mean over warps with an active query),
        "pair_share" (tiles read over warps x tiles: the share of all
        (query, point) slots the warps test), "chunk_share"}.
    """
    out = nearest_cull(points, valid, query, q_valid)
    nw, nt = len(out["tiles_read"]), out["tiles"]
    busy = max(int((out["seed_tiles"] > 0).sum()), 1)
    total = int(out["tiles_read"].sum())
    return {"warps": nw, "tiles": nt, "tiles_read": total, "tiles_per_warp": total / busy,
            "pair_share": total / max(nw * nt, 1),
            "chunk_share": int(out["chunks_read"].sum()) / max(nw * nt * (TILE // CHUNK), 1)}
