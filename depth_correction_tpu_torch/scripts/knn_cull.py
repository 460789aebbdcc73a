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
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BLOCK_Q", "CHUNK", "INVALID_KEY", "TILE", "box_d2_f32", "boxes", "cell_keys",
           "cell_order", "cull_masks", "cull_stats", "d2_f32"]

# The kernel's queries per block (one warp, one a lane), points per staged
# tile (kTile) and per culled chunk.
BLOCK_Q = 32
TILE = 128
CHUNK = 32
# Bits of each cell coordinate in the key (kCellBits): cells are clamped to
# [0, 127] and keys stay below the invalid rows' key 2^22 - 1.
CELL_BITS = 7
INVALID_KEY = np.int64(2 ** (3 * CELL_BITS + 1) - 1)


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


def cell_keys(points, valid, r: float) -> np.ndarray:
    """(N,) int64 keys as knn_keys_kernel makes them: over the box [lo, hi]
    of the valid rows, cells of side max(sqrt(r2), extent / 128) (float32,
    r2 the float32 square of ``r``, 1 for r2 = 0; extent the box's largest
    side), the Morton key of floor((x - lo) / side) clamped to [0, 127] per
    axis; invalid rows :data:`INVALID_KEY`."""
    p = _host(points).astype(np.float32).reshape(-1, 3)
    v = _host(valid).astype(bool)
    lo, hi = boxes(p, v, max(len(p), 1))
    lo, hi = lo[0], hi[0]
    with np.errstate(invalid="ignore", over="ignore"):
        ext = np.fmax(np.fmax(hi[0] - lo[0], hi[1] - lo[1]), hi[2] - lo[2])
        r2 = np.float32(r) ** 2
        side_r = np.float32(np.sqrt(np.float64(r2))) if r2 > 0 else np.float32(1)
        side = np.fmax(side_r, ext / np.float32(2 ** CELL_BITS))
        f = np.floor((p - lo) / side)
    c = np.fmin(np.fmax(f, np.float32(0)), np.float32(2 ** CELL_BITS - 1)).astype(np.int64)
    key = _spread(c[:, 0]) | (_spread(c[:, 1]) << 1) | (_spread(c[:, 2]) << 2)
    return np.where(v, key, INVALID_KEY)


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

