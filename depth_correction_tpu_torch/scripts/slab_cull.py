"""A host model of X1's warp cull (csrc/slabwin.cu), for measurement and
tests; no path of the package calls it.

Each warp of WARP tile rows keeps the valid span entries whose float32
distance to the box of its valid rows, in the pair test's own operation
sequence (no fused multiply-add), is at most r2. :func:`cull_pair_tests`
counts the work that leaves the kernel: it is computed here from the
layout, not read from the kernel, which counts nothing.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["TILE", "WARP", "cull_pair_tests", "cull_windows", "d2_f32"]

# The kernel's tile (kTile) and warp (kWarp) widths.
TILE = 128
WARP = 32


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def d2_f32(dx, dy, dz):
    """X1's membership distance (dx*dx + dy*dy) + dz*dz in float32, each
    operation rounded on its own (numpy float32 arrays)."""
    return (dx * dx + dy * dy) + dz * dz


def cull_windows(pts_T, valid, lo, width, ctr, r2: float, step: int = 32):
    """The warp cull of one launch, per chunk of ``step`` live tiles.

    :param pts_T: (3, n) sorted positions, n a multiple of :data:`TILE`.
    :param valid: (n,) bool.
    :param lo, width: (T, 3) span starts and lengths; ctr: (T, 3) centres.
    :yield: (tiles (c,) tile indices, v (3, c, TILE) tile-centred rows,
        qv (c, TILE) valid rows, e (3, c, W) tile-centred span entries, the
        three spans back to back, ev (c, W) entries in a span and valid,
        kept (c, TILE / WARP, W)), all numpy, for the live tiles in order; a
        warp without a valid row keeps nothing.
    """
    pts = _host(pts_T).astype(np.float32)
    valid = _host(valid).astype(bool)
    lo = _host(lo).astype(np.int64)
    width = np.maximum(_host(width).astype(np.int64), 0)
    ctr = _host(ctr).astype(np.float32)
    r2 = np.float32(r2)
    n = pts.shape[1]
    warps = TILE // WARP
    live = np.flatnonzero(valid.reshape(-1, TILE).any(1))
    for a in range(0, len(live), step):
        tiles = live[a:a + step]
        c = ctr[tiles].T[:, :, None]  # (3, c, 1)
        rows = tiles[:, None] * TILE + np.arange(TILE)
        v = pts[:, rows] - c
        qv = valid[rows]
        w_max = max(int(width[tiles].sum(1).max()), 1)
        pre = np.concatenate([np.zeros((len(tiles), 1), np.int64),
                              np.cumsum(width[tiles], 1)], 1)  # (c, 4)
        idx = np.arange(w_max)
        span = (idx[None, :, None] >= pre[:, None, 1:]).sum(-1)  # (c, W), 3 past the end
        sel = span < 3
        s = np.minimum(span, 2)
        j = np.take_along_axis(lo[tiles], s, 1) + idx - np.take_along_axis(pre, s, 1)
        j = np.where(sel, j, 0).clip(0, n - 1)
        ev = sel & valid[j]
        e = pts[:, j] - c  # (3, c, W)
        kept = np.zeros((len(tiles), warps, w_max), bool)
        for w in range(warps):
            rw = qv[:, w * WARP:(w + 1) * WARP]
            vw = v[:, :, w * WARP:(w + 1) * WARP]
            blo = np.where(rw, vw, np.float32(np.inf)).min(-1)[..., None]  # (3, c, 1)
            bhi = np.where(rw, vw, np.float32(-np.inf)).max(-1)[..., None]
            with np.errstate(invalid="ignore", over="ignore"):  # inf gaps: no valid row
                gap = np.maximum(np.maximum(blo - e, np.float32(0)), e - bhi)
                kept[:, w] = (d2_f32(gap[0], gap[1], gap[2]) <= r2) & ev
        yield tiles, v, qv, e, ev, kept


def cull_pair_tests(pts_T, valid, lo, width, ctr, r2: float) -> tuple:
    """(pair tests X1's warps make after the cull, all pair tests, box
    tests): a warp with a valid row tests each entry it keeps against each
    of its 32 rows and makes one box test per valid entry of its tile's
    spans; without the cull every row of a live tile tests every entry of
    its spans."""
    width_all = np.maximum(_host(width).astype(np.int64), 0)
    kept_tests = box_tests = all_pairs = 0
    for tiles, _, qv, _, ev, kept in cull_windows(pts_T, valid, lo, width, ctr, r2):
        real = qv.reshape(len(tiles), -1, WARP).any(-1)  # (c, warps)
        kept_tests += int(kept.sum()) * WARP
        box_tests += int((real.sum(-1) * ev.sum(-1)).sum())
        all_pairs += int(width_all[tiles].sum()) * TILE
    return kept_tests, all_pairs, box_tests
