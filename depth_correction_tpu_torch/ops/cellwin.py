"""Cell-window neighborhood moments (counterpart of ``depth_correction_tpu/
ops/cellwin.py``).

The uncapped within-r graph (the reference's query_ball_point semantics,
src/depth_correction/nearest_neighbors.py:22-80) has spatial structure: every
neighbor of a query lies inside the 3x3x3 cell window around the query's
grid cell (cell >= r). This module exploits it:

1. points and query rows are sorted by grid cell and padded into fixed-size
   tiles (host builder ``build_cellwin_graph``, numpy, a verbatim copy of the
   JAX package's so both packages freeze bit-equal graphs);
2. each tile's candidate window is a short list of contiguous spans of the
   cell-sorted point table;
3. membership is recomputed on the device from the STATIC establishment-time
   positions: w_ij = [d2(q_est_i, x_est_j) <= r2], in f32 difference form;
4. the weighted moment sums of the CURRENT positions accumulate per row.

Pairs within a conservative epsilon of r2 (where f32 rounding could flip
the test), and rows whose simulated window membership disagrees with the
frozen graph, are flagged at build time; those "exception rows" are
recomputed by the gather moments and merged, so the composed op is exact.

The backward is the symmetric computation: point tiles windowed over the
cell-sorted ROW table, accumulating each referencing row's cotangent row
(S, u of ``features._cotangent_table``) — no scatter, no atomics.

Forward and backward are the hand-written CUDA kernels of
``csrc/cellwin.cu`` (built and bound by ``ops/_kernels.py``) on CUDA
tensors, and their plain torch versions ``cellwin_fwd_plain`` /
``cellwin_bwd_plain`` on CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _kernels
from .eigh3 import eigvals3_c
from .features import TransposeGraph, _cotangent_table, build_transpose_graph, \
    neighborhood_moments

__all__ = [
    "BWD_LAUNCHES",
    "CellWinDevice",
    "CellWinGraph",
    "FWD_LAUNCHES",
    "build_cellwin_graph",
    "cellwin_bwd",
    "cellwin_bwd_plain",
    "cellwin_features",
    "cellwin_fwd",
    "cellwin_fwd_plain",
    "cellwin_moments",
    "graph_to_device",
]


# Static caps. NS = 3 * (Y_MAX + 2) window spans per tile: a tile may merge
# up to Y_MAX consecutive y-columns of one x-column; its window then covers
# (x-1..x+1) x (y_lo-1..y_hi+1) columns, each contributing one contiguous
# z-run of the cell-sorted table.
Y_MAX = 3
NS = 3 * (Y_MAX + 2)


@dataclasses.dataclass(frozen=True)
class CellWinGraph:
    """Static cell-window graph (host-built once per frozen neighborhood).

    Point layout: the merged point table is permuted into cell-sorted order
    and PADDED into T2 tiles of P slots (``m_pad = T2 * P``); ``perm``
    maps padded slots to original point indices (0 on padding; padding est
    positions are a far sentinel so membership never selects them).

    Row layout: valid query rows are cell-sorted and padded into T tiles of
    R slots (``mq_pad = T * R``); ``row_map`` maps padded slots to the
    original compacted-row index (-1 on padding).
    """

    # geometry
    r2: float
    # forward (row-tile) side
    n_row_tiles: int
    row_cap: int  # R
    span_cap: int  # S
    ns_f: int  # mini-span slots per row tile
    f_span_start: np.ndarray  # (T, ns_f) int32 into the padded point axis
    f_span_len: np.ndarray  # (T, ns_f) int32
    f_tile_ctr: np.ndarray  # (T, 3) float32
    q_est: np.ndarray  # (8, mq_pad) float32 rows [est x,y,z, 0, ...]
    row_map: np.ndarray  # (mq_pad,) int32 -> original compacted row / -1
    # backward (point-tile) side
    n_pt_tiles: int
    pt_cap: int  # P
    rspan_cap: int  # SR
    ns_b: int  # mini-span slots per point tile
    b_span_start: np.ndarray  # (T2, ns_b) int32 into the padded row axis
    b_span_len: np.ndarray  # (T2, ns_b) int32
    b_tile_ctr: np.ndarray  # (T2, 3) float32
    # padded point layout
    perm: np.ndarray  # (m_pad,) int32 -> original point index (0 on pad)
    perm_valid: np.ndarray  # (m_pad,) bool
    inv: np.ndarray  # (n_orig,) int32 original -> padded slot (-1 invalid)
    est_sorted: np.ndarray  # (8, m_pad) float32 rows [est x,y,z, 0...]
    # exception rows (recomputed via the gather path)
    exc_slots: np.ndarray  # (E,) int32 padded-row slots; possibly empty
    exc_nn: np.ndarray  # (E, K) int32 neighbors in PADDED point indices
    # diagnostics
    n_rows: int
    n_exc: int

    @property
    def mq_pad(self) -> int:
        return self.n_row_tiles * self.row_cap

    @property
    def m_pad(self) -> int:
        return self.n_pt_tiles * self.pt_cap


def _cell_grid(pts: np.ndarray, valid: np.ndarray, cell: float,
               max_cells: int = 1 << 24):
    """Cell coords/linear ids in f64; auto-coarsens past ``max_cells``."""
    v = pts[valid]
    if v.size == 0:
        v = np.zeros((1, 3))
    lo, hi = v.min(0), v.max(0)
    while True:
        mins = np.floor(lo / cell) * cell
        dims = np.floor((hi - mins) / cell).astype(np.int64) + 1
        if int(dims.prod()) <= max_cells:
            break
        cell *= 2.0
    cc = np.floor((pts - mins) / cell).astype(np.int64)
    cc = np.clip(cc, 0, dims[None] - 1)
    lin = (cc[:, 0] * dims[1] + cc[:, 1]) * dims[2] + cc[:, 2]
    return cc, lin, mins, dims, cell


def _build_tiles(cc_sorted: np.ndarray, cap: int, span_budget_probe,
                 z_max: Optional[int] = None):
    """Greedy tiles over cell-sorted items.

    A tile is a run of consecutive sorted items sharing one x-column, with
    a y-span of at most Y_MAX columns, a z-extent of at most ``z_max``
    cells (None = unlimited; small z_max trades window size — dense-pair
    work — for more tiles — DMA issue overhead), at most ``cap`` items,
    and whose window spans (checked via
    ``span_budget_probe(cx, ylo, yhi, zlo, zhi)`` -> max span length) stay
    within the caller's budget. Returns a list of (start, end) item ranges
    plus each tile's (cx, ylo, yhi, zlo, zhi).
    """
    n = cc_sorted.shape[0]
    # Plain Python ints once: per-item numpy scalar indexing dominates the
    # loop otherwise (measured 610k probes -> 21 s at bench scale).
    xs, ys, zs = (cc_sorted[:, c].tolist() for c in range(3))
    tiles = []
    i = 0
    while i < n:
        cx, cy = xs[i], ys[i]
        j = i + 1
        ylo = yhi = cy
        zlo = zhi = zs[i]
        ok_bounds = None  # last PROBE-APPROVED (yhi, zlo, zhi)
        while j < n and (j - i) < cap:
            x2, y2, z2 = xs[j], ys[j], zs[j]
            if x2 != cx or (y2 - ylo) >= Y_MAX:
                break
            ny2 = y2 if y2 > yhi else yhi
            nzlo = z2 if z2 < zlo else zlo
            nzhi = z2 if z2 > zhi else zhi
            if z_max is not None and nzhi - nzlo + 1 > z_max:
                break
            cand = (ny2, nzlo, nzhi)
            if cand != ok_bounds:
                # The window only changes when a bound expands; bounds the
                # probe already approved need no re-probe (items are
                # cell-sorted, so most extensions keep the bounds). The
                # FIRST extension always probes (nothing approved yet).
                if not span_budget_probe(cx, ylo, ny2, nzlo, nzhi):
                    break
                ok_bounds = cand
            yhi, zlo, zhi = cand
            j += 1
        tiles.append((i, j, cx, ylo, yhi, zlo, zhi))
        i = j
    return tiles


def _window_spans(starts, dims, cx, ylo, yhi, zlo, zhi):
    """(NS,) span (start, length) pairs over a dense cell-start table.

    Window columns: (cx-1..cx+1) x (ylo-1..yhi+1); z-run clamped to the
    grid. Out-of-range columns produce empty spans. ``starts`` has
    ``n_cells + 1`` entries (cumulative counts of the sorted layout the
    spans index into).
    """
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    z0 = max(int(zlo) - 1, 0)
    z1 = min(int(zhi) + 1, nz - 1)
    out_start = np.zeros(NS, np.int64)
    out_len = np.zeros(NS, np.int64)
    s = 0
    for dx in (-1, 0, 1):
        x = int(cx) + dx
        for y in range(int(ylo) - 1, int(ylo) - 1 + (Y_MAX + 2)):
            if s >= NS:
                break
            if 0 <= x < nx and 0 <= y < ny and y <= int(yhi) + 1:
                base = (x * ny + y) * nz
                a = starts[base + z0]
                b = starts[base + z1 + 1]
                out_start[s] = a
                out_len[s] = b - a
            s += 1
    return out_start, out_len


def _window_spans_max(starts, dims, cx, ylo, yhi, zlo, zhi) -> int:
    """Max span length of :func:`_window_spans`, vectorized (probe path)."""
    nx, ny, nz = int(dims[0]), int(dims[1]), int(dims[2])
    z0 = max(int(zlo) - 1, 0)
    z1 = min(int(zhi) + 1, nz - 1)
    x = np.arange(int(cx) - 1, int(cx) + 2)
    y = np.arange(int(ylo) - 1, int(yhi) + 2)
    x = x[(x >= 0) & (x < nx)]
    y = y[(y >= 0) & (y < ny)]
    if x.size == 0 or y.size == 0:
        return 0
    base = (x[:, None] * ny + y[None, :]).ravel() * nz
    return int((starts[base + z1 + 1] - starts[base + z0]).max(initial=0))


def _decompose_minispans(st: np.ndarray, ln: np.ndarray,
                         budget: Optional[int] = None):
    """Raw window spans -> 128-col MINI-SPAN tables.

    Every output entry satisfies ``start % 128 + len <= 128``, so the
    kernels' span caps become exactly 128 lanes: the dense per-slot
    d2/matmul work shrinks to the data actually present (the raw geometric
    spans average ~61 of a 640-cap on the bench graph — ~90% of the dense
    compute was masked padding). Mini-spans of one tile stay ascending and
    disjoint (the audit's searchsorted relies on it).

    :param budget: max mini-spans per tile; tiles needing more get ALL
        their spans zeroed (the exactness audit then routes their rows
        through the gather path). None = size to the densest tile.
    :return: (starts, lens, n_slots, n_over_budget).
    """
    t_dim = st.shape[0]
    per_tile = []
    for t in range(t_dim):
        mini = []
        for s in range(st.shape[1]):
            length = int(ln[t, s])
            if length <= 0:
                continue
            start = int(st[t, s])
            first = 128 - start % 128
            mini.append((start, min(length, first)))
            off = first
            while off < length:
                mini.append((start + off, min(length - off, 128)))
                off += 128
        per_tile.append(mini)
    max_nb = max((len(m) for m in per_tile), default=1)
    nb = max_nb if budget is None else min(max_nb, budget)
    nb = max(nb, 1)
    starts = np.zeros((t_dim, nb), np.int64)
    lens = np.zeros((t_dim, nb), np.int64)
    n_over = 0
    for t, mini in enumerate(per_tile):
        if len(mini) > nb:
            n_over += 1
            continue
        for j, (s0, l0) in enumerate(mini):
            starts[t, j] = s0
            lens[t, j] = l0
    return starts, lens, nb, n_over


# Why the last build_cellwin_graph call declined (the text of the check
# that fired), or None after a build.
LAST_NOTE = None


def _note(msg: str) -> None:
    """Build-time diagnostic: kept in :data:`LAST_NOTE`, and printed to
    stderr under DC_CELLWIN_DEBUG=1 (as the JAX package prints it)."""
    import os
    import sys

    global LAST_NOTE
    LAST_NOTE = msg
    if os.environ.get("DC_CELLWIN_DEBUG"):
        print("[cellwin] %s" % msg, file=sys.stderr)


def _dense_starts(lin_sorted: np.ndarray, n_cells: int) -> np.ndarray:
    """Cumulative bucket starts (n_cells + 1) of a sorted linear-id array
    (ids >= n_cells — the invalid-item sentinel — fall past the end)."""
    return np.searchsorted(lin_sorted, np.arange(n_cells + 1)).astype(np.int64)


def build_cellwin_graph(
    est_points: np.ndarray,
    valid: np.ndarray,
    qrows: np.ndarray,
    nn: np.ndarray,
    r: float,
    row_cap: int = 128,
    pt_cap: int = 128,
    span_limit: int = 512,
    eps_rel: float = 2e-5,
    max_exc_frac: float = 0.05,
    z_max: Optional[int] = None,
    f_slot_budget: int = 16,
) -> Optional[CellWinGraph]:
    """Build the static cell-window graph, or None when ineligible.

    :param est_points: (M, 3) establishment-time global positions (f64).
    :param valid: (M,) validity of the merged table.
    :param qrows: (Mq0,) compacted query rows (original indices, -1 pad).
    :param nn: (Mq0, K) frozen UNCAPPED within-r graph (original indices,
        -1 pad), aligned with ``qrows``.
    :param r: neighborhood radius (the graph must be within-r exact).
    :param span_limit: max window span length; scenes whose densest 3-cell
        z-run exceeds it are ineligible (the dense window would not fit
        VMEM).
    :param max_exc_frac: give up (return None) when more than this fraction
        of rows needs the gather fallback — the kernel would win nothing.
    :param eps_rel: boundary-ambiguity margin, relative to r^2. The kernels
        classify membership in f32 difference form (error a few ulps of
        ~r^2, i.e. ~1e-7 relative); 2e-5 gives two orders of margin while
        keeping the exception-row fraction low on dense graphs.
    :param z_max: tile z-extent limit in cells (see _build_tiles).
    :param f_slot_budget: max forward mini-spans per row tile; over-budget
        tiles degrade to the gather exception path (p99 of the bench
        distribution is 16, so the default exceptions ~1% of rows).
    """
    global LAST_NOTE
    LAST_NOTE = None
    est_points = np.asarray(est_points, np.float64)
    # The kernels read establishment positions quantized to float32 at
    # GLOBAL magnitude (q_est / est_sorted are f32 tables); the exactness
    # audit below must therefore simulate membership on the same rounded
    # values — the quantization error scales with |coordinate| (~|x| *
    # 2^-24 * 2r on d2), which can exceed the eps band on large scenes,
    # while the kernels' remaining f32 arithmetic error on tile-shifted
    # (small) coordinates stays orders below eps.
    est_f32 = est_points.astype(np.float32).astype(np.float64)
    valid = np.asarray(valid, bool)
    qrows = np.asarray(qrows, np.int64)
    nn = np.asarray(nn, np.int64)
    m0 = est_points.shape[0]
    r2 = float(r) * float(r)

    cc, lin, mins, dims, cell = _cell_grid(est_points, valid, float(r))
    n_cells = int(dims.prod())
    # Invalid points sort past every real cell and never enter a span.
    lin_pts = np.where(valid, lin, n_cells)

    # ---- padded point layout (bwd tiles) ----
    p_order = np.argsort(lin_pts, kind="stable")
    lin_p_sorted = lin_pts[p_order]
    nvalid = int(valid.sum())
    order_valid = p_order[:nvalid]
    cc_pts = cc[order_valid]

    pt_starts = _dense_starts(lin_p_sorted[:nvalid], n_cells)

    # Probe uses the unpadded sorted layout; the padded span lengths can
    # only grow by the padding of tiles fully inside the window, bounded
    # below by construction (padding inflates a span by < pt_cap per tile
    # inside it) — so tiles are built against a conservative budget and
    # spans are recomputed over the padded layout afterwards.
    def probe_pts(cx, ylo, yhi, zlo, zhi):
        return (
            _window_spans_max(pt_starts, dims, cx, ylo, yhi, zlo, zhi)
            <= span_limit
        )

    pt_tiles = _build_tiles(cc_pts, pt_cap, probe_pts, z_max=z_max)
    t2 = len(pt_tiles)
    m_pad = t2 * pt_cap

    perm = np.zeros(m_pad, np.int64)
    perm_valid = np.zeros(m_pad, bool)
    lin_padded = np.full(m_pad, n_cells, np.int64)
    for t, (a, b, cx, ylo, yhi, zlo, zhi) in enumerate(pt_tiles):
        k = b - a
        sl = slice(t * pt_cap, t * pt_cap + k)
        perm[sl] = order_valid[a:b]
        perm_valid[sl] = True
        lin_padded[sl] = lin_pts[order_valid[a:b]]
        # padding slots inherit the tile's last cell id to keep the padded
        # layout sorted (their est positions are sentinels below)
        lin_padded[t * pt_cap + k : (t + 1) * pt_cap] = lin_padded[
            t * pt_cap + max(k - 1, 0)
        ]
    # Invalid points have no slot: -1, so permute_rows' backward gives
    # them a zero gradient.
    inv = np.full(m0, -1, np.int64)
    inv[perm[perm_valid]] = np.flatnonzero(perm_valid)

    est_sorted = np.zeros((8, m_pad), np.float32)
    # Opposite-sign sentinels: padding POINTS sit at +1e15 and padding
    # ROWS at -1e15, so sentinel-sentinel pairs are far apart too (a
    # shared sentinel would have distance zero and pass membership) and
    # squared magnitudes stay finite in float32.
    est_sorted[:3, :] = np.where(
        perm_valid[None, :], est_points[perm].T, 1e15
    ).astype(np.float32)

    pt_starts_padded = _dense_starts(lin_padded, n_cells)

    # ---- row layout (fwd tiles) ----
    rows = qrows[qrows >= 0]
    mq_real = rows.shape[0]
    if mq_real == 0:
        _note("declined: no query rows")
        return None
    lin_rows = lin[rows]
    r_order = np.argsort(lin_rows, kind="stable")
    rows_sorted = rows[r_order]
    cc_rows = cc[rows_sorted]

    def probe_rows(cx, ylo, yhi, zlo, zhi):
        return (
            _window_spans_max(
                pt_starts_padded, dims, cx, ylo, yhi, zlo, zhi
            )
            <= span_limit
        )

    row_tiles = _build_tiles(cc_rows, row_cap, probe_rows, z_max=z_max)
    t1 = len(row_tiles)
    mq_pad = t1 * row_cap

    row_map = np.full(mq_pad, -1, np.int64)
    lin_rows_padded = np.full(mq_pad, n_cells, np.int64)
    f_span_start = np.zeros((t1, NS), np.int64)
    f_span_len = np.zeros((t1, NS), np.int64)
    f_tile_ctr = np.zeros((t1, 3), np.float64)
    # r_order position (into rows_sorted) per padded slot, for bookkeeping
    slot_of_sorted_row = np.full(mq_real, -1, np.int64)
    for t, (a, b, cx, ylo, yhi, zlo, zhi) in enumerate(row_tiles):
        k = b - a
        sl = slice(t * row_cap, t * row_cap + k)
        row_map[sl] = r_order[a:b]
        slot_of_sorted_row[a:b] = np.arange(t * row_cap, t * row_cap + k)
        lin_rows_padded[sl] = lin_rows[r_order[a:b]]
        lin_rows_padded[t * row_cap + k : (t + 1) * row_cap] = (
            lin_rows_padded[t * row_cap + max(k - 1, 0)]
        )
        st, ln = _window_spans(
            pt_starts_padded, dims, cx, ylo, yhi, zlo, zhi
        )
        if ln.max(initial=0) > span_limit:
            # Over-budget window (an irreducibly dense single-row tile, or
            # tile padding pushed a span over): degrade gracefully — leave
            # the tile's spans empty so the exactness audit routes its rows
            # through the gather path (every frozen neighbor reads as
            # missing) instead of declining the whole graph.
            continue
        f_span_start[t] = st
        f_span_len[t] = ln
        f_tile_ctr[t] = mins + cell * np.array(
            [cx + 0.5, (ylo + yhi + 1) * 0.5, (zlo + zhi + 1) * 0.5]
        )

    q_est = np.zeros((8, mq_pad), np.float32)
    sel = row_map >= 0
    q_est[:3, sel] = est_points[rows[np.maximum(row_map[sel], 0)]].T.astype(
        np.float32
    )
    q_est[:3, ~sel] = -1e15

    # 128-col mini-spans: every slot's dense work is one (128, R) tile
    # instead of a span_limit-wide window that averaged ~10% occupancy.
    # Over-budget row tiles (needing > f_block_budget slots; ~1% on the
    # bench graph) zero out and their rows route through the gather path.
    f_span_start, f_span_len, ns_f, n_over_f = _decompose_minispans(
        f_span_start, f_span_len, budget=f_slot_budget
    )
    # Lane-aligned span cap (128 by construction: mini-spans satisfy
    # start % 128 + len <= 128; Mosaic needs 128-divisible dynamic DMA
    # offsets, so the kernels DMA from start - start % 128 and mask the
    # lead — the cap holds lead + length).
    span_cap = int(max((f_span_start % 128 + f_span_len).max(initial=1), 1))
    span_cap = -(-span_cap // 128) * 128

    # ---- backward span tables: point tiles windowed over padded rows ----
    row_starts_padded = _dense_starts(lin_rows_padded, n_cells)
    b_span_start = np.zeros((t2, NS), np.int64)
    b_span_len = np.zeros((t2, NS), np.int64)
    b_tile_ctr = np.zeros((t2, 3), np.float64)
    for t, (a, b, cx, ylo, yhi, zlo, zhi) in enumerate(pt_tiles):
        st, ln = _window_spans(
            row_starts_padded, dims, cx, ylo, yhi, zlo, zhi
        )
        b_span_start[t] = st
        b_span_len[t] = ln
        b_tile_ctr[t] = mins + cell * np.array(
            [cx + 0.5, (ylo + yhi + 1) * 0.5, (zlo + zhi + 1) * 0.5]
        )
    # Backward mini-spans are sized to the densest point tile (a point's
    # gradient cannot route through exceptions, so no budget) — decline
    # only on a pathological slot count.
    b_span_start, b_span_len, ns_b, _ = _decompose_minispans(
        b_span_start, b_span_len, budget=None
    )
    if ns_b > 40:
        _note("declined: ns_b=%d > 40 (pathological backward slot count)"
              % ns_b)
        return None
    rspan_cap = int(max((b_span_start % 128 + b_span_len).max(initial=1), 1))
    rspan_cap = -(-rspan_cap // 128) * 128

    # ---- exactness audit: simulate the kernel membership in f64 ----
    # For every row, membership over its tile window must equal the frozen
    # graph exactly, with no pair within eps of the r2 boundary. Rows that
    # fail either test fall back to the gather path.
    exc = np.zeros(mq_real, bool)  # indexed by sorted-row position
    eps = eps_rel * r2
    # frozen pair sets in padded point indices, grouped by sorted row (an
    # invalid neighbour, which establishment never lists, maps to -1)
    nn_sorted = nn[r_order]  # (Mq_real, K)
    nn_padded = np.where(nn_sorted >= 0, inv[np.maximum(nn_sorted, 0)], -1)
    k_dim = nn_padded.shape[1]
    for t, (a, b, cx, ylo, yhi, zlo, zhi) in enumerate(row_tiles):
        st, ln = f_span_start[t], f_span_len[t]
        w_idx = np.concatenate(
            [np.arange(st[s], st[s] + ln[s]) for s in range(ns_f) if ln[s] > 0]
        ) if ln.max(initial=0) > 0 else np.zeros(0, np.int64)
        q = est_f32[rows_sorted[a:b]]  # (kk, 3) f32-rounded, f64 math
        if w_idx.size:
            x = est_f32[perm[w_idx]]  # (W, 3); sentinels excluded
            xv = perm_valid[w_idx]
            d2 = (
                (q * q).sum(1)[:, None]
                + (x * x).sum(1)[None, :]
                - 2.0 * (q @ x.T)
            )
            member = (d2 <= r2) & xv[None, :]
            near = np.abs(d2 - r2) <= eps
            exc[a:b] |= (near & xv[None, :]).any(1)
            # Compare with the frozen graph, vectorized: the window indices
            # are globally ascending (spans are listed in increasing
            # linear-cell order and are disjoint), so set equality is
            # "member count == frozen count AND every frozen pair is a
            # member" (frozen sets have no duplicates).
            fr = nn_padded[a:b]  # (kk, K) padded point indices, -1 pad
            pos = np.searchsorted(w_idx, np.maximum(fr, 0))
            posc = np.clip(pos, 0, w_idx.size - 1)
            in_win = (pos < w_idx.size) & (
                w_idx[posc] == np.maximum(fr, 0)
            )
            in_member = np.take_along_axis(
                member, np.clip(posc, 0, member.shape[1] - 1), axis=1
            )
            frozen_ok = np.where(fr >= 0, in_win & in_member, True).all(1)
            row_ok = frozen_ok & (member.sum(1) == (fr >= 0).sum(1))
            exc[a:b] |= ~row_ok
        else:
            # no window at all: every frozen neighbor is missing
            exc[a:b] |= (nn_padded[a:b] >= 0).any(1)

    n_exc = int(exc.sum())
    if n_exc > max_exc_frac * mq_real:
        _note(
            "declined: %d/%d exception rows (%.2f%% > %.2f%%); "
            "%d over-budget row tiles" % (
                n_exc, mq_real, 100.0 * n_exc / mq_real,
                100.0 * max_exc_frac, n_over_f,
            )
        )
        return None
    if n_exc:
        exc_slots = slot_of_sorted_row[exc]
        exc_nn = nn_padded[exc]
    else:
        exc_slots = np.zeros(0, np.int64)
        exc_nn = np.zeros((0, k_dim), np.int64)

    return CellWinGraph(
        r2=r2,
        n_row_tiles=t1,
        row_cap=row_cap,
        span_cap=span_cap,
        ns_f=ns_f,
        f_span_start=f_span_start.astype(np.int32),
        f_span_len=f_span_len.astype(np.int32),
        f_tile_ctr=f_tile_ctr.astype(np.float32),
        q_est=q_est,
        row_map=row_map.astype(np.int32),
        n_pt_tiles=t2,
        pt_cap=pt_cap,
        rspan_cap=rspan_cap,
        ns_b=ns_b,
        b_span_start=b_span_start.astype(np.int32),
        b_span_len=b_span_len.astype(np.int32),
        b_tile_ctr=b_tile_ctr.astype(np.float32),
        perm=perm.astype(np.int32),
        perm_valid=perm_valid,
        inv=inv.astype(np.int32),
        est_sorted=est_sorted,
        exc_slots=exc_slots.astype(np.int32),
        exc_nn=exc_nn.astype(np.int32),
        n_rows=mq_real,
        n_exc=n_exc,
    )


# ---------------------------------------------------------------------------
# Kernels: CUDA on CUDA tensors, plain torch on CPU tensors.
#
# K1 (cellwin_fwd) replaces depth_correction_tpu/ops/cellwin.py:_fwd_kernel
# and K2 (cellwin_bwd) replaces :_bwd_kernel; both are in csrc/cellwin.cu.
# What bounds them on an H100: instruction issue per membership test and
# per member accumulation — the window's bytes are few. Design: one lane
# per row (K1) / point (K2) with register accumulators; each warp reads its
# tile's window, buffers in shared memory the entries that a conservative
# test against the box of its real rows (points) keeps, and walks only
# those (csrc/cellwin_fwd.cuh; scripts/cellwin_cull.py counts them on the
# host); raw span starts bound every read; no atomics.
# The TPU kernels' workarounds are left out: the bf16 mantissa-split
# _moment_dot and its DC_CELLWIN_PREC / DC_CELLWIN_KCAT knobs (f32 FMAs in
# registers are exact-class on this card), the 128-lane start/lead
# alignment and the sentinel window columns (Mosaic DMA rules).
# ---------------------------------------------------------------------------

# Launch counts of the CUDA kernels; each wrapper adds one where it launches
# its kernel and nowhere else (the plain versions never count).
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

# Elements of the largest (tiles, slots, window) intermediate the plain
# versions materialize at once.
_PLAIN_CHUNK_ELEMS = 1 << 23


def _span_index(starts, lens):
    """(T, ns) span tables -> (T, ns * L) flat window indices (0 outside a
    span: every read stays in range) and the (T, ns * L) in-span mask."""
    t_dim = starts.shape[0]
    width = max(int(lens.max()) if lens.numel() else 0, 1)
    ar = torch.arange(width, device=starts.device)
    sel = ar < lens.long()[..., None]
    idx = torch.where(sel, starts.long()[..., None] + ar, torch.zeros_like(ar))
    return idx.reshape(t_dim, -1), sel.reshape(t_dim, -1)


def _fwd_windows(pts_sorted, q_est, est_sorted, f_start, f_len, f_ctr):
    """K1's per-pair inputs, one chunk of row tiles at a time, in the dtype
    and on the device of ``pts_sorted``.

    :yield: (d2 (c, R, W) on tile-centred establishment coordinates, the
        in-span mask (c, 1, W), the row-centred current coordinates (three
        (c, R, W)), the tile-centred rows (3, c, R), the centres (c, 3)).
    """
    dt, dev = pts_sorted.dtype, pts_sorted.device
    t1 = f_start.shape[0]
    mq_pad = q_est.shape[1]
    r_cap = mq_pad // t1
    idx, sel = _span_index(f_start.to(dev), f_len.to(dev))
    width = idx.shape[1]
    est = est_sorted[:3].to(device=dev, dtype=dt)
    q = q_est[:3].to(device=dev, dtype=dt).reshape(3, t1, r_cap)
    ctr = f_ctr.to(device=dev, dtype=dt)
    step = max(1, _PLAIN_CHUNK_ELEMS // (r_cap * width))
    for a in range(0, t1, step):
        b = min(t1, a + step)
        ix, sl = idx[a:b], sel[a:b]
        c = ctr[a:b].T[:, :, None]  # (3, c, 1)
        e = est[:, ix] - c  # (3, c, W) tile-centred est window
        qq = q[:, a:b] - c  # (3, c, R) tile-centred est rows
        dx = e[0][:, None, :] - qq[0][:, :, None]  # (c, R, W)
        dy = e[1][:, None, :] - qq[1][:, :, None]
        dz = e[2][:, None, :] - qq[2][:, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        x = pts_sorted[ix] - ctr[a:b][:, None, :]  # (c, W, 3) tile-centred current
        # Row-centred current coordinates (see the kernel).
        xr = tuple(x[..., k][:, None, :] - qq[k][:, :, None] for k in range(3))
        yield d2, sl[:, None, :], xr, qq, ctr[a:b]


def cellwin_fwd_plain(pts_sorted, q_est, est_sorted, f_start, f_len, f_ctr,
                      r2: float):
    """Plain torch version of K1, in the dtype and on the device of
    ``pts_sorted`` (vectorized per chunk of row tiles): membership in the
    tile-centred difference form, sums about each row's own establishment
    position, the TPU kernel's epilogue.

    :param pts_sorted: (m_pad, 3) CURRENT positions, padded cell-sorted.
    :param q_est: (>=3, mq_pad) establishment positions of the padded rows.
    :param est_sorted: (>=3, m_pad) establishment positions of the points.
    :param f_start, f_len: (t1, ns) span tables into the point axis.
    :param f_ctr: (t1, 3) tile centres.
    :return: raw (10, mq_pad): mean (3), cov 00/11/22/01/02/12, w_sum.
    """
    zero = torch.zeros((), dtype=pts_sorted.dtype, device=pts_sorted.device)
    parts = []
    for d2, sl, xr, qq, cb in _fwd_windows(pts_sorted, q_est, est_sorted, f_start,
                                           f_len, f_ctr):
        member = (d2 <= r2) & sl  # (c, R, W)
        x0, x1, x2 = (torch.where(member, xk, zero) for xk in xr)
        s0 = member.sum(-1).to(pts_sorted.dtype)
        s0c = torch.clamp(s0, min=1e-12)
        m0, m1, m2 = x0.sum(-1) / s0c, x1.sum(-1) / s0c, x2.sum(-1) / s0c
        denom = torch.clamp(s0 - 1.0, min=1e-6)
        parts.append(torch.stack([
            (m0 + qq[0]) + cb[:, 0:1], (m1 + qq[1]) + cb[:, 1:2],
            (m2 + qq[2]) + cb[:, 2:3],
            ((x0 * x0).sum(-1) - s0 * m0 * m0) / denom,
            ((x1 * x1).sum(-1) - s0 * m1 * m1) / denom,
            ((x2 * x2).sum(-1) - s0 * m2 * m2) / denom,
            ((x0 * x1).sum(-1) - s0 * m0 * m1) / denom,
            ((x0 * x2).sum(-1) - s0 * m0 * m2) / denom,
            ((x1 * x2).sum(-1) - s0 * m1 * m2) / denom,
            s0c,
        ], 0).reshape(10, -1))
    return torch.cat(parts, 1)


def cellwin_bwd_plain(pts_sorted, q_est, est_sorted, table9, b_start, b_len,
                      b_ctr, r2: float):
    """Plain torch version of K2, in the dtype and on the device of
    ``pts_sorted``: per point tile, sum the referencing rows' cotangent
    rows (S00, S11, S22, S01, S02, S12, u0, u1, u2) through the membership
    test and return grad = S x + u, (m_pad, 3)."""
    dt, dev = pts_sorted.dtype, pts_sorted.device
    t2 = b_start.shape[0]
    m_pad = pts_sorted.shape[0]
    p_cap = m_pad // t2
    idx, sel = _span_index(b_start.to(dev), b_len.to(dev))
    width = idx.shape[1]
    q = q_est[:3].to(device=dev, dtype=dt)
    tab = table9.to(device=dev, dtype=dt)
    est = est_sorted[:3].to(device=dev, dtype=dt).reshape(3, t2, p_cap)
    ctr = b_ctr.to(device=dev, dtype=dt)
    pts = pts_sorted.reshape(t2, p_cap, 3)
    step = max(1, _PLAIN_CHUNK_ELEMS // (p_cap * width))
    parts = []
    for a in range(0, t2, step):
        b = min(t2, a + step)
        ix, sl = idx[a:b], sel[a:b]
        c = ctr[a:b].T[:, :, None]
        qr = q[:, ix] - c  # (3, c, W) tile-centred row est window
        ep = est[:, a:b] - c  # (3, c, P) tile-centred point est
        dx = qr[0][:, None, :] - ep[0][:, :, None]  # (c, P, W)
        dy = qr[1][:, None, :] - ep[1][:, :, None]
        dz = qr[2][:, None, :] - ep[2][:, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        w = ((d2 <= r2) & sl[:, None, :]).to(dt)
        rows = tab[:, ix].permute(1, 2, 0)  # (c, W, 9)
        rows = torch.where(sl[..., None], rows, torch.zeros_like(rows))
        s = w @ rows  # (c, P, 9)
        x0, x1, x2 = pts[a:b].unbind(-1)
        parts.append(torch.stack([
            s[..., 0] * x0 + s[..., 3] * x1 + s[..., 4] * x2 + s[..., 6],
            s[..., 3] * x0 + s[..., 1] * x1 + s[..., 5] * x2 + s[..., 7],
            s[..., 4] * x0 + s[..., 5] * x1 + s[..., 2] * x2 + s[..., 8],
        ], -1).reshape(-1, 3))
    return torch.cat(parts, 0)


def cellwin_fwd(pts_sorted, q_est, est_sorted, f_start, f_len, f_ctr,
                r2: float):
    """K1 wrapper: the CUDA kernel for CUDA tensors (float32 only; anything
    else raises), :func:`cellwin_fwd_plain` for CPU tensors."""
    global FWD_LAUNCHES
    if pts_sorted.device.type == "cpu":
        return cellwin_fwd_plain(pts_sorted, q_est, est_sorted, f_start,
                                 f_len, f_ctr, r2)
    out = _kernels.launch_cellwin_fwd(pts_sorted, q_est, est_sorted, f_start,
                                      f_len, f_ctr, r2)
    FWD_LAUNCHES += 1
    return out


def cellwin_bwd(pts_sorted, q_est, est_sorted, table9, b_start, b_len,
                b_ctr, r2: float):
    """K2 wrapper: the CUDA kernel for CUDA tensors (float32 only; anything
    else raises), :func:`cellwin_bwd_plain` for CPU tensors."""
    global BWD_LAUNCHES
    if pts_sorted.device.type == "cpu":
        return cellwin_bwd_plain(pts_sorted, q_est, est_sorted, table9,
                                 b_start, b_len, b_ctr, r2)
    out = _kernels.launch_cellwin_bwd(pts_sorted, q_est, est_sorted, table9,
                                      b_start, b_len, b_ctr, r2)
    BWD_LAUNCHES += 1
    return out




def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Device-side graph + public op
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CellWinDevice:
    """Device-resident cell-window graph.

    Span starts are the builder's raw starts (no 128-lane alignment).
    ``perm``/``inv`` map the ORIGINAL merged point table into the padded
    cell-sorted layout the kernels consume (use with
    ``ops.features.permute_rows``; padding slots read row 0 and their
    gradients are dropped by the inverse gather; invalid points have
    ``inv`` -1 and receive a zero gradient).
    """

    q_est: torch.Tensor  # (8, mq_pad) float32
    est_sorted: torch.Tensor  # (8, m_pad) float32
    f_start: torch.Tensor  # (t1, ns_f) int32
    f_len: torch.Tensor
    f_ctr: torch.Tensor  # (t1, 3) float32
    b_start: torch.Tensor  # (t2, ns_b) int32
    b_len: torch.Tensor
    b_ctr: torch.Tensor  # (t2, 3) float32
    perm: torch.Tensor  # (m_pad,) int64
    inv: torch.Tensor  # (n_orig,) int64, -1 for invalid points
    row_map: torch.Tensor  # (mq_pad,) int64 -> original compacted row / -1
    exc_slots: torch.Tensor  # (E,) int64
    exc_nn: torch.Tensor  # (E, K) int64 neighbors in padded point indices
    exc_w: torch.Tensor  # (E, K) float32
    r2: float
    n_exc: int
    # The exception rows' transpose over the m_pad padded points, for their
    # gather moments' backward (X4); rebuilt after a prep-cache load.
    exc_tg: Optional[TransposeGraph] = None


def with_exc_transpose(dev: CellWinDevice) -> CellWinDevice:
    """``dev`` with the transpose of its exception rows over its m_pad
    points (JAX package, cellwin.py:1120-1133), its targets in the cell
    order of their establishment positions."""
    return dataclasses.replace(dev, exc_tg=build_transpose_graph(
        dev.exc_nn, dev.est_sorted[:3].T, dev.exc_w))


def graph_to_device(g: CellWinGraph, device=None) -> CellWinDevice:
    """Upload the host graph to ``device``, with the exception rows'
    transpose."""

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return with_exc_transpose(CellWinDevice(
        q_est=t(g.q_est, torch.float32),
        est_sorted=t(g.est_sorted, torch.float32),
        f_start=t(g.f_span_start, torch.int32),
        f_len=t(g.f_span_len, torch.int32),
        f_ctr=t(g.f_tile_ctr, torch.float32),
        b_start=t(g.b_span_start, torch.int32),
        b_len=t(g.b_span_len, torch.int32),
        b_ctr=t(g.b_tile_ctr, torch.float32),
        perm=t(g.perm, torch.int64),
        inv=t(g.inv, torch.int64),
        row_map=t(g.row_map, torch.int64),
        exc_slots=t(g.exc_slots, torch.int64),
        exc_nn=t(g.exc_nn, torch.int64),
        exc_w=t(g.exc_nn >= 0, torch.float32),
        r2=float(g.r2),
        n_exc=int(g.n_exc),
    ))


class CellWinCore(torch.autograd.Function):
    """Raw (10, mq_pad) moments of the padded row tiles: forward K1,
    backward ``_cotangent_table`` -> K2 (the JAX package's
    ``_cellwin_core`` custom VJP). ``plain`` computes both directions with
    the plain versions on any device and dtype (reference runs)."""

    @staticmethod
    def forward(ctx, pts_sorted, dev: CellWinDevice, plain: bool):
        fwd = cellwin_fwd_plain if plain else cellwin_fwd
        raw = fwd(pts_sorted, dev.q_est, dev.est_sorted, dev.f_start,
                  dev.f_len, dev.f_ctr, dev.r2)
        ctx.save_for_backward(pts_sorted, raw)
        ctx.dev = dev
        ctx.plain = plain
        return raw

    @staticmethod
    def backward(ctx, g_raw):
        pts_sorted, raw = ctx.saved_tensors
        dev = ctx.dev
        # g_raw[9] (w_sum) is ignored, as in the JAX package: the loss
        # reads the moments only.
        table9 = _cotangent_table(raw[0:3], raw[9],
                                  (g_raw[0:3], tuple(g_raw[3:9])))
        bwd = cellwin_bwd_plain if ctx.plain else cellwin_bwd
        grad = bwd(pts_sorted, dev.q_est, dev.est_sorted, table9.contiguous(),
                   dev.b_start, dev.b_len, dev.b_ctr, dev.r2)
        return grad, None, None


def cellwin_moments(pts_sorted, dev: CellWinDevice, plain: bool = False):
    """Weighted neighborhood moments over the padded row tiles.

    :param pts_sorted: (m_pad, 3) CURRENT positions in the padded
        cell-sorted layout (permute the merged table with ``dev.perm``).
    :param plain: use the plain torch kernels on any device (reference
        runs); otherwise the wrappers (CUDA kernels on CUDA tensors).
    :return: (mean (3, mq_pad), comps 6-tuple of (mq_pad,)).

    Exception rows are recomputed by the gather moments and merged
    (JAX package, cellwin.py:1181-1190); ``index_copy`` routes their
    gradients through the gather branch only, whose backward is X4 over
    ``dev.exc_tg``.
    """
    raw = CellWinCore.apply(pts_sorted, dev, plain)
    mean = raw[0:3]
    comps = tuple(raw[3 + i] for i in range(6))
    if dev.n_exc:
        em, ec = neighborhood_moments(pts_sorted, dev.exc_nn, dev.exc_w, dev.exc_tg, plain)
        mean = mean.index_copy(1, dev.exc_slots, em)
        comps = tuple(c.index_copy(0, dev.exc_slots, e) for c, e in zip(comps, ec))
    return mean, comps


def cellwin_features(pts_sorted, dev: CellWinDevice, plain: bool = False):
    """Feature dict over the padded rows: mean (mq_pad, 3), trace and
    ascending eigvals (mq_pad, 3) — the loss-path tail of
    ``neighborhood_features``."""
    mean, comps = cellwin_moments(pts_sorted, dev, plain=plain)
    a00, a11, a22, a01, a02, a12 = comps
    return {
        "mean": mean.T,
        "trace": a00 + a11 + a22,
        "eigvals": torch.stack(eigvals3_c(*comps), -1),
    }
