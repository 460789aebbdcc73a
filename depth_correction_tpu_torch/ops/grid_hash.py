"""Grid-hash (voxel-bucket) neighbour search and the cell sorts built on it
(counterpart of ``depth_correction_tpu/ops/grid_hash.py``).

Points are bucketed into cells of side >= r, so every within-r neighbour of
a query lies in the 27 cells around the query's own. Everything runs on
the points' device in plain torch, with the JAX package's arithmetic
(float bbox and cell sizing, int32-range cell ids, the sentinel id past
every real cell on invalid rows, stable sorts), so both packages build the
same tables:

- the grid build: :func:`_build_grid` (host-sized grid; the plain twin's
  window, :func:`_query_window`, is the dense per-cell start table up to
  ``_DENSE_STARTS_MAX_CELLS`` cells and the searched form above it),
  :func:`grid_sort_traced` and :func:`grid_establish_traced` (sized on
  the device, the cell doubling until the grid fits a static table);
- the query: :func:`grid_query` gives each query its up-to-k nearest
  within-r neighbours (or its within-r count, k = 0) from the 9 (dx, dy)
  columns of 3 z-cells around it. On CUDA tensors it launches kernel X2
  (``csrc/grid_query.cu``), which reads each column's run of sorted points
  to its own length; on CPU tensors it runs :func:`_grid_query_chunk_plain`,
  the plain twin of the JAX package's ``_grid_query_chunk_impl``, windows
  and all. :func:`grid_radius_neighbors` and :func:`grid_neighbor_counts`
  are the entry points;
- :func:`grid_sort_colpad_traced`, the column-aligned sort of the online
  corrector's slab engine (``ops/slabwin.py``): the longest grid axis
  major, every major-axis column's run starting at a multiple of 128
  slots, so that every 128-query tile of the slab engine lies in one
  column.

:func:`grid_radius_neighbors_sharded` splits the queries over the ranks of
a process group: each rank builds the whole grid and queries its slice.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _kernels
from ..utils import trace

__all__ = [
    "GRID_NN_MIN_POINTS",
    "cell_candidates",
    "colpad_dims0_ideal",
    "grid_establish_traced",
    "grid_neighbor_counts",
    "grid_occupancy",
    "grid_query",
    "grid_radius_neighbors",
    "grid_radius_neighbors_sharded",
    "grid_sort_colpad_traced",
    "grid_sort_traced",
]

# Queries per chunk of the plain twin (JAX package, grid_hash.py:45).
_QUERY_CHUNK = 32768
# Below this padded size the tiled scan beats the grid (establishment
# routing, suggest_k_max) and the node routes to the brute-force engine
# (JAX package, grid_hash.py:48).
GRID_NN_MIN_POINTS = 65536
# Dense per-cell start table up to this many cells (grid_hash.py:51).
_DENSE_STARTS_MAX_CELLS = 1 << 23
# Bound on |cell coordinate| before the integer conversion: larger floats
# have no defined conversion, and such cells lie outside every grid.
_COORD_CLAMP = 2.0 ** 30


def cell_candidates(points, valid, r: float, n_cells_pad: int):
    """Masked bbox and the 32 candidate cell sides ``r * 2^i``: their grid
    mins, dims and whether the cell count fits ``n_cells_pad``."""
    dt = points.dtype
    inf = torch.full((), float("inf"), dtype=dt, device=points.device)
    lo = torch.where(valid[:, None], points, inf).amin(0)
    hi = torch.where(valid[:, None], points, -inf).amax(0)
    has_pts = torch.isfinite(lo).all()
    lo = torch.where(has_pts, lo, torch.zeros_like(lo))
    hi = torch.where(has_pts, hi, torch.zeros_like(hi))
    cells = torch.full((), r, dtype=dt, device=points.device) * torch.pow(
        2.0, torch.arange(32, dtype=dt, device=points.device))  # (32,)
    mins_c = torch.floor(lo[None] / cells[:, None]) * cells[:, None]  # (32, 3)
    # Clamped below 2^30 before the int conversion: such grids never fit
    # the table, and the conversion of a larger float is undefined.
    dims_c = torch.floor((hi[None] - mins_c) / cells[:, None]).clamp(max=2.0 ** 30)
    dims_c = dims_c.to(torch.int64) + 1  # (32, 3)
    log_cells = torch.log2(dims_c.to(dt)).sum(1)
    count_ok = log_cells <= (math.log2(n_cells_pad) - 1e-3)
    return cells, mins_c, dims_c, count_ok


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when none), like ``jnp.argmax`` of a bool."""
    return torch.argmax(mask.to(torch.int32))


def colpad_dims0_ideal(candidates) -> torch.Tensor:
    """The major grid dim of the finest cell side whose grid fits the
    table, from :func:`cell_candidates`: the column count a scan's layout
    needs (the side's index read on the host)."""
    _, _, dims_c, count_ok = candidates
    return dims_c[int(trace.to_host(_first_true(count_ok)))].amax()


def grid_sort_colpad_traced(points, valid, r: float, n_cells_pad: int,
                            x_cols_pad: int = 512, candidates=None):
    """Column-aligned cell sort (JAX package, grid_hash.py:325-465).

    :param points: (N, 3) positions.
    :param valid: (N,) bool; invalid rows sort past every cell.
    :param r: neighbourhood radius, the smallest cell side.
    :param n_cells_pad: cell-table bound; also the invalid rows' id.
    :param x_cols_pad: bound on the major grid dim (cells coarsen past it)
        and the number of 128-aligned column blocks.
    :param candidates: :func:`cell_candidates` of the same arguments, when
        the caller has them already.
    :return: ``(pts_pad_T (3, n_pad), valid_pad, ids_pad, slot_of_orig,
        mins, dims, cell, dims0_ideal)`` with ``n_pad = N + 128 *
        x_cols_pad``. ``ids_pad`` is non-decreasing (padding slots carry
        their column's last id, the tail the sentinel); padding slots are
        invalid and sit at 1e15. ``slot_of_orig`` maps each original row to
        its slot; ``dims`` is in id axis order (major first).
    """
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    if candidates is None:
        candidates = cell_candidates(points, valid, r, n_cells_pad)
    cells, mins_c, dims_c, count_ok = candidates
    feasible = count_ok & (dims_c.amax(1) <= x_cols_pad)
    ji = int(trace.to_host(_first_true(feasible)))
    cell, mins, dims = cells[ji], mins_c[ji], dims_c[ji]
    dims0_ideal = colpad_dims0_ideal(candidates)

    c = torch.floor((points - mins) / cell).clamp(-1.0, 2.0 ** 30).to(torch.int64)
    c = torch.minimum(c.clamp(min=0), dims[None] - 1)
    perm = torch.argsort(-dims, stable=True)  # longest axis major
    dims = dims[perm]
    c = c[:, perm]
    dimyz = dims[1] * dims[2]
    lin = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    ids = torch.where(valid, lin, torch.full_like(lin, n_cells_pad))
    order = torch.argsort(ids, stable=True)
    ids_sorted = ids[order]
    # Invalid rows go to the virtual overflow column whatever dimyz is.
    xcol_sorted = torch.where(ids_sorted >= n_cells_pad,
                              torch.full_like(ids_sorted, x_cols_pad),
                              torch.clamp(ids_sorted // dimyz, max=x_cols_pad))

    col_first_all = torch.searchsorted(
        xcol_sorted, torch.arange(x_cols_pad + 1, device=dev))  # (x_cols_pad + 1,)
    counts = col_first_all[1:] - col_first_all[:-1]
    col_first = col_first_all[:-1]
    padded_counts = -(-counts // 128) * 128
    ends_pad = torch.cumsum(padded_counts, 0)
    starts_pad = ends_pad - padded_counts
    used = ends_pad[-1]
    n_valid = col_first_all[-1]

    j = torch.arange(n, device=dev)
    colj = torch.clamp(xcol_sorted, max=x_cols_pad - 1)
    dest = torch.where(xcol_sorted < x_cols_pad,
                       starts_pad[colj] + (j - col_first[colj]),
                       used + (j - n_valid))

    # Slot -> sorted row from the block structure (no scatter needed).
    n_pad = n + 128 * x_cols_pad
    slot = torch.arange(n_pad, device=dev)
    col_of_slot = torch.searchsorted(ends_pad, slot, right=True)
    in_cols = col_of_slot < x_cols_pad
    colc = torch.clamp(col_of_slot, max=x_cols_pad - 1)
    off = slot - starts_pad[colc]
    j_of_slot = torch.where(in_cols, col_first[colc] + off, n_valid + (slot - used))
    has_src = torch.where(in_cols, off < counts[colc], j_of_slot < n)
    jj = torch.clamp(j_of_slot, 0, n - 1)
    src = order[jj]
    far = torch.full((), 1e15, dtype=points.dtype, device=dev)
    pts_pad_T = torch.where(has_src[None, :], points.T[:, src], far)
    valid_pad = has_src & valid[src]
    pad_id = torch.where(in_cols, (colc + 1) * dimyz - 1,
                         torch.full_like(colc, n_cells_pad))
    ids_pad = torch.where(has_src, ids_sorted[jj], pad_id)
    slot_of_orig = torch.empty_like(dest)
    slot_of_orig[order] = dest
    return (pts_pad_T.contiguous(), valid_pad, ids_pad, slot_of_orig, mins, dims,
            cell, dims0_ideal)


# ---------------------------------------------------------------------------
# The grid build.


def _cell_tensor(cell_size, like: torch.Tensor) -> torch.Tensor:
    """The cell side as a 0-d tensor on ``like``'s device and dtype. A
    Python float divisor would let PyTorch's CUDA division multiply by its
    reciprocal, which can put a point on a cell face into the next cell;
    a tensor divides as kernel X2 and the CPU do."""
    return torch.as_tensor(cell_size, dtype=like.dtype, device=like.device)


def _cell_ids(points, mins, dims, cell_size):
    """Linearized cell id per point; coordinates clamp into the grid
    (JAX package, grid_hash.py:54-59)."""
    cell = _cell_tensor(cell_size, points)
    c = torch.floor((points - mins) / cell).clamp(-1.0, _COORD_CLAMP).to(torch.int64)
    c = torch.minimum(c.clamp(min=0), dims[None] - 1)
    return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2], c


def _minmax(points, valid):
    """Masked per-axis min and max (grid_hash.py:62-70)."""
    inf = torch.full((), float("inf"), dtype=points.dtype, device=points.device)
    lo = torch.where(valid[:, None], points, inf).amin(0)
    hi = torch.where(valid[:, None], points, -inf).amax(0)
    return lo, hi


def _grid_meta(points, valid, cell_size: float):
    """Sizing on the host from six scalars (grid_hash.py:73-94): per-axis
    mins, cell-grid dims and the cell side, which doubles until the grid
    has fewer than 2^31 cells (exactness only needs cell >= r)."""
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    lo, hi = _minmax(points, valid)
    lo = lo.cpu().to(torch.float64).numpy()
    hi = hi.cpu().to(torch.float64).numpy()
    if not np.isfinite(lo).all():  # no valid points
        lo = hi = np.zeros(3)
    while True:
        mins = np.floor(lo / cell_size) * cell_size
        dims = np.floor((hi - mins) / cell_size).astype(np.int64) + 1
        if int(dims[0]) * int(dims[1]) * int(dims[2]) < 2 ** 31:
            return mins, dims.astype(np.int32), float(cell_size)
        cell_size = 2.0 * cell_size


def grid_occupancy(ids_sorted: torch.Tensor) -> torch.Tensor:
    """Largest run of equal ids in a sorted id array (grid_hash.py:97-105)."""
    if ids_sorted.numel() == 0:
        return torch.ones((), dtype=torch.int64, device=ids_sorted.device)
    return torch.unique_consecutive(ids_sorted, return_counts=True)[1].amax()


def _ceil_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


def _query_window(ids_sorted, n_cells: int, bucket_cap=None, static_shapes: bool = False):
    """The JAX query's window over a sorted grid of ``n_cells`` cells
    (grid_hash.py:636-676): ``(cell_starts or None, width)``, the dense
    start table up to ``_DENSE_STARTS_MAX_CELLS`` cells (a window of
    ``width`` slots a column) or none above (``3 * width`` slots from a
    binary search). One host read of the width."""
    dev = ids_sorted.device
    cell_starts = None
    if n_cells <= _DENSE_STARTS_MAX_CELLS:
        cell_starts = torch.searchsorted(
            ids_sorted, torch.arange(n_cells + 1, dtype=torch.int32, device=dev)
        ).to(torch.int32)
        if n_cells >= 3:
            win = int((cell_starts[3:] - cell_starts[:-3]).amax())
        else:
            win = int(cell_starts[-1] - cell_starts[0])
        if bucket_cap is not None:
            win = min(win, 3 * int(bucket_cap))
        width = max(int(-(-max(win, 1) // 8) * 8), 8)
    elif bucket_cap is None:
        # Occupancy of real cells only: invalid slots get distinct ids.
        neg = -torch.arange(ids_sorted.shape[0], dtype=torch.int32, device=dev) - 1
        occ = int(grid_occupancy(torch.where(ids_sorted >= n_cells, neg, ids_sorted)))
        width = max(int(-(-occ // 8) * 8), 8)
    else:
        width = int(bucket_cap)

    if static_shapes:
        # Power-of-two width and table length (the JAX package's recompile
        # bound); results are the same.
        width = _ceil_pow2(width)
        if cell_starts is not None:
            padded = _ceil_pow2(n_cells) + 1
            if padded > cell_starts.shape[0]:
                cell_starts = torch.cat([cell_starts, cell_starts[-1:].expand(
                    padded - cell_starts.shape[0])])
    return cell_starts, width


def _build_grid(points, valid_points, r: float, cell_size, bucket_cap,
                static_shapes: bool = False):
    """Host-sized grid (grid_hash.py:607-679).

    :return: ``(grid, width)``: ``grid = (pts_sorted_T (3, N), valid_sorted,
        ids_sorted int32, order int32, mins (3,), dims (3,) int64, cell,
        cell_starts or None)`` and the JAX query's static window width (the
        window is ``width`` slots a column with the dense table,
        ``3 * width`` without). Kernel X2 reads each run whole and needs
        neither, so on CUDA tensors without ``bucket_cap`` both are None.
    """
    cell = float(cell_size if cell_size is not None else r)
    if cell < r:
        raise ValueError("cell_size %g < r %g breaks 27-cell coverage" % (cell, r))
    dev = points.device
    if valid_points is None:
        valid_points = torch.ones(points.shape[0], dtype=torch.bool, device=dev)
    mins_np, dims_np, cell = _grid_meta(points, valid_points, cell)
    mins = torch.as_tensor(mins_np, dtype=points.dtype, device=dev)
    dims = torch.as_tensor(dims_np.astype(np.int64), device=dev)
    n_cells = int(dims_np[0]) * int(dims_np[1]) * int(dims_np[2])
    ids, _ = _cell_ids(points, mins, dims, cell)
    # Invalid rows take an id past every real cell: they sort to the end and
    # never fall in a searched run.
    ids = torch.where(valid_points, ids, torch.full_like(ids, n_cells)).to(torch.int32)
    order = torch.argsort(ids, stable=True).to(torch.int32)
    ids_sorted = ids[order]
    pts_sorted_T = points.T[:, order].contiguous()
    valid_sorted = valid_points[order]

    cell_starts, width = None, None
    if dev.type == "cpu" or bucket_cap is not None:
        cell_starts, width = _query_window(ids_sorted, n_cells, bucket_cap, static_shapes)
    grid = (pts_sorted_T, valid_sorted, ids_sorted, order, mins, dims, cell, cell_starts)
    return grid, width


def grid_sort_traced(points, valid, r: float, n_cells_pad: int, sort_axes=False):
    """Grid sort sized on the device (grid_hash.py:269-322): the finest cell
    side ``r * 2^i`` whose grid fits ``n_cells_pad`` cells, ids with the
    sentinel ``n_cells_pad`` on invalid rows, one stable sort.

    :param sort_axes: relabel the grid axes so slab consumers slice thin
        slabs: ``'major'`` / True puts the longest extent first,
        ``'second'`` the second-longest.
    :return: (pts_sorted_T (3, N), valid_sorted, ids_sorted int32, order
        int32, mins (3,), dims (3,) int64 in id axis order, cell (0-d)).
    """
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    cells, mins_c, dims_c, count_ok = cell_candidates(points, valid, r, n_cells_pad)
    ji = int(trace.to_host(_first_true(count_ok)))
    cell, mins, dims = cells[ji], mins_c[ji], dims_c[ji]
    c = torch.floor((points - mins) / cell).clamp(-1.0, _COORD_CLAMP).to(torch.int64)
    c = torch.minimum(c.clamp(min=0), dims[None] - 1)
    if sort_axes:
        perm = torch.argsort(-dims, stable=True)
        if sort_axes == "second":
            perm = perm[[1, 0, 2]]
        dims = dims[perm]
        c = c[:, perm]
    lin = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    ids = torch.where(valid, lin, torch.full_like(lin, n_cells_pad)).to(torch.int32)
    order = torch.argsort(ids, stable=True).to(torch.int32)
    return (points.T[:, order].contiguous(), valid[order], ids[order], order, mins, dims,
            cell)


def grid_establish_traced(points, valid, r: float, n_cells_pad: int):
    """:func:`grid_sort_traced` plus the dense start table over
    ``n_cells_pad + 1`` cells and ``true_win``, the largest 3-cell run
    (grid_hash.py:233-266), the JAX node's establishment. The port's node
    sorts with :func:`grid_sort_traced` alone: X2 reads neither.

    :return: ``(pts_sorted_T, valid_sorted, ids_sorted, order, mins, dims,
        cell, cell_starts, true_win)``.
    """
    (pts_sorted_T, valid_sorted, ids_sorted, order, mins, dims,
     cell) = grid_sort_traced(points, valid, r, n_cells_pad)
    cell_starts = torch.searchsorted(
        ids_sorted, torch.arange(n_cells_pad + 1, dtype=torch.int32, device=points.device)
    ).to(torch.int32)
    true_win = (cell_starts[3:] - cell_starts[:-3]).amax()
    return (pts_sorted_T, valid_sorted, ids_sorted, order, mins, dims, cell, cell_starts,
            true_win)


# ---------------------------------------------------------------------------
# The query: kernel X2 and its plain twin.

# The 9 (dx, dy) columns in the JAX package's order (grid_hash.py:135-137);
# a candidate's position in the top-k's tie order is its column, then its
# offset in the column's run.
_OFFS = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))


def _query_columns(q_pts, mins, dims, cell_size):
    """Each query's 9 columns (grid_hash.py:125-152): ``(col_ok (Q, 9),
    lo (Q, 9) clipped to the grid, hi (Q, 9), zlo (Q,), zhi (Q,))``; the
    column's cells are the linear ids [lo, hi] when ``col_ok``."""
    dev = q_pts.device
    cell = _cell_tensor(cell_size, q_pts)
    cq = torch.floor((q_pts - mins) / cell).clamp(-_COORD_CLAMP, _COORD_CLAMP)
    cq = cq.to(torch.int64)
    offs = torch.tensor(_OFFS, dtype=torch.int64, device=dev)
    cc = cq[:, None, :2] + offs[None]  # (Q, 9, 2)
    col_ok = (cc[..., 0] >= 0) & (cc[..., 0] < dims[0]) & (cc[..., 1] >= 0) & (cc[..., 1] < dims[1])
    zlo = torch.minimum((cq[:, 2] - 1).clamp(min=0), dims[2] - 1)
    zhi = torch.minimum((cq[:, 2] + 1).clamp(min=0), dims[2] - 1)
    base = (cc[..., 0] * dims[1] + cc[..., 1]) * dims[2]
    n_cells_total = dims[0] * dims[1] * dims[2]
    lo = torch.minimum((base + zlo[:, None]).clamp(min=0), n_cells_total - 1)
    return col_ok, lo, base + zhi[:, None], zlo, zhi


def _grid_query_chunk_plain(q_pts, q_valid, pts_sorted_T, valid_sorted, ids_sorted, order,
                            mins, dims, r2, k: int, bucket_cap: int, cell_size,
                            cell_starts=None):
    """Plain twin of the JAX package's ``_grid_query_chunk_impl``
    (grid_hash.py:108-225), in the dtype of the points.

    Candidates: per column a window of ``bucket_cap`` slots from the dense
    start table (``cell_starts`` given) or ``3 * bucket_cap`` slots from a
    binary search, masked to the column's cells; members: d2 <= r2 on valid
    queries, d2 summed x, y, z. ``k == 0`` returns the member counts (Q,)
    int32; otherwise the up-to-k nearest, by a stable sort on d2 over the
    candidates in (column, window offset) order, which is ``lax.top_k``'s
    order of ties: (d (Q, k), idx (Q, k) int32), -1 / inf padded, also when
    k exceeds the 9-window width.
    """
    n = ids_sorted.shape[0]
    q = q_pts.shape[0]
    dev = q_pts.device
    col_ok, lo, hi, zlo, zhi = _query_columns(q_pts, mins, dims, cell_size)
    if cell_starts is not None:
        n_cells = cell_starts.shape[0] - 1
        starts = cell_starts.to(torch.int64)
        zlen = (zhi - zlo + 1)[:, None]
        start = starts[lo.clamp(0, n_cells)]
        end = starts[(lo + zlen).clamp(0, n_cells)]
        length = torch.where(col_ok, end - start, torch.zeros_like(start))
        win = int(bucket_cap)
        w = torch.arange(win, device=dev)
        slots_raw = start[..., None] + w  # (Q, 9, win)
        slots = slots_raw.clamp(max=n - 1)
        in_window = w < length[..., None]
    else:
        start = torch.searchsorted(ids_sorted.to(torch.int64), lo)
        win = 3 * int(bucket_cap)
        w = torch.arange(win, device=dev)
        slots_raw = start[..., None] + w
        slots = slots_raw.clamp(max=n - 1)
        ids_c = ids_sorted[slots]
        in_window = ((ids_c >= lo[..., None]) & (ids_c <= hi[..., None]) & col_ok[..., None]
                     & (slots_raw < n) & valid_sorted[slots])
    slots = slots.reshape(q, 9 * win)
    in_window = in_window.reshape(q, 9 * win)
    dx = pts_sorted_T[0][slots] - q_pts[:, 0:1]
    dy = pts_sorted_T[1][slots] - q_pts[:, 1:2]
    dz = pts_sorted_T[2][slots] - q_pts[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    inf = torch.full((), float("inf"), dtype=d2.dtype, device=dev)
    d2 = torch.where(in_window & (d2 <= r2) & q_valid[:, None], d2, inf)
    if k == 0:  # counts-only mode
        return (~torch.isinf(d2)).sum(1).to(torch.int32)
    k_eff = min(k, d2.shape[1])
    best_d2, arg = torch.sort(d2, dim=1, stable=True)
    best_d2, arg = best_d2[:, :k_eff], arg[:, :k_eff]
    idx = order[torch.gather(slots, 1, arg)].to(torch.int32)
    missing = torch.isinf(best_d2)
    idx = torch.where(missing, torch.full_like(idx, -1), idx)
    d = torch.sqrt(torch.where(missing, torch.zeros_like(best_d2), best_d2))
    d = torch.where(missing, inf, d)
    if k_eff < k:
        pad = k - k_eff
        d = torch.cat([d, torch.full((q, pad), float("inf"), dtype=d.dtype, device=dev)], 1)
        idx = torch.cat([idx, torch.full((q, pad), -1, dtype=idx.dtype, device=dev)], 1)
    return d, idx


def _grid_query_plain(q_pts, q_valid, pts_sorted_T, valid_sorted, ids_sorted, order, mins,
                      dims, r2, k: int, bucket_cap: Optional[int], cell_size, cell_starts=None):
    """:func:`_grid_query_chunk_plain` over chunks of :data:`_QUERY_CHUNK`
    queries, on any device and dtype. Without ``bucket_cap`` the window is
    the largest 3-cell run of ``cell_starts`` (one host read); without
    either, the window :func:`_query_window` sizes for the grid's cells."""
    if bucket_cap is None:
        if cell_starts is None:
            n_cells = int(torch.prod(torch.as_tensor(dims).to(torch.int64)))
            cell_starts, bucket_cap = _query_window(ids_sorted, n_cells)
        else:
            bucket_cap = max(int((cell_starts[3:] - cell_starts[:-3]).amax()), 1)
    outs = [_grid_query_chunk_plain(q_pts[i:i + _QUERY_CHUNK], q_valid[i:i + _QUERY_CHUNK],
                                    pts_sorted_T, valid_sorted, ids_sorted, order, mins, dims,
                                    r2, k, bucket_cap, cell_size, cell_starts)
            for i in range(0, max(q_pts.shape[0], 1), _QUERY_CHUNK)]
    if k == 0:
        return torch.cat(outs)
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _kernel_cap(bucket_cap: Optional[int], cell_starts):
    """The run cut of the JAX query's window: ``bucket_cap`` slots with the
    dense table, ``3 * bucket_cap`` searched; None reads every run whole."""
    if bucket_cap is None:
        return None
    return int(bucket_cap) if cell_starts is not None else 3 * int(bucket_cap)


def grid_query(q_pts, q_valid, pts_sorted_T, valid_sorted, ids_sorted, order, mins, dims,
               r2, k: int, bucket_cap: Optional[int], cell_size, cell_starts=None,
               own_points: bool = False):
    """Up-to-k nearest within-r neighbours (k > 0) or within-r counts
    (k = 0) of the queries in a sorted grid: kernel X2 on CUDA tensors
    (float32 only; anything else raises), :func:`_grid_query_plain` on CPU
    tensors, with the same arguments and results.

    The kernel reads each column's run to its own length and needs neither
    the start table nor a static window. ``bucket_cap`` is the JAX query's
    window width: with it, a run is cut at ``bucket_cap`` slots (dense
    table) or ``3 * bucket_cap`` (searched) as the JAX query cuts it; that
    cut bites only when the caller's ``bucket_cap`` undersized the grid.
    ``None`` reads every run whole. ``own_points``: the queries are the
    grid's own points (the kernel then takes them in the grid's slot order;
    the results do not change).
    """
    if q_pts.device.type == "cpu":
        return _grid_query_plain(q_pts, q_valid, pts_sorted_T, valid_sorted, ids_sorted, order,
                                 mins, dims, r2, k, bucket_cap, cell_size, cell_starts)
    return _kernels.launch_grid_query(q_pts, q_valid, pts_sorted_T, ids_sorted, order, mins,
                                      dims, cell_size, r2, k, _kernel_cap(bucket_cap, cell_starts),
                                      own_points=own_points)



def _run_chunks(grid, bucket_cap, points, query, valid_query, r: float, k: int):
    """The query of every row through :func:`grid_query` (grid_hash.py:
    682-711): chunks of :data:`_QUERY_CHUNK` rows through the plain twin on
    the CPU, one launch of X2 on the card."""
    (pts_sorted_T, valid_sorted, ids_sorted, order, mins, dims, cell, cell_starts) = grid
    q = points if query is None else query
    if valid_query is None:
        valid_query = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    r2 = torch.full((), r, dtype=pts_sorted_T.dtype) ** 2  # a host scalar
    return grid_query(q, valid_query, pts_sorted_T, valid_sorted, ids_sorted, order, mins, dims,
                      r2, k, bucket_cap, cell, cell_starts, own_points=query is None)


def grid_radius_neighbors(points, query=None, r: float = 1.0, k: int = 32,
                          valid_points=None, valid_query=None,
                          bucket_cap: Optional[int] = None,
                          cell_size: Optional[float] = None,
                          static_shapes: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` nearest neighbours within ``r`` via cell buckets
    (grid_hash.py:468-499): the reference's ``query_ball_point`` sets,
    padded with -1 / inf, whenever ``k`` holds the largest count.

    :param bucket_cap: largest cell occupancy to assume; default exact.
    :param cell_size: cell side, >= r; default r.
    :param static_shapes: power-of-two window width and table length, as
        the JAX package's streaming callers ask; the results are the same.
    :return: (dist (Q, k) ascending, idx (Q, k) int32).
    """
    grid, width = _build_grid(points, valid_points, r, cell_size, bucket_cap,
                              static_shapes=static_shapes)
    return _run_chunks(grid, width, points, query, valid_query, r, k)


def grid_radius_neighbors_sharded(points, query=None, r: float = 1.0, k: int = 32,
                                  valid_points=None, valid_query=None, mesh=None,
                                  bucket_cap: Optional[int] = None,
                                  cell_size: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`grid_radius_neighbors` with the queries split over the ranks
    of ``mesh`` (a ``parallel.DataMesh``; JAX package, grid_hash.py:
    502-575): every rank builds the whole grid (O(N) positions and ids),
    queries its slice (kernel X2 on the card), and the (Q, k) tables are
    all-gathered in query order, bit for bit those of the single search."""
    from ..parallel.collectives import gather_query_slices, query_slice

    grid, width = _build_grid(points, valid_points, r, cell_size, bucket_cap)
    q = points if query is None else query
    nq = q.shape[0]
    lo, hi, per = query_slice(nq, mesh)
    vq = (torch.ones(nq, dtype=torch.bool, device=q.device)
          if valid_query is None else valid_query)[lo:hi]
    d, idx = _run_chunks(grid, width, points, q[lo:hi], vq, r, k)
    return gather_query_slices((d, idx), nq, per, mesh, (float("inf"), -1))


def grid_neighbor_counts(points, query=None, r: float = 1.0, valid_points=None,
                         valid_query=None, bucket_cap: Optional[int] = None,
                         cell_size: Optional[float] = None) -> torch.Tensor:
    """Number of valid points within ``r`` of each query (grid_hash.py:
    586-600), int32."""
    grid, width = _build_grid(points, valid_points, r, cell_size, bucket_cap)
    return _run_chunks(grid, width, points, query, valid_query, r, 0)
