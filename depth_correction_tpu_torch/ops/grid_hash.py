"""Column-aligned cell sort of one scan (counterpart of the parts of
``depth_correction_tpu/ops/grid_hash.py`` that the online corrector's slab
engine runs).

:func:`grid_sort_colpad_traced` buckets a scan into cells of side >= r
(doubling the cell until the grid fits ``n_cells_pad`` cells), puts the
longest grid axis major, and starts every major-axis column's run of
sorted rows at a multiple of 128 slots, so that every 128-query tile of
``ops/slabwin.py`` lies in one column. Everything runs on the points'
device in plain torch, with the JAX package's arithmetic (float bbox and
cell sizing, int32-range cell ids, stable sorts), so both packages give
the same layout.

The gather-window engine (``grid_radius_neighbors`` and the node's
``nn_backend='grid'``) is not ported yet.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "GRID_NN_MIN_POINTS",
    "cell_candidates",
    "colpad_dims0_ideal",
    "grid_sort_colpad_traced",
]

# Below this padded size the node routes to the brute-force engine
# (JAX package, grid_hash.py:48).
GRID_NN_MIN_POINTS = 65536


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
    needs."""
    _, _, dims_c, count_ok = candidates
    return dims_c[_first_true(count_ok)].amax()


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
    ji = _first_true(feasible)
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
