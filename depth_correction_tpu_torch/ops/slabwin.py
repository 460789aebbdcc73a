"""Slab-window moments, the online corrector's large-scan engine
(counterpart of ``depth_correction_tpu/ops/slabwin.py``).

Input is a scan sorted by :func:`.grid_hash.grid_sort_colpad_traced`: cells
of side >= r, the longest axis major, each major column's rows starting at
a multiple of 128 slots. Cut into tiles of 128 slots, every within-r
neighbour of a tile's rows lies in three contiguous ranges of the sorted
table: the tile's second-axis window [ylo - 1, yhi + 1] inside each of the
major slabs x - 1, x, x + 1 (a tile that straddles columns takes one
whole-slab range [x_lo - 1, x_hi + 1] instead). :func:`slab_tile_spans`
finds the ranges with ``torch.searchsorted`` on the device;
:func:`slab_window_kernel` computes every slot's within-r moments over
them: kernel X1 (``csrc/slabwin.cu``) on CUDA tensors,
:func:`slab_window_moments_plain` on CPU tensors.

No K cap and no static width: each span is read to its own length, so the
TPU engine's ``w_slab``, its retry and its two width classes are gone.
"""
from __future__ import annotations

import torch

from . import _kernels

__all__ = [
    "TILE",
    "slab_tile_spans",
    "slab_window_kernel",
    "slab_window_moments",
    "slab_window_moments_plain",
]

TILE = 128

# Elements of the largest (tiles, candidates, 128) intermediate the plain
# version materializes at once.
_PLAIN_ELEMS = 1 << 22


def slab_tile_spans(pts_T, valid, ids_sorted, dims, sentinel: int):
    """Per-tile candidate spans and centres (JAX package, slabwin.py:79-111).

    :param pts_T: (3, n) cell-sorted positions, n a multiple of 128.
    :param valid: (n,) bool.
    :param ids_sorted: (n,) non-decreasing linear cell ids; invalid slots
        carry ``sentinel`` or their column's pad id.
    :param dims: (3,) grid dims in id axis order (major first).
    :param sentinel: the invalid rows' id (``n_cells_pad`` of the sort).
    :return: (lo (T, 3) int32, width (T, 3) int32, ctr (T, 3) tile centres
        in the points' dtype, has (T,) bool: the tile holds a valid row).
    """
    n = pts_T.shape[1]
    assert n % TILE == 0, n
    t = n // TILE
    nx, ny, nz = dims[0], dims[1], dims[2]
    dimyz = ny * nz
    ids2 = ids_sorted.reshape(t, TILE)
    v2 = valid.reshape(t, TILE)
    has = v2.any(1)
    id_lo = torch.where(v2, ids2, torch.full_like(ids2, sentinel)).amin(1)
    id_hi = torch.where(v2, ids2, torch.zeros_like(ids2)).amax(1)
    x_lo = id_lo // dimyz
    x_hi = id_hi // dimyz
    y2 = (ids2 // nz) % ny
    ylo = torch.where(v2, y2, ny.expand_as(y2)).amin(1)
    yhi = torch.where(v2, y2, torch.zeros_like(y2)).amax(1)
    y0 = torch.clamp(ylo - 1, min=0)
    y1 = torch.minimum(yhi + 1, ny - 1)
    single = (x_lo == x_hi) & has
    zero = torch.zeros_like(x_lo)
    klo, khi = [], []
    for dx in (-1, 0, 1):
        xk = x_lo + dx
        ok = single & (xk >= 0) & (xk < nx)
        klo.append(torch.where(ok, xk * dimyz + y0 * nz, zero))
        khi.append(torch.where(ok, xk * dimyz + (y1 + 1) * nz, zero))
    # A column-straddling tile: one range of whole slabs, spans 1, 2 empty.
    cross = has & ~single
    klo[0] = torch.where(cross, torch.clamp(x_lo - 1, min=0) * dimyz, klo[0])
    khi[0] = torch.where(cross, torch.minimum(x_hi + 2, nx) * dimyz, khi[0])
    ids = ids_sorted.contiguous()
    lo = torch.searchsorted(ids, torch.stack(klo, 1).to(ids.dtype))
    hi = torch.searchsorted(ids, torch.stack(khi, 1).to(ids.dtype))
    width = torch.clamp(hi - lo, min=0)
    # Tile centres: membership uses the TPU engine's tile-centred
    # difference form, so both versions decide it on the same numbers.
    q = torch.where(v2[None], pts_T.reshape(3, t, TILE), torch.zeros((), dtype=pts_T.dtype,
                                                                      device=pts_T.device))
    ctr = q.sum(2) / torch.clamp(v2.sum(1).to(pts_T.dtype), min=1.0)  # (3, T)
    return lo.to(torch.int32), width.to(torch.int32), ctr.T.contiguous(), has


def slab_window_moments_plain(pts_T, valid, lo, width, ctr, r2: float) -> torch.Tensor:
    """Plain torch version of kernel X1, any device and dtype.

    Each live tile's three spans are gathered into a padded
    (tiles, 3 * W, 128) candidate block, W the widest span of a chunk of
    tiles, with the kernel's membership test and its sums about each row's
    own position. Tiles without a valid row output zeros.

    :return: (10, n): mean x, y, z; covariance 00, 11, 22, 01, 02, 12
        (Bessel, normaliser max(s0 - 1, 1e-6)); w_sum = max(s0, 0). The mean
        of an invalid row is its own position.
    """
    n = pts_T.shape[1]
    dt, dev = pts_T.dtype, pts_T.device
    out = torch.zeros((10, n), dtype=dt, device=dev)
    has = valid.reshape(-1, TILE).any(1)
    live = torch.nonzero(has).squeeze(1)
    if live.numel() == 0:
        return out
    wmax = width.amax(1)[live].cpu().tolist()
    r2 = torch.full((), r2, dtype=dt, device=dev)
    start = 0
    while start < len(wmax):
        stop, w = start, 1
        while stop < len(wmax) and (stop - start + 1) * 3 * max(w, wmax[stop]) * TILE <= _PLAIN_ELEMS:
            w = max(w, wmax[stop])
            stop += 1
        stop = max(stop, start + 1)
        w = max(w, wmax[start], 1)
        tiles = live[start:stop]
        col = torch.arange(w, device=dev)
        idx = lo[tiles].long()[:, :, None] + col  # (Tc, 3, W)
        ok = col < width[tiles].long()[:, :, None]
        idx = torch.clamp(idx, 0, n - 1).reshape(len(tiles), 3 * w)
        ok = ok.reshape(len(tiles), 3 * w) & valid[idx]
        rows = (tiles[:, None] * TILE + torch.arange(TILE, device=dev)).reshape(-1)
        q = pts_T[:, rows].reshape(3, len(tiles), TILE)
        qv = valid[rows].reshape(len(tiles), TILE)
        c = ctr[tiles].T[:, :, None]  # (3, Tc, 1)
        cand = pts_T[:, idx] - c  # (3, Tc, 3W)
        d = cand[:, :, :, None] - (q - c)[:, :, None, :]  # (3, Tc, 3W, 128)
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        wm = ((d2 <= r2) & ok[:, :, None] & qv[:, None, :]).to(dt)
        dm = d * wm
        s0 = wm.sum(1)  # (Tc, 128)
        s1 = dm.sum(2)  # (3, Tc, 128)
        s2 = [(dm[a] * d[b]).sum(1) for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]
        s0c = torch.clamp(s0, min=1e-12)
        m = s1 / s0c
        denom = torch.clamp(s0 - 1.0, min=1e-6)
        pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
        block = torch.stack(
            [m[0] + q[0], m[1] + q[1], m[2] + q[2]]
            + [(s2[i] - s0 * m[a] * m[b]) / denom for i, (a, b) in enumerate(pairs)]
            + [torch.clamp(s0, min=0.0)], 0)  # (10, Tc, 128)
        out[:, rows] = block.reshape(10, -1)
        start = stop
    return out


def slab_window_kernel(pts_T, valid, lo, width, ctr, r2: float) -> torch.Tensor:
    """X1 wrapper: the CUDA kernel for CUDA tensors (float32 only; anything
    else raises), :func:`slab_window_moments_plain` for CPU tensors."""
    if pts_T.device.type == "cpu":
        return slab_window_moments_plain(pts_T, valid, lo, width, ctr, r2)
    return _kernels.launch_slab_window(pts_T, valid, lo, width, ctr.to(pts_T.dtype), r2)



def slab_window_moments(pts_T, valid, ids_sorted, dims, r2: float, sentinel: int,
                        plain: bool = False):
    """Within-r neighbourhood moments of every sorted slot (JAX package,
    slabwin.py:53-226, without its static width ``w_slab``).

    :param plain: compute with :func:`slab_window_moments_plain` on any
        device and dtype (reference runs).
    :return: (mean (3, n), comps 6-tuple of (n,), w_sum (n,), widths (T,)
        the widest span of each tile).
    """
    lo, width, ctr, _ = slab_tile_spans(pts_T, valid, ids_sorted, dims, sentinel)
    fn = slab_window_moments_plain if plain else slab_window_kernel
    out = fn(pts_T, valid, lo, width, ctr, r2)
    return out[0:3], tuple(out[3:9]), out[9], width.amax(1)
