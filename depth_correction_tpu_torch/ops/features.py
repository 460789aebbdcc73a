"""Neighborhood moments and features (counterpart of ``depth_correction_tpu/
ops/features.py``).

One function chain replaces the reference's mutation chain
``update_points -> update_neighbors -> update_mean -> update_cov ->
update_eig -> update_normals -> update_incidence_angles``
(reference: src/depth_correction/depth_cloud.py:426-441): gather -> weighted
mean/cov -> closed-form 3x3 eigenvalues (-> oriented normals -> incidence
angles). Neighborhoods are (M, K) index matrices with -1 padding and
(M, K) weights (0 on padding), frozen across optimization iterations.

The gather engine's backward runs over a transpose graph of the frozen
neighbourhoods (:func:`build_transpose_graph`: a CSR of each point's
referencing (row, slot) pairs with the points in cell order, cut into
tiles, built once in prep): the moments' analytic VJP
(:class:`NeighborhoodMoments`) is kernel X4 and the pair-level gather of
``nn_scale`` (:class:`GatherNeighborsTransposed`) kernel X5, both in
``csrc/transpose_gather.cu``, on CUDA tensors; their plain versions
(:func:`transpose_moments_plain`, :func:`transpose_gather_plain`) on CPU
tensors. A gradient path without a transpose raises. The JAX
package's padded (M, Kt) tables and their bucketing by in-degree pad for
the TPU's lanes and are not ported: the CSR holds the same pairs in the
same order.

Moments that need no gradient (the online corrector, prep features, the
viewpoint and direction dispersions of the trainability masks) go through
:func:`gather_moments`: kernel P7 (``csrc/gather_moments.cu``) on CUDA
tensors, :func:`gather_moments_plain` on CPU tensors. The Gaussian
re-weighting (``nn_scale``) takes two of them without a gradient: the mean,
then the moments under the re-weighted weights.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..cloud import Cloud
from . import _kernels
from .eigh3 import eigh3, eigvals3_c

__all__ = [
    "GatherNeighborsTransposed",
    "NeighborhoodMoments",
    "PointCSR",
    "TILE_ROWS",
    "TILE_TARGETS",
    "TransposeGraph",
    "TransposeTiles",
    "build_transpose_graph",
    "cell_order",
    "compute_features",
    "dir_dispersion",
    "gather_moments",
    "gather_moments_plain",
    "gather_neighbors",
    "gather_neighbors_transposed",
    "index_order",
    "mean_depth",
    "mean_vp_dist",
    "neighborhood_features",
    "neighborhood_moments",
    "permute_rows",
    "point_csr",
    "transpose_gather",
    "transpose_gather_plain",
    "transpose_in_order",
    "transpose_moments",
    "transpose_moments_plain",
    "vp_dispersion",
]


class PermuteRows(torch.autograd.Function):
    """``x[perm]`` whose backward is the gather ``g[inv]`` through the
    inverse permutation. Autograd's generic backward of an index would
    ``index_add`` the gradients of padding slots (which all read row 0)
    into row 0; the inverse gather drops them. Rows outside the layout
    (``inv`` -1, the invalid points) read an appended zero row, so they
    receive no gradient."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        gz = torch.cat([g, g.new_zeros((1,) + tuple(g.shape[1:]))])
        return gz.index_select(0, torch.where(inv >= 0, inv, g.shape[0])), None, None


def permute_rows(x: torch.Tensor, perm: torch.Tensor, inv: torch.Tensor):
    """Row permutation ``x[perm]`` with an exact gather backward
    (``inv[perm[i]] = i`` on the permuted rows; a row with ``inv`` -1 gets
    a zero gradient)."""
    return PermuteRows.apply(x, perm, inv)


def gather_neighbors(values: torch.Tensor, neighbors: torch.Tensor):
    """Per-neighbor values: (N, D) or (N,) by (M, K) indices -> (M, K, D) or
    (M, K). A missing neighbor (index -1) must carry weight zero; it reads
    row (slot number mod N) rather than row 0. Autograd's backward of the
    gather accumulates the duplicates of each index serially, so padding
    that all read row 0 (millions of slots on an uncapped graph) would
    serialize it; spread out, each zero gradient lands on its own row."""
    idx = neighbors.long()
    spread = torch.arange(idx.numel(), device=idx.device).reshape(idx.shape) % values.shape[0]
    return values[torch.where(idx >= 0, idx, spread)]


# A transpose tile holds at most TILE_TARGETS consecutive targets of the
# cell order and, unless it is one hub target, at most TILE_ROWS distinct
# rows: X4 stages a tile's rows of the (Mq, 12) cotangent table in shared
# memory, 48 bytes a row (48 KB at 1,024 rows). 128 targets: on the capped
# bench graph X4 took 0.072 ms over them against 0.075 over 64 and 0.076
# over 256 (NVIDIA H100 80GB HBM3, 700.00 W;
# scripts/exp_transpose_variants.py --sweep).
TILE_TARGETS = 128
TILE_ROWS = 1024
# Morton grid of the cell order: 2^21 cells an axis over the targets'
# bounding box (a 63-bit key), finer than any neighbourhood radius.
_MORTON_BITS = 21


@dataclasses.dataclass(frozen=True)
class TransposeTiles:
    """The tiles X4 stages over a :class:`TransposeGraph`'s positions: tile
    b holds positions ``tile_start[b]:tile_start[b + 1]`` and the rows
    ``rows[row_start[b]:row_start[b + 1]]``, ascending, and a pair's row is
    ``rows[row_start[b] + local]`` (``local`` read as uint16). A tile holds
    more than ``budget`` rows only when it is one hub target: X4 then reads
    its rows from global memory through the graph's ``pair``, and its
    ``local`` indices are kept modulo 2^16."""

    local: torch.Tensor  # (P,) int16, read as uint16
    tile_start: torch.Tensor  # (T + 1,) int32
    row_start: torch.Tensor  # (T + 1,) int32
    rows: torch.Tensor  # (R,) int32
    rows_max: int  # the most rows of a tile within the budget
    budget: int

    @property
    def num_tiles(self) -> int:
        return self.tile_start.shape[0] - 1

    def to(self, device=None) -> "TransposeTiles":
        return dataclasses.replace(self, local=self.local.to(device),
                                   tile_start=self.tile_start.to(device),
                                   row_start=self.row_start.to(device), rows=self.rows.to(device))


@dataclasses.dataclass(frozen=True)
class TransposeGraph:
    """Transpose of a frozen (Mq, K) neighbour graph in CSR form (the JAX
    package's ``build_transpose_graph`` / ``_transpose_pairs_sized``,
    features.py:88-143, :280-404), its targets in cell order: position t
    holds point ``order[t]``, whose referencing pairs are
    ``pair[start[t]:start[t + 1]]``, each the linear slot ``i * k + slot``
    of a row i whose neighbour ``slot`` is that point, in ascending slot
    order (the JAX package's stable argsort: each run is the JAX table's
    row of that point). ``w`` holds each pair's frozen weight (None for a
    pair-level transpose built without weights). X4 and X5 walk the
    positions in ``tiles`` (:class:`TransposeTiles`) and raise on a graph
    without them; the plain versions read the pairs through ``order``, and
    :func:`point_csr` gives the same pairs in point order."""

    order: torch.Tensor  # (M,) int32 point at each position
    start: torch.Tensor  # (M + 1,) int32
    pair: torch.Tensor  # (P,) int32 = i * k + slot
    w: Optional[torch.Tensor]  # (P,) float or None
    k: int
    tiles: Optional[TransposeTiles] = None

    @property
    def num_points(self) -> int:
        return self.order.shape[0]

    def in_degree(self) -> torch.Tensor:
        """(M,) int32: each point's count of pairs."""
        deg = torch.empty_like(self.order)
        deg[self.order.long()] = self.start[1:] - self.start[:-1]
        return deg

    def targets(self) -> torch.Tensor:
        """(P,) int64: each pair's target point."""
        deg = (self.start[1:] - self.start[:-1]).long()
        return torch.repeat_interleave(self.order.long(), deg, output_size=self.pair.shape[0])

    def pairs_per_row(self) -> float:
        """Pairs over the tiles' distinct rows: how often X4 reads a staged
        row (1.0 where no two pairs of a tile share a row)."""
        return self.pair.shape[0] / max(self.tiles.rows.shape[0], 1)

    def nbytes(self) -> dict:
        """Bytes of the tables that grow with the pairs (``pairs``: pairs,
        weights and local row indices) and with the points (``points``: the
        order, run starts and the tiles' row lists)."""
        def nb(*ts):
            return int(sum(t.numel() * t.element_size() for t in ts if t is not None))

        t = self.tiles
        tiles = (t.local, t.tile_start, t.row_start, t.rows) if t is not None else (None,) * 4
        return {"pairs": nb(self.pair, self.w, tiles[0]),
                "points": nb(self.order, self.start, *tiles[1:])}

    def to(self, device=None, dtype=None) -> "TransposeGraph":
        """Moved to ``device``; ``w`` cast to ``dtype`` (the run's float type)."""
        w = None if self.w is None else self.w.to(device=device, dtype=dtype)
        return dataclasses.replace(
            self, order=self.order.to(device), start=self.start.to(device),
            pair=self.pair.to(device), w=w,
            tiles=None if self.tiles is None else self.tiles.to(device))


class PointCSR(NamedTuple):
    """A transpose's pairs in point order: point j's run is
    ``pair[start[j]:start[j + 1]]`` (weights ``w``), the layout of the JAX
    package's tables."""

    start: torch.Tensor  # (M + 1,) int32
    pair: torch.Tensor  # (P,) int32
    w: Optional[torch.Tensor]  # (P,) float or None
    k: int


def point_csr(tg: TransposeGraph) -> PointCSR:
    """``tg``'s runs moved from cell order to point order."""
    m, p = tg.num_points, tg.pair.shape[0]
    dev = tg.start.device
    deg = tg.start[1:] - tg.start[:-1]
    start = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    start[1:] = torch.cumsum(tg.in_degree(), 0)
    at = torch.repeat_interleave(torch.arange(m, device=dev), deg.long(), output_size=p)
    dest = (torch.arange(p, device=dev) - tg.start.long()[at]
            + start.long()[tg.order.long()[at]])
    pair = torch.empty_like(tg.pair)
    pair[dest] = tg.pair
    w = None
    if tg.w is not None:
        w = torch.empty_like(tg.w)
        w[dest] = tg.w
    return PointCSR(start=start, pair=pair, w=w, k=tg.k)


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """The low 21 bits of ``x`` (int64) spread to every third bit."""
    x = x & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def cell_order(positions: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(M,) int64 order of the targets: the ``active`` ones (those with
    pairs) by the Morton key of their ``positions`` on a 2^21 grid an axis
    over their bounding box, ties by index, then the others by index. The
    JAX package's ``spatial_sort_perm`` (preproc.py:449-486) sorts by the
    same curve on a coarser grid."""
    dev = active.device
    p = torch.nan_to_num(positions.detach().to(device=dev, dtype=torch.float64), 0.0, 0.0, 0.0)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    lo = torch.where(active[:, None], p, inf).amin(0)
    hi = torch.where(active[:, None], p, -inf).amax(0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    extent = torch.clamp((torch.where(torch.isfinite(hi), hi, lo) - lo).amax(), min=1e-12)
    top = (1 << _MORTON_BITS) - 1
    c = torch.clamp((p - lo) / extent * top, 0, top).to(torch.int64)
    key = (_part1by2(c[:, 0]) << 2) | (_part1by2(c[:, 1]) << 1) | _part1by2(c[:, 2])
    key = torch.where(active, key, torch.iinfo(torch.int64).max)
    return torch.sort(key, stable=True).indices


def index_order(active: torch.Tensor) -> torch.Tensor:
    """(M,) int64: the ``active`` targets by index, then the others: point
    order, which :func:`transpose_in_order` takes to measure what the cell
    order gains."""
    return torch.sort((~active).to(torch.int8), stable=True).indices


def _tile_cuts(tps: torch.Tensor, m: int, budget: int) -> torch.Tensor:
    """(M,) bool: the positions that start a tile. Tiles are the aligned
    blocks of TILE_TARGETS positions, each halved while it references more
    than ``budget`` distinct rows (a one-target block past it is a hub).
    ``tps``: (Mq, K) int32 each slot's target position, ascending along a
    row, ``m`` on an empty slot. A slot counts its row for a block when the
    slot before it in the row lies in another block."""
    dev = tps.device
    mq = tps.shape[0]
    cut = torch.zeros(m, dtype=torch.bool, device=dev)
    cut[::TILE_TARGETS] = True
    real = tps < m
    size = TILE_TARGETS
    while size > 1:
        blk = tps // size
        first = real.clone()
        first[:, 1:] &= blk[:, 1:] != blk[:, :-1]
        nb = max(-(-m // size), 1)
        # The slots that count nothing add their 0 to bins spread by row:
        # on the card atomics all aimed at one bin serialise.
        spread = torch.arange(mq, dtype=torch.int32, device=dev)[:, None] % nb
        index = torch.where(first, blk, spread).reshape(-1).long()
        del blk, spread
        rows = torch.zeros(nb, dtype=torch.int32, device=dev).scatter_add_(
            0, index, first.reshape(-1).to(torch.int32))
        del index, first
        size //= 2
        at = torch.arange(size, max(m, size), 2 * size, device=dev)
        cut[at] = rows[at // (2 * size)] > budget
    return cut


def build_transpose_graph(neighbors: torch.Tensor, positions: torch.Tensor,
                          weights: Optional[torch.Tensor] = None) -> TransposeGraph:
    """The transpose of ``neighbors`` over the points at ``positions``, on
    the neighbours' device, its targets in their cell order
    (:func:`cell_order`) and cut into tiles (:class:`TransposeTiles`).

    One stable sort of the Mq * K target keys (slots whose index is -1 or
    outside [0, M) keyed past every point, so they are dropped, as
    :func:`gather_moments_plain` drops them) and a ``searchsorted`` give
    the point-order runs; the runs are moved to their targets' positions by
    a scan of their lengths, the tiles cut by counts of each block's
    distinct rows (:func:`_tile_cuts`), and the tiles' rows and each pair's
    local index come from one more sort. All with fixed shapes, in int32
    where the values fit, freeing each table when it is spent; one read
    comes to the host (the pair, tile and row counts).

    :param neighbors: (Mq, K) indices, -1 padded.
    :param positions: (M, 3) the points' positions at establishment; M is
        the size of the point axis.
    :param weights: (Mq, K) frozen weights; each pair's is kept as ``w``.
    """
    return transpose_in_order(neighbors, positions.shape[0], weights,
                              lambda active: cell_order(positions, active))


def transpose_in_order(neighbors: torch.Tensor, num_points: int,
                       weights: Optional[torch.Tensor], order_of) -> TransposeGraph:
    """:func:`build_transpose_graph` with the targets in the order
    ``order_of(active)`` gives ((M,) int64, the targets with pairs first,
    ``active`` their (M,) bool mask), to measure another order's tiles
    (:func:`index_order`)."""
    mq, k = neighbors.shape
    m = int(num_points)
    n = mq * k
    if m >= 2 ** 31 - 1 or n >= 2 ** 31:
        raise ValueError("a transpose graph indexes points and slots in int32: %d points, "
                         "%d slots" % (m, n))
    budget = TILE_ROWS
    dev = neighbors.device
    i32 = torch.int32
    j = neighbors.reshape(-1)
    key = torch.where((j >= 0) & (j < m), j, m).to(i32)
    key_s, slots = torch.sort(key, stable=True)
    slots = slots.to(i32)
    start = torch.searchsorted(key_s, torch.arange(m + 1, dtype=i32, device=dev)).to(i32)
    order = order_of(start[1:] > start[:-1])
    rank = torch.empty(m + 1, dtype=i32, device=dev)
    rank[order] = torch.arange(m, dtype=i32, device=dev)
    rank[m] = m
    tstart = torch.zeros(m + 1, dtype=i32, device=dev)
    tstart[1:] = torch.cumsum((start[1:] - start[:-1])[order], 0)
    # Each sorted slot's index in the cell-order CSR: its target's run moved
    # to the target's position; the empty slots past the pairs keep theirs
    # (tstart[M] = start[M]).
    dest = torch.arange(n, dtype=i32, device=dev)
    dest -= start[key_s]
    dest += tstart[rank[key_s]]
    del key_s
    by_slot = torch.empty(n, dtype=i32, device=dev)
    by_slot[slots] = dest
    del dest, slots
    tpair = torch.empty(n, dtype=i32, device=dev)
    tpair[by_slot] = torch.arange(n, dtype=i32, device=dev)
    tw = None
    if weights is not None:
        tw = torch.empty(n, dtype=weights.dtype, device=dev)
        tw[by_slot] = weights.reshape(-1)
    # Each slot's target position, ascending along its row, and its place
    # in the cell-order CSR.
    tps, kperm = torch.sort(rank[key].view(mq, k), dim=1, stable=True)
    del key
    dest = by_slot.view(mq, k).gather(1, kperm)
    del by_slot, kperm
    cut = _tile_cuts(tps, m, budget)
    n_tiles = cut.sum()
    tile_of = torch.cumsum(cut, 0, dtype=i32) - 1
    del cut
    # Tile b starts at the first position of tile b (M past the last tile).
    tile_start = torch.searchsorted(tile_of, torch.arange(m + 1, dtype=i32, device=dev))
    # The slots sorted by tile, rows ascending within a tile (the slots of
    # one row and tile are neighbours there); each new (tile, row) pair is
    # the tile's next row.
    tl_s, by_tile = torch.sort(torch.cat([tile_of, tile_of.new_full((1,), m)])[tps].view(-1),
                               stable=True)
    del tps
    row_s = (by_tile // k).to(i32)
    dest = dest.view(-1)[by_tile]
    del by_tile
    real = tl_s < m
    new = real.clone()
    new[1:] &= (tl_s[1:] != tl_s[:-1]) | (row_s[1:] != row_s[:-1])
    seen = torch.cumsum(new, 0, dtype=i32)
    # Tile b's rows start at the count of (tile, row) pairs before its first
    # slot.
    row_start = torch.cat([seen - new.to(i32), seen[-1:] if n else seen.new_zeros(1)])[
        torch.searchsorted(tl_s, torch.arange(m + 1, dtype=i32, device=dev))]
    del new
    seen -= 1  # each real slot's (tile, row) among all tiles' rows
    rows = torch.empty(n, dtype=i32, device=dev)
    # A row's slots in one tile write the same value; the empty slots write
    # past the rows.
    rows[torch.where(real, seen, n - 1)] = row_s
    del row_s, real
    seen -= row_start[tl_s]  # the slot's index among its tile's rows
    del tl_s
    tlocal = torch.empty(n, dtype=torch.int16, device=dev)
    tlocal[dest] = ((seen + 32768) % 65536 - 32768).to(torch.int16)
    del seen, dest
    per_tile = torch.diff(row_start, prepend=row_start.new_zeros(1))
    counts = torch.stack([start[m], n_tiles.to(i32), row_start[m],
                          torch.where(per_tile <= budget, per_tile, 0).max()])
    p, t, r, rows_max = counts.tolist()
    tiles = TransposeTiles(
        local=tlocal[:p].clone(), tile_start=tile_start[:t + 1].to(i32),
        row_start=row_start[:t + 1], rows=rows[:r].clone(), rows_max=int(rows_max),
        budget=int(budget))
    return TransposeGraph(order=order.to(i32), start=tstart, pair=tpair[:p].clone(),
                          w=None if tw is None else tw[:p].clone(), k=int(k), tiles=tiles)


# Pairs per chunk of the plain versions' (pairs, 12) intermediates.
_PLAIN_PAIRS = 1 << 22


def transpose_moments_plain(points, tg: TransposeGraph, table):
    """Plain torch version of kernel X4, any device and dtype: for each
    point j, grad_j = sum over its pairs (i, k) of w_ik (S_i (x_j - mu_i)
    + h_i), with ``table`` rows (S00 S11 S22 S01 S02 S12, mu, h) from
    :func:`_cotangent_rows`; a point with no pairs gets 0.

    :return: (M, 3) in ``table``'s dtype.
    """
    dt = table.dtype
    x = points.to(dt)
    tgt = tg.targets()
    rows = tg.pair.long() // tg.k
    w = tg.w.to(dt)
    out = torch.zeros((tg.num_points, 3), dtype=dt, device=table.device)
    for c in range(0, rows.shape[0], _PLAIN_PAIRS):
        sl = slice(c, c + _PLAIN_PAIRS)
        t = table[rows[sl]]
        d = x[tgt[sl]] - t[:, 6:9]
        s00, s11, s22, s01, s02, s12 = t[:, :6].unbind(1)
        g = torch.stack([s00 * d[:, 0] + s01 * d[:, 1] + s02 * d[:, 2],
                         s01 * d[:, 0] + s11 * d[:, 1] + s12 * d[:, 2],
                         s02 * d[:, 0] + s12 * d[:, 1] + s22 * d[:, 2]], 1) + t[:, 9:12]
        out.index_add_(0, tgt[sl], w[sl, None] * g)
    return out


def transpose_moments(points, tg: TransposeGraph, table):
    """X4 wrapper: the CUDA kernel over ``tg``'s tiles for CUDA tensors
    (float32; anything else, or a graph without tiles, raises),
    :func:`transpose_moments_plain` for CPU tensors."""
    if points.device.type == "cpu":
        return transpose_moments_plain(points, tg, table)
    return _kernels.launch_transpose_moments(points.contiguous(), tg, table.contiguous())



def transpose_gather_plain(g, tg: TransposeGraph):
    """Plain torch version of kernel X5, any device and dtype: the (Mq, K)
    or (Mq, K, D) cotangent of a neighbour gather summed over each point's
    pairs -> (M,) or (M, D)."""
    flat = g.reshape(-1, 1 if g.dim() == 2 else g.shape[-1])
    out = flat.new_zeros((tg.num_points, flat.shape[1]))
    out.index_add_(0, tg.targets(), flat[tg.pair.long()])
    return out[:, 0] if g.dim() == 2 else out


def transpose_gather(g, tg: TransposeGraph):
    """X5 wrapper: the CUDA kernel over ``tg``'s cell order for CUDA tensors
    (float32, D 1 or 3; a graph without tiles raises),
    :func:`transpose_gather_plain` for CPU tensors."""
    if g.device.type == "cpu":
        return transpose_gather_plain(g, tg)
    d = 1 if g.dim() == 2 else g.shape[-1]
    out = _kernels.launch_transpose_gather(g.reshape(-1, d).contiguous(), tg)
    return out[:, 0] if g.dim() == 2 else out



class GatherNeighborsTransposed(torch.autograd.Function):
    """:func:`gather_neighbors` whose backward sums the cotangent over the
    transpose graph (the JAX package's ``gather_neighbors_transposed`` /
    ``_gather_T``, features.py:406-471): X5, or its plain version with
    ``plain`` or on CPU tensors. Padding slots get no gradient."""

    @staticmethod
    def forward(ctx, values, neighbors, tg: TransposeGraph, plain: bool):
        ctx.tg, ctx.plain = tg, plain
        return gather_neighbors(values, neighbors)

    @staticmethod
    def backward(ctx, g):
        fn = transpose_gather_plain if ctx.plain else transpose_gather
        return fn(g, ctx.tg), None, None, None


def gather_neighbors_transposed(values, neighbors, tg: TransposeGraph, plain: bool = False):
    """Per-neighbour values as :func:`gather_neighbors` gives them, with the
    backward through ``tg`` (a transpose of ``neighbors`` over the rows of
    ``values``)."""
    return GatherNeighborsTransposed.apply(values, neighbors, tg, plain)


# Row-chunk the moments past this many (Mq * K) pairs, bounding the
# (chunk, K, 3) intermediates (the JAX package's _FWD_PAIRS_MAX).
_FWD_PAIRS_MAX = 16_000_000


def _moments_impl(points, neighbors, weights):
    """Weighted neighborhood moments, row-chunked on large graphs.

    :return: (mean (3, Mq), comps 6-tuple of (Mq,), w_sum (Mq,)).
    """
    mq, k = neighbors.shape
    if mq * k <= _FWD_PAIRS_MAX:
        return _moments_impl_block(points, neighbors, weights)
    chunk = max(((_FWD_PAIRS_MAX // k) // 512) * 512, 512)
    parts = [
        _moments_impl_block(points, neighbors[i:i + chunk], weights[i:i + chunk])
        for i in range(0, mq, chunk)
    ]
    mean = torch.cat([p[0] for p in parts], 1)
    comps = tuple(torch.cat([p[1][c] for p in parts]) for c in range(6))
    return mean, comps, torch.cat([p[2] for p in parts])


def _moments_impl_block(points, neighbors, weights):
    """One row block: gather (Mq, K, 3), then :func:`_moments_of`."""
    return _moments_of(gather_neighbors(points, neighbors), weights)


def _moments_of(nbr, weights):
    """Weighted mean and Bessel-corrected covariance components (normalizer
    clamped at 1e-6) of gathered (Mq, K, 3) neighbours."""
    w = weights.to(nbr.dtype)
    w_raw = w.sum(1)
    w_sum = torch.clamp(w_raw, min=1e-12)
    mean = (nbr * w[..., None]).sum(1) / w_sum[:, None]  # (Mq, 3)
    c = nbr - mean[:, None, :]
    cw = c * w[..., None]
    denom = torch.clamp(w_raw - 1.0, min=1e-6)

    def cc(a, b):
        return (cw[..., a] * c[..., b]).sum(1) / denom

    comps = (cc(0, 0), cc(1, 1), cc(2, 2), cc(0, 1), cc(0, 2), cc(1, 2))
    return mean.T, comps, w_sum


def gather_moments_plain(points, neighbors, weights):
    """Plain torch version of kernel P7, any device and dtype: the JAX
    package's ``_moments_impl`` (features.py:761-794) with index -1 and
    indices outside [0, N) contributing nothing.

    :param points: (N, 3) positions.
    :param neighbors: (Mq, K) indices, -1 padded.
    :param weights: (Mq, K) weights.
    :return: (mean (3, Mq), comps (6, Mq), w_sum (Mq,) = max(sum w, 1e-12)).
    """
    n = points.shape[0]
    ok = (neighbors >= 0) & (neighbors < n)
    w = torch.where(ok, weights.to(points.dtype), torch.zeros((), dtype=points.dtype,
                                                              device=points.device))
    mean, comps, w_sum = _moments_impl(points, torch.where(ok, neighbors, -1), w)
    return mean, torch.stack(comps), w_sum


def gather_moments(points, neighbors, weights, centred: bool = False):
    """P7 wrapper: the CUDA kernel for CUDA tensors (float32, forward only;
    anything else raises), :func:`gather_moments_plain` for CPU tensors.
    Same arguments and results as :func:`gather_moments_plain`; ``points``
    may also be (3, N) (a (3, 3) table is read as (N, 3)). ``centred``
    takes P7's two-pass form, which sums the covariance about the mean as
    the plain version does (the gather engine's differentiable forward)."""
    if points.device.type == "cpu":
        return gather_moments_plain(points if points.shape[1] == 3 else points.T,
                                    neighbors, weights)
    return _kernels.launch_gather_moments(points, neighbors.to(torch.int32).contiguous(),
                                          weights.to(points.dtype).contiguous(), centred)



class NeighborhoodMoments(torch.autograd.Function):
    """Weighted neighbourhood moments with the analytic backward (the JAX
    package's ``neighborhood_moments`` custom VJP, features.py:537-641).

    Forward: P7 in its two-pass form (:func:`gather_moments` with
    ``centred``: its float32 rounding is the plain version's, which the
    eager forward had) on CUDA tensors, or :func:`gather_moments_plain` on
    CPU tensors or with ``plain``.
    Backward: the (Mq, 12) row table (:func:`_cotangent_rows`) and X4
    (:func:`transpose_moments`), or its plain version, over the transpose
    ``tg``. The weights are frozen: they get no gradient."""

    @staticmethod
    def forward(ctx, points, neighbors, weights, tg: TransposeGraph, plain: bool):
        if plain or points.device.type == "cpu":
            mean, comps, w_sum = gather_moments_plain(points, neighbors, weights)
        else:
            mean, comps, w_sum = gather_moments(points, neighbors, weights, centred=True)
        ctx.save_for_backward(points, mean, w_sum)
        ctx.tg, ctx.plain = tg, plain
        return mean, comps

    @staticmethod
    def backward(ctx, g_mean, g_comps):
        points, mean, w_sum = ctx.saved_tensors
        table = _cotangent_rows(mean, w_sum, (g_mean, g_comps))
        fn = transpose_moments_plain if ctx.plain else transpose_moments
        return fn(points, ctx.tg, table).to(points.dtype), None, None, None, None


def neighborhood_moments(points, neighbors, weights, tg: Optional[TransposeGraph] = None,
                         plain: bool = False):
    """Weighted mean + covariance components over frozen neighborhoods.

    With a gradient (``points`` requires grad) through
    :class:`NeighborhoodMoments` over the transpose ``tg``, which must then
    be given; without one the moments of :func:`gather_moments` (or its
    plain version with ``plain``).

    :param points: (M, 3) global positions.
    :param neighbors: (Mq, K) indices into points, -1 padded.
    :param weights: (Mq, K) frozen weights (0 on padding).
    :param tg: :func:`build_transpose_graph` of ``neighbors`` over the M
        points, with ``weights``.
    :return: (mean (3, Mq), comps (a00, a11, a22, a01, a02, a12) of (Mq,)).
    """
    if torch.is_grad_enabled() and points.requires_grad:
        if tg is None or tg.w is None:
            raise ValueError("the moments' gradient needs the neighbour graph's transpose "
                             "with its weights (build_transpose_graph(neighbors, num_points, "
                             "weights))")
        if tg.num_points != points.shape[0] or tg.k != neighbors.shape[1]:
            raise ValueError("the transpose covers %d points and K %d; the moments have %d "
                             "points and K %d" % (tg.num_points, tg.k, points.shape[0],
                                                  neighbors.shape[1]))
        if weights.requires_grad:
            raise ValueError("neighborhood_moments takes frozen weights: they require grad")
        mean, comps = NeighborhoodMoments.apply(points, neighbors, weights, tg, plain)
        return mean, tuple(comps.unbind(0))
    fn = gather_moments_plain if plain else gather_moments
    mean, comps, _ = fn(points, neighbors, weights)
    return mean, tuple(comps)


def _cotangent_table(mean, w_sum, cotangents):
    """(9, Mq) per-query backward table of the moments: S (symmetric,
    /denom) and u rows, so that grad_j = (sum_i w_ij S_i) x_j +
    sum_i w_ij u_i (JAX package, features.py:537-587). Diagonal S terms
    pick up both delta terms of d a_pq / d x (factor 2)."""
    g_mean, g_comps = cotangents
    g00, g11, g22, g01, g02, g12 = g_comps
    denom = torch.clamp(w_sum - 1.0, min=1e-6)
    s00, s11, s22 = 2.0 * g00 / denom, 2.0 * g11 / denom, 2.0 * g22 / denom
    s01, s02, s12 = g01 / denom, g02 / denom, g12 / denom
    mux, muy, muz = mean[0], mean[1], mean[2]
    u0 = g_mean[0] / w_sum - (s00 * mux + s01 * muy + s02 * muz)
    u1 = g_mean[1] / w_sum - (s01 * mux + s11 * muy + s12 * muz)
    u2 = g_mean[2] / w_sum - (s02 * mux + s12 * muy + s22 * muz)
    return torch.stack([s00, s11, s22, s01, s02, s12, u0, u1, u2], 0)


def _cotangent_rows(mean, w_sum, cotangents):
    """(Mq, 12) per-row backward table of X4, row-major: S00 S11 S22 S01
    S02 S12 (the symmetric cotangent matrix over the Bessel normaliser,
    diagonal doubled as in :func:`_cotangent_table`), the mean (3) and the
    mean's cotangent over the weight sum (3). X4 keeps S (x_j - mu) centred
    where the JAX package folds S mu into u (float32 cancellation far from
    the origin)."""
    g_mean, g_comps = cotangents
    denom = torch.clamp(w_sum - 1.0, min=1e-6)
    scale = torch.tensor([2.0, 2.0, 2.0, 1.0, 1.0, 1.0], dtype=mean.dtype, device=mean.device)
    s = g_comps * scale[:, None] / denom
    return torch.cat([s, mean, g_mean / w_sum], 0).T.contiguous()


def _query_points(points, neighbors, query_rows):
    """Each query row's own position: ``points[query_rows]`` (-1 rows read
    row 0), or ``points`` itself when the rows are the whole table. Under
    autograd the gather is :func:`permute_rows`, whose backward gathers
    through the inverse (each point is at most one row's query, as prep's
    compacted rows are; a -1 row's gradient, zero through its zero
    weights, is dropped) rather than scattering."""
    if query_rows is not None:
        rows = query_rows.clamp(min=0).long()
        if not (torch.is_grad_enabled() and points.requires_grad):
            return points[rows]
        n = points.shape[0]
        inv = torch.full((n + 1,), -1, dtype=torch.long, device=points.device)
        inv.scatter_(0, torch.where(query_rows >= 0, rows, n),
                     torch.arange(rows.shape[0], device=points.device))
        return permute_rows(points, rows, inv[:n])
    if neighbors.shape[0] == points.shape[0]:
        return points
    raise ValueError("nn_scale needs query positions: got %d query rows over a "
                     "%d-point table; pass query_rows"
                     % (neighbors.shape[0], points.shape[0]))


def _gaussian_weights(weights, qpts, mean, scale: float):
    """``w * exp(-|q - mean|^2 / scale^2)`` (reference:
    depth_cloud.py:356-364; JAX package, features.py:764-782), with
    ``mean`` (3, Mq) the mean under ``weights``."""
    dist2 = ((qpts - mean.T) ** 2).sum(-1)
    return weights * torch.exp(-(dist2 / scale ** 2))[:, None]


def neighborhood_features(points, neighbors, weights, dirs=None,
                          scale: Optional[float] = None,
                          compute_normals: bool = True, plain: bool = False,
                          query_rows=None, tg: Optional[TransposeGraph] = None):
    """Weighted neighborhood statistics for each query row.

    :param points: (N, 3) cloud positions.
    :param neighbors: (M, K) neighbor indices with -1 padding.
    :param weights: (M, K) neighbor weights (0 on padding slots).
    :param dirs: (M, 3) view directions for normal orientation and
        incidence angles; None skips those outputs.
    :param scale: Gaussian re-weighting (``nn_scale``): each weight times
        ``exp(-|q - mean|^2 / scale^2)``, q the query row's own position
        and mean the neighbourhood's under the given weights; the mean and
        moments are then taken again under the new weights. Under autograd
        the gradient flows through the re-weighting.
    :param compute_normals: skip the eigenvector path when False (the
        min-eigval / trace losses only need eigenvalues).
    :param plain: the plain versions of the kernels (P7, X4, X5) on any
        device and dtype (reference runs).
    :param query_rows: (M,) each query row's position in ``points`` (-1 on
        padding rows), needed by ``scale`` when M != N.
    :param tg: the transpose of ``neighbors`` over the N points
        (:func:`build_transpose_graph`, with ``weights``), needed when
        ``points`` requires grad: the moments' backward is X4 over it, and
        with ``scale`` the gather's backward X5.
    :return: dict with mean, weights (re-weighted with ``scale``), trace,
        eigvals and, with normals, cov, eigvecs, normals, inc_angles.
    """
    if weights.dim() == 3:
        weights = weights[..., 0]
    if torch.is_grad_enabled() and points.requires_grad:
        if scale is not None:
            # The weights move with the points: one gather, differentiated
            # through the transpose (X5), and the moments by autograd over it.
            if tg is None:
                raise ValueError("nn_scale's gradient needs the neighbour graph's transpose "
                                 "(build_transpose_graph(neighbors, num_points))")
            nbr = gather_neighbors_transposed(points, neighbors, tg, plain)
            w = weights.to(points.dtype)
            mean = ((nbr * w[..., None]).sum(1) / torch.clamp(w.sum(1), min=1e-12)[:, None]).T
            weights = _gaussian_weights(w, _query_points(points, neighbors, query_rows),
                                        mean, scale)
            mean, comps, _ = _moments_of(nbr, weights)
        else:
            mean, comps = neighborhood_moments(points, neighbors, weights, tg, plain)
    else:
        fn = gather_moments_plain if plain else gather_moments
        if scale is not None:
            mean, _, _ = fn(points, neighbors, weights)
            weights = _gaussian_weights(weights.to(points.dtype),
                                        _query_points(points, neighbors, query_rows),
                                        mean, scale)
        mean, comps, _ = fn(points, neighbors, weights)
        comps = tuple(comps)
    return _finish_features(mean, comps, weights, dirs, compute_normals)


def _finish_features(mean, comps, weights, dirs, compute_normals):
    """Shared feature tail (JAX package, features.py:809-830): trace,
    eigenvalues and, with ``dirs``, eigenvectors, normals oriented against
    the view direction and incidence angles."""
    a00, a11, a22, a01, a02, a12 = comps
    out = {"mean": mean.T, "weights": weights, "trace": a00 + a11 + a22}
    if compute_normals and dirs is not None:
        cov = torch.stack([
            torch.stack([a00, a01, a02], -1),
            torch.stack([a01, a11, a12], -1),
            torch.stack([a02, a12, a22], -1),
        ], -2)
        eigvals, eigvecs = eigh3(cov)
        # Normal = eigenvector of the smallest eigenvalue, oriented against
        # the view direction (reference: depth_cloud.py:401-415); incidence
        # angle = arccos |dirs . n| (depth_cloud.py:417-424).
        normals = eigvecs[..., :, 0]
        cos = (dirs * normals).sum(-1)
        out.update(
            cov=cov, eigvals=eigvals, eigvecs=eigvecs,
            normals=-torch.sign(cos)[..., None] * normals,
            inc_angles=torch.arccos(torch.clamp(cos.abs(), 0.0, 1.0)),
        )
    else:
        out["eigvals"] = torch.stack(eigvals3_c(*comps), -1)
    return out


def compute_features(cloud: Cloud, neighbors, weights,
                     scale: Optional[float] = None,
                     compute_normals: bool = True) -> Cloud:
    """Cloud-level wrapper: a new Cloud with the derived fields set
    (``update_all(keep_neighbors=True)``, reference: depth_cloud.py:435-441)."""
    points = cloud.get_points()
    feats = neighborhood_features(points, neighbors, weights, dirs=cloud.dirs,
                                  scale=scale, compute_normals=compute_normals)
    return cloud.replace(
        points=points,
        mean=feats["mean"],
        cov=feats.get("cov"),
        eigvals=feats["eigvals"],
        eigvecs=feats.get("eigvecs"),
        normals=feats.get("normals", cloud.normals),
        inc_angles=feats.get("inc_angles", cloud.inc_angles),
        trace=feats["trace"],
    )


def _dispersion(values, neighbors, weights) -> torch.Tensor:
    """Trace of the weighted, Bessel-corrected covariance of the gathered
    (N, 3) ``values`` (the JAX package's ``trace3(weighted_cov(...))``,
    covs.py:38-80, whose normaliser is P7's): the first three components
    of :func:`gather_moments`, kernel P7 on the card."""
    _, comps, _ = gather_moments(values, neighbors, weights)
    return comps[0] + comps[1] + comps[2]


def vp_dispersion(cloud: Cloud, neighbors, weights) -> torch.Tensor:
    """Total variation of the neighbours' viewpoints, a trainability
    statistic (reference: depth_cloud.py:314-319; JAX package,
    features.py:870-875)."""
    return _dispersion(cloud.vps, neighbors, weights)


def dir_dispersion(cloud: Cloud, neighbors, weights) -> torch.Tensor:
    """Total variation of the neighbours' view directions (reference:
    depth_cloud.py:321-326; JAX package, features.py:878-881)."""
    return _dispersion(cloud.dirs, neighbors, weights)


def mean_depth(cloud: Cloud, neighbors, weights) -> torch.Tensor:
    """Weighted mean neighbour depth (reference: depth_cloud.py:328-334;
    JAX package, features.py:884-888)."""
    d = gather_neighbors(cloud.depth, neighbors)
    w = weights.to(d.dtype)
    w_sum = torch.clamp(w.sum(-1), min=1e-12)
    return (w * d).sum(-1) / w_sum


def mean_vp_dist(cloud: Cloud, neighbors, weights) -> torch.Tensor:
    """Weighted mean distance of the neighbours' viewpoints from their
    weighted mean (reference: depth_cloud.py:336-346; JAX package,
    features.py:891-898)."""
    vps = gather_neighbors(cloud.vps, neighbors)  # (N, K, 3)
    w = weights.to(vps.dtype)
    w_sum = torch.clamp(w.sum(-1), min=1e-12)
    mean_vp = (w[..., None] * vps).sum(-2) / w_sum[..., None]
    dists = torch.linalg.norm(vps - mean_vp[..., None, :], dim=-1)
    return (w * dists).sum(-1) / w_sum
