"""The cell-window moments over a process group (counterpart of
``depth_correction_tpu/parallel/cellwin_shard.py``).

Row tiles are independent in the forward and point tiles in the backward,
so the engine of ``ops/cellwin.py`` shards over D ranks with the same two
kernels and no new one:

- the forward shards by row tile: each rank runs K1
  (``ops.cellwin.cellwin_fwd``) on its ``t1/D`` row tiles against the full
  cell-sorted point table (the positions every rank all-gathers anyway);
- the backward shards by point tile: the rank's (12, mq_local) block, its
  rows' 3 establishment positions and 9 cotangent rows, is all-gathered,
  and K2 (``ops.cellwin.cellwin_bwd``) then gives the complete gradient of
  the rank's ``t2/D`` point tiles (every row that references a point is in
  the gathered table). The rank returns it in place, zeros elsewhere; the
  position gather's backward sums the ranks' parts;
- tile counts pad to multiples of D with empty tiles: zero spans, the
  builder's row sentinel in ``q_est``, the far sentinel in ``est_sorted``,
  ``row_map`` -1;
- exception rows split by the rank that owns their row slot and go through
  the gather moments, as ``ops.cellwin.cellwin_moments`` routes them, with
  the transpose of the rank's rows over the padded points for X4. Each
  rank keeps its own rows (torch takes tables of any length a rank), and
  runs the branch even with none, so that every rank's autograd graph has
  the same collectives.

K1 reads the spans' global point slots and K2 the spans' global row slots
(``ops/_kernels.py``: ``row_cap = mq_pad // t1``, ``pt_cap = m_pad //
t2``), so the rank's tables are plain slices. Each slice is copied
contiguous at sharding time (``est_local`` beside the full
``est_sorted``), since the launchers take contiguous tensors only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.cellwin import CellWinDevice, cellwin_bwd, cellwin_fwd
from ..ops.eigh3 import eigvals3_c
from ..ops.features import TransposeGraph, _cotangent_table, build_transpose_graph, \
    neighborhood_moments
from .collectives import gather_detached

__all__ = ["CellWinShards", "cellwin_features_sharded", "cellwin_moments_sharded",
           "rehearse", "shard_cellwin_device"]

# The builder's sentinels (ops.cellwin.build_cellwin_graph): padding rows
# sit far on one side, padding points far on the other.
_ROW_PAD = -1e15
_PT_PAD = 1e15


@dataclasses.dataclass(frozen=True)
class CellWinShards:
    """One rank's part of a cell-window graph over D ranks.

    Row side (forward): ``q_est`` (3, mq_local), ``f_start`` / ``f_len``
    (t1_local, ns_f), ``f_ctr`` (t1_local, 3) and ``row_map`` (mq_local,),
    the rank's rows ``rank * mq_local`` onwards of the padded row
    axis. Point side (backward): ``b_start`` / ``b_len`` (t2_local, ns_b),
    ``b_ctr`` and ``est_local`` (3, m_local), the rank's points
    ``pt_start : pt_start + m_local``. Full on every rank: ``est_sorted``
    (3, m_pad_p), the forward's source, and ``perm`` / ``inv``. Exception
    rows: ``exc_slots`` (E_rank,) local row slots, ``exc_nn`` / ``exc_w``
    (E_rank, K) in padded point slots; ``n_exc`` counts all ranks'.
    """

    q_est: torch.Tensor
    est_sorted: torch.Tensor
    est_local: torch.Tensor
    f_start: torch.Tensor
    f_len: torch.Tensor
    f_ctr: torch.Tensor
    b_start: torch.Tensor
    b_len: torch.Tensor
    b_ctr: torch.Tensor
    perm: torch.Tensor
    inv: torch.Tensor
    row_map: torch.Tensor
    exc_slots: torch.Tensor
    exc_nn: torch.Tensor
    exc_w: torch.Tensor
    r2: float
    n_exc: int
    pt_start: int
    mesh: object = None
    # The rank's exception rows' transpose over the padded points.
    exc_tg: Optional[TransposeGraph] = None


def _pad_rows(x: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    if rows == x.shape[0]:
        return x
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], 0)


def _pad_cols(x: torch.Tensor, cols: int, fill: float) -> torch.Tensor:
    if cols == x.shape[1]:
        return x
    pad = torch.full((x.shape[0], cols - x.shape[1]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], 1)


def shard_cellwin_device(dev: CellWinDevice, mesh, rank: int = None,
                         size: int = None) -> CellWinShards:
    """Rank ``rank``'s part of ``dev`` over ``size`` ranks (default: the
    mesh's rank and size); the copies are the rank's own, so ``dev`` can be
    dropped. ``mesh`` may be None with an explicit rank and size (the
    kernels' rehearsal of D shards in one process)."""
    rank = mesh.rank if rank is None else int(rank)
    size = mesh.size if size is None else int(size)
    t1, t2 = dev.f_start.shape[0], dev.b_start.shape[0]
    mq_pad, m_pad = dev.q_est.shape[1], dev.est_sorted.shape[1]
    r_cap, p_cap = mq_pad // t1, m_pad // t2
    t1p, t2p = -(-t1 // size) * size, -(-t2 // size) * size
    t1l, t2l = t1p // size, t2p // size
    mq_l, m_l = t1l * r_cap, t2l * p_cap
    row0, pt0 = rank * mq_l, rank * m_l

    def rows(x, a, n, fill=0):
        return _pad_rows(x, a * size, fill)[rank * n:(rank + 1) * n].clone()

    q_est = _pad_cols(dev.q_est[:3], t1p * r_cap, _ROW_PAD)
    est = _pad_cols(dev.est_sorted[:3], t2p * p_cap, _PT_PAD).contiguous()
    slots = dev.exc_slots
    mine = (slots >= row0) & (slots < row0 + mq_l)
    exc_nn, exc_w = dev.exc_nn[mine].clone(), dev.exc_w[mine].clone()
    return CellWinShards(
        q_est=q_est[:, row0:row0 + mq_l].contiguous(),
        est_sorted=est,
        est_local=est[:, pt0:pt0 + m_l].contiguous(),
        f_start=rows(dev.f_start, t1l, t1l),
        f_len=rows(dev.f_len, t1l, t1l),
        f_ctr=rows(dev.f_ctr, t1l, t1l),
        b_start=rows(dev.b_start, t2l, t2l),
        b_len=rows(dev.b_len, t2l, t2l),
        b_ctr=rows(dev.b_ctr, t2l, t2l),
        perm=_pad_rows(dev.perm, t2p * p_cap, 0).clone(),
        inv=dev.inv.clone(),
        row_map=rows(dev.row_map, mq_l, mq_l, -1),
        exc_slots=(slots[mine] - row0).clone(),
        exc_nn=exc_nn,
        exc_w=exc_w,
        r2=dev.r2, n_exc=int(dev.n_exc), pt_start=pt0, mesh=mesh,
        exc_tg=build_transpose_graph(exc_nn, est.T, exc_w))


def sharded_fwd(pts_full, sh: CellWinShards) -> torch.Tensor:
    """K1 over the rank's row tiles -> raw (10, mq_local)."""
    return cellwin_fwd(pts_full, sh.q_est, sh.est_sorted, sh.f_start, sh.f_len, sh.f_ctr, sh.r2)


def sharded_bwd(pts_full, sh: CellWinShards, q_full, table9_full) -> torch.Tensor:
    """K2 over the rank's point tiles against every rank's rows ->
    the complete (m_local, 3) gradient of the rank's points."""
    m_l = sh.est_local.shape[1]
    return cellwin_bwd(pts_full[sh.pt_start:sh.pt_start + m_l], q_full, sh.est_local, table9_full,
               sh.b_start, sh.b_len, sh.b_ctr, sh.r2)


def row_block(sh: CellWinShards, raw, g_raw) -> torch.Tensor:
    """The rank's (12, mq_local) block: its rows' establishment positions
    over their 9 cotangent rows (``features._cotangent_table``)."""
    table9 = _cotangent_table(raw[0:3], raw[9], (g_raw[0:3], tuple(g_raw[3:9])))
    return torch.cat([sh.q_est.to(table9.dtype), table9], 0).contiguous()


def split_table(t12):
    """Every rank's gathered blocks -> (q (3, mq_pad_p), table9)."""
    return t12[:3].contiguous(), t12[3:].contiguous()


class CellWinShardCore(torch.autograd.Function):
    """Raw (10, mq_local) moments of the rank's row tiles (K1); backward:
    the gathered cotangent table -> K2 on the rank's point tiles, the
    gradient in place in a zero (m_pad_p, 3) table."""

    @staticmethod
    def forward(ctx, pts_full, sh: CellWinShards):
        raw = sharded_fwd(pts_full, sh)
        ctx.save_for_backward(pts_full, raw)
        ctx.sh = sh
        return raw

    @staticmethod
    def backward(ctx, g_raw):
        pts_full, raw = ctx.saved_tensors
        sh = ctx.sh
        q_full, table9 = split_table(gather_detached(row_block(sh, raw, g_raw), sh.mesh, dim=1))
        grad_local = sharded_bwd(pts_full, sh, q_full, table9)
        grad = torch.zeros_like(pts_full)
        grad[sh.pt_start:sh.pt_start + grad_local.shape[0]] = grad_local
        return grad, None


def cellwin_moments_sharded(pts_full, sh: CellWinShards):
    """The rank's rows' weighted moments (mean (3, mq_local), 6 comps),
    exception rows through the gather moments (``ops.cellwin.
    cellwin_moments``'s routing).

    :param pts_full: (m_pad_p, 3) CURRENT positions of every point in the
        padded cell-sorted layout (``permute_rows`` with ``sh.perm``).
    """
    raw = CellWinShardCore.apply(pts_full, sh)
    mean = raw[0:3]
    comps = tuple(raw[3 + i] for i in range(6))
    if sh.n_exc:
        em, ec = neighborhood_moments(pts_full, sh.exc_nn, sh.exc_w, sh.exc_tg)
        mean = mean.index_copy(1, sh.exc_slots, em)
        comps = tuple(c.index_copy(0, sh.exc_slots, e) for c, e in zip(comps, ec))
    return mean, comps


def cellwin_features_sharded(pts_full, sh: CellWinShards):
    """Trace and ascending eigvals (mq_local, 3) of the rank's rows."""
    _mean, comps = cellwin_moments_sharded(pts_full, sh)
    a00, a11, a22, _a01, _a02, _a12 = comps
    return {"trace": a00 + a11 + a22, "eigvals": torch.stack(eigvals3_c(*comps), -1)}


def rehearse(pts_sorted, dev: CellWinDevice, size: int, g_raw):
    """The sharded forward and backward of ``size`` ranks in one process,
    the collectives replaced by concatenations: K1 on each rank's row
    tiles (padding tiles included), the ranks' 12-row blocks joined, K2 on
    each rank's point tiles against them.

    :param pts_sorted: (m_pad, 3) positions in ``dev``'s padded layout.
    :param g_raw: (10, mq_pad) cotangent of the raw moments.
    :return: (raw (10, mq_pad), grad (m_pad, 3)) cut back to ``dev``'s
        layout, for a comparison with the single launches.
    """
    shards = [shard_cellwin_device(dev, None, rank=r, size=size) for r in range(size)]
    m_pad, mq_pad = pts_sorted.shape[0], g_raw.shape[1]
    extra = shards[0].est_sorted.shape[1] - m_pad
    pts_full = torch.cat([pts_sorted, pts_sorted[:1].expand(extra, 3)]) if extra else pts_sorted
    mq_l = shards[0].q_est.shape[1]
    g_pad = torch.cat([g_raw, g_raw.new_zeros((10, mq_l * size - mq_pad))], 1)
    raws = [sharded_fwd(pts_full, sh) for sh in shards]
    blocks = [row_block(sh, raw, g_pad[:, r * mq_l:(r + 1) * mq_l])
              for r, (sh, raw) in enumerate(zip(shards, raws))]
    q_full, table9 = split_table(torch.cat(blocks, 1))
    grads = [sharded_bwd(pts_full, sh, q_full, table9) for sh in shards]
    return torch.cat(raws, 1)[:, :mq_pad], torch.cat(grads, 0)[:m_pad]


def shard_tables_bytes(sh: CellWinShards) -> dict:
    """Bytes of the rank's row-side and point-side tables (the exception
    rows' transpose pairs among the rows), and of the tables every rank
    holds whole (``est_sorted``, ``perm``, ``inv``, the transpose's run
    starts, cell order and tiles)."""
    def nb(*ts):
        return int(sum(t.numel() * t.element_size() for t in ts))

    tg = sh.exc_tg.nbytes() if sh.exc_tg is not None else {"pairs": 0, "points": 0}
    return {"rows": nb(sh.q_est, sh.f_start, sh.f_len, sh.f_ctr, sh.row_map, sh.exc_slots,
                       sh.exc_nn, sh.exc_w) + tg["pairs"],
            "points": nb(sh.est_local, sh.b_start, sh.b_len, sh.b_ctr),
            "whole": nb(sh.est_sorted, sh.perm, sh.inv) + tg["points"]}
