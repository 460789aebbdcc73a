"""The point-sharded training step over a ``torch.distributed`` process
group (counterpart of ``depth_correction_tpu/parallel/sharding.py``).

One process runs per rank: ``nccl`` on CUDA devices (``cuda:<local
rank>``), ``gloo`` on the CPU. A :class:`DataMesh` names the group, the
rank, the size and the device, and stands where the JAX package passes its
1-D ``jax.sharding.Mesh``. Each rank holds 1/D of every per-point table:

- the scan batches (the point table's source fields) split along the
  padded scan-point axis N; the poses are whole on every rank;
- the query-row tables (neighbours, weights, masks, query rows, the loss
  offset's graph) split along the rows; a cell-window graph splits by
  row tile and point tile (``parallel/cellwin_shard.py``); ICP
  correspondences split along the per-pair point axis; plane members
  along the support axis;
- each rank corrects and poses its (S, N/D) slice of every scan and
  all-gathers only the (S, N, 3) positions (with the loss offset, the
  local positions beside them in the same gather);
- each rank reduces its rows to a (sum, count) pair; the global loss is a
  detached all-reduce, each rank back-propagates its own sum, and the
  gradients are all-reduced once (``parallel/collectives.py``). Every
  rank then holds the same loss and gradients, bit for bit, so the
  optimizers, L-BFGS's line search included, take the same branch on
  every rank.

Each rank builds the transposes of its own rows (the gather path's graph
and the offset's, over all S * N points, and a cell-window graph's
exception rows over its padded points) for the backward kernels X4 / X5,
as the JAX package builds per-shard transposes (sharding.py:221-365). Its
uniform padding of every shard's transposes and exception rows to one
length serves shard_map's uniform operands and is not ported: each rank
keeps tables of its own length.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import Config, NeighborhoodType, PoseCorrection
from ..ops.features import build_transpose_graph
from ..preproc import global_cloud
from .cellwin_shard import CellWinShards, cellwin_features_sharded, shard_cellwin_device, \
    shard_tables_bytes
from .collectives import all_gather_rows, all_reduce_sum, gather_detached, sum_over_ranks, \
    with_global_value

__all__ = [
    "DataMesh",
    "make_mesh",
    "make_multihost_mesh",
    "make_sharded_loss_fn",
    "mesh_from_config",
    "resident_bytes",
    "shard_train_data",
]

_LAUNCH_HINT = ("launch one process a rank with torchrun (torchrun --nproc-per-node N -m "
                "depth_correction_tpu_torch.main ...) or set dist_coordinator, "
                "dist_num_processes and dist_process_id")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh: one rank of a process group, one device a rank.

    ``group`` None is the default group. ``rank`` 0 is the one that writes
    logs, histories, checkpoints, summaries and traces.
    """

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def is_writer(mesh: Optional[DataMesh]) -> bool:
    """True on the process that writes a run's files: rank 0, or the only
    process without a mesh."""
    return mesh is None or mesh.rank == 0


def writes_for(cfg: Config) -> bool:
    """:func:`is_writer` for a run of ``cfg`` that is not sharded (the
    ICP and SLAM evaluations, which every rank runs whole): rank 0 of the
    group ``cfg`` asks for (:func:`mesh_from_config`), or the only
    process."""
    if not (cfg.mesh_shape or cfg.dist_coordinator):
        return True
    return is_writer(mesh_from_config(cfg))


def _local_rank(rank: int) -> int:
    """The rank's card on its host: ``LOCAL_RANK`` (torchrun), else the
    rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return int(rank) % max(torch.cuda.device_count(), 1)


def make_mesh(n_devices: Optional[int] = None, device=None) -> DataMesh:
    """The data mesh over the process group that is up (JAX package,
    sharding.py:45-62).

    :param n_devices: the ranks the caller expects; None takes the group's.
    :param device: ``"cpu"`` for CPU tensors; otherwise each rank takes
        ``cuda:<local rank>`` and makes it the current device.
    :raises ValueError: no group is up, or ``n_devices`` is not its size.
    """
    if not dist.is_initialized():
        raise ValueError("no process group is up: " + _LAUNCH_HINT)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError("mesh_shape asks for %d ranks but the process group has %d"
                         % (int(n_devices), size))
    dev = torch.device(str(device) if device else "cuda")
    if dev.type == "cuda":
        dev = torch.device("cuda", _local_rank(rank))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    mesh = DataMesh(group=None, rank=rank, size=size, device=dev, backend=dist.get_backend())
    # One all-reduce proves the group: a failed NCCL initialisation raises
    # here, on every rank, and nothing falls back to another backend.
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)
    if int(probe.item()) != size:
        raise RuntimeError("the process group's all-reduce summed %r over %d ranks"
                           % (probe.item(), size))
    return mesh


def _init_group(init_method: str, world_size: int, rank: int, device) -> None:
    dev = torch.device(str(device) if device else "cuda")
    kw = {}
    if dev.type == "cuda":
        backend = "nccl"
        local = torch.device("cuda", _local_rank(rank))
        torch.cuda.set_device(local)
        kw["device_id"] = local
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank), **kw)


def make_multihost_mesh(n_devices: Optional[int] = None, *,
                        coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None, device=None) -> DataMesh:
    """Initialise the process group at ``tcp://<coordinator_address>``
    unless one is up (JAX package, sharding.py:65-109: idempotent, as its
    live-client check), then :func:`make_mesh`. ``nccl`` on CUDA devices
    (with the rank's card as ``device_id``), ``gloo`` with ``device =
    "cpu"``. Without a coordinator the call is :func:`make_mesh`."""
    if coordinator_address is not None and not dist.is_initialized():
        if num_processes is None or process_id is None:
            raise ValueError("dist_coordinator needs dist_num_processes and dist_process_id")
        _init_group("tcp://" + str(coordinator_address), num_processes, process_id, device)
    return make_mesh(n_devices, device=device)


def mesh_from_config(cfg: Config) -> Optional[DataMesh]:
    """The mesh ``cfg`` asks for, or None for one device (JAX package,
    sharding.py:112-139).

    - ``dist_coordinator`` set: the group at that address
      (:func:`make_multihost_mesh`), with ``mesh_shape`` counting every
      rank of every host (None or ``'all'``: the group's size);
    - ``mesh_shape`` of N <= 1 and no coordinator: None;
    - otherwise the group that is up, or one from torchrun's environment
      (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``; ``env://``).

    :raises ValueError: N > 1 and no group (naming torchrun and
        ``dist_coordinator``), or N is not the group's size.
    """
    shape, coord = cfg.mesh_shape, cfg.dist_coordinator
    if not shape and not coord:
        return None
    n = shape.get("data", 1) if isinstance(shape, dict) else shape
    n = None if n in (None, "all") else int(n)
    device = str(cfg.device) if cfg.device else "cuda"
    if coord:
        return make_multihost_mesh(n, coordinator_address=coord,
                                   num_processes=cfg.dist_num_processes,
                                   process_id=cfg.dist_process_id, device=device)
    if n is not None and n <= 1:
        return None
    if not dist.is_initialized():
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            raise ValueError("mesh_shape %r asks for %s ranks but no process group is up: %s"
                             % (shape, n if n is not None else "all", _LAUNCH_HINT))
        _init_group("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), device)
    return make_mesh(n, device=device)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def _split(x: Optional[torch.Tensor], mesh: DataMesh, dim: int = 0, fill=0):
    """The rank's 1/D of ``x`` along ``dim``, padded with ``fill`` to a
    multiple of D first; a copy, so the whole table can be freed."""
    if x is None:
        return None
    n = x.shape[dim]
    pad = (-n) % mesh.size
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim)
    per = x.shape[dim] // mesh.size
    return x.narrow(dim, mesh.rank * per, per).clone()


def _split_batch(batch, mesh: DataMesh):
    """The rank's (S, N/D) slice of every cloud field; poses whole. N must
    divide by D: the neighbour tables index the (S*N) point axis."""
    n = batch.cloud.depth.shape[1]
    if n % mesh.size:
        raise ValueError("%d padded points a scan do not split over %d ranks (pad_size's "
                         "multiple of 512 does for powers of two)" % (n, mesh.size))
    per = n // mesh.size
    cloud = batch.cloud.map(lambda x: x.narrow(1, mesh.rank * per, per).clone())
    return dataclasses.replace(batch, cloud=cloud)


def _split_planes(planes, mesh: DataMesh):
    """Members split along the support axis (padded with -1 and weight 0);
    the per-plane fields whole."""
    idx, w = planes.member_idx, planes.member_weights
    w = torch.where(idx >= 0, w, torch.zeros_like(w))
    return planes.replace(member_idx=_split(idx, mesh, 1, -1), member_weights=_split(w, mesh, 1),
                          cov=None, eigvals=None, mask=None, loss=None)


def shard_train_data(data, mesh: DataMesh):
    """The rank's part of prepared training data (JAX package,
    sharding.py:221-430), as a ``train.TrainData`` whose ``mesh`` is set.

    Every rank must call it with the same data (``prepare_sequences(...,
    mesh=mesh)`` builds it so); rows pad to a multiple of D with masked
    rows, a cell-window graph with empty tiles. The port's TrainData has no
    static offsets (only the dynamic ``loss_offset``), so nothing is
    refused for them, as the JAX package refuses its static ones.
    """
    if getattr(data, "mesh", None) is not None:
        return data
    n_seq = len(data.batches)

    def per_seq(field):
        vals = getattr(data, field, ()) or ()
        return tuple(vals) + (None,) * (n_seq - len(vals))

    neighbors, weights, masks, qrows = [], [], [], []
    cellwin, off_nn, off_w, tgs, otgs = [], [], [], [], []
    for i, (nn, w, m, qr, cw, onn, ow) in enumerate(zip(
            per_seq("neighbors"), per_seq("weights"), per_seq("masks"), per_seq("query_rows"),
            per_seq("cellwin"), per_seq("off_neighbors"), per_seq("off_weights"))):
        if nn is not None and hasattr(nn, "member_idx"):
            planes = _split_planes(nn, mesh)
            neighbors.append(planes)
            weights.append(None)
            masks.append(planes.valid)
            qrows.append(None)
            cellwin.append(None)
            off_nn.append(None)
            off_w.append(None)
            tgs.append(None)
            otgs.append(None)
            continue
        n_points = data.batches[i].cloud.depth.numel()
        if cw is not None:
            sh = shard_cellwin_device(cw, mesh)
            # The graph's row_map carries the rows' mask; the compacted
            # row tables only served prep.
            neighbors.append(None)
            weights.append(None)
            masks.append(None)
            qrows.append(None)
            cellwin.append(sh)
            rows_p = sh.row_map.shape[0] * mesh.size
            if onn is not None:
                grow = rows_p - onn.shape[0]
                onn = torch.cat([onn, onn.new_full((grow, onn.shape[1]), -1)]) if grow else onn
                ow = torch.cat([ow, ow.new_zeros((grow, ow.shape[1]))]) if grow else ow
        else:
            neighbors.append(_split(nn, mesh, 0, -1))
            weights.append(_split(w, mesh, 0, 0))
            masks.append(_split(m, mesh, 0, False))
            qrows.append(_split(qr, mesh, 0, -1))
            cellwin.append(None)
        off_nn.append(_split(onn, mesh, 0, -1))
        off_w.append(_split(ow, mesh, 0, 0))
        # The rank's rows' transposes over every point (the backward's X4 /
        # X5 sum each point's pairs among this rank's rows; the position
        # gather's backward adds the ranks' parts).
        pos = (global_cloud(data.batches[i]).get_points()
               if neighbors[-1] is not None or off_nn[-1] is not None else None)
        tgs.append(None if neighbors[-1] is None
                   else build_transpose_graph(neighbors[-1], pos, weights[-1]))
        otgs.append(None if off_nn[-1] is None
                    else build_transpose_graph(off_nn[-1], pos, off_w[-1]))
    icp_idx = tuple(_split(x, mesh, 1, 0) for x in (data.icp_idx or ()))
    icp_w = tuple(_split(x, mesh, 1, False) for x in (data.icp_w or ()))
    return dataclasses.replace(
        data, batches=tuple(_split_batch(b, mesh) for b in data.batches),
        neighbors=tuple(neighbors), weights=tuple(weights), masks=tuple(masks),
        query_rows=tuple(qrows), cellwin=tuple(cellwin), off_neighbors=tuple(off_nn),
        off_weights=tuple(off_w), icp_idx=icp_idx, icp_w=icp_w, mesh=mesh,
        transposes=tuple(tgs), off_transposes=tuple(otgs))


def resident_bytes(data) -> dict:
    """Bytes of this rank's per-point tables (``points``: the scan
    batches' fields), its row tables (``rows``: neighbours, weights,
    masks, query rows, the offset graph, ICP correspondences, plane
    members, a cell-window graph's row and point tiles and the transposes'
    pairs) and the tables every rank holds whole (``whole``: the
    cell-window graph's, the transposes' run starts, cell orders and
    tiles)."""
    def nb(x):
        if x is None:
            return 0
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if hasattr(x, "member_idx"):
            return nb(x.member_idx) + nb(x.member_weights)
        return 0

    out = {"points": 0, "rows": 0, "whole": 0}
    for b in data.batches:
        out["points"] += sum(nb(getattr(b.cloud, f.name)) for f in dataclasses.fields(b.cloud))
    for field in ("neighbors", "weights", "masks", "query_rows", "off_neighbors",
                  "off_weights", "icp_idx", "icp_w"):
        out["rows"] += sum(nb(x) for x in (getattr(data, field, ()) or ()))
    for tg in (data.transposes or ()) + (data.off_transposes or ()):
        if tg is not None:
            t = tg.nbytes()
            out["rows"] += t["pairs"]
            out["whole"] += t["points"]
    for cw in data.cellwin or ():
        if isinstance(cw, CellWinShards):
            t = shard_tables_bytes(cw)
            out["rows"] += t["rows"] + t["points"]
            out["whole"] += t["whole"]
        elif cw is not None:
            out["rows"] += sum(nb(getattr(cw, f.name)) for f in dataclasses.fields(cw))
    return out


# ---------------------------------------------------------------------------
# The sharded losses
# ---------------------------------------------------------------------------


def _delta(pose_deltas, i: int, mode):
    if pose_deltas is None:
        return None
    return pose_deltas[0] if mode == PoseCorrection.common else pose_deltas[i]


def _loss_terms(cfg: Config):
    """``(loss, kwargs, reduction)``: the configured consistency loss of
    ``loss.py``, its ``loss_kwargs`` and its reduction (mean or sum)."""
    from ..loss import loss_by_name

    kw = dict(cfg.loss_kwargs or {})
    reduction = str(kw.pop("reduction", "mean"))
    if reduction not in ("mean", "sum"):
        raise ValueError("the sharded loss reduces by mean or sum, got %r" % reduction)
    return loss_by_name(cfg.loss), kw, reduction


def _global_quantile(mesh: DataMesh):
    """``loss.py``'s inlier quantile over every rank's rows: the pointwise
    losses and masks all-gathered (detached), as the JAX package's trim
    does (sharding.py:527-561)."""
    from ..ops.reduce import masked_quantile

    def quantile(pointwise, mask, q):
        both = gather_detached(torch.stack([pointwise.detach(), mask.to(pointwise.dtype)]),
                               mesh, dim=1)
        return masked_quantile(both[0], both[1] > 0.5, q)

    return quantile


def make_sharded_loss_fn(cfg: Config, mesh: DataMesh):
    """The sharded counterpart of ``train.make_loss_fn`` (JAX package,
    sharding.py:459-785): ``loss_fn(model, data, pose_deltas=None)`` over
    data from :func:`shard_train_data`. The returned tensor holds the
    global loss (the same bits on every rank) and back-propagates this
    rank's share; all-reduce the gradients once afterwards
    (``collectives.all_reduce_grads``; ``train.fit`` does).

    The consistency losses run the gather path (capped or not, with
    ``nn_scale``) or the cell-window path over the rank's rows, with the
    loss offset and the pose deltas; ``loss.py``'s own losses then give
    the rank's (sum, count), their inlier trim taking its quantile over
    every rank's rows. Plane mode and ``icp_loss`` take their own bodies.
    """
    if cfg.loss == "icp_loss":
        return _make_sharded_icp_loss_fn(cfg, mesh)
    if cfg.loss not in ("min_eigval_loss", "trace_loss"):
        raise NotImplementedError("the sharded step takes the consistency losses and icp_loss")
    if cfg.nn_type == NeighborhoodType.plane:
        return _make_sharded_plane_loss_fn(cfg, mesh)
    from ..loss import batch_sums, pointwise_loss
    from ..ops.features import neighborhood_features, permute_rows
    from ..preproc import corrected_poses
    from ..train import FeatureRows

    loss, kw, reduction = _loss_terms(cfg)
    quantile = _global_quantile(mesh)
    trace, normalization = cfg.loss == "trace_loss", bool(kw.get("normalization", False))
    mode = cfg.pose_correction

    def seq_rows(model, batch, data, i, delta):
        """The rank's feature rows, their mask and the offset's pointwise
        loss (or None) of sequence ``i``."""
        cloud = model.apply(batch.cloud) if model is not None else batch.cloud
        posed = cloud.transform(corrected_poses(batch.poses, delta)).to_points()
        onn = data.off_neighbors[i] if data.off_neighbors else None
        # One gather a sequence: the posed positions, and with the offset
        # the local (scan-frame) positions beside them.
        table = posed if onn is None else torch.cat([posed, cloud.to_points()], -1)
        full = all_gather_rows(table, mesh, dim=1)
        full = full.reshape(-1, full.shape[-1])
        points = full[:, :3]
        cw = data.cellwin[i] if data.cellwin else None
        if cw is not None:
            feats = cellwin_features_sharded(permute_rows(points, cw.perm, cw.inv), cw)
            mask = cw.row_map >= 0
        else:
            feats = neighborhood_features(points, data.neighbors[i], data.weights[i],
                                          scale=cfg.nn_scale, compute_normals=False,
                                          query_rows=data.query_rows[i],
                                          tg=data.transposes[i])
            mask = data.masks[i]
        off = None
        if onn is not None:
            # Unscaled, as the single-device offset (train.make_loss_fn).
            f = neighborhood_features(full[:, 3:], onn, data.off_weights[i],
                                      compute_normals=False, tg=data.off_transposes[i])
            off = pointwise_loss(FeatureRows(eigvals=f["eigvals"], trace=f["trace"]), trace,
                                 normalization)
        rows = FeatureRows(eigvals=feats["eigvals"], trace=feats["trace"], valid=mask)
        return rows, mask, off

    def loss_fn(model, data, pose_deltas=None):
        rows, masks, offs = zip(*[seq_rows(model, batch, data, i, _delta(pose_deltas, i, mode))
                                  for i, batch in enumerate(data.batches)])
        total, count, _ = batch_sums(loss, rows, masks, offs, inlier_quantile=quantile, **kw)
        return _combine(total, count, reduction, mesh)

    return loss_fn


def _combine(total, count, reduction: str, mesh: DataMesh):
    """The global loss from every rank's (sum, count): a detached
    all-reduce of both; the rank back-propagates its sum over the global
    count."""
    count = torch.as_tensor(count, dtype=total.dtype, device=total.device)
    sc = all_reduce_sum(torch.stack([total.detach(), count]), mesh)
    if reduction == "sum":
        return with_global_value(total, sc[0])
    denom = torch.clamp(sc[1], min=1)
    return with_global_value(total / denom, sc[0] / denom)


def _make_sharded_plane_loss_fn(cfg: Config, mesh: DataMesh):
    """Plane mode over the support axis (JAX package, sharding.py:787-932):
    each rank gathers its members' posed viewpoints, directions and depths
    from the all-gathered (S*N, 7) table, corrects them with the planes'
    normals for the incidence angles, and three sums over ranks ((P,)
    beside (P, 3) in one, then (P, 3, 3)) give each plane's covariance.
    The planes' loss (``loss.py``'s, the plane axis whole on every rank)
    is then the same on every rank; each rank back-propagates it over D,
    and the sums' backward all-reduces (``collectives.sum_over_ranks``).
    The eigenvalues are solved in float64 (``segmentation._plane_eigvals``)."""
    from ..loss import batch_sums
    from ..ops.features import gather_neighbors
    from ..preproc import corrected_poses
    from ..segmentation import _plane_eigvals
    from ..train import FeatureRows

    loss, kw, reduction = _loss_terms(cfg)
    mode = cfg.pose_correction

    def seq_rows(model, batch, planes, delta):
        tc = batch.cloud.transform(corrected_poses(batch.poses, delta))
        full = all_gather_rows(torch.cat([tc.vps, tc.dirs, tc.depth[..., None]], -1), mesh,
                               dim=1)
        g = gather_neighbors(full.reshape(-1, 7), planes.member_idx)  # (P, s, 7)
        vps, dirs, depth = g[..., 0:3], g[..., 3:6], g[..., 6]
        normals = planes.params[:, None, :3].to(dirs.dtype)
        inc = torch.arccos(torch.clamp(torch.abs((dirs * normals).sum(-1)), 0.0, 1.0))
        if model is not None:
            depth = model.correct_depth(depth, inc)
        pts = vps + depth[..., None] * dirs
        w = planes.member_weights.to(pts.dtype)
        s1 = sum_over_ranks(torch.cat([w.sum(-1)[:, None], (w[..., None] * pts).sum(-2)], 1),
                            mesh)
        sw = s1[:, 0]
        mean = s1[:, 1:] / torch.clamp(sw, min=1e-12)[:, None]
        xc = pts - mean[:, None, :]
        xx = sum_over_ranks(torch.einsum("pki,pkj->pij", xc * w[..., None], xc), mesh)
        cov = xx / torch.clamp(sw - 1.0, min=1e-6)[:, None, None]
        return FeatureRows(eigvals=_plane_eigvals(cov), cov=cov, valid=planes.valid)

    def loss_fn(model, data, pose_deltas=None):
        rows = [seq_rows(model, batch, data.neighbors[i], _delta(pose_deltas, i, mode))
                for i, batch in enumerate(data.batches)]
        total, count, _ = batch_sums(loss, rows, [r.valid for r in rows], **kw)
        value = total if reduction == "sum" else total / torch.clamp(
            torch.as_tensor(count, dtype=total.dtype), min=1)
        return with_global_value(value / mesh.size, value.detach())

    return loss_fn


def _make_sharded_icp_loss_fn(cfg: Config, mesh: DataMesh):
    """The ICP objective over the per-pair point axis (JAX package,
    sharding.py:934-1040): each rank holds N/D correspondence rows of
    every pair, takes its source rows from its own slice and the targets
    from the all-gathered scans (positions and normals in one gather), and
    its share is its rows' part of each pair's weighted mean; the pairs'
    weight sums are all-reduced (the weights are frozen)."""
    from ..preproc import corrected_poses

    p2plane = bool((cfg.loss_kwargs or {}).get("icp_point_to_plane", True))
    mode = cfg.pose_correction

    def seq_share(model, batch, idx, w, delta):
        cloud = model.apply(batch.cloud) if model is not None else batch.cloud
        tc = cloud.transform(corrected_poses(batch.poses, delta))
        p_loc = tc.to_points()
        n_loc = tc.normals if p2plane else None
        if p2plane and n_loc is None:
            raise ValueError("point-to-plane ICP needs normals")
        table = p_loc if n_loc is None else torch.cat([p_loc, n_loc], -1)
        full = all_gather_rows(table, mesh, dim=1)
        gi = idx.clamp(min=0).long()[..., None].expand(-1, -1, 3)
        p1 = p_loc[:-1]
        q2 = torch.gather(full[1:, :, 0:3], 1, gi)
        wf = w.to(p_loc.dtype)
        w_sum = torch.clamp(all_reduce_sum(wf.sum(-1), mesh), min=1.0)
        if p2plane:
            n2 = torch.gather(full[1:, :, 3:6], 1, gi)
            d12 = ((n_loc[:-1] * (q2 - p1)).sum(-1).abs() * wf).sum(-1) / w_sum
            d21 = ((n2 * (p1 - q2)).sum(-1).abs() * wf).sum(-1) / w_sum
            pair = 0.5 * (d12 + d21)
        else:
            pair = (torch.linalg.norm(q2 - p1, dim=-1) * wf).sum(-1) / w_sum
        return pair.mean()

    def loss_fn(model, data, pose_deltas=None):
        share = 0.0
        for i, batch in enumerate(data.batches):
            share = share + seq_share(model, batch, data.icp_idx[i], data.icp_w[i],
                                      _delta(pose_deltas, i, mode))
        share = share / max(len(data.batches), 1)
        return with_global_value(share, all_reduce_sum(share, mesh))

    return loss_fn
