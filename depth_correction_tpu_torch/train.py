"""Self-supervised training (counterpart of ``depth_correction_tpu/train.py``).

Reference trainer: src/depth_correction/train.py:46-327. Preprocessing
(per-scan feature clouds, frozen global neighborhoods, trainable-region
masks, the cell-window graph) happens once; each step then runs

    model apply -> pose transform + merge -> permute into the cell-sorted
    layout -> cell-window moments (CUDA kernel K1) -> 3x3 eigenvalues ->
    masked loss -> backward (cotangent table -> CUDA kernel K2) -> Adam.

The port trains the min-eigenvalue, trace and ICP objectives with Adam,
SGD or L-BFGS (``optim.LBFGS``: optax's algorithm with its strong-Wolfe
zoom line search) on one device, over the uncapped graph (the cell-window
kernels) or a capped one (gather moments: P7 forward, X4 backward over the
graph's transpose), with the
dynamic loss offset (``loss_offset``: the local clouds' pointwise loss
under the current model subtracted), the Gaussian re-weighting
(``nn_scale``), pose corrections (``pose_correction`` none, common,
sequence or pose: SE(3) deltas trained beside the model), validation
sequences, checkpoint and resume (``checkpoint_period``, ``resume``), the
prep cache (``prep_cache_dir``) and the JAX package's outputs
(``train.yaml``, the best model's ``<tag>_state_dict.npz`` and
``<tag>_pose_deltas.npz``, ``best.yaml``, ``train_history.csv``). Plane
neighbourhoods (``nn_type = 'plane'``) train on the RANSAC planes of the
global cloud (``segmentation.py``): the model corrects each member point
with its plane's normal for the incidence angle, and the loss takes each
plane's eigenvalues. With ``mesh_shape`` or ``dist_coordinator`` the step
runs over a ``torch.distributed`` group, one process a rank, each rank
holding 1/D of every per-point table (``parallel/``); rank 0 writes the
run's files. With ``profile_dir`` the loop writes a ``torch.profiler``
trace of iterations 2 to 6.

Prep builds, for the gather path, the transpose of each sequence's graph
and of the offset's graph (``ops.features.build_transpose_graph``, a CSR
on the device): the backward of the gather moments is kernel X4 over it,
and under ``nn_scale`` the gather's backward kernel X5. The JAX package's
bucketing of those transposes by in-degree pads for the TPU's lanes and
is not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .config import Config, NeighborhoodType, PoseCorrection
from .loss import create_loss, pointwise_loss
from .models import load_model, model_state, save_state_file
from .ops.features import TransposeGraph, build_transpose_graph
from .ops.filters import global_cloud_mask
from .optim import LBFGS, Adam
from .preproc import (
    SequenceBatch,
    compute_neighborhood_features,
    corrected_poses,
    establish_neighborhoods,
    global_cloud,
    local_feature_cloud,
    offset_cloud,
    pad_size,
    sequence_batch,
)
from .utils import trace
from .utils.checkpoint import save_pytree

__all__ = [
    "FeatureRows",
    "TrainCallbacks",
    "TrainData",
    "check_slice",
    "fit",
    "init_pose_deltas",
    "make_loss_fn",
    "make_optimizer",
    "prepare_sequences",
    "train",
]


def check_slice(cfg: Config) -> None:
    """Raise NotImplementedError for an optimizer the port does not have."""
    if cfg.optimizer.lower() not in ("adam", "sgd", "lbfgs"):
        raise NotImplementedError("optimizer=%s is not ported" % cfg.optimizer)


class TrainCallbacks:
    """Hook interface (reference: train.py:25-43)."""

    def __init__(self, cfg: Config = None):
        self.cfg = cfg

    def iteration_started(self, it):
        pass

    def train_inputs(self, it, data):
        """Fired once before the loop with the prepared (frozen) TrainData."""

    def train_loss(self, it, model, pose_deltas, loss):
        """Fired each step with the model the loss was evaluated at (before
        the optimizer updates it in place)."""

    def val_loss(self, it, model, pose_deltas, loss):
        """Fired each step with the validation loss at the same model."""


def init_pose_deltas(data: "TrainData", cfg: Config):
    """Zero pose corrections for ``cfg.pose_correction`` (JAX package,
    train.py:600-622; reference: eval.py:31-65): None for ``none``; one
    (1, 6) leaf shared by every sequence for ``common``; a (1, 6) leaf a
    sequence for ``sequence``; an (S, 6) leaf a sequence, a row a scan, for
    ``pose``. Each row is [tx ty tz rx ry rz] (translation, axis-angle);
    the leaves require grad, in ``cfg.torch_dtype()`` on
    ``cfg.torch_device()``."""
    mode = cfg.pose_correction
    if mode == PoseCorrection.none:
        return None
    kw = {"dtype": cfg.torch_dtype(), "device": cfg.torch_device(), "requires_grad": True}
    if mode == PoseCorrection.common:
        return (torch.zeros((1, 6), **kw),)
    if mode == PoseCorrection.sequence:
        return tuple(torch.zeros((1, 6), **kw) for _ in data.batches)
    if mode == PoseCorrection.pose:
        return tuple(torch.zeros((b.num_scans, 6), **kw) for b in data.batches)
    raise ValueError(mode)


def _delta_for_seq(pose_deltas, i: int, mode):
    """Sequence ``i``'s delta: the shared leaf in ``common`` mode."""
    if pose_deltas is None:
        return None
    return pose_deltas[0] if mode == PoseCorrection.common else pose_deltas[i]


def _mask_delta_grads(pose_deltas, cfg: Config) -> None:
    """Freeze the first pose in ``pose`` mode (JAX package, train.py:936-940;
    reference: train.py:308-311): its gradient is zeroed, so Adam and SGD
    leave it exactly where it is."""
    if pose_deltas is None or cfg.pose_correction != PoseCorrection.pose:
        return
    for d in pose_deltas:
        if d.grad is not None:
            d.grad[0] = 0.0


def _pose_path(paths, i: int, names):
    """Entry ``i`` of a ``*_poses_path`` list, with a clear error on a
    length mismatch (JAX package, train.py:48-59)."""
    if not paths:
        return None
    if i >= len(paths):
        raise ValueError("poses_path list has %d entries for %d sequences (%s)"
                         % (len(paths), len(names), ", ".join(map(str, names))))
    return paths[i]


@dataclasses.dataclass(frozen=True)
class TrainData:
    """Static per-sequence training inputs (frozen across iterations).

    With a cell-window graph (``cellwin[i]`` not None) the feature rows live
    in the graph's padded tile layout and ``neighbors[i]`` only serves
    prep; otherwise the loss gathers over the compacted rows. In plane mode
    ``neighbors[i]`` is the sequence's :class:`segmentation.Planes` and
    ``masks[i]`` its ``valid``; the batches hold the raw padded scans.
    """

    batches: tuple  # tuple[SequenceBatch]
    # tuple[(Mq, K) int64 compacted query rows' neighbors, or Planes]
    neighbors: tuple
    weights: tuple  # tuple[(Mq, K) float]
    masks: tuple  # tuple[(Mq,) bool]
    query_rows: tuple  # tuple[(Mq,) int64] row -> global point, -1 padding
    cellwin: tuple  # tuple[ops.cellwin.CellWinDevice or None]
    prep_seconds: dict = dataclasses.field(default_factory=dict)
    # Why each sequence's cell-window build declined (the builder's note),
    # None where it built or was not tried.
    cellwin_notes: tuple = ()
    # The dynamic loss offset (loss_offset): each loss row's frozen LOCAL
    # (per-scan) neighbourhood in the (S*N,) local-point axis, in the
    # rows' layout (compacted rows, or the cell-window tile layout), and
    # its weights; None per sequence without the offset.
    off_neighbors: tuple = ()  # tuple[(Mq, Kl) int64 or None]
    off_weights: tuple = ()  # tuple[(Mq, Kl) float or None]
    # ICP training: frozen correspondences of consecutive scans, rows of
    # scan i+1 (S-1, N) and their inlier weights (S-1, N) bool.
    icp_idx: tuple = ()
    icp_w: tuple = ()
    # The rank's data mesh (parallel.sharding.DataMesh) once
    # parallel.shard_train_data has split the tables; None on one device.
    mesh: object = None
    # The gather path's transposes (ops.features.TransposeGraph) of
    # ``neighbors[i]`` over the sequence's points and of ``off_neighbors[i]``
    # over its local points, for the backward; None on the cell-window
    # path, in plane and ICP mode, without a gradient (for_grad False) and
    # before parallel.shard_train_data builds each rank's own.
    transposes: tuple = ()
    off_transposes: tuple = ()

    def to(self, device=None, dtype=None) -> "TrainData":
        """Move to ``device`` and cast the floating point clouds and
        weights to ``dtype``; the cell-window graphs keep their float32
        tables (the kernels' inputs) and move only."""
        def mv(x):
            if x is None:
                return None
            if not isinstance(x, torch.Tensor):  # Planes
                return x.to(device=device, dtype=dtype)
            if dtype is not None and x.is_floating_point():
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)

        def mv_cw(cw):
            if cw is None:
                return None
            return dataclasses.replace(cw, **{
                f.name: getattr(cw, f.name).to(device=device)
                for f in dataclasses.fields(cw)
                if isinstance(getattr(cw, f.name), (torch.Tensor, TransposeGraph))
            })

        return TrainData(
            batches=tuple(b.to(device=device, dtype=dtype) for b in self.batches),
            neighbors=tuple(mv(x) for x in self.neighbors),
            weights=tuple(mv(x) for x in self.weights),
            masks=tuple(mv(x) for x in self.masks),
            query_rows=tuple(mv(x) for x in self.query_rows),
            cellwin=tuple(mv_cw(c) for c in self.cellwin),
            prep_seconds=dict(self.prep_seconds),
            cellwin_notes=self.cellwin_notes,
            off_neighbors=tuple(mv(x) for x in self.off_neighbors),
            off_weights=tuple(mv(x) for x in self.off_weights),
            icp_idx=tuple(mv(x) for x in self.icp_idx),
            icp_w=tuple(mv(x) for x in self.icp_w),
            mesh=self.mesh,
            transposes=tuple(mv(x) for x in self.transposes),
            off_transposes=tuple(mv(x) for x in self.off_transposes),
        )


@dataclasses.dataclass(frozen=True)
class FeatureRows:
    """Pointwise features for the loss over the query rows; duck-types the
    Cloud surface the consistency losses consume."""

    eigvals: torch.Tensor  # (Mq, 3)
    trace: Optional[torch.Tensor] = None
    cov: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    loss: Optional[torch.Tensor] = None

    @property
    def size(self):
        return self.eigvals.shape[0]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _use_cellwin(cfg: Config, for_grad: bool) -> bool:
    backend = cfg.moments_backend or "auto"
    # 'auto' promotes the cell-window engine on a CUDA device, only when the
    # requested graph already IS the uncapped within-r graph, so it never
    # changes the objective; explicit 'cellwin' forces an uncapped graph.
    # spatial_sort turns the engine off, as in the JAX package
    # (train.py:335-342): the graph is then established with the config as
    # given and the step gathers.
    auto = (backend == "auto" and cfg.torch_device().type == "cuda"
            and cfg.nn_max_neighbors is None)
    return ((backend == "cellwin" or auto) and for_grad
            and cfg.nn_scale is None and bool(cfg.nn_r) and not cfg.nn_k
            and not cfg.spatial_sort)


@contextlib.contextmanager
def _prep_part(seconds: dict, part: str, device):
    """One part of prep: the span ``prep.<part>``, and its seconds (ending
    in a device sync) added to ``seconds[part]`` unless the block sets the
    yielded flag's ``[0]`` False (a prep cache lookup that missed)."""
    keep = [True]
    t0 = time.perf_counter()
    with trace.span("prep." + part):
        yield keep
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if keep[0]:
        seconds[part] = seconds.get(part, 0.0) + (time.perf_counter() - t0)


def _offset_graph(local_nns, n_dim: int, qrows, qvalid, cw_dev, dtype):
    """The loss offset's frozen graph (JAX package, train.py:471-524): each
    scan's local neighbours moved to the (S*N,) local-point axis by
    ``s * n_dim``, stacked, gathered through the query rows and, on a
    cell-window graph, re-indexed into its tile layout through
    ``row_map``. Returns (neighbors (Mq, Kl) int64, weights)."""
    kl = max(a.shape[1] for a in local_nns)
    blocks = []
    for s, a in enumerate(local_nns):
        a = a.long()
        block = torch.where(a >= 0, a + s * n_dim, torch.full_like(a, -1))
        blocks.append(torch.nn.functional.pad(block, (0, kl - a.shape[1]), value=-1))
    flat = torch.cat(blocks, 0)
    minus = torch.full((), -1, dtype=torch.int64, device=flat.device)
    onn = torch.where(qvalid[:, None], flat[qrows.clamp(min=0)], minus)
    if cw_dev is not None:
        rm = cw_dev.row_map
        onn = torch.where((rm >= 0)[:, None], onn[rm.clamp(min=0)], minus)
    return onn, (onn >= 0).to(dtype)


_RECORD_FIELDS = ("batches", "neighbors", "weights", "masks", "query_rows", "cellwin",
                  "cellwin_notes", "off_neighbors", "off_weights", "icp_idx",
                  "icp_w")


def prepare_sequences(datasets, cfg: Config, for_grad: bool = True, mesh=None) -> TrainData:
    """Build per-sequence batches, frozen neighborhoods, masks and the
    cell-window graphs (reference: train.py:90-216 without the hot loop;
    JAX package, train.py:132-597).

    Neighborhoods are established as ``preproc`` routes ``cfg.nn_backend``
    (None, ``'grid'``, ``'scipy'``, as in the JAX package): the bench's
    ``'grid'`` runs the grid-hash search, kernel X2 on the card, for every
    scan and for the global cloud. With ``loss = 'icp_loss'`` the scans
    keep their normals and planar masks, and the frozen correspondences of
    consecutive scans replace the global graph; with ``loss_offset`` the
    per-scan neighbourhoods are kept for the offset. With
    ``cfg.prep_cache_dir`` each sequence is looked up in, or written to,
    the prep cache (``utils/prep_cache.py``). The seconds of each prep part
    are printed to stderr and kept in ``TrainData.prep_seconds``.

    :param mesh: a ``parallel.DataMesh``: the global establishment then
        queries each rank's slice of the rows and gathers the tables
        (``preproc.establish_neighborhoods(mesh=)``), so every rank holds
        the same whole tables and the same cell-window graph, built on the
        host; ``parallel.shard_train_data`` splits them afterwards. The
        prep cache keys the mesh flag.
    """
    check_slice(cfg)
    device = cfg.torch_device()
    seconds: dict = {}
    out = {f: [] for f in _RECORD_FIELDS}
    # Plane mode gathers plane members; the cell-window engine stays off
    # (JAX package, config.py:184).
    use_cellwin = _use_cellwin(cfg, for_grad) and cfg.nn_type != NeighborhoodType.plane
    icp_mode = cfg.loss == "icp_loss"
    cache_dir = cfg.prep_cache_dir
    transposes, off_transposes = [], []
    for ds in datasets:
        with _prep_part(seconds, "load_scans", device):
            scans = [(scan, pose) for scan, pose in ds]
        fp = rec = None
        if cache_dir:
            from .utils.prep_cache import load_record, sequence_fingerprint

            with _prep_part(seconds, "cache_load", device) as hit:
                fp = sequence_fingerprint(scans, cfg, for_grad, mesh=mesh is not None)
                rec = load_record(cache_dir, fp, device)
                hit[0] = rec is not None
            if rec is not None:
                print("[prep] sequence reloaded from prep cache (%s)" % fp, file=sys.stderr)
        if rec is None:
            rec = _prepare_sequence(scans, cfg, use_cellwin, icp_mode, seconds, device, mesh)
            if fp is not None:
                from .utils.prep_cache import save_record

                with _prep_part(seconds, "cache_save", device):
                    save_record(cache_dir, fp, rec)
        del scans
        tg, otg = _sequence_transposes(rec, for_grad and mesh is None, seconds, device)
        transposes.append(tg)
        off_transposes.append(otg)
        for f in _RECORD_FIELDS:
            out[f].append(rec[f])
    for part, s in seconds.items():
        print("[prep] %s: %.3f s" % (part, s), file=sys.stderr)
    return TrainData(prep_seconds=seconds, transposes=tuple(transposes),
                     off_transposes=tuple(off_transposes),
                     **{f: tuple(v) for f, v in out.items()})


def _sequence_transposes(rec: dict, for_grad: bool, seconds: dict, device) -> tuple:
    """The transposes of one sequence's gather graph and offset graph over
    its S * N points, for the backward (``(None, None)`` where no gather
    is differentiated, or under a mesh, where parallel.shard_train_data
    builds each rank's), timed as ``transpose``. A cell-window graph
    reloaded from the prep cache gets its exception rows' transpose back
    (the cache does not store transposes)."""
    from .ops import cellwin as cwin

    tg = otg = None
    with _prep_part(seconds, "transpose", device):
        cw, nn = rec["cellwin"], rec["neighbors"]
        if cw is not None and cw.exc_tg is None:
            rec["cellwin"] = cwin.with_exc_transpose(cw)
        if for_grad and rec["batches"] is not None:
            gather = cw is None and isinstance(nn, torch.Tensor)
            if gather or rec["off_neighbors"] is not None:
                # The points' positions at establishment order the targets.
                pos = global_cloud(rec["batches"]).get_points()
            if gather:
                tg = build_transpose_graph(nn, pos, rec["weights"])
            if rec["off_neighbors"] is not None:
                otg = build_transpose_graph(rec["off_neighbors"], pos, rec["off_weights"])
    return tg, otg


def _prepare_sequence(scans, cfg: Config, use_cellwin: bool, icp_mode: bool, seconds: dict,
                      device, mesh=None) -> dict:
    """One sequence's record of :data:`_RECORD_FIELDS` (the body of
    :func:`prepare_sequences`)."""
    from .cloud import Cloud

    rec = dict.fromkeys(_RECORD_FIELDS)
    common_pad = max((pad_size(len(s)) for s, _ in scans), default=0)
    plane_mode = cfg.nn_type == NeighborhoodType.plane and not icp_mode
    clouds, poses, local_nns = [], [], []
    with _prep_part(seconds, "local_features", device):
        for scan, pose in scans:
            if plane_mode:
                # Plane mode consumes the raw clouds; the incidence angles
                # come from the plane normals (JAX package, train.py:235-239;
                # reference: train.py:98-101).
                clouds.append(Cloud.from_structured_array(
                    scan, dtype=cfg.torch_dtype(), device=device).pad(common_pad))
                poses.append(np.asarray(pose))
                continue
            if cfg.loss_offset and not icp_mode:
                fc, lnn, _ = local_feature_cloud(scan, cfg, pad_to=common_pad,
                                                 return_neighbors=True)
                local_nns.append(lnn)
            else:
                fc = local_feature_cloud(scan, cfg, pad_to=common_pad)
            # The hot loop consumes source fields, incidence angles and the
            # planar mask only; ICP also the per-scan normals.
            clouds.append(fc.replace(points=None, mean=None, cov=None, eigvals=None,
                                     eigvecs=None, trace=None, loss=None,
                                     normals=fc.normals if icp_mode else None))
            poses.append(np.asarray(pose))
        batch = sequence_batch(clouds, np.stack(poses))
        rec["batches"] = batch

    if icp_mode:
        from .loss import icp_pair_correspondences

        # Frozen correspondences of the posed, uncorrected points
        # (reference: train.py:179-210; JAX package, train.py:266-296).
        with _prep_part(seconds, "icp_correspondences", device):
            posed = batch.cloud.transform(batch.poses)
            idx, w = icp_pair_correspondences(
                posed.to_points().detach().cpu().numpy(), batch.cloud.valid.cpu().numpy(),
                float((cfg.loss_kwargs or {}).get("icp_inlier_ratio", 0.5)))
            rec["icp_idx"] = torch.as_tensor(idx, dtype=torch.int64, device=device)
            rec["icp_w"] = torch.as_tensor(w, device=device)
        return rec

    if plane_mode:
        # The planes stand in for the neighbours, their valid flags for the
        # rows' mask (JAX package, train.py:298-310).
        with _prep_part(seconds, "planes", device):
            planes, _ = establish_neighborhoods(global_cloud(batch), cfg, mesh=mesh)
            rec.update(neighbors=planes, masks=planes.valid)
        return rec
    est_cfg = cfg
    if use_cellwin:
        # Membership recomputed as d2 <= r2 is exact only for the
        # UNCAPPED within-r graph, so establishment ignores the cap.
        est_cfg = cfg.copy()
        est_cfg.nn_max_neighbors = None
        est_cfg.nn_symmetrize = False
    with _prep_part(seconds, "global_neighbors", device):
        gcloud = global_cloud(batch)
        nn, w = establish_neighborhoods(gcloud, est_cfg, mesh=mesh)
    with _prep_part(seconds, "global_features", device):
        feat = compute_neighborhood_features(gcloud, nn, w, cfg)
        gmask = global_cloud_mask(feat, nn, w, cfg, mask=feat.mask)

    # Query-row compaction: only rows that enter the loss keep their
    # neighborhoods; every point still serves as a neighbor.
    kept = torch.nonzero(gmask).reshape(-1)
    mq = pad_size(max(int(kept.numel()), 1))
    qrows = torch.full((mq,), -1, dtype=torch.int64, device=gmask.device)
    qrows[: kept.numel()] = kept
    qvalid = qrows >= 0
    nn_c = torch.where(qvalid[:, None], nn[qrows.clamp(min=0)],
                       torch.full_like(nn[:1], -1))
    rec.update(neighbors=nn_c, weights=(nn_c >= 0).to(w.dtype), masks=qvalid, query_rows=qrows)

    cw_dev = None
    if use_cellwin:
        with _prep_part(seconds, "cellwin_build", device):
            cw_dev = _cellwin_graph(rec, cfg, gcloud, qrows, nn_c, device)
    rec["cellwin"] = cw_dev
    if cfg.loss_offset:
        with _prep_part(seconds, "offset_graph", device):
            rec["off_neighbors"], rec["off_weights"] = _offset_graph(
                local_nns, batch.cloud.depth.shape[1], qrows, qvalid, cw_dev, w.dtype)
    return rec


def _cellwin_graph(rec: dict, cfg: Config, gcloud, qrows, nn_c, device):
    """The cell-window graph of the compacted rows on ``device``, or None
    where the build declines (its note then in ``rec["cellwin_notes"]``)."""
    from .ops import cellwin as cwin

    extra = {}
    if cfg.cellwin_eps_rel is not None:
        extra["eps_rel"] = float(cfg.cellwin_eps_rel)
    if cfg.cellwin_max_exc_frac is not None:
        extra["max_exc_frac"] = float(cfg.cellwin_max_exc_frac)
    pts_np = gcloud.get_points().detach().cpu().to(torch.float64).numpy()
    valid_np = gcloud.valid.cpu().numpy()
    qrows_np, nn_np = qrows.cpu().numpy(), nn_c.cpu().numpy()
    g = None
    # Escalate the span budget once before declining.
    for span_limit in (512, 1024):
        g = cwin.build_cellwin_graph(
            pts_np, valid_np, qrows_np, nn_np, float(cfg.nn_r),
            row_cap=int(cfg.cellwin_row_cap),
            pt_cap=int(cfg.cellwin_pt_cap),
            span_limit=span_limit,
            z_max=cfg.cellwin_z_max,
            **extra,
        )
        if g is not None:
            break
    if g is None:
        rec["cellwin_notes"] = cwin.LAST_NOTE
        print("[prep] cellwin build %s; using gather moments" % cwin.LAST_NOTE,
              file=sys.stderr)
        return None
    print("[prep] cellwin graph: %d rows -> %d tiles x %d "
          "(span cap %d/%d), %d exception rows"
          % (g.n_rows, g.n_row_tiles, g.row_cap, g.span_cap,
             g.rspan_cap, g.n_exc), file=sys.stderr)
    return cwin.graph_to_device(g, device)


def make_loss_fn(cfg: Config, loss_fun=None, plain: bool = False):
    """Loss of the model over all sequences: ``loss_fn(model, data,
    pose_deltas=None)``, with ``pose_deltas`` as :func:`init_pose_deltas`
    makes them (each sequence's poses right-multiplied by its delta).

    Mirrors ``eval_loss_clouds`` (reference: eval.py:85-112) for the
    map-consistency losses: corrected global clouds -> features over frozen
    neighborhoods (Gaussian re-weighted with ``nn_scale``) -> batch loss,
    less the dynamic offset with ``loss_offset``. For ``icp_loss`` (JAX
    package, train.py:714-742): corrected scans -> corrected poses ->
    the batched ICP distance over the frozen correspondences, averaged
    over sequences. In plane mode (JAX package, train.py:788-797) each
    sequence's global cloud is posed uncorrected and the model applies
    inside :func:`segmentation.plane_neighborhood_features`, with the plane
    normals for the incidence angles; the loss takes each plane's
    eigenvalues. ``plain`` computes the moments with the plain torch
    kernels on any device and dtype (reference runs).
    """
    check_slice(cfg)
    mode = cfg.pose_correction
    plane_mode = cfg.nn_type == NeighborhoodType.plane

    if cfg.loss == "icp_loss":
        from .loss import icp_pair_loss_batched

        p2plane = bool((cfg.loss_kwargs or {}).get("icp_point_to_plane", True))

        def icp_loss_fn(model, data: TrainData, pose_deltas=None):
            total = 0.0
            for i, batch in enumerate(data.batches):
                cloud = model.apply(batch.cloud) if model is not None else batch.cloud
                tc = cloud.transform(corrected_poses(
                    batch.poses, _delta_for_seq(pose_deltas, i, mode)))
                total = total + icp_pair_loss_batched(tc.to_points(), tc.normals,
                                                      data.icp_idx[i], data.icp_w[i],
                                                      point_to_plane=p2plane)
            return total / max(len(data.batches), 1)

        return icp_loss_fn

    loss_fun = loss_fun or create_loss(cfg)
    normalization = bool((cfg.loss_kwargs or {}).get("normalization"))
    trace = cfg.loss == "trace_loss"

    def local_offset(model, batch, onn, ow, otg):
        """The local clouds' pointwise loss under the current model (JAX
        package, train.py:744-768; reference: preproc.py:67-77,
        loss.py:279-281), unscaled even with ``nn_scale`` (the reference
        re-weights the global cloud only); its backward through the offset
        graph's transpose ``otg``."""
        from .ops.features import neighborhood_features

        f = neighborhood_features(offset_cloud(batch, model).get_points(), onn, ow,
                                  compute_normals=False, plain=plain, tg=otg)
        return pointwise_loss(FeatureRows(eigvals=f["eigvals"], trace=f["trace"]), trace,
                              normalization)

    def loss_fn(model, data: TrainData, pose_deltas=None):
        from .ops.cellwin import cellwin_features
        from .ops.features import neighborhood_features, permute_rows

        feats, seq_masks, offsets = [], [], []
        for i, batch in enumerate(data.batches):
            if plane_mode:
                from .segmentation import plane_neighborhood_features

                gcloud = global_cloud(batch, model=None,
                                      pose_deltas=_delta_for_seq(pose_deltas, i, mode))
                feats.append(plane_neighborhood_features(gcloud, data.neighbors[i], model, cfg))
                seq_masks.append(data.masks[i])
                offsets.append(None)
                continue
            cw = data.cellwin[i] if data.cellwin else None
            gcloud = global_cloud(batch, model=model,
                                  pose_deltas=_delta_for_seq(pose_deltas, i, mode))
            if cw is not None:
                # The kernels consume the padded cell-sorted point layout;
                # rows live in the graph's padded tile layout.
                ps = permute_rows(gcloud.get_points(), cw.perm, cw.inv)
                f = cellwin_features(ps, cw, plain=plain)
                mask = cw.row_map >= 0
            else:
                f = neighborhood_features(gcloud.get_points(), data.neighbors[i],
                                          data.weights[i], scale=cfg.nn_scale,
                                          compute_normals=False, plain=plain,
                                          query_rows=data.query_rows[i],
                                          tg=data.transposes[i] if data.transposes else None)
                mask = data.masks[i]
            seq_masks.append(mask)
            feats.append(FeatureRows(eigvals=f["eigvals"], trace=f["trace"], valid=mask))
            onn = data.off_neighbors[i] if data.off_neighbors else None
            offsets.append(None if onn is None else local_offset(
                model, batch, onn, data.off_weights[i],
                data.off_transposes[i] if data.off_transposes else None))
        value, _ = loss_fun(feats, mask=seq_masks,
                            offset=offsets if any(o is not None for o in offsets) else None)
        return value

    return loss_fn


def make_optimizer(cfg: Config, params):
    """Adam, SGD or L-BFGS per config (reference: train.py:140-156; JAX
    package, train.py:869-915): ``optax.adam(lr)`` with betas (0.9, 0.999)
    and eps 1e-8 becomes ``torch.optim.Adam`` with the same values, and
    with a non-zero ``eps_root`` or ``nesterov`` the port's
    :class:`optim.Adam` (optax's update; ``mu_dtype`` raises);
    ``optax.sgd(lr, momentum, nesterov)`` becomes ``torch.optim.SGD``, whose
    momentum buffer starts at the first gradient as optax's trace does;
    ``lbfgs`` becomes :class:`optim.LBFGS` (``optimizer_kwargs``
    ``memory_size`` 10, ``line_search`` True: the strong-Wolfe zoom, which
    sets the stepsize and ignores ``lr``; ``max_linesearch_steps`` 20).
    ``params`` is a list of tensors or of parameter groups (the model's and
    the pose deltas'); Adam and SGD update each element on its own, as
    optax does each leaf."""
    check_slice(cfg)
    kwargs = dict(cfg.optimizer_kwargs or {})
    lr = float(cfg.optimizer_args[0]) if cfg.optimizer_args else cfg.lr
    name = cfg.optimizer.lower()
    if name == "lbfgs":
        opts = {"memory_size": int(kwargs.pop("memory_size", 10)),
                "line_search": bool(kwargs.pop("line_search", True)),
                "max_linesearch_steps": int(kwargs.pop("max_linesearch_steps", 20))}
        make = LBFGS
    elif name == "sgd":
        make = torch.optim.SGD
        opts = {"momentum": float(kwargs.pop("momentum", None) or 0.0),
                "nesterov": bool(kwargs.pop("nesterov", False))}
    else:
        make = torch.optim.Adam
        opts = {"betas": tuple(kwargs.pop("betas", (0.9, 0.999))),
                "eps": float(kwargs.pop("eps", 1e-8))}
        extra = {"eps_root": float(kwargs.pop("eps_root", 0.0)),
                 "nesterov": bool(kwargs.pop("nesterov", False))}
        if extra["eps_root"] or extra["nesterov"]:
            make = Adam
            opts.update(extra)
    if kwargs:
        # mu_dtype (Adam) and accumulator_dtype (SGD): the port keeps every
        # optimizer state in its parameter's dtype.
        raise NotImplementedError("optimizer_kwargs %s are not ported" % sorted(kwargs))
    return make(params, lr=lr, **opts)


def _opt_step(opt, value, loss_at):
    """One optimizer step from the gradients in ``.grad``. L-BFGS's line
    search calls ``loss_at()`` at each trial point (the loss, unmasked
    gradients of the optimizer's tensors, as the JAX package's
    ``value_fn``); Adam and SGD need neither."""
    if isinstance(opt, LBFGS):
        opt.step(value=float(value.detach()), closure=loss_at)
    else:
        opt.step()


def _grads_of(value, tensors, mesh=None):
    """d value / d tensors, zeros for tensors it does not reach; under a
    mesh summed over the ranks (``value`` back-propagates the rank's
    share)."""
    grads = torch.autograd.grad(value, tensors, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(tensors, grads)]
    if mesh is not None:
        from .parallel.collectives import all_reduce_grads

        grads = all_reduce_grads(tensors, mesh, grads=grads)
    return grads


def _start_profile(device):
    """A running ``torch.profiler`` session (CPU, and CUDA on a card)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, first: int, last: int) -> str:
    """Stop ``prof`` and write its Chrome trace into ``profile_dir``, and
    beside it ``idle_by_span_it<first>-<last>.json``: the device-idle
    seconds of the same profile by the program span open on the host
    (``utils.trace.idle_by_span``)."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace_it%03d-%03d.json" % (first, last))
    prof.export_chrome_trace(path)
    with open(os.path.join(profile_dir, "idle_by_span_it%03d-%03d.json" % (first, last)),
              "w") as f:
        json.dump(trace.idle_by_span(prof.events()), f, indent=1)
    return path


def _checkpoint_dir(cfg: Config) -> Optional[str]:
    return (os.path.join(os.path.abspath(cfg.log_dir), "train_state")
            if cfg.checkpoint_period else None)


def _read_on_writer(path_of, mesh) -> Optional[bytes]:
    """The bytes of the file ``path_of()`` names (None: no file), read on
    the writer; under a mesh rank 0 reads it and broadcasts the bytes, so
    every rank sees rank 0's file whether or not the ranks share a
    ``log_dir``."""
    from .parallel.sharding import is_writer

    blob = None
    if is_writer(mesh):
        path = path_of()
        if path is not None and os.path.exists(path):
            with open(path, "rb") as f:
                blob = f.read()
    if mesh is not None:
        from .parallel.collectives import broadcast_object

        blob = broadcast_object(blob, mesh)
    return blob


def _load_checkpoint(ckpt_dir: str, device, mesh=None) -> Optional[dict]:
    """The newest ``train_state/<it>`` file, or None; under a mesh rank
    0's (:func:`_read_on_writer`)."""
    def newest():
        if not os.path.isdir(ckpt_dir):
            return None
        steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
        return os.path.join(ckpt_dir, str(steps[-1])) if steps else None

    blob = _read_on_writer(newest, mesh)
    if blob is None:
        return None
    return torch.load(io.BytesIO(blob), map_location=device, weights_only=True)


def _save_checkpoint(ckpt_dir: str, it: int, state: dict) -> None:
    """``torch.save`` into ``train_state/<it>`` through a temporary file
    (a restart that revisits an iteration overwrites it)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, str(it))
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)


def fit(cfg: Config, train_data: TrainData, callbacks: Optional[TrainCallbacks] = None,
        val_data: Optional[TrainData] = None, on_step=None, pose_deltas=None,
        best: Optional[dict] = None):
    """The optimisation loop of :func:`train`: ``cfg.n_opt_iters`` steps of
    Adam, SGD or L-BFGS on ``cfg.torch_device()`` over the model and, with
    ``cfg.pose_correction``, the pose deltas (a second parameter group;
    with ``optimize_model`` False the model's gradients are zeroed, so it
    stays as loaded; in ``pose`` mode so is the first pose's).

    Each step evaluates the training loss, and the validation loss on
    ``val_data`` at the model the step starts from, then updates the
    model (JAX package, train.py:1059-1097, 1197-1214): in ``sequence`` and
    ``pose`` modes validation takes a step of its own optimizer on the
    validation sequences' own deltas (``val_data`` prepared for gradients),
    in ``common`` mode it reuses the training delta, otherwise it is
    forward only. L-BFGS's line search evaluates the loss again at each
    trial point. ``step_ms`` covers the step and validation and ends in a
    sync. The step's weights are cloned on the device before the update,
    with no sync.

    Under a mesh (``train_data.mesh``, from ``parallel.shard_train_data``)
    the loss is :func:`parallel.make_sharded_loss_fn`'s and the gradients
    are all-reduced once a step, so every rank takes the same step; rank 0
    alone prints, checkpoints and traces, and with ``resume`` every rank
    restores rank 0's checkpoint, broadcast. With ``cfg.profile_dir`` a
    ``torch.profiler`` trace of iterations 2 to ``min(6, n_opt_iters - 1)``
    (the JAX package's window, train.py:1193-1217) is written there as
    ``trace_it002-006.json``.

    With ``cfg.checkpoint_period`` every ``checkpoint_period``-th step and
    the last save the train state with ``torch.save`` into
    ``log_dir/train_state/<it>`` (JAX package, train.py:1139-1180,
    1284-1302): the model's tensors and the pose deltas, the optimizer's
    state (L-BFGS's memory too), validation's deltas and optimizer, ``it``,
    ``best``'s minima and the history. With ``cfg.resume`` the newest is
    restored and the loop continues after it.

    :param on_step: called after each step's timing as ``on_step(it, model,
        row, state)`` with the history row and the pre-step values:
        ``state["model"]`` (:func:`models.model_state`), and with pose
        deltas ``state["pose_deltas"]`` and their masked gradients
        ``state["pose_grads"]`` (tuples of tensors); returns whether they
        were saved.
    :param pose_deltas: the training deltas to start from (leaf tensors
        that require grad, shaped as :func:`init_pose_deltas` makes them;
        updated in place); default zeros.
    :param best: the caller's best-step bookkeeping, ``{"train": loss,
        "val": loss}``, saved in checkpoints; a resume restores the two
        and sets ``best["resumed"]`` to the iteration it continues at.
    :return: (model, history) — the trained ``nn.Module`` and the rows
        (iteration, train loss, val loss, step_ms); without ``val_data``
        the val loss is the train loss.
    """
    from .parallel.sharding import is_writer

    check_slice(cfg)
    callbacks = callbacks or TrainCallbacks(cfg)
    device = cfg.torch_device()
    mode = cfg.pose_correction
    mesh = train_data.mesh
    writes = is_writer(mesh)
    model = load_model(cfg=cfg)
    if mesh is None:
        loss_fn = make_loss_fn(cfg)
    else:
        from .parallel import make_sharded_loss_fn, shard_train_data
        from .parallel.collectives import all_reduce_grads

        loss_fn = make_sharded_loss_fn(cfg, mesh)
        if val_data is not None:
            val_data = shard_train_data(val_data, mesh)
    params = [p for p in model.parameters() if p.requires_grad]
    if pose_deltas is None:
        pose_deltas = init_pose_deltas(train_data, cfg)
    groups = [g for g in (params, list(pose_deltas or ())) if g]
    opt = make_optimizer(cfg, [{"params": g} for g in groups])
    trained = [t for g in groups for t in g]
    val_deltas = val_opt = None
    if val_data is not None and mode in (PoseCorrection.sequence, PoseCorrection.pose):
        val_deltas = init_pose_deltas(val_data, cfg)
        val_opt = make_optimizer(cfg, list(val_deltas))
    best = {} if best is None else best
    history = []
    it0 = 0
    ckpt_dir = _checkpoint_dir(cfg)
    restored = _load_checkpoint(ckpt_dir, device, mesh) if ckpt_dir and cfg.resume else None
    if restored is not None:
        with torch.no_grad():
            for t, v in zip(trained, restored["tensors"]):
                t.copy_(v)
            for d, v in zip(val_deltas or (), restored["val_deltas"] or ()):
                d.copy_(v)
        opt.load_state_dict(restored["opt"])
        if val_opt is not None:
            val_opt.load_state_dict(restored["val_opt"])
        it0 = int(restored["it"]) + 1
        best["train"], best["val"] = restored["min_train_loss"], restored["min_val_loss"]
        best["resumed"] = it0
        history = [tuple(r) for r in restored["history"]]
        if writes:
            print("Resumed train state at iteration %d." % it0)

    def train_loss_at():
        value = loss_fn(model, train_data, pose_deltas)
        return value.detach(), _grads_of(value, trained, mesh)

    def val_loss_at():
        value = loss_fn(model, val_data, val_deltas)
        return value.detach(), _grads_of(value, list(val_deltas), mesh)

    prof = None
    callbacks.train_inputs(it0, train_data)
    for it in range(it0, cfg.n_opt_iters):
        if cfg.profile_dir and it == 2 and writes:
            prof = _start_profile(device)
        with trace.span("fit.step", it=it):
            callbacks.iteration_started(it)
            t0 = time.perf_counter()
            with trace.span("step.forward"):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model, train_data, pose_deltas)
            with trace.span("step.backward"):
                loss.backward()
                if mesh is not None:
                    all_reduce_grads(trained, mesh)
                if not cfg.optimize_model:
                    # The JAX package masks the model's gradients to zero
                    # (train.py:932-933): the optimizers then leave it where
                    # it is.
                    for p in params:
                        p.grad.zero_()
                _mask_delta_grads(pose_deltas, cfg)
            callbacks.train_loss(it, model, pose_deltas, loss)
            val = loss
            if val_opt is not None:
                with trace.span("step.val"):
                    val_opt.zero_grad(set_to_none=True)
                    val = loss_fn(model, val_data, val_deltas)
                    # Gradients of the validation deltas alone: the model's
                    # stay the training loss's.
                    for d, g in zip(val_deltas, _grads_of(val, list(val_deltas), mesh)):
                        d.grad = g
                    _mask_delta_grads(val_deltas, cfg)
                    _opt_step(val_opt, val, val_loss_at)
                callbacks.val_loss(it, model, None, val)
            elif val_data is not None:
                with trace.span("step.val"), torch.no_grad():
                    val = loss_fn(model, val_data,
                                  pose_deltas if mode == PoseCorrection.common else None)
                callbacks.val_loss(it, model, None, val)
            state = {"model": model_state(model)}
            if pose_deltas is not None:
                state["pose_deltas"] = tuple(d.detach().clone() for d in pose_deltas)
                state["pose_grads"] = tuple(torch.zeros_like(d) if d.grad is None
                                            else d.grad.detach().clone() for d in pose_deltas)
            with trace.span("step.optim"):
                _opt_step(opt, loss, train_loss_at)
            # The loss reads wait for the step (same stream).
            train_loss = float(trace.to_host(loss.detach()))
            val_loss = train_loss if val is loss else float(trace.to_host(val.detach()))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            row = (it, train_loss, val_loss, (time.perf_counter() - t0) * 1e3)
            history.append(row)
            if prof is not None and it >= min(6, cfg.n_opt_iters - 1):
                _stop_profile(prof, cfg.profile_dir, 2, it)
                prof = None
            with trace.span("step.after"):
                saved = bool(on_step(it, model, row, state)) if on_step is not None else False
                if writes and (cfg.log_filters or it % max(cfg.plot_period, 1) == 0):
                    print("It. %03i: train loss: %.9f, val.: %.9f.%s"
                          % (it, train_loss, val_loss, " saved" if saved else ""))
                if writes and ckpt_dir and ((it + 1) % cfg.checkpoint_period == 0
                                            or it == cfg.n_opt_iters - 1):
                    _save_checkpoint(ckpt_dir, it, {
                        "tensors": [t.detach().clone() for t in trained],
                        "opt": opt.state_dict(),
                        "val_deltas": None if val_deltas is None else [d.detach().clone()
                                                                       for d in val_deltas],
                        "val_opt": None if val_opt is None else val_opt.state_dict(),
                        "it": it,
                        "min_train_loss": float(best.get("train", np.inf)),
                        "min_val_loss": float(best.get("val", np.inf)),
                        "history": list(history),
                    })
    return model, history


def _write_summaries(writer, cfg: Config, it: int, row, model, state) -> None:
    """One step's TensorBoard scalars: the losses, the step time, each model
    weight and its gradient; with pose deltas their histograms per sequence
    and component, and their gradients' (JAX package, train.py:1241-1283)."""
    _, train_loss, val_loss, step_ms = row
    writer.add_scalar("%s/train" % cfg.loss, train_loss, it)
    writer.add_scalar("%s/val" % cfg.loss, val_loss, it)
    writer.add_scalar("time/step_ms", step_ms, it)
    for field in ("w", "exponent", "p0"):
        if field not in state["model"]:
            continue
        grad = getattr(model, field).grad
        for i, v in enumerate(state["model"][field].reshape(-1).tolist()):
            writer.add_scalar("model/%s_%d" % (field, i), v, it)
            if grad is not None:
                writer.add_scalar("model/%s_%d/grad" % (field, i),
                                  float(grad.reshape(-1)[i]), it)
    names = cfg.train_names or []
    for i, (d, g) in enumerate(zip(state.get("pose_deltas", ()), state.get("pose_grads", ()))):
        name = names[i] if i < len(names) else str(i)
        d, g = d.cpu().numpy(), g.cpu().numpy()
        for j, key in enumerate(("tx", "ty", "tz", "rx", "ry", "rz")):
            writer.add_histogram("pose_correction/train/%s/%s" % (name, key), d[:, j], it)
            writer.add_histogram("pose_correction/train/%s/%s/grad" % (name, key), g[:, j], it)


def _summary_writer(log_dir: str):
    """TensorBoard's writer where ``torch.utils.tensorboard`` imports, else
    None (JAX package, train.py:1122-1131)."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir)
    except Exception:
        return None


def train(cfg: Config, callbacks: Optional[TrainCallbacks] = None,
          train_datasets: Optional[Sequence] = None,
          val_datasets: Optional[Sequence] = None,
          train_data: Optional[TrainData] = None):
    """Train a depth-correction model; returns the best config (JAX
    package, train.py:945-1316).

    Writes ``train.yaml`` into ``cfg.log_dir``; whenever a step's train and
    val losses both improve on every earlier step's, the step's pre-update
    model as ``"%03i_%.6g_state_dict.npz" % (it, val_loss)`` (readable by
    both packages' ``load_model``), with pose correction its pre-update
    deltas as ``<tag>_pose_deltas.npz`` (``utils.checkpoint.save_pytree``,
    keys ``0``, ``1``, ...), and ``best.yaml`` (``cfg`` with
    ``model_state_dict`` and ``train_pose_deltas`` pointing at them); at
    the end ``train_history.csv`` (``iter train_loss val_loss step_ms``),
    and TensorBoard scalars (and the deltas' histograms
    ``pose_correction/train/<name>/<t|r><xyz>`` with their ``/grad``) where
    ``torch.utils.tensorboard`` imports. With ``checkpoint_period`` the
    train state is saved as :func:`fit` says; with ``resume`` the run
    continues from the newest and, when it does not beat the restored
    minima, returns ``best.yaml``'s config.

    :param train_datasets: datasets to prepare (default: ``cfg.train_names``).
    :param val_datasets: validation datasets (default: ``cfg.val_names``);
        their loss is taken at the model each step starts from, forward
        only, or, in ``sequence`` and ``pose`` modes, with a step on their
        own deltas (prepared for gradients). Without any, the val loss is
        the train loss.
    :param train_data: already prepared data (skips dataset creation and
        prep of the training sequences).
    :return: the best config, or None if no step improved.

    With ``cfg.mesh_shape`` or ``cfg.dist_coordinator`` every rank calls
    ``train`` alike (JAX package, train.py:988-1064): the mesh comes from
    ``parallel.mesh_from_config``, prep runs under it, the tables are
    split over the ranks and :func:`fit` steps them together. Rank 0
    alone writes ``train.yaml``, the state and delta files, ``best.yaml``,
    the history, the summaries and the trace; with ``resume`` every rank
    reads rank 0's checkpoint and ``best.yaml``, broadcast, so every rank
    returns the same best config whether or not the ranks share a
    ``log_dir``.
    """
    from .datasets import create_dataset
    from .parallel.sharding import is_writer

    check_slice(cfg)
    mesh = None
    if cfg.mesh_shape or cfg.dist_coordinator:
        from .parallel import mesh_from_config

        mesh = mesh_from_config(cfg)
    writes = is_writer(mesh)
    if writes:
        os.makedirs(cfg.log_dir, exist_ok=True)
        cfg.to_yaml(os.path.join(cfg.log_dir, "train.yaml"))
    if train_data is None and not train_datasets:
        names = cfg.train_names or []
        train_datasets = [create_dataset(name, cfg,
                                         poses_path=_pose_path(cfg.train_poses_path, i, names))
                          for i, name in enumerate(names)]
    if not val_datasets:
        names = cfg.val_names or []
        val_datasets = [create_dataset(name, cfg,
                                       poses_path=_pose_path(cfg.val_poses_path, i, names))
                        for i, name in enumerate(names)]
    if train_data is None:
        if not train_datasets:
            raise ValueError("No training data: set cfg.train_names or pass train_datasets.")
        train_data = prepare_sequences(train_datasets, cfg, mesh=mesh)
    # Validation takes gradients only where it trains its own deltas (JAX
    # package, train.py:1000-1008).
    val_grad = cfg.pose_correction in (PoseCorrection.sequence, PoseCorrection.pose)
    val_data = (prepare_sequences(val_datasets, cfg, for_grad=val_grad, mesh=mesh)
                if val_datasets else None)
    if mesh is not None:
        from .parallel import shard_train_data

        train_data = shard_train_data(train_data, mesh)
        val_data = shard_train_data(val_data, mesh) if val_data is not None else None

    writer = _summary_writer(cfg.log_dir) if writes else None
    best = {"cfg": None, "train": np.inf, "val": np.inf}
    # The best config names the files where rank 0 writes them, on every
    # rank alike, whether or not the ranks share a log_dir.
    files_dir = cfg.log_dir
    if mesh is not None:
        from .parallel.collectives import broadcast_object

        files_dir = broadcast_object(cfg.log_dir, mesh)

    def on_step(it, model, row, state):
        _, train_loss, val_loss, _ = row
        if writer is not None:
            _write_summaries(writer, cfg, it, row, model, state)
        if not (train_loss < best["train"] and val_loss < best["val"]):
            return False
        best["train"], best["val"] = train_loss, val_loss
        tag = "%03i_%.6g" % (it, val_loss)
        best_cfg = cfg.copy()
        # Every rank holds the same losses, so every rank's bookkeeping
        # names the same files; rank 0 writes them.
        best_cfg.model_state_dict = os.path.join(files_dir, "%s_state_dict.npz" % tag)
        if writes:
            save_state_file(best_cfg.model_state_dict, state["model"])
        if "pose_deltas" in state:
            best_cfg.train_pose_deltas = os.path.join(files_dir, "%s_pose_deltas.npz" % tag)
            if writes:
                save_pytree(best_cfg.train_pose_deltas, state["pose_deltas"])
        if writes:
            best_cfg.to_yaml(os.path.join(cfg.log_dir, "best.yaml"))
        best["cfg"] = best_cfg
        return True

    _, history = fit(cfg, train_data, callbacks, val_data, on_step, best=best)
    if best["cfg"] is None and best.get("resumed"):
        # The best step came before the interruption (JAX package,
        # train.py:1174-1180); under a mesh, rank 0's best.yaml.
        text = _read_on_writer(lambda: os.path.join(cfg.log_dir, "best.yaml"), mesh)
        if text is not None:
            best["cfg"] = cfg.copy()
            best["cfg"].from_yaml(text.decode())
    if writer is not None:
        writer.flush()
        writer.close()
    if writes:
        with open(os.path.join(cfg.log_dir, "train_history.csv"), "w") as f:
            f.write("iter train_loss val_loss step_ms\n")
            for row in history:
                f.write("%i %.9g %.9g %.6g\n" % row)
    return best["cfg"]
