"""Map-consistency losses (counterpart of ``depth_correction_tpu/loss.py``).

Reference: src/depth_correction/loss.py:216-565. The pointwise loss of a
feature-annotated cloud is computed with static shapes; mask selection,
inlier-quantile trimming and finite filtering are mask composition. Losses
return ``(scalar, cloud_with_pointwise_loss)`` like the reference.

The ICP losses (JAX package, loss.py:262-470) take symmetric point-to-plane
or point-to-point distances over consecutive scan pairs. Training freezes
the pairs' correspondences once in prep (:func:`icp_pair_correspondences`,
scipy's cKDTree on the host); evaluation finds them per call by the 1-NN
search of ``ops/knn.py`` (kernel X3 on CUDA tensors).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .ops.reduce import masked_mean, masked_quantile, masked_sum, reduce_loss

__all__ = [
    "batch_loss",
    "batch_sums",
    "create_loss",
    "icp_loss",
    "icp_pair_correspondences",
    "icp_pair_loss_batched",
    "loss_by_name",
    "min_eigval_loss",
    "point_to_plane_dist",
    "point_to_point_dist",
    "pointwise_loss",
    "trace_loss",
]


def _base_mask(cloud, mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Combine padding validity with the caller's mask."""
    if mask is None:
        return cloud.valid
    return mask & cloud.valid


def _inlier_trim(loss, mask, inlier_max_loss, inlier_ratio: float,
                 inlier_loss_mult: float, quantile=masked_quantile):
    """Quantile-based inlier masking (reference: loss.py:256-273)."""
    if inlier_ratio < 1.0:
        thr = quantile(loss, mask, inlier_ratio)
        if inlier_loss_mult != 1.0:
            thr = inlier_loss_mult * thr
        if inlier_max_loss is None:
            inlier_max_loss = thr
        else:
            inlier_max_loss = torch.minimum(
                torch.as_tensor(inlier_max_loss, dtype=loss.dtype,
                                device=loss.device), thr)
    if inlier_max_loss is not None:
        keep = loss <= inlier_max_loss
        mask = keep if mask is None else (mask & keep)
    return mask


def _consistency_loss(pointwise, cloud, mask, offset, sqrt: bool,
                      reduction: str, inlier_max_loss, inlier_ratio: float,
                      inlier_loss_mult: float, only_finite: bool,
                      skip_nans: bool, quantile=masked_quantile):
    mask = _base_mask(cloud, mask)
    mask = _inlier_trim(pointwise, mask, inlier_max_loss, inlier_ratio,
                        inlier_loss_mult, quantile)
    # Offset by a per-point baseline loss, then clamp to positive
    # (reference: loss.py:279-284).
    if offset is not None:
        if hasattr(offset, "loss"):
            offset = offset.loss
        pointwise = pointwise - offset
    pointwise = torch.relu(pointwise)
    if sqrt:
        pointwise = torch.sqrt(pointwise)
    value, eff = reduce_loss(pointwise, mask, reduction=reduction,
                             only_finite=only_finite, skip_nans=skip_nans)
    out_cloud = cloud.replace(loss=pointwise,
                              mask=eff if eff is not None else cloud.mask)
    return value, out_cloud


def pointwise_loss(cloud, trace: bool, normalization: bool = False):
    """The pointwise loss before trim and offset: the covariance trace
    (``trace_loss``; the ``trace`` field where the input has one, else the
    trace of ``cov``, as :class:`segmentation.Planes` has; JAX package,
    loss.py:183-188) or the smallest eigenvalue (``min_eigval_loss``),
    with ``normalization`` over clamp(sum lam, 1e-6)."""
    if trace:
        tr = getattr(cloud, "trace", None)
        if tr is not None:
            return tr
        cov = cloud.cov
        return cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]
    pointwise = cloud.eigvals[..., 0]
    if normalization:
        pointwise = pointwise / torch.clamp(cloud.eigvals.sum(-1), min=1e-6)
    return pointwise


def min_eigval_loss(cloud, mask=None, offset=None, sqrt: bool = False,
                    normalization: bool = False, reduction: str = "mean",
                    inlier_max_loss=None, inlier_ratio: float = 1.0,
                    inlier_loss_mult: float = 1.0, only_finite: bool = False,
                    skip_nans: bool = False, inlier_quantile=masked_quantile, **_unused):
    """Smallest-eigenvalue map-consistency loss (reference: loss.py:216-294):
    pointwise lam_1, optionally over clamp(sum lam, 1e-6), inlier-trimmed,
    offset, relu'd, sqrt'd, then mask-mean reduced. ``cloud`` is a feature
    cloud, feature rows or :class:`segmentation.Planes` (a value a plane).
    ``inlier_quantile(loss, mask, q)`` takes the trim's quantile (a
    sharded loss passes one over every rank's rows)."""
    if isinstance(cloud, (list, tuple)):
        return batch_loss(
            min_eigval_loss, cloud, masks=mask, offsets=offset,
            reduction=reduction, only_finite=only_finite, skip_nans=skip_nans,
            sqrt=sqrt, normalization=normalization,
            inlier_max_loss=inlier_max_loss, inlier_ratio=inlier_ratio,
            inlier_loss_mult=inlier_loss_mult, inlier_quantile=inlier_quantile,
        )
    return _consistency_loss(pointwise_loss(cloud, False, normalization), cloud, mask, offset,
                             sqrt, reduction, inlier_max_loss, inlier_ratio, inlier_loss_mult,
                             only_finite, skip_nans, inlier_quantile)


def trace_loss(cloud, mask=None, offset=None, sqrt: bool = False,
               reduction: str = "mean", inlier_max_loss=None,
               inlier_ratio: float = 1.0, inlier_loss_mult: float = 1.0,
               only_finite: bool = False, skip_nans: bool = False,
               inlier_quantile=masked_quantile, **_unused):
    """Covariance-trace map-consistency loss (reference: loss.py:297-370)
    over :func:`pointwise_loss`'s trace."""
    if isinstance(cloud, (list, tuple)):
        return batch_loss(
            trace_loss, cloud, masks=mask, offsets=offset,
            reduction=reduction, only_finite=only_finite, skip_nans=skip_nans,
            sqrt=sqrt, inlier_max_loss=inlier_max_loss,
            inlier_ratio=inlier_ratio, inlier_loss_mult=inlier_loss_mult,
            inlier_quantile=inlier_quantile,
        )
    return _consistency_loss(pointwise_loss(cloud, True), cloud, mask, offset, sqrt, reduction,
                             inlier_max_loss, inlier_ratio, inlier_loss_mult,
                             only_finite, skip_nans, inlier_quantile)


def batch_sums(loss_fun, clouds: Sequence, masks=None, offsets=None,
               only_finite: bool = False, skip_nans: bool = False, **kwargs):
    """(sum, count, loss clouds) of the pooled pointwise losses of several
    clouds: :func:`batch_loss` before its reduction (a sharded loss
    all-reduces the pair)."""
    if masks is None:
        masks = [None] * len(clouds)
    if offsets is None:
        offsets = [None] * len(clouds)
    total = 0.0
    count = 0
    loss_clouds = []
    for cloud, mask, offset in zip(clouds, masks, offsets):
        pointwise, lc = loss_fun(cloud, mask=mask, offset=offset,
                                 reduction="none", only_finite=only_finite,
                                 skip_nans=skip_nans, **kwargs)
        # reduce_loss(reduction="none") folded only_finite / skip_nans
        # into the effective mask it returned on lc.mask.
        eff = lc.mask
        total = total + masked_sum(pointwise, eff)
        count = count + (eff.sum() if eff is not None else pointwise.numel())
        loss_clouds.append(lc)
    return total, count, loss_clouds


def batch_loss(loss_fun, clouds: Sequence, masks=None, offsets=None,
               reduction: str = "mean", only_finite: bool = False,
               skip_nans: bool = False, **kwargs):
    """Joint loss of several clouds (one per sequence): pointwise losses
    are pooled and reduced once, so every point weighs equally across
    sequences (reference: loss.py:181-213)."""
    total, count, loss_clouds = batch_sums(loss_fun, clouds, masks, offsets, only_finite,
                                           skip_nans, **kwargs)
    if reduction == "mean":
        value = total / torch.clamp(torch.as_tensor(count), min=1)
    elif reduction == "sum":
        value = total
    else:
        raise ValueError("batch_loss requires mean/sum reduction")
    return value, loss_clouds


def _pair_correspondence(points1, valid1, points2, valid2, icp_inlier_ratio: float):
    """1-NN correspondences 1 -> 2 with quantile inlier gating (JAX
    package, loss.py:260-274; reference: loss.py:439-452): (indices into
    cloud 2, bool weights), false on outliers and padding. The search is
    :func:`ops.knn.nearest_neighbors` at k = 1 with no radius (kernel X3 on
    CUDA tensors)."""
    from .ops.knn import nearest_neighbors

    dists, idx = nearest_neighbors(points2, points1, k=1, valid_points=valid2)
    dists, idx = dists[:, 0], idx[:, 0]
    ok = valid1 & (idx >= 0)
    thr = masked_quantile(dists, ok, icp_inlier_ratio)
    return idx, (dists <= thr) & ok


def _pair_masks(c1, c2, masks, i: int, icp_inlier_ratio: float):
    """Pair ``i``'s (idx2, weights): the given ones, or 1-NN
    correspondences of the points without their gradient."""
    if masks is not None:
        return masks[i]
    return _pair_correspondence(c1.get_points().detach(), c1.valid,
                                c2.get_points().detach(), c2.valid, icp_inlier_ratio)


def point_to_plane_dist(clouds: Sequence, icp_inlier_ratio: float = 0.5, masks=None,
                        **_unused):
    """Symmetric point-to-plane distance over consecutive scan pairs
    (reference: loss.py:406-488; JAX package, loss.py:277-320): the matched
    point's distance along each cloud's normal, its mean over the pair's
    inliers, averaged both ways and over the pairs. Gradients flow through
    the gathered coordinates, not the correspondences.

    :param masks: optional per-pair (idx2, weights) tuples.
    """
    n_pairs = len(clouds) - 1
    total = 0.0
    for i in range(n_pairs):
        c1, c2 = clouds[i], clouds[i + 1]
        assert c1.normals is not None, "point-to-plane needs normals"
        p1, p2 = c1.get_points(), c2.get_points()
        idx2, w = _pair_masks(c1, c2, masks, i, icp_inlier_ratio)
        rows = idx2.clamp(min=0).long()
        q2, n2_of_2 = p2[rows], c2.normals[rows]
        d12 = masked_mean((c1.normals * (q2 - p1)).sum(-1).abs(), w)
        d21 = masked_mean((n2_of_2 * (p1 - q2)).sum(-1).abs(), w)
        total = total + 0.5 * (d12 + d21)
    return total / max(n_pairs, 1)


def point_to_point_dist(clouds: Sequence, icp_inlier_ratio: float = 0.5, masks=None,
                        **_unused):
    """Symmetric point-to-point distance over consecutive scan pairs
    (reference: loss.py:491-565; JAX package, loss.py:323-349)."""
    n_pairs = len(clouds) - 1
    total = 0.0
    for i in range(n_pairs):
        c1, c2 = clouds[i], clouds[i + 1]
        p1, p2 = c1.get_points(), c2.get_points()
        idx2, w = _pair_masks(c1, c2, masks, i, icp_inlier_ratio)
        q2 = p2[idx2.clamp(min=0).long()]
        total = total + masked_mean(torch.linalg.norm(q2 - p1, dim=-1), w)
    return total / max(n_pairs, 1)


def icp_pair_correspondences(points, valid, icp_inlier_ratio: float = 0.5):
    """Frozen 1-NN correspondences between consecutive scans of a sequence
    (JAX package, loss.py:352-390; reference: train.py:179-210): for each
    pair (i, i+1), scipy's cKDTree 1-NN of scan i's points among scan
    i+1's valid points on the host, gated by the ``icp_inlier_ratio``
    quantile of the distances over scan i's valid points.

    :param points: (S, N, 3) numpy posed points.
    :param valid: (S, N) bool, False on padding.
    :return: (idx (S-1, N) int32 rows of scan i+1, w (S-1, N) bool); a
        pair with an empty scan has no inliers.
    """
    from scipy.spatial import cKDTree

    points, valid = np.asarray(points), np.asarray(valid)
    s, n = valid.shape
    idx = np.zeros((s - 1, n), np.int32)
    w = np.zeros((s - 1, n), bool)
    for i in range(s - 1):
        v1, v2 = valid[i], valid[i + 1]
        rows2 = np.flatnonzero(v2)
        if len(rows2) == 0 or not v1.any():
            continue
        d, ind = cKDTree(points[i + 1][rows2]).query(points[i], k=1, workers=-1)
        ind = np.minimum(ind, len(rows2) - 1)
        thr = np.quantile(d[v1], icp_inlier_ratio)
        idx[i] = rows2[ind]
        w[i] = (d <= thr) & v1
    return idx, w


def icp_pair_loss_batched(points: torch.Tensor, normals: Optional[torch.Tensor],
                          idx: torch.Tensor, w: torch.Tensor,
                          point_to_plane: bool = True) -> torch.Tensor:
    """Symmetric ICP distance over all consecutive scan pairs at once, over
    frozen correspondences (JAX package, loss.py:393-436).

    :param points: (S, N, 3) corrected, posed points.
    :param normals: (S, N, 3) posed normals (None for point-to-point).
    :param idx: (S-1, N) correspondence rows of scan i+1.
    :param w: (S-1, N) inlier weights (0 on outliers and padding).
    :return: the mean over pairs.
    """
    p1, p2 = points[:-1], points[1:]
    gi = idx.clamp(min=0).long()[..., None].expand(-1, -1, 3)
    q2 = torch.gather(p2, 1, gi)
    wf = w.to(points.dtype)
    w_sum = torch.clamp(wf.sum(-1), min=1.0)
    if point_to_plane:
        assert normals is not None, "point-to-plane needs normals"
        n1 = normals[:-1]
        n2 = torch.gather(normals[1:], 1, gi)
        d12 = ((n1 * (q2 - p1)).sum(-1).abs() * wf).sum(-1) / w_sum
        d21 = ((n2 * (p1 - q2)).sum(-1).abs() * wf).sum(-1) / w_sum
        pair = 0.5 * (d12 + d21)
    else:
        pair = (torch.linalg.norm(q2 - p1, dim=-1) * wf).sum(-1) / w_sum
    return pair.mean()


def icp_loss(clouds, poses=None, model=None, masks=None, icp_point_to_plane: bool = True,
             icp_inlier_ratio: float = 0.5, **_unused):
    """ICP loss over sequences of scans (reference: loss.py:373-403; JAX
    package, loss.py:439-470).

    :param clouds: a list (sequences) of lists (scans) of Clouds.
    :param poses: a list of (S, 4, 4) pose tensors, one a sequence.
    :return: (the mean over sequences, the posed clouds).
    """
    loss_fun = point_to_plane_dist if icp_point_to_plane else point_to_point_dist
    total = 0.0
    loss_clouds = []
    for i, seq in enumerate(clouds):
        seq_clouds = list(seq)
        if model is not None:
            seq_clouds = [model(c) for c in seq_clouds]
        if poses is not None:
            seq_clouds = [c.transform(poses[i][j]).with_points()
                          for j, c in enumerate(seq_clouds)]
        else:
            seq_clouds = [c.with_points() for c in seq_clouds]
        total = total + loss_fun(seq_clouds, icp_inlier_ratio=icp_inlier_ratio,
                                 masks=None if masks is None else masks[i])
        loss_clouds.append(seq_clouds)
    return total / max(len(clouds), 1), loss_clouds


def loss_by_name(name: str):
    losses = {"min_eigval_loss": min_eigval_loss, "trace_loss": trace_loss,
              "icp_loss": icp_loss}
    if name not in losses:
        raise ValueError("Unknown loss: %s" % name)
    return losses[name]


def create_loss(cfg):
    """Bind config loss kwargs (reference: loss.py:573-579)."""
    loss = loss_by_name(cfg.loss)
    kwargs = dict(cfg.loss_kwargs or {})

    def loss_fun(*args, **kw):
        merged = dict(kwargs)
        merged.update(kw)
        return loss(*args, **merged)

    return loss_fun
