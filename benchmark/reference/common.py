"""Plain building blocks of the benchmark's reference: exact radius
neighbourhoods, neighbourhood moments and eigen-features, in plain torch
on any device and dtype. Imports nothing of the program.

``precision`` is ``"float64"`` (the reference), ``"float32"``, or
``"tf32"``: float32 with the operands of every product a tensor-core
program would run as a matrix product (the rotation of points into the
world frame, the covariance's products) rounded to TF32's 10-bit mantissa
first, as ``torch.backends.cuda.matmul.allow_tf32`` would. The rounding is
done here by hand, so the control reads the same on any device.
"""
from __future__ import annotations

import torch

__all__ = ["AMBIGUOUS_REL", "dtype_of", "eig_features", "eigvalsh", "moments", "pad_size",
           "radius_pairs", "radius_pairs_flagged", "round_tf32"]

PAD_MULTIPLE = 512


def pad_size(n: int, multiple: int = PAD_MULTIPLE) -> int:
    """The padded length of a scan of ``n`` points: a multiple of 512, at
    least 512 (the layout the program's batches use, which the reference
    follows to index the global cloud as scan * N + point)."""
    return max(multiple, -(-n // multiple) * multiple)


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits; nearest,
    ties away from zero) where ``precision`` is ``"tf32"``; else ``x``. The
    gradient passes through the rounding unchanged."""
    if precision != "tf32":
        return x
    x = x.to(torch.float32)
    b = x.detach().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return x + (b.view(torch.float32) - x).detach()


def radius_pairs(points: torch.Tensor, valid: torch.Tensor, r: float, cap=None,
                 block: int = 2048):
    """Every pair (i, j) of valid points with |p_i - p_j|^2 <= r^2, i and j
    included, computed in ``points``' dtype; with ``cap`` only each row's
    ``cap`` nearest (by distance, then index). Rows are swept in blocks
    along x, each against the points within r of the block's x-range.

    :return: (rows, cols) int64, sorted by row, then by distance, then col.
    """
    dev = points.device
    idx = torch.nonzero(valid).reshape(-1)
    p = points[idx]
    order = torch.argsort(p[:, 0], stable=True)
    ps, ids = p[order], idx[order]
    xs = ps[:, 0].contiguous()
    r2 = torch.tensor(r, dtype=points.dtype, device=dev) ** 2
    rows, cols, dists = [], [], []
    for b in range(0, ps.shape[0], block):
        q = ps[b:b + block]
        lo = int(torch.searchsorted(xs, q[0, 0] - r, right=False))
        hi = int(torch.searchsorted(xs, q[-1, 0] + r, right=True))
        c = ps[lo:hi]
        d2 = ((q[:, None, 0] - c[None, :, 0]) ** 2 + (q[:, None, 1] - c[None, :, 1]) ** 2
              + (q[:, None, 2] - c[None, :, 2]) ** 2)
        qi, ci = torch.nonzero(d2 <= r2, as_tuple=True)
        rows.append(ids[b + qi])
        cols.append(ids[lo + ci])
        dists.append(d2[qi, ci])
    rows, cols, dists = torch.cat(rows), torch.cat(cols), torch.cat(dists)
    # Sort by (row, distance, col): three stable sorts, minor key first.
    o = torch.argsort(cols, stable=True)
    o = o[torch.argsort(dists[o], stable=True)]
    o = o[torch.argsort(rows[o], stable=True)]
    rows, cols = rows[o], cols[o]
    if cap is not None:
        rows, cols = _cap(rows, cols, int(cap))
    return rows, cols


# Pairs whose squared distance lies within this share of r^2 are decided by
# the rounding of a float32 program: its points carry errors of a few
# micrometres at 25 m, which move d^2 by up to ~3e-5 of r^2 at r = 0.25.
AMBIGUOUS_REL = 1e-4


def radius_pairs_flagged(points: torch.Tensor, valid: torch.Tensor, r: float):
    """:func:`radius_pairs` (uncapped), and a flag on each point with a pair
    (itself aside) whose d^2 lies within ``AMBIGUOUS_REL`` of r^2, inside or
    outside: that point's neighbourhood is decided by rounding."""
    rows, cols = radius_pairs(points, valid, r * (1.0 + AMBIGUOUS_REL) ** 0.5)
    d2 = ((points[rows] - points[cols]) ** 2).sum(1)
    r2 = r * r
    inside = d2 <= r2
    near = (d2 >= r2 * (1.0 - AMBIGUOUS_REL)) & (rows != cols)
    flag = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    flag[rows[near]] = True
    return rows[inside], cols[inside], flag


def _rank_in_row(rows: torch.Tensor) -> torch.Tensor:
    """Each pair's position within its row's run (rows sorted)."""
    n = rows.shape[0]
    start = torch.ones(n, dtype=torch.bool, device=rows.device)
    start[1:] = rows[1:] != rows[:-1]
    pos = torch.arange(n, device=rows.device)
    first = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)), 0).values
    return pos - first


def _cap(rows, cols, cap: int):
    keep = _rank_in_row(rows) < cap
    return rows[keep], cols[keep]


def mutual(rows: torch.Tensor, cols: torch.Tensor, n: int):
    """The pairs (i, j) whose reverse (j, i) is a pair too, in their order."""
    key = rows * n + cols
    rkey = torch.sort(cols * n + rows).values
    pos = torch.searchsorted(rkey, key).clamp(max=rkey.numel() - 1)
    keep = rkey[pos] == key
    return rows[keep], cols[keep]


def moments(points: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
            precision: str = "float64"):
    """Each row's neighbour count, mean and Bessel-corrected covariance
    (the normaliser clamped at 1e-6) over the pairs (rows, cols), with the
    covariance's products of centred coordinates rounded as ``precision``
    says: (count (n_rows,), mean (n_rows, 3), cov (n_rows, 3, 3))."""
    dt = points.dtype
    cnt = torch.zeros(n_rows, dtype=dt, device=points.device).index_add(
        0, rows, torch.ones_like(rows, dtype=dt))
    x = points[cols]
    mean = torch.zeros(n_rows, 3, dtype=dt, device=points.device).index_add(0, rows, x)
    mean = mean / cnt.clamp(min=1e-12)[:, None]
    c = round_tf32(x - mean[rows], precision).to(dt)
    a, b = (0, 1, 2, 0, 0, 1), (0, 1, 2, 1, 2, 2)
    prod = c[:, a] * c[:, b]
    s = torch.zeros(n_rows, 6, dtype=dt, device=points.device).index_add(0, rows, prod)
    s = s / (cnt - 1.0).clamp(min=1e-6)[:, None]
    cov = torch.stack([s[:, [0, 3, 4]], s[:, [3, 1, 5]], s[:, [4, 5, 2]]], 1)
    return cnt, mean, cov


def eig_features(cov: torch.Tensor, dirs=None):
    """Ascending eigenvalues of each 3 x 3 covariance and, with view
    directions, the normal (the smallest eigenvalue's eigenvector, turned
    against the view direction) and the incidence angle arccos |d . n|."""
    if dirs is None:
        return eigvalsh(cov), None, None
    lam, vec = (x.to(cov.device) for x in torch.linalg.eigh(cov.cpu()))
    n = vec[..., :, 0]
    cos = (dirs * n).sum(-1)
    normals = -torch.sign(cos)[:, None] * n
    return lam, normals, torch.arccos(cos.abs().clamp(0.0, 1.0))


def eigvalsh(cov: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of each 3 x 3 matrix. The eigen-solves run on
    the host's LAPACK: cuSOLVER's batched solver refuses these batches on
    the card (CUSOLVER_STATUS_INVALID_VALUE)."""
    return torch.linalg.eigvalsh(cov.cpu()).to(cov.device)


def ratio_mask(lam: torch.Tensor, bounds) -> torch.Tensor:
    """Rows whose eigenvalue ratios lam_i / max(lam_j, 1e-30) lie in
    [lo, hi] for every [i, j, lo, hi] of ``bounds``."""
    keep = torch.ones(lam.shape[0], dtype=torch.bool, device=lam.device)
    for i, j, lo, hi in bounds or []:
        ratio = lam[:, int(i)] / lam[:, int(j)].clamp(min=1e-30)
        keep &= (ratio >= lo) & (ratio <= hi)
    return keep
