"""A host model of K1's and K2's warp cull (csrc/cellwin_fwd.cuh), for
measurement and tests; no path of the package calls it.

Each warp of WARP tile slots keeps the window entries whose float32
distance to the box of its real slots, in the pair test's own operation
sequence, is at most r2. :func:`cull_pair_tests` counts the work that
leaves the kernels: it is computed here from the graph, not read from the
kernels, which count nothing.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["POINT_PAD", "ROW_PAD", "WARP", "cull_pair_tests", "cull_windows", "d2_form_f32"]

# The kernels' warp width (kWarp).
WARP = 32
# The builder's padding sentinels (est x of padding rows / points; the
# kernels' kRowPad, kPointPad).
ROW_PAD = np.float32(-1e15)
POINT_PAD = np.float32(1e15)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fma_f32(a, b, c):
    """float32 fma(a, b, c), rounded once: the product of two float32 is
    exact in float64, the float64 sum is made round-to-odd from its exact
    error (TwoSum), and round-to-odd at 53 bits then to 24 rounds as one
    rounding of the exact value would."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def d2_form_f32(dx, dy, dz):
    """The kernels' membership distance fma(dz, dz, fma(dx, dx, dy * dy)) in
    float32 (numpy float32 arrays)."""
    return _fma_f32(dz, dz, _fma_f32(dx, dx, dy * dy))


def cull_windows(tile_vals, pad, win_vals, starts, lens, ctr, r2: float, step: int = 64):
    """The warp cull of a kernel's launch, per chunk of ``step`` tiles.

    :param tile_vals: (>=3, T * cap) est of the tile slots (K1: q_est; K2:
        est_sorted), padding at ``pad`` (:data:`ROW_PAD` / :data:`POINT_PAD`).
    :param win_vals: (>=3, .) est of the window table (K1: est_sorted; K2:
        q_est).
    :param starts, lens: (T, ns) span tables; ctr: (T, 3) tile centres.
    :yield: (v (3, c, cap) tile-centred slots, real (c, cap), e (3, c, W)
        tile-centred window entries, in_span (c, W), kept (c, n_warps, W)),
        all numpy, for each chunk of c tiles in order; a warp without a
        real slot keeps nothing.
    """
    tile_vals = _host(tile_vals)[:3].astype(np.float32)
    win_vals = _host(win_vals)[:3].astype(np.float32)
    ctr = _host(ctr).astype(np.float32)
    starts = _host(starts).astype(np.int64)
    lens = np.maximum(_host(lens).astype(np.int64), 0)
    t_dim = starts.shape[0]
    cap = tile_vals.shape[1] // t_dim
    n_warps = -(-cap // WARP)
    r2 = np.float32(r2)
    width = max(int(lens.max(initial=0)), 1)
    ar = np.arange(width)
    for a in range(0, t_dim, step):
        b = min(t_dim, a + step)
        c = ctr[a:b].T[:, :, None]  # (3, c, 1)
        v = tile_vals[:, a * cap:b * cap].reshape(3, b - a, cap) - c
        real = tile_vals[0, a * cap:b * cap].reshape(b - a, cap) != pad
        sel = ar < lens[a:b, :, None]  # (c, ns, width)
        idx = np.where(sel, starts[a:b, :, None] + ar, 0).reshape(b - a, -1)
        sel = sel.reshape(b - a, -1)
        e = win_vals[:, idx] - c  # (3, c, W)
        kept = np.zeros((b - a, n_warps, idx.shape[1]), bool)
        for w in range(n_warps):
            rw = real[:, w * WARP:(w + 1) * WARP]
            vw = v[:, :, w * WARP:(w + 1) * WARP]
            lo = np.where(rw, vw, np.float32(np.inf)).min(-1)[..., None]  # (3, c, 1)
            hi = np.where(rw, vw, np.float32(-np.inf)).max(-1)[..., None]
            with np.errstate(invalid="ignore", over="ignore"):  # inf gaps: no real slot
                gap = np.maximum(np.maximum(lo - e, np.float32(0)), e - hi)
                kept[:, w] = (d2_form_f32(gap[0], gap[1], gap[2]) <= r2) & sel
        yield v, real, e, sel, kept


def cull_pair_tests(tile_vals, pad, win_vals, starts, lens, ctr, r2: float) -> tuple:
    """(pair tests the kernel's warps make after the cull, all pair tests,
    box tests): a warp tests each entry it keeps against each of its slots;
    without the cull every slot of a tile tests every entry of its spans; a
    warp with a real slot makes one box test per entry of its tile's spans."""
    t_dim = starts.shape[0]
    cap = tile_vals.shape[1] // t_dim
    n_warps = -(-cap // WARP)
    lanes = np.minimum(WARP, cap - WARP * np.arange(n_warps))
    kept_tests = box_tests = 0
    for _, real, _, sel, kept in cull_windows(tile_vals, pad, win_vals, starts, lens, ctr, r2):
        kept_tests += int((kept.sum(-1) * lanes).sum())
        real_warps = np.stack([real[:, w * WARP:(w + 1) * WARP].any(-1)
                               for w in range(n_warps)], -1)  # (c, n_warps)
        box_tests += int((real_warps.sum(-1) * sel.sum(-1)).sum())
    return kept_tests, int(np.maximum(_host(lens), 0).sum()) * cap, box_tests
