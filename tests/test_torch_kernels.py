"""The port's CUDA kernels against their plain torch versions.

The ``cuda`` cases need a CUDA card and skip without one. This file imports
no JAX, so on a machine with a card and PyTorch alone they run as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest``: the suite's conftest pins JAX to the CPU).
"""
import dataclasses
import inspect
import math
import os
import re

import numpy as np
import pytest
import torch

from depth_correction_tpu_torch.ops import _kernels
from depth_correction_tpu_torch.ops import cellwin as tcw
from depth_correction_tpu_torch.ops import features as tfeat
from depth_correction_tpu_torch.ops import slabwin as tslab
from depth_correction_tpu_torch.ops.features import _cotangent_table, permute_rows
from depth_correction_tpu_torch.ops.grid_hash import grid_sort_colpad_traced
from depth_correction_tpu_torch import scripts
from depth_correction_tpu_torch.scripts import cellwin_cull as cull

# Bars of the float32 kernels against the float64 plain versions (the
# bars chip_smoke.py holds them to at the slice's shapes).
MEAN_ABS_BAR = 1e-5  # m
COMPS_ABS_BAR = 1e-6  # m^2
GRAD_REL_BAR = 1e-4  # relative to max |grad|


def uncapped_graph(pts, r):
    """(N, K) within-r neighbor matrix via scipy (includes self)."""
    from scipy.spatial import cKDTree

    lists = cKDTree(pts).query_ball_point(pts, r)
    nn = np.full((len(pts), max(len(l) for l in lists)), -1, np.int64)
    for i, l in enumerate(lists):
        nn[i, : len(l)] = sorted(l)
    return nn


def scene(n, r, seed, plane_frac=0.5):
    """Half a noisy plane, half a volume; a random 70% of rows queried.

    :return: (points (n, 3), query rows, their (Mq, K) neighbors).
    """
    rng = np.random.default_rng(seed)
    n1 = int(n * plane_frac)
    p1 = np.c_[rng.uniform(-3, 3, (n1, 2)), 0.02 * rng.standard_normal(n1)]
    p2 = rng.uniform(-3, 3, (n - n1, 3))
    pts = np.vstack([p1, p2])
    nn = uncapped_graph(pts, r)
    qrows = np.flatnonzero(rng.uniform(size=len(pts)) < 0.7)
    return pts, qrows, nn[qrows]


def _slice_graph(n, r, seed, cap):
    """A graph whose rows are those the slice's prep keeps (>= 5
    neighbors: fewer give the max(s0 - 1, 1e-6) normalizer, whose
    cotangents the loss never produces)."""
    pts, qrows, nn = scene(n, r, seed)
    keep = (nn >= 0).sum(1) >= 5
    g = tcw.build_cellwin_graph(pts, np.ones(len(pts), bool), qrows[keep], nn[keep], r,
                                row_cap=cap, pt_cap=cap, span_limit=512)
    assert g is not None
    return pts, g


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """A non-CPU tensor goes to the kernel launcher (which validates and
    raises), never silently to the plain version."""
    pts, g = _slice_graph(1500, 0.35, 1, 64)
    dev = tcw.graph_to_device(g)
    ps = permute_rows(torch.as_tensor(pts, dtype=torch.float32), dev.perm, dev.inv)
    calls = []

    def fake_launch(*args):
        calls.append(args)
        raise RuntimeError("launched")

    for name in ("launch_cellwin_fwd", "launch_cellwin_bwd"):
        monkeypatch.setattr(_kernels, name, fake_launch)
    before = (tcw.FWD_LAUNCHES, tcw.BWD_LAUNCHES)
    table = torch.zeros(9, dev.q_est.shape[1])
    for fn, args in ((tcw.cellwin_fwd, (dev.f_start, dev.f_len, dev.f_ctr)),
                     (tcw.cellwin_bwd, (table, dev.b_start, dev.b_len, dev.b_ctr))):
        with pytest.raises(RuntimeError, match="launched"):
            fn(ps.to("meta"), dev.q_est, dev.est_sorted, *args, dev.r2)
    assert len(calls) == 2
    assert (tcw.FWD_LAUNCHES, tcw.BWD_LAUNCHES) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run this file with -m cuda on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,seed,cap", [(6000, 0.35, 0, 128), (3000, 0.4, 2, 64)])
def test_cuda_kernels_match_plain(cuda_device, n, r, seed, cap):
    pts, g = _slice_graph(n, r, seed, cap)
    dev = tcw.graph_to_device(g, cuda_device)
    ps = torch.as_tensor(pts, dtype=torch.float32, device=cuda_device)[dev.perm].contiguous()
    args = (dev.q_est, dev.est_sorted, dev.f_start, dev.f_len, dev.f_ctr, dev.r2)
    before = tcw.FWD_LAUNCHES
    raw = tcw.cellwin_fwd(ps, *args)
    assert tcw.FWD_LAUNCHES == before + 1
    ref = tcw.cellwin_fwd_plain(ps.double(), *args)
    rows = dev.row_map >= 0
    rows[dev.exc_slots] = False  # exception rows are recomputed by gather
    d = (raw.double() - ref)[:, rows].abs()
    assert float(d[0:3].max()) <= MEAN_ABS_BAR and float(d[3:9].max()) <= COMPS_ABS_BAR
    gen = torch.Generator().manual_seed(seed)
    gr = torch.randn((9, raw.shape[1]), generator=gen, dtype=torch.float64).to(cuda_device)
    gr = torch.where(rows[None], gr, torch.zeros_like(gr))
    table = _cotangent_table(ref[0:3], ref[9], (gr[0:3], tuple(gr[3:9]))).float().contiguous()
    bargs = (dev.b_start, dev.b_len, dev.b_ctr, dev.r2)
    before = tcw.BWD_LAUNCHES
    grad = tcw.cellwin_bwd(ps, dev.q_est, dev.est_sorted, table, *bargs)
    assert tcw.BWD_LAUNCHES == before + 1
    gref = tcw.cellwin_bwd_plain(ps.double(), dev.q_est, dev.est_sorted, table.double(), *bargs)
    assert float((grad.double() - gref).abs().max()) <= GRAD_REL_BAR * float(gref.abs().max())


# ---------------------------------------------------------------------------
# Hand-built kernel inputs that probe the warps' box cull (csrc/cellwin_fwd.cuh).

LATTICE_R = 0.25  # the lattice spacing and the radius: axis neighbours at d2 == r2
BUFFER = 256  # at least the kept entries a warp buffers (kFwdBuf, kBwdBuf)
# Spans (start, length) into the 584-entry window table, the same for every
# tile: longer than a warp's buffer, empty, ordinary, ending in the table's
# padding, and empty at the table's start.
SPANS = ((0, 300), (300, 0), (350, 100), (0, 0), (560, 24), (450, 110))


def window_case(side: str, cap: int, counts, seed: int = 0) -> dict:
    """K1 ("fwd") or K2 ("bwd") inputs on a dyadic lattice of spacing r.

    The window table is the 12 x 12 x 4 lattice (576 entries) and 8 padding
    entries; tile t has ``counts[t]`` real slots on lattice sites, the rest
    padding. Every difference is exact in float32, so every slot's axis
    neighbours sit at d2 == r2 exactly, in any order of operations.
    :return: the wrapper's arguments by name, plus ``real`` (tiles, cap).
    """
    rng = np.random.default_rng(seed)
    ax = np.arange(12) * LATTICE_R
    lattice = np.stack(np.meshgrid(ax, ax, ax[:4], indexing="ij"), -1).reshape(-1, 3)
    n_win, t_dim = len(lattice) + 8, len(counts)
    win_pad, slot_pad = ((cull.POINT_PAD, cull.ROW_PAD) if side == "fwd" else
                         (cull.ROW_PAD, cull.POINT_PAD))
    win = np.zeros((8, n_win), np.float32)
    win[:3] = win_pad
    win[:3, :len(lattice)] = lattice.T
    slots = np.zeros((8, t_dim * cap), np.float32)
    slots[:3] = slot_pad
    real = np.zeros((t_dim, cap), bool)
    for t, c in enumerate(counts):
        real[t, :c] = True
        slots[:3, t * cap:t * cap + c] = lattice[rng.choice(len(lattice), c, replace=False)].T
    starts = np.array([[a for a, _ in SPANS]] * t_dim, np.int32)
    lens = np.array([[n for _, n in SPANS]] * t_dim, np.int32)
    ctr = np.tile(np.float32([1.5, 1.5, 0.5]), (t_dim, 1))
    # Current positions: the lattice sites moved by a few millimetres.
    n_pts = n_win if side == "fwd" else t_dim * cap
    est_pts = win if side == "fwd" else slots
    pts = (np.where(est_pts[:3].T < 1e14, est_pts[:3].T, 0.0)
           + 0.005 * rng.standard_normal((n_pts, 3))).astype(np.float32)
    t = torch.as_tensor
    case = {"pts_sorted": t(pts), "r2": LATTICE_R ** 2, "real": real}
    if side == "fwd":
        case.update(q_est=t(slots), est_sorted=t(win), f_start=t(starts), f_len=t(lens),
                    f_ctr=t(ctr))
    else:
        case.update(q_est=t(win), est_sorted=t(slots),
                    table9=t(rng.standard_normal((9, n_win)).astype(np.float32)),
                    b_start=t(starts), b_len=t(lens), b_ctr=t(ctr))
    return case


def _cull_args(side: str, case: dict) -> tuple:
    """``scripts.cellwin_cull.cull_windows``' arguments for a case's kernel."""
    if side == "fwd":
        return (case["q_est"], cull.ROW_PAD, case["est_sorted"], case["f_start"], case["f_len"],
                case["f_ctr"], case["r2"])
    return (case["est_sorted"], cull.POINT_PAD, case["q_est"], case["b_start"], case["b_len"],
            case["b_ctr"], case["r2"])


WINDOW_CASES = [("fwd", 128, (1, 31, 33, 127)), ("bwd", 128, (1, 31, 33, 127)),
                ("fwd", 40, (1, 33, 40)), ("bwd", 40, (1, 33, 40))]


def _members_and_kept(args):
    """Per chunk of tiles: (member (c, cap, W): real slot and in-span entry
    within r in the kernels' float32 form, kept (c, cap, W): the entry kept
    by the slot's warp)."""
    r2 = np.float32(args[-1])
    for v, real, e, sel, kept in cull.cull_windows(*args):
        d = [e[k][:, None, :] - v[k][:, :, None] for k in range(3)]  # entry - slot, (c, cap, W)
        member = (cull.d2_form_f32(*d) <= r2) & sel[:, None, :] & real[:, :, None]
        cap = v.shape[2]
        yield member, np.repeat(kept, cull.WARP, axis=1)[:, :cap], d


@pytest.mark.parametrize("side,cap,counts", WINDOW_CASES)
def test_window_cases_hold_what_they_claim(side, cap, counts):
    """The hand-built inputs have tiles with the claimed real-slot counts
    (padding inside a warp), spans empty and longer than a warp's buffer,
    and member pairs at d2 == r2 exactly in the kernels' float32 form."""
    case = window_case(side, cap, counts)
    real = case["real"]
    assert tuple(real.sum(1)) == tuple(counts)
    assert any(0 < row[w:w + cull.WARP].sum() < min(cull.WARP, cap - w)
               for row in real for w in range(0, cap, cull.WARP))
    lens = (case["f_len"] if side == "fwd" else case["b_len"]).numpy()
    assert lens.max() > BUFFER and (lens == 0).any() and lens.sum(1).min() > BUFFER
    r2 = np.float32(case["r2"])
    at_r = sum(int(((cull.d2_form_f32(*d) == r2) & m).sum())
               for m, _, d in _members_and_kept(_cull_args(side, case)))
    assert at_r > 0


@pytest.mark.parametrize("case_id", range(len(WINDOW_CASES) + 4))
def test_box_cull_keeps_every_member(case_id):
    """The warps' box cull, as scripts.cellwin_cull.cull_windows computes it
    in the kernels' float32 form, keeps every member pair: on the lattice cases
    (members at d2 == r2 exactly) and on both sides of two seeded graphs;
    and it drops entries."""
    if case_id < len(WINDOW_CASES):
        side, cap, counts = WINDOW_CASES[case_id]
        args = _cull_args(side, window_case(side, cap, counts))
    else:
        n, r, seed, cap = [(6000, 0.35, 0, 128), (3000, 0.4, 2, 64)][(case_id - 4) // 2]
        g = _slice_graph(n, r, seed, cap)[1]
        args = ((g.q_est, cull.ROW_PAD, g.est_sorted, g.f_span_start, g.f_span_len,
                 g.f_tile_ctr, g.r2) if case_id % 2 == 0 else
                (g.est_sorted, cull.POINT_PAD, g.q_est, g.b_span_start, g.b_span_len,
                 g.b_tile_ctr, g.r2))
    members = lost = 0
    for member, kept, _ in _members_and_kept(args):
        members += int(member.sum())
        lost += int((member & ~kept).sum())
    kept_tests, tests, box_tests = cull.cull_pair_tests(*args)
    assert members > 0 and lost == 0
    assert members <= kept_tests < tests
    assert 0 < box_tests < tests


@pytest.mark.cuda
@pytest.mark.parametrize("case_id", range(len(WINDOW_CASES)))
def test_cuda_kernels_match_plain_on_window_cases(cuda_device, case_id):
    """K1 and K2 on the lattice cases (ties at d2 == r2, partial and padded
    warps, long and empty spans) against their plain versions: K1's member
    counts equal the float32 plain version's and its moments meet the
    float64 bars of test_cuda_kernels_match_plain on every column; K2, with
    the case's cotangent table and with an all-ones table, within
    GRAD_REL_BAR of max |grad| of the float64 plain version."""
    side, cap, counts = WINDOW_CASES[case_id]
    case = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
            for k, v in window_case(side, cap, counts).items()}
    names = (["pts_sorted", "q_est", "est_sorted"]
             + (["f_start", "f_len", "f_ctr"] if side == "fwd" else
                ["table9", "b_start", "b_len", "b_ctr"]) + ["r2"])
    args = [case[k] for k in names]
    _hold_window_case(side, args)
    if side == "bwd":
        args[3] = torch.ones_like(args[3])
        _hold_window_case(side, args)


def _hold_window_case(side: str, args: list) -> None:
    """K1 or K2 on the wrapper's arguments ``args`` against the plain
    versions, at the bars of test_cuda_kernels_match_plain."""
    if side == "fwd":
        got = tcw.cellwin_fwd(*args)
        assert torch.equal(got[9], tcw.cellwin_fwd_plain(*args)[9])
        ref = tcw.cellwin_fwd_plain(args[0].double(), *args[1:])
        d = (got.double() - ref).abs()
        assert float(d[0:3].max()) <= MEAN_ABS_BAR and float(d[3:9].max()) <= COMPS_ABS_BAR
        return
    got = tcw.cellwin_bwd(*args)
    wide = list(args)
    wide[0], wide[3] = args[0].double(), args[3].double()
    ref = tcw.cellwin_bwd_plain(*wide)
    assert float((got.double() - ref).abs().max()) <= GRAD_REL_BAR * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["fwd", "bwd"])
def test_cuda_kernels_take_wide_span_tables(cuda_device, side):
    """A span table of 3,000 mini-spans a tile (empty past the lattice
    case's six) needs more than the default 48 KB of dynamic shared memory
    per block; the kernels opt in and still meet their plain versions'
    bars."""
    case = window_case(side, 128, (1, 31, 33, 127))
    keys = ("f_start", "f_len") if side == "fwd" else ("b_start", "b_len")
    for k in keys:
        wide = torch.zeros((case[k].shape[0], 3000), dtype=torch.int32)
        wide[:, :case[k].shape[1]] = case[k]
        case[k] = wide
    case = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
            for k, v in case.items()}
    names = (["pts_sorted", "q_est", "est_sorted"]
             + (["f_start", "f_len", "f_ctr"] if side == "fwd" else
                ["table9", "b_start", "b_len", "b_ctr"]) + ["r2"])
    _hold_window_case(side, [case[k] for k in names])


@pytest.mark.cuda
def test_cuda_moments_gradient_matches_plain(cuda_device):
    """cellwin_moments end to end (K1, exception-row merge, K2 through
    CellWinCore) against the plain float64 path on the same graph."""
    pts, g = _slice_graph(4000, 0.35, 3, 128)
    dev = tcw.graph_to_device(g, cuda_device)
    rows = dev.row_map >= 0
    wg = torch.randn(rows.shape[0], generator=torch.Generator().manual_seed(3),
                     dtype=torch.float64).to(cuda_device) * rows

    def objective(p, plain):
        mean, comps = tcw.cellwin_moments(permute_rows(p, dev.perm, dev.inv), dev, plain=plain)
        return (wg * (comps[0] + 0.7 * comps[3] + 0.3 * comps[5] + 0.11 * mean[1])).sum()

    p32 = torch.tensor(pts, dtype=torch.float32, device=cuda_device, requires_grad=True)
    p64 = torch.tensor(pts, dtype=torch.float64, device=cuda_device, requires_grad=True)
    before = (tcw.FWD_LAUNCHES, tcw.BWD_LAUNCHES)
    objective(p32, plain=False).backward()
    assert (tcw.FWD_LAUNCHES, tcw.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    objective(p64, plain=True).backward()
    gref = p64.grad
    err = float((p32.grad.double() - gref).abs().max())
    assert err <= GRAD_REL_BAR * float(gref.abs().max())


@pytest.mark.cuda
def test_cuda_wrappers_refuse_float64(cuda_device):
    """On the card the wrappers launch float32 kernels or raise: a float64
    CUDA tensor is refused, not computed by the plain version."""
    pts, g = _slice_graph(1500, 0.35, 1, 64)
    dev = tcw.graph_to_device(g, cuda_device)
    ps = torch.as_tensor(pts, dtype=torch.float64, device=cuda_device)[dev.perm].contiguous()
    before = (tcw.FWD_LAUNCHES, tcw.BWD_LAUNCHES)
    with pytest.raises(TypeError, match="dtype"):
        tcw.cellwin_fwd(ps, dev.q_est, dev.est_sorted, dev.f_start, dev.f_len, dev.f_ctr, dev.r2)
    table = torch.zeros((9, dev.q_est.shape[1]), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        tcw.cellwin_bwd(ps, dev.q_est, dev.est_sorted, table, dev.b_start, dev.b_len, dev.b_ctr,
                        dev.r2)
    assert (tcw.FWD_LAUNCHES, tcw.BWD_LAUNCHES) == before


# ---------------------------------------------------------------------------
# The online corrector's kernels: X1 (slab-window moments) and P7 (gather
# moments).

N_CELLS = 1 << 21


def test_node_wrappers_never_take_the_plain_path(monkeypatch):
    """Non-CPU tensors go to the X1 / P7 launchers, never to the plain
    versions."""
    calls = []

    def fake_launch(*args):
        calls.append(args)
        raise RuntimeError("launched")

    monkeypatch.setattr(_kernels, "launch_slab_window", fake_launch)
    monkeypatch.setattr(_kernels, "launch_gather_moments", fake_launch)
    pts = torch.zeros((3, 256), device="meta")
    spans = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="launched"):
        tslab.slab_window_kernel(pts, torch.zeros(256, dtype=torch.bool, device="meta"),
                                 spans, spans, torch.zeros((2, 3), device="meta"), 0.01)
    with pytest.raises(RuntimeError, match="launched"):
        tfeat.gather_moments(pts.T, torch.zeros((4, 8), dtype=torch.int32, device="meta"),
                             torch.zeros((4, 8), device="meta"))
    assert len(calls) == 2


def _slab_inputs(device, seed=0, n=16384, r=0.25):
    """A sorted slab layout of half a noisy plane and half a volume, with
    cells of side >= r."""
    rng = np.random.default_rng(seed)
    n1 = n // 2
    p = np.vstack([np.c_[rng.uniform(-4, 4, (n1, 2)), 0.01 * rng.standard_normal(n1)],
                   rng.uniform(-4, 4, (n - n1, 3)) * [1.0, 1.0, 0.3]]) + [12.0, -7.0, 1.5]
    valid = torch.as_tensor(rng.uniform(size=n) > 0.1, device=device)
    pts = torch.as_tensor(p, dtype=torch.float32, device=device)
    pts_T, val, ids, _, _, dims, _, _ = grid_sort_colpad_traced(pts, valid, r, N_CELLS,
                                                                x_cols_pad=64)
    lo, width, ctr, _ = tslab.slab_tile_spans(pts_T, val, ids, dims, N_CELLS)
    return pts_T, val, lo, width, ctr


def _straddle_inputs(device, seed=3, n=16000):
    """A cell sort without column padding (tiles straddle major columns:
    one whole-slab span), padded to a multiple of 128 with invalid slots."""
    from depth_correction_tpu_torch.ops.grid_hash import grid_sort_traced

    rng = np.random.default_rng(seed)
    p = np.c_[rng.uniform(-4, 4, (n, 2)), 0.02 * rng.standard_normal(n)] + [3.0, 1.0, 0.5]
    pts = torch.as_tensor(p, dtype=torch.float32, device=device)
    valid = torch.as_tensor(rng.uniform(size=n) > 0.1, device=device)
    pts_T, val, ids, _, _, dims, _ = grid_sort_traced(pts, valid, 0.25, N_CELLS, sort_axes=True)
    pad = -n % 128
    pts_T = torch.cat([pts_T, torch.full((3, pad), 1e15, device=device)], 1).contiguous()
    val = torch.cat([val, torch.zeros(pad, dtype=torch.bool, device=device)])
    ids = torch.cat([ids, torch.full((pad,), N_CELLS, dtype=ids.dtype, device=device)])
    lo, width, ctr, _ = tslab.slab_tile_spans(pts_T, val, ids, dims, N_CELLS)
    return pts_T, val, lo, width, ctr


def _slab_case(case, device):
    """X1's cases: the noisy plane and volume (with all-padding tiles at
    the tail), tiles straddling columns, whole tiles and warps dropped, and
    wide spans (r = 1: spans of thousands of entries)."""
    if case == "plane_volume":
        return _slab_inputs(device) + (0.0625,)
    if case == "straddle":
        out = _straddle_inputs(device)
        assert bool((out[3][:, 1:] == 0).all(1).logical_and(out[3][:, 0] > 0).any())
        return out + (0.0625,)
    if case == "dropped_tiles_and_warps":
        pts_T, val, lo, width, ctr = _slab_inputs(device, seed=4)
        val = val.clone()
        live = torch.nonzero(val.reshape(-1, 128).any(1)).squeeze(1)
        for t in live[::7].tolist():
            val[t * 128:(t + 1) * 128] = False  # a whole live tile
        for t in live[3::5].tolist():
            val[t * 128 + 32:t * 128 + 64] = False  # its second warp
        return pts_T, val, lo, width, ctr, 0.0625
    if case == "wide_spans":
        pts_T, val, lo, width, ctr = _slab_inputs(device, seed=5, r=1.0)
        return pts_T, val, lo, width, ctr, 1.0
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plane_volume", "straddle", "dropped_tiles_and_warps",
                                  "wide_spans"])
def test_cuda_slab_window_matches_plain(cuda_device, case):
    """X1 on every case of :func:`_slab_case`: one launch, the member
    counts of the float32 plain version (the same membership, no fused
    multiply-add), and the float64 bars on every valid slot."""
    pts_T, val, lo, width, ctr, r2 = _slab_case(case, cuda_device)
    before = _kernels.SLAB_LAUNCHES
    out = tslab.slab_window_kernel(pts_T, val, lo, width, ctr, r2)
    torch.cuda.synchronize()
    assert _kernels.SLAB_LAUNCHES == before + 1
    p32 = tslab.slab_window_moments_plain(pts_T, val, lo, width, ctr, r2)
    assert torch.equal(out[9], p32[9])
    p64 = tslab.slab_window_moments_plain(pts_T.double(), val, lo, width, ctr.double(), r2)
    d = (out.double() - p64)[:, val].abs()
    assert float(d[0:3].max()) <= MEAN_ABS_BAR and float(d[3:9].max()) <= COMPS_ABS_BAR
    assert float(p64[9][val].min()) >= 1.0  # every valid row is its own member
    if case == "wide_spans":
        assert int(width.sum(1).max()) > 1000


@pytest.mark.cuda
def test_cuda_gather_moments_matches_plain(cuda_device):
    rng = np.random.default_rng(5)
    pts = torch.as_tensor(rng.normal(size=(20000, 3)) + 20.0, dtype=torch.float32,
                          device=cuda_device)
    idx = rng.integers(0, 20000, (5000, 40))
    idx[rng.uniform(size=idx.shape) < 0.2] = -1
    idx = torch.as_tensor(idx, dtype=torch.int32, device=cuda_device)
    w = torch.as_tensor(rng.uniform(size=(5000, 40)) > 0.1, dtype=torch.float32,
                        device=cuda_device)
    before = _kernels.GATHER_LAUNCHES
    mean, comps, wsum = tfeat.gather_moments(pts, idx, w)
    mean_t, comps_t, wsum_t = tfeat.gather_moments(pts.T, idx, w)  # (3, N) layout
    torch.cuda.synchronize()
    assert _kernels.GATHER_LAUNCHES == before + 2
    assert torch.equal(mean, mean_t) and torch.equal(comps, comps_t)
    ref = tfeat.gather_moments_plain(pts.double(), idx, w.double())
    for got, want in zip((mean, comps, wsum), ref):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())


def _node_scan():
    from depth_correction_tpu_torch.datasets.synthetic import OpenBoxDataset

    scan = OpenBoxDataset(name="open_box/n_6_size_10_10_5_height_1_density_60").local_cloud(0)
    rng = np.random.default_rng(7)
    for f in "xyz":
        scan[f] += 0.005 * rng.standard_normal(len(scan))
    return scan


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["slab", "brute", "grid"])
def test_cuda_correct_cloud_launches_kernels(cuda_device, backend):
    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.node import correct_cloud
    from depth_correction_tpu_torch.preproc import pad_size

    cfg = Config()
    cfg.min_depth, cfg.max_depth, cfg.grid_res, cfg.nn_r = 1.0, 25.0, 0.1, 0.25
    cfg.min_valid_neighbors = 5
    cfg.eigenvalue_ratio_bounds = [[0, 1, 0, 0.25], [1, 2, 0.25, 1.0]]
    cfg.nn_backend = backend
    scan = _node_scan()
    outs = {}
    for dtype, plain in ((torch.float32, False), (torch.float64, True)):
        cloud = Cloud.from_structured_array(scan, dtype=dtype, device=cuda_device)
        cloud = cloud.pad(pad_size(cloud.size))
        if plain:
            # The voxel filter draws its ranks in the cloud's float type:
            # the float64 reference takes the float32 run's kept points.
            cloud = cloud.replace(valid=outs[False][4])
            cfg.grid_res = 0.0
        model = ScaledPolynomial(w=[-0.002], exponent=[4.0], dtype=dtype, device=cuda_device)
        before = (_kernels.SLAB_LAUNCHES, _kernels.GATHER_LAUNCHES, _kernels.GRID_LAUNCHES)
        outs[plain] = correct_cloud(model, cloud, cfg, plain=plain)
        after = (_kernels.SLAB_LAUNCHES, _kernels.GATHER_LAUNCHES, _kernels.GRID_LAUNCHES)
        launched = [a - b for a, b in zip(after, before)]
        want = {"slab": [1, 0, 0], "brute": [0, 1, 0], "grid": [0, 1, 1]}[backend]
        assert launched == ([0, 0, 0] if plain else want)
    got, ref = outs[False], outs[True]
    assert torch.equal(got[4], ref[4])
    both = got[3] & ref[3]
    assert int(both.sum()) > 0.9 * int(ref[3].sum()) > 0
    assert float((got[0].double() - ref[0])[both].abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_node_wrappers_refuse_float64_and_grad(cuda_device):
    pts_T, val, lo, width, ctr = _slab_inputs(cuda_device, n=2048)
    idx = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    w = torch.ones((4, 8), device=cuda_device)
    before = (_kernels.SLAB_LAUNCHES, _kernels.GATHER_LAUNCHES)
    with pytest.raises(TypeError, match="dtype"):
        tslab.slab_window_kernel(pts_T.double(), val, lo, width, ctr.double(), 0.0625)
    with pytest.raises(TypeError, match="dtype"):
        tfeat.gather_moments(pts_T.T.double(), idx, w)
    with pytest.raises(RuntimeError, match="forward only"):
        tfeat.gather_moments(pts_T.T.detach().requires_grad_(), idx, w)
    with pytest.raises(RuntimeError, match="forward only"):
        tslab.slab_window_kernel(pts_T.detach().requires_grad_(), val, lo, width, ctr, 0.0625)
    assert (_kernels.SLAB_LAUNCHES, _kernels.GATHER_LAUNCHES) == before


# ---------------------------------------------------------------------------
# The probes: P1 (cell-window knockout), P2 (moment product), P3-P5 (moment
# product with in-kernel operands).


def test_probe_wrappers_never_take_the_plain_path(monkeypatch):
    """Non-CPU tensors go to the P1-P5 launchers, never to the plain
    versions."""
    from depth_correction_tpu_torch.ops.cellwin_knockout import cellwin_knockout
    from depth_correction_tpu_torch.ops.moment_dot import moment_dot
    from depth_correction_tpu_torch.ops.moment_window import moment_window

    calls = []

    def fake_launch(*args, **kw):
        calls.append(args)
        raise RuntimeError("launched")

    for name in ("launch_cellwin_knockout", "launch_moment_dot", "launch_moment_window"):
        monkeypatch.setattr(_kernels, name, fake_launch)
    meta = torch.zeros((256, 3), device="meta")
    tab = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="launched"):
        cellwin_knockout(meta, meta.T, meta.T, tab, tab, torch.zeros((2, 3), device="meta"),
                         0.1, "no_d2")
    with pytest.raises(RuntimeError, match="launched"):
        moment_dot(torch.zeros((5, 16, 64), device="meta"),
                   torch.zeros((5, 64, 128), device="meta"), 2, "tf32x3")
    with pytest.raises(RuntimeError, match="launched"):
        moment_window(torch.zeros((5, 8, 64), device="meta"), torch.zeros((8, 128), device="meta"),
                      0.0625, 2, 5, 64, 27, "tf32")
    assert len(calls) == 3
    with pytest.raises(ValueError, match="mode"):
        cellwin_knockout(meta, meta.T, meta.T, tab, tab, meta, 0.1, "dot1")
    with pytest.raises(ValueError, match="precision"):
        moment_dot(meta, meta, 1, "bf16")


def test_device_ms_times_cuda_devices_only():
    """The probes' timer takes CUDA events only; a CPU device raises before
    anything is called."""
    from depth_correction_tpu_torch.scripts import device_ms

    calls = []
    with pytest.raises(ValueError, match="CUDA"):
        device_ms(lambda: calls.append(1), "cpu", reps=1)
    assert not calls


@pytest.mark.parametrize("timer", ["kernel_ms", "queued_ms"])
def test_profiler_timers_take_cuda_devices_only(timer):
    """kernel_ms and its fallback, queued_ms, time CUDA devices only; a CPU
    device raises before anything is called."""
    calls = []
    with pytest.raises(ValueError, match="CUDA"):
        getattr(scripts, timer)(lambda: calls.append(1), "cpu", reps=1)
    assert not calls


@pytest.mark.parametrize("counts,ms,retakes", [([19, 20], 0.1, 1), ([0, 40], 0.2, 1),
                                               ([19, 1, 21, 19, 39], 0.2, 4)])
def test_kernel_ms_retakes_profiles_that_drop_launches(monkeypatch, counts, ms, retakes):
    """A profile that recorded no kernel, or a kernel's launches short of a
    multiple of the calls, is taken again with the waits around the calls
    three times as long; the first whole profile's reading stands, else the
    last one's per-launch mean; the retaken profiles' calls are counted.
    On a faked profiler and card clock."""
    from types import SimpleNamespace

    import torch.profiler
    from torch.autograd import DeviceType

    recorded = iter(counts)

    class Dropping:
        def __init__(self, *args, **kwargs):
            self.count = next(recorded)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [SimpleNamespace(device_type=DeviceType.CUDA, count=self.count, key="k",
                                    self_device_time_total=100.0 * self.count)]

    waits, calls = [], []
    monkeypatch.setattr(torch.profiler, "profile", Dropping)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(scripts.time, "sleep", waits.append)
    retaken, queued = scripts.RETAKEN_CALLS, scripts.QUEUED_TIMINGS
    got = scripts.kernel_ms(lambda: calls.append(1), "cuda", 20, warmup=1)
    assert got == pytest.approx(ms)
    assert scripts.RETAKEN_CALLS - retaken == 20 * retakes
    assert scripts.QUEUED_TIMINGS == queued
    assert len(calls) == 1 + 20 * (retakes + 1)
    assert waits == pytest.approx([scripts.PROFILE_PAD_S * 3 ** a
                                   for a in range(retakes + 1) for _ in range(2)])


@pytest.mark.cuda
def test_cuda_kernel_ms_times_queued_calls_after_empty_profiles(cuda_device, monkeypatch):
    """When every profile records no kernel, kernel_ms times the calls queued
    behind a spin kernel: counted in QUEUED_TIMINGS, every call past the
    warm and asked-for ones in RETAKEN_CALLS, and the reading within 10% of
    the profiler's for a 2048-square matmul."""
    import torch.profiler

    a = torch.randn(2048, 2048, device=cuda_device)
    calls = []

    def fn():
        calls.append(1)
        return a @ a

    profiled = scripts.kernel_ms(fn, cuda_device, 20)

    class Empty:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return []

    monkeypatch.setattr(torch.profiler, "profile", Empty)
    monkeypatch.setattr(scripts, "PROFILE_ATTEMPTS", 2)
    calls.clear()
    queued, retaken = scripts.QUEUED_TIMINGS, scripts.RETAKEN_CALLS
    ms = scripts.kernel_ms(fn, cuda_device, 20, warmup=1)
    assert scripts.QUEUED_TIMINGS == queued + 1
    assert scripts.RETAKEN_CALLS - retaken == len(calls) - 1 - 20
    assert len(calls) >= 1 + 2 * 20 + 2 * 20
    assert abs(ms - profiled) <= 0.1 * profiled, (ms, profiled)
    assert abs(scripts.queued_ms(fn, cuda_device, 20) - profiled) <= 0.1 * profiled


@pytest.mark.cuda
def test_cuda_knockout_matches_plain(cuda_device):
    """Every P1 mode against its float64 plain version; full (the same
    template instance) and no_cull (the cull off) bit-equal to K1."""
    from depth_correction_tpu_torch.scripts import exp_cellwin_knockout as p1

    pts, g = _slice_graph(6000, 0.35, 0, 128)
    dev = tcw.graph_to_device(g, cuda_device)
    ps = torch.as_tensor(pts, dtype=torch.float32, device=cuda_device)[dev.perm].contiguous()
    before, retaken = _kernels.KNOCKOUT_LAUNCHES, scripts.RETAKEN_CALLS
    res = p1.run(ps, dev, reps=1)
    # per mode: 2 warm and 1 timed by events, 1 under the profiler, 1
    # checked; and one a profile that kernel_ms took again
    assert _kernels.KNOCKOUT_LAUNCHES == (before + 5 * len(res["modes"])
                                          + scripts.RETAKEN_CALLS - retaken)
    k1 = tcw.cellwin_fwd(ps, dev.q_est, dev.est_sorted, dev.f_start, dev.f_len, dev.f_ctr, dev.r2)
    assert torch.equal(res["modes"]["full"]["out"], k1)
    assert torch.equal(res["modes"]["no_cull"]["out"].view(torch.int32), k1.view(torch.int32))
    for mode, e in res["modes"].items():
        err = e["errors"]
        assert err["count"] == 0, (mode, err)
        if mode in ("full", "no_cull"):
            assert err["mean_abs"] <= MEAN_ABS_BAR and err["comps_abs"] <= COMPS_ABS_BAR
        else:
            assert err["rel"] <= 1e-5, (mode, err)


@pytest.mark.cuda
def test_cuda_moment_dot_matches_plain(cuda_device, monkeypatch):
    """P2 at its shapes (8 tiles): every variant within 1e-5 of its float32
    plain version per row, fp32 and tf32x3 within 1e-5 of the float64
    oracle, every tile's slot the same."""
    from depth_correction_tpu_torch.scripts import exp_mosaic_dot_probe as p2

    monkeypatch.setattr(p2, "T1", 8)
    before = _kernels.DOT_LAUNCHES
    res = p2.run(cuda_device, reps=1)
    assert _kernels.DOT_LAUNCHES == before + 4 * len(res["variants"])
    for v, e in res["variants"].items():
        assert e["err32"] <= 1e-5, (v, e["err32"])
        if v in ("fp32", "tf32x3"):
            assert e["oracle"] <= 1e-5, (v, e["oracle"])
        out = e["out"].reshape(16, 8, 128)
        assert torch.equal(out, out[:, :1].expand_as(out))


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["exp_mosaic_dot_probe2", "exp_mosaic_dot_probe3",
                                   "exp_mosaic_dot_probe4"])
def test_cuda_moment_window_matches_plain(cuda_device, monkeypatch, probe):
    """P3-P5 at their probes' draws, 16 tiles: every variant within 1e-5
    per row of its float32 plain version and, without the epilogue (P3's
    precisions, P4's A-C), of its float64 plain version."""
    import importlib

    mod = importlib.import_module("depth_correction_tpu_torch.scripts." + probe)
    monkeypatch.setattr(mod, "T1", 16)
    before = _kernels.WINDOW_LAUNCHES
    res = mod.run(cuda_device, reps=1)
    assert _kernels.WINDOW_LAUNCHES == before + 4 * len(res["variants"])
    if probe == "exp_mosaic_dot_probe2":
        kws = {v: {} for v in res["variants"]}
    elif probe == "exp_mosaic_dot_probe3":
        draws = mod.inputs(cuda_device)
        kws = {v: mod.variant_args(v, draws)[2] for v in res["variants"]}
    else:
        kws = {v: c[2] for v, c in mod.inputs(cuda_device, tuple(res["variants"])).items()}
    for v, e in res["variants"].items():
        assert e["err32"] <= 1e-5, (v, e["err32"])
        if not kws[v].get("epilogue"):
            assert e["err64"] <= 1e-5, (v, e["err64"])


@pytest.mark.cuda
def test_cuda_moment_window_clamps_spans_to_the_table(cuda_device):
    """Staged spans that start before the table, run past its end or lie
    wholly outside it: the kernel reads only the table's columns and matches
    the plain version within 1e-5 per row."""
    from depth_correction_tpu_torch.ops.moment_window import moment_window
    from depth_correction_tpu_torch.scripts import rel_rows

    rng = np.random.default_rng(3)
    ncols = 300
    big = rng.normal(scale=0.2, size=(8, ncols)).astype(np.float32)
    q = rng.normal(scale=0.2, size=(8, 128)).astype(np.float32)
    starts = np.array([[-50, 10, ncols + 10], [ncols - 20, 200, -500]], np.int32)
    lens = np.full((2, 3), 59, np.int32)

    def call(device):
        big_t, q_t, lens_t, starts_t = (torch.as_tensor(x, device=device)
                                        for x in (big, q, lens, starts))
        return moment_window(big_t, q_t, 0.0625, 2, 3, 64, lens_t, "tf32x3", starts=starts_t)

    got, want = call(cuda_device), call("cpu")
    assert want[0].abs().max() > 0
    assert rel_rows(got.cpu(), want) <= 1e-5


@pytest.mark.cuda
def test_cuda_probe_wrappers_refuse(cuda_device):
    """float64 CUDA inputs and a switch set that was not instantiated raise;
    nothing is counted."""
    from depth_correction_tpu_torch.ops.moment_dot import moment_dot
    from depth_correction_tpu_torch.ops.moment_window import moment_window

    a = torch.zeros((5, 16, 64), dtype=torch.float64, device=cuda_device)
    b = torch.zeros((5, 64, 128), dtype=torch.float64, device=cuda_device)
    win = torch.zeros((5, 8, 64), device=cuda_device)
    q = torch.zeros((8, 128), device=cuda_device)
    lens = torch.full((2, 5), 27, dtype=torch.int32, device=cuda_device)
    before = (_kernels.DOT_LAUNCHES, _kernels.WINDOW_LAUNCHES)
    with pytest.raises(TypeError, match="dtype"):
        moment_dot(a, b, 2, "tf32x3")
    with pytest.raises(TypeError, match="dtype"):
        moment_window(win.double(), q.double(), 0.0625, 2, 5, 64, 27, "tf32x3")
    with pytest.raises(RuntimeError, match="launch failed"):
        moment_window(win, q, 0.0625, 2, 5, 64, lens, "fp32")  # fp32 has no span table
    assert (_kernels.DOT_LAUNCHES, _kernels.WINDOW_LAUNCHES) == before


# ---------------------------------------------------------------------------
# P2's and P6's wrappers and P2 at its edge shapes.

P2_PRECS = ("fp32", "tf32", "tf32x2", "tf32x3")
P6_PROBES = ("reshape_f32", "iota_col", "iota_col_full", "bool_reshape", "dot_tlhs",
             "transpose_f32", "broadcast_row_to_col")


@pytest.mark.parametrize("name", [("moment_dot", p) for p in P2_PRECS]
                         + [("layout_probe", p) for p in P6_PROBES])
def test_p2_p6_wrappers_send_cuda_tensors_to_the_redesign(monkeypatch, name):
    """Non-CPU tensors go from moment_dot / layout_probe to the kernel's
    launcher with the variant's index, never to the plain twin."""
    from depth_correction_tpu_torch.ops import layout_probe as tlayout
    from depth_correction_tpu_torch.ops import moment_dot as tdot

    kernel, variant = name
    calls = []

    def fake_launch(*args, **kw):
        calls.append(args)
        raise RuntimeError("launched")

    def refuse(*args, **kw):
        raise AssertionError("took another route")

    monkeypatch.setattr(_kernels, "launch_" + kernel, fake_launch)
    monkeypatch.setattr(tdot, "moment_dot_plain", refuse)
    monkeypatch.setattr(tlayout, "layout_probe_plain", refuse)
    with pytest.raises(RuntimeError, match="launched"):
        if kernel == "moment_dot":
            tdot.moment_dot(torch.zeros((5, 16, 64), device="meta"),
                            torch.zeros((5, 64, 128), device="meta"), 2, variant)
        else:
            tlayout.layout_probe(torch.zeros((8, 512), device="meta"), variant)
    assert len(calls) == 1
    want = P2_PRECS.index(variant) if kernel == "moment_dot" else P6_PROBES.index(variant)
    assert calls[0][0] == want
    if kernel == "layout_probe":
        assert tuple(calls[0][2]) == tlayout.PROBES[variant]


@pytest.mark.parametrize("prec", P2_PRECS)
def test_window_wrapper_sends_cuda_tensors_to_the_redesign(monkeypatch, prec):
    """Non-CPU tensors go from moment_window to the kernel's launcher with
    the precision's index and the switches' bits, never to the plain
    twin."""
    from depth_correction_tpu_torch.ops import moment_window as twin

    calls = []

    def fake_launch(*args, **kw):
        calls.append((args, kw))
        raise RuntimeError("launched")

    def refuse(*args, **kw):
        raise AssertionError("took another route")

    monkeypatch.setattr(_kernels, "launch_moment_window", fake_launch)
    monkeypatch.setattr(twin, "moment_window_plain", refuse)
    lens = torch.zeros((2, 5), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="launched"):
        twin.moment_window(torch.zeros((8, 640), device="meta"),
                           torch.zeros((8, 256), device="meta"), 0.0625, 2, 5, 64, lens, prec,
                           starts=lens, leads=lens, ctr=torch.zeros((2, 3), device="meta"),
                           per_tile_q=True, epilogue=True)
    (args, kw), = calls
    assert args[0] == P2_PRECS.index(prec) and args[1] == sum(twin.FLAG_BITS.values())
    assert kw["starts"] is lens and kw["leads"] is lens


def _p2_inputs(device, ns, s_len, seed=0):
    """Seeded P2 inputs at any shape: a (ns, 16, S) normal, b (ns, S, 128)
    {0, 1} of density 0.3 (the probe's draws)."""
    rng = np.random.default_rng(seed + 1000 * ns + s_len)
    a = rng.normal(size=(ns, 16, s_len)).astype(np.float32)
    b = (rng.random((ns, s_len, 128)) < 0.3).astype(np.float32)
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [1, 3, 513])
@pytest.mark.parametrize("s_len", [8, 72, 640])
@pytest.mark.parametrize("ns", [1, 5])
def test_cuda_moment_dot_edge_shapes(cuda_device, ns, s_len, n_tiles):
    """P2 at the edge shapes (one span, a chunk of 8 k, a ragged last
    chunk, a ragged last block of tiles): every variant within 1e-5 per row
    of its float32 plain twin; fp32 and tf32x3 within 1e-5 of the float64
    product; every tile's slot the same; one launch a variant."""
    from depth_correction_tpu_torch.ops.moment_dot import moment_dot, moment_dot_plain
    from depth_correction_tpu_torch.scripts import rel_max, rel_rows

    a, b = _p2_inputs(cuda_device, ns, s_len)
    oracle = moment_dot_plain(a.double(), b.double(), 1, "fp32")
    before = _kernels.DOT_LAUNCHES
    for prec in P2_PRECS:
        got = moment_dot(a, b, n_tiles, prec)
        torch.cuda.synchronize()
        assert got.shape == (16, 128 * n_tiles)
        tiles = got.reshape(16, n_tiles, 128)
        assert torch.equal(tiles, tiles[:, :1].expand_as(tiles)), prec
        first = got[:, :128]
        assert rel_rows(first, moment_dot_plain(a, b, 1, prec)) <= 1e-5, prec
        if prec in ("fp32", "tf32x3"):
            assert rel_max(first, oracle) <= 1e-5, prec
    assert _kernels.DOT_LAUNCHES == before + len(P2_PRECS)


# Bar of P3-P5 against the plain versions (chip_smoke.py's PROBE_REL_BAR).
PROBE_REL_BAR = 1e-5


def _check_window(win, q, prec, kw, exact: bool):
    """P3-P5 against the plain version in float32, and in float64 when
    ``exact`` (no epilogue), per row within PROBE_REL_BAR."""
    from depth_correction_tpu_torch.ops.moment_window import moment_window, moment_window_plain
    from depth_correction_tpu_torch.scripts import rel_rows

    r2 = 0.0625
    got = moment_window(win, q, r2, prec=prec, **kw)
    torch.cuda.synchronize()
    label = (prec, {k: v for k, v in kw.items() if not isinstance(v, torch.Tensor)})
    assert torch.isfinite(got).all(), label
    assert rel_rows(got, moment_window_plain(win, q, r2, prec=prec, **kw)) <= PROBE_REL_BAR, label
    if exact:
        wide = dict(kw, ctr=kw["ctr"].double()) if "ctr" in kw else kw
        ref64 = moment_window_plain(win.double(), q.double(), r2, prec=prec, **wide)
        assert rel_rows(got, ref64) <= PROBE_REL_BAR, label


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [1, 3, 16])
@pytest.mark.parametrize("s_len", [64, 72, 640])
@pytest.mark.parametrize("ns", [1, 5, 15])
def test_cuda_moment_window_edge_shapes(cuda_device, ns, s_len, n_tiles):
    """P3-P5 against the plain versions at the edge shapes: span lengths that are not a multiple of 8 and empty spans,
    leads > 0 with lead + len past S, starts before the table and past its
    end; every switch (J's set), the staged length table without the
    epilogue (C's set), and every precision on per-span windows with one
    length."""
    rng = np.random.default_rng(1000 * ns + 10 * s_len + n_tiles)
    ncols = 3 * s_len + 40
    big = torch.as_tensor(rng.normal(scale=0.2, size=(8, ncols)).astype(np.float32),
                          device=cuda_device)
    q = torch.as_tensor(rng.normal(scale=0.2, size=(8, 128 * n_tiles)).astype(np.float32),
                        device=cuda_device)
    lens = rng.integers(0, s_len + 1, (n_tiles, ns))
    lens[rng.random((n_tiles, ns)) < 0.2] = 0
    leads = rng.integers(0, s_len, (n_tiles, ns))
    starts = rng.integers(-s_len // 2, ncols - s_len // 2, (n_tiles, ns))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=cuda_device)

    ctr = torch.as_tensor(rng.normal(scale=0.1, size=(n_tiles, 3)).astype(np.float32),
                          device=cuda_device)
    j_kw = dict(n_tiles=n_tiles, ns=ns, s_len=s_len, lens=t(lens), starts=t(starts),
                leads=t(leads), ctr=ctr, per_tile_q=True, epilogue=True)
    _check_window(big, q, "tf32x3", j_kw, exact=False)
    q0 = q[:, :128].contiguous()  # every tile's q without per_tile_q
    c_kw = dict(n_tiles=n_tiles, ns=ns, s_len=s_len, lens=t(lens), starts=t(starts))
    _check_window(big, q0, "tf32x3", c_kw, exact=True)
    win = torch.as_tensor(rng.normal(scale=0.2, size=(ns, 8, s_len)).astype(np.float32),
                          device=cuda_device)
    for prec in P2_PRECS:
        for ln in (s_len - 3, 0):
            kw = dict(n_tiles=n_tiles, ns=ns, s_len=s_len, lens=ln)
            _check_window(win, q0, prec, kw, exact=prec in ("fp32", "tf32x3"))


# ---------------------------------------------------------------------------
# X2 (the grid radius search), P6 (layout probes) and P8 (gather probes).


def test_grid_wrappers_never_take_the_plain_path(monkeypatch):
    """Non-CPU tensors go to the X2 / P6 / P8 launchers, never to the plain
    versions."""
    from depth_correction_tpu_torch.ops import grid_hash as tgrid
    from depth_correction_tpu_torch.ops.gather_probe import gather_probe
    from depth_correction_tpu_torch.ops.layout_probe import layout_probe

    calls = []

    def fake_launch(*args, **kw):
        calls.append(args)
        raise RuntimeError("launched")

    for name in ("launch_grid_query", "launch_layout_probe", "launch_gather_probe"):
        monkeypatch.setattr(_kernels, name, fake_launch)
    pts = torch.zeros((64, 3), device="meta")
    i32 = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="launched"):
        tgrid.grid_query(pts, torch.zeros(64, dtype=torch.bool, device="meta"), pts.T, None,
                         i32, i32, torch.zeros(3), torch.ones(3, dtype=torch.int64), 0.01, 8,
                         None, 0.1)
    with pytest.raises(RuntimeError, match="launched"):
        layout_probe(torch.zeros((8, 512), device="meta"), "dot_tlhs")
    with pytest.raises(RuntimeError, match="launched"):
        gather_probe(torch.zeros((8, 256), device="meta"),
                     torch.zeros((8, 256), dtype=torch.int32, device="meta"), 1, "global")
    assert len(calls) == 3
    with pytest.raises(ValueError, match="layout probe"):
        layout_probe(torch.zeros((8, 512)), "k_dot")
    with pytest.raises(ValueError, match="form"):
        gather_probe(torch.zeros(8), torch.zeros(8, dtype=torch.int32), 1, "vmem")


def _grid_inputs(device, seed=0, n=20000, dup=0):
    """Half a noisy plane, half a volume, 10% invalid; ``dup`` rows repeat
    earlier points exactly (ties in d2)."""
    from depth_correction_tpu_torch.ops.grid_hash import _build_grid

    rng = np.random.default_rng(seed)
    n1 = n // 2
    p = np.vstack([np.c_[rng.uniform(-4, 4, (n1, 2)), 0.01 * rng.standard_normal(n1)],
                   rng.uniform(-4, 4, (n - n1, 3)) * [1.0, 1.0, 0.3]]) + [12.0, -7.0, 1.5]
    if dup:
        p[-dup:] = p[rng.integers(0, n - dup, dup)]
    valid = torch.as_tensor(rng.uniform(size=n) > 0.1, device=device)
    pts = torch.as_tensor(p, dtype=torch.float32, device=device)
    grid, width = _build_grid(pts, valid, 0.3, None, None)
    return pts, valid, grid, width


def _f32_ulps(a, b):
    """Distance in float32 ulps between finite values of a and b."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    return (ia - ib).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("k,dup", [(16, 0), (32, 3000), (200, 0), (0, 0)])
def test_cuda_grid_query_matches_plain(cuda_device, k, dup):
    """X2 against its plain twin on the same float32 grid: counts equal;
    for k <= 32, k > 32 and ties (duplicated points) the index tables equal,
    order included, and distances within one float32 ulp."""
    from depth_correction_tpu_torch.ops.grid_hash import _grid_query_plain, grid_query

    pts, valid, grid, width = _grid_inputs(cuda_device, dup=dup)
    (pts_T, val_s, ids_s, order, mins, dims, cell, starts) = grid
    r2 = torch.full((), 0.3, dtype=torch.float32) ** 2
    before = _kernels.GRID_LAUNCHES
    got = grid_query(pts, valid, pts_T, val_s, ids_s, order, mins, dims, r2, k, None, cell,
                     starts)
    torch.cuda.synchronize()
    assert _kernels.GRID_LAUNCHES == before + 1
    want = _grid_query_plain(pts, valid, pts_T, val_s, ids_s, order, mins, dims, r2, k, width,
                             cell, starts)
    if k == 0:
        assert torch.equal(got, want) and int(want.max()) > 32
        return
    assert torch.equal(got[1], want[1])
    fin = torch.isfinite(want[0])
    assert torch.equal(fin, torch.isfinite(got[0]))
    assert int(_f32_ulps(got[0][fin], want[0][fin]).max()) <= 1
    if k == 200:  # k holds every count: the sets are the uncapped ones
        counts = grid_query(pts, valid, pts_T, val_s, ids_s, order, mins, dims, r2, 0, None,
                            cell, starts)
        assert torch.equal((got[1] >= 0).sum(1).to(torch.int32), counts)


@pytest.mark.cuda
def test_cuda_grid_radius_neighbors_bucket_cap(cuda_device):
    """An undersized bucket_cap cuts each run where the JAX window cuts it:
    the kernel equals the twin under the same cap (dense and searched)."""
    from depth_correction_tpu_torch.ops import grid_hash as tgrid

    pts, valid, _, _ = _grid_inputs(cuda_device, seed=1, n=6000)
    got = tgrid.grid_radius_neighbors(pts, r=0.3, k=24, valid_points=valid, valid_query=valid,
                                      bucket_cap=4)
    want = tgrid.grid_radius_neighbors(pts.cpu(), r=0.3, k=24, valid_points=valid.cpu(),
                                       valid_query=valid.cpu(), bucket_cap=4)
    assert torch.equal(got[1].cpu(), want[1])


def _face_lattice(c: float = 0.3):
    """Points on the faces i * c (i = 10..18) of cells of side ``c`` (a side
    whose reciprocal is inexact) and one float32 ulp to either side, 27 to a
    site, plus one point near the origin, so the grid's origin is 0:
    neighbours sit at distance ~c, within an ulp of the radius."""
    ax = torch.arange(10, 19, dtype=torch.float32) * torch.tensor(c)
    ax = torch.cat([ax, torch.nextafter(ax, ax + 1), torch.nextafter(ax, ax - 1)])
    lattice = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    return torch.cat([torch.full((1, 3), 0.1), lattice])


def test_face_lattice_straddles_cell_faces():
    """The face lattice has coordinates whose cell differs between a true
    division by the side and a multiply by its float32 reciprocal, which is
    what the card's scalar division does; the grid divides by a tensor."""
    x = _face_lattice()[:, 0]
    c = torch.tensor(0.3, dtype=torch.float32)
    assert bool((torch.floor(x / c) != torch.floor(x * (1.0 / c))).any())
    from depth_correction_tpu_torch.ops.grid_hash import _cell_tensor

    assert _cell_tensor(0.3, x).dtype == torch.float32 and _cell_tensor(0.3, x).dim() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 32])
def test_cuda_grid_query_on_cell_faces(cuda_device, k):
    """On points on cell faces with r = 0.3, the card's grid build, X2 and
    the CPU's plain path put every point in the same cell: counts equal,
    index tables equal (order included), distances within one ulp."""
    from depth_correction_tpu_torch.ops import grid_hash as tgrid

    pts = _face_lattice()
    if k == 0:
        got = tgrid.grid_neighbor_counts(pts.to(cuda_device), r=0.3)
        want = tgrid.grid_neighbor_counts(pts, r=0.3)
        assert torch.equal(got.cpu(), want) and int(want.max()) > 32
        return
    got = tgrid.grid_radius_neighbors(pts.to(cuda_device), r=0.3, k=k)
    want = tgrid.grid_radius_neighbors(pts, r=0.3, k=k)
    assert torch.equal(got[1].cpu(), want[1])
    fin = torch.isfinite(want[0])
    assert torch.equal(fin, torch.isfinite(got[0].cpu()))
    assert int(_f32_ulps(got[0].cpu()[fin], want[0][fin]).max()) <= 1


def _x2_case(case, device):
    """X2's cases -> (queries, their validity, grid, window, k, bucket
    cap): the noisy plane and volume (largest count ~60) at k below and
    above every count, duplicated points (ties in d2), the cell-face lattice,
    an undersized bucket_cap and a separate query set."""
    from depth_correction_tpu_torch.ops.grid_hash import _build_grid

    name, k = case
    if name == "faces":
        pts = _face_lattice().to(device)
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
        grid, width = _build_grid(pts, valid, 0.3, None, None)
        return pts, valid, grid, width, k, None
    pts, valid, grid, width = _grid_inputs(device, seed=7, dup=3000 if name == "dup" else 0)
    if name == "dense":  # the same cloud at a quarter of the scale: counts past 256
        pts = (pts * 0.25).contiguous()
        grid, width = _build_grid(pts, valid, 0.3, None, None)
    if name == "query_set":
        rng = np.random.default_rng(8)
        q = pts[:6000] + torch.as_tensor(rng.normal(0, 0.05, (6000, 3)), dtype=torch.float32,
                                         device=device)
        qv = torch.as_tensor(rng.uniform(size=6000) > 0.2, device=device)
        return q, qv, grid, width, k, None
    return pts, valid, grid, width, k, 4 if name == "cap" else None


X2_CASES = ([("plane_volume", k) for k in (0, 1, 16, 32, 33, 168)]
            + [("dup", 32), ("dup", 168), ("faces", 32), ("faces", 168), ("cap", 32),
               ("cap", 168), ("query_set", 16), ("query_set", 168), ("dense", 300),
               ("dense", 1000)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", X2_CASES)
def test_cuda_grid_query_cases_match_plain(cuda_device, case):
    """X2 on every case of :func:`_x2_case` against its plain twin: index
    tables equal, distances within one float32 ulp, counts equal; one
    launch."""
    from depth_correction_tpu_torch.ops import grid_hash as tgrid

    q, qv, grid, width, k, cap = _x2_case(case, cuda_device)
    (pts_T, val_s, ids_s, order, mins, dims, cell, starts) = grid
    args = (q, qv, pts_T, val_s, ids_s, order, mins, dims,
            torch.full((), 0.3, dtype=torch.float32) ** 2, k)
    before = _kernels.GRID_LAUNCHES
    # The queries are the grid's own points except in the query-set cases:
    # the kernel then takes them in the grid's slot order.
    got = tgrid.grid_query(*args, cap, cell, starts, own_points=case[0] != "query_set")
    torch.cuda.synchronize()
    assert _kernels.GRID_LAUNCHES == before + 1
    want = tgrid._grid_query_plain(*args, width if cap is None else cap, cell, starts)
    counts = tgrid._grid_query_plain(*args[:-1], 0, width if cap is None else cap, cell, starts)
    if k == 0:
        assert torch.equal(got, want)
        return
    if cap is None:  # the cases cut (k below the largest count) or do not
        assert (int(counts.max()) > k) == (k < 168 or case[0] == "dense")
    assert torch.equal(got[1], want[1])
    fin = torch.isfinite(want[0])
    assert torch.equal(fin, torch.isfinite(got[0]))
    assert int(_f32_ulps(got[0][fin], want[0][fin]).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("first", [None, 200.0])
def test_cuda_layout_probes_match_plain(cuda_device, first):
    """Every P6 probe equals its plain version on the script's input (and
    with x[0, 0] = 200, so the masks are not all zero)."""
    from depth_correction_tpu_torch.ops.layout_probe import PROBES, layout_probe

    x = torch.arange(8 * 512, dtype=torch.float32).reshape(8, 512)
    if first is not None:
        x[0, 0] = first
    before = _kernels.LAYOUT_LAUNCHES
    for name in PROBES:
        got = layout_probe(x.to(cuda_device), name)
        assert torch.equal(got.cpu(), layout_probe(x, name)), name
    assert _kernels.LAYOUT_LAUNCHES == before + len(PROBES)


@pytest.mark.cuda
def test_cuda_gather_probes_match_plain(cuda_device):
    """Every P8 case and form equals its plain version (error 0); B's staged
    form runs on a cluster of 8 blocks; a row too long for a cluster is
    refused."""
    from depth_correction_tpu_torch.ops.gather_probe import (FORMS, gather_probe,
                                                             staged_blocks)
    from depth_correction_tpu_torch.scripts import exp_pallas_gather2 as p8

    ran = 0
    for case, (x, idx, axis) in p8.inputs(cuda_device).items():
        want = gather_probe(x.cpu(), idx.cpu(), axis, "global")
        assert staged_blocks(x, axis) == (8 if case == "B" else 1)
        for form in FORMS:
            assert torch.equal(gather_probe(x, idx, axis, form).cpu(), want), (case, form)
            ran += 1
    assert ran == 10
    x = torch.zeros((1, 8 * 58112 + 1), device=cuda_device)
    with pytest.raises(ValueError, match="does not fit"):
        gather_probe(x, torch.zeros((1, 4), dtype=torch.int32, device=cuda_device), 1, "staged")


def _p8_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


# (x shape, idx shape, axis): i_cols not a multiple of 4, 8 or 256, a single
# row, one column, rows past one block's shared memory in one and several
# rows (the cluster form), odd cluster slices.
P8_EDGE_SHAPES = [
    ((8, 256), (8, 253), 1), ((3, 1000), (3, 7), 1), ((1, 5), (1, 3), 1),
    ((5, 1), (5, 1), 1), ((1, 4097), (1, 4097), 1), ((8, 3), (8, 3), 0),
    ((17, 301), (5, 301), 0), ((1, 131072), (1, 131072), 1),
    ((3, 70001), (3, 9999), 1), ((2, 58113), (2, 58113), 1), ((8, 131072), (8, 1001), 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,i_shape,axis", P8_EDGE_SHAPES)
@pytest.mark.parametrize("form", ["global", "staged"])
def test_cuda_gather_probe_edge_shapes(cuda_device, x_shape, i_shape, axis, form):
    """Edge shapes with indices at 0 and at the last column (row) of x: P8
    equals the plain version bit for bit, and a view off 16-byte alignment
    takes the scalar loads to the same bits."""
    from depth_correction_tpu_torch.ops.gather_probe import gather_probe, gather_probe_plain

    g = torch.Generator().manual_seed(sum(x_shape) + sum(i_shape) + axis)
    x = torch.randn(x_shape, generator=g)
    hi = x_shape[axis]
    idx = torch.randint(0, hi, i_shape, generator=g, dtype=torch.int32)
    idx.view(-1)[0] = 0
    idx.view(-1)[-1] = hi - 1
    if idx.numel() > 2:
        idx.view(-1)[1] = hi - 1
    want = gather_probe_plain(x, idx, axis)
    xd, id_ = x.to(cuda_device), idx.to(cuda_device)
    got = gather_probe(xd, id_, axis, form)
    assert _p8_equal(got.cpu(), want)
    # The same values one float past a 16-byte boundary.
    xs = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x_shape)
    xs.copy_(xd)
    is_ = torch.empty(idx.numel() + 1, dtype=torch.int32, device=cuda_device)[1:].view(i_shape)
    is_.copy_(id_)
    assert _p8_equal(gather_probe(xs, is_, axis, form).cpu(), want)


# ---------------------------------------------------------------------------
# X3 (the brute-force search) and P7a (P7's gather-sum probe).


def test_knn_and_gather_sum_wrappers_never_take_the_plain_path(monkeypatch):
    """Non-CPU tensors go to the X3 / P7a launchers, never to the plain
    twins (``plain=True`` asks for the twin explicitly)."""
    from depth_correction_tpu_torch.ops import gather_sum as tgsum
    from depth_correction_tpu_torch.ops import knn as tknn

    calls = []

    def fake_launch(*args, **kw):
        calls.append(args)
        raise RuntimeError("launched")

    def refuse(*args, **kw):
        raise AssertionError("took the plain twin")

    for name in ("launch_knn_brute", "launch_gather_sum"):
        monkeypatch.setattr(_kernels, name, fake_launch)
    monkeypatch.setattr(tgsum, "gather_sum_plain", refuse)
    pts = torch.zeros((64, 3), device="meta")
    valid = torch.zeros(64, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="launched"):
        tknn.radius_neighbors(pts, pts, r=0.1, k=8, valid_points=valid, valid_query=valid)
    with pytest.raises(RuntimeError, match="launched"):
        tknn.nearest_neighbors(pts, k=4)
    with pytest.raises(RuntimeError, match="launched"):
        tknn.neighbor_counts(pts, r=0.1, valid_points=valid)
    with pytest.raises(RuntimeError, match="launched"):
        tgsum.gather_sum(torch.zeros((3, 64), device="meta"),
                         torch.zeros((4, 8), dtype=torch.int32, device="meta"))
    assert len(calls) == 4


# A C entry defined in a source (at the start of its line).
C_ENTRY = re.compile(r"^(?:int|long long|const char\*) (dc_\w+)\(", re.M)


@pytest.mark.parametrize("source", [os.path.basename(p) for p in _kernels.SOURCES])
def test_each_source_defines_only_bound_entries(source):
    """Every C entry a compiled source (``_kernels.SOURCES``) defines is
    bound by ``load``, no other source defines it, and every entry ``load``
    binds is defined in one of them."""
    defined = {os.path.basename(p): set(C_ENTRY.findall(open(p).read()))
               for p in _kernels.SOURCES}
    bound = set(re.findall(r"lib\.(dc_\w+)", inspect.getsource(_kernels.load)))
    assert defined[source] and defined[source] <= bound
    for other, entries in defined.items():
        assert other == source or not entries & defined[source], other
    assert bound == set().union(*defined.values())


def test_gather_variants_apply_to_the_sources():
    """scripts/exp_gather_variants.py builds its variants by replacing
    lines of the committed P7 sources: every replacement still finds its
    line (``_sources`` raises otherwise), and each grouping replaces the
    whole dispatch by one launch of its (G, C)."""
    from depth_correction_tpu_torch.scripts import exp_gather_variants as gv

    src = gv._sources()
    for g, c in {gc for gcs in gv.GROUPINGS.values() for gc in gcs}:
        code, entry = src["g%dc%d" % (g, c)]
        assert entry == "dc_gather_moments"
        assert "launch<%d, %d>(" % (g, c) in code and "if (k <= 32)" not in code
    for name, (fname, _) in gv.KNOCKOUTS.items():
        assert src[name][1] == "dc_" + fname[:-3]


def test_window_variants_apply_to_the_sources():
    """scripts/exp_window_variants.py builds its knockouts by replacing
    lines of the committed P3-P5 source: every replacement still finds its
    line (``sources`` raises otherwise), each renames the source's entry,
    and the knockouts leave the pair test, the wgmma chain and the barrier
    out as they say."""
    from depth_correction_tpu_torch.scripts import exp_window_variants as wv

    src = wv.sources()
    assert sorted(src) == sorted(wv.KNOCKOUTS)
    for name, (fname, _) in wv.KNOCKOUTS.items():
        assert fname == "moment_window.cu" and src[name][1] == "dc_moment_window"
    assert "set.le.f32.f32" not in src["no_test"][0]
    assert "issue_step<P>(d, fr[ks]" not in src["no_wgmma"][0]
    full = open(os.path.join(os.path.dirname(_kernels.SOURCES[0]), "moment_window.cu")).read()
    assert src["no_barrier"][0].count("__syncthreads") == full.count("__syncthreads") - 1


def test_reset_zeroes_every_launch_count(monkeypatch):
    """Every launch count kept in ops/_kernels.py (each module-level
    ``*_LAUNCHES``) is in its ``__all__``, and one reset_launch_counts
    zeroes them all."""
    names = [n for n in vars(_kernels) if n.endswith("_LAUNCHES")]
    assert names and set(names) <= set(_kernels.__all__)
    for name in names:
        monkeypatch.setattr(_kernels, name, 5)
    _kernels.reset_launch_counts()
    assert [getattr(_kernels, n) for n in names] == [0] * len(names)


def _launch_counts() -> tuple:
    """Every kernel's launch count: ops/_kernels.py's and K1 / K2's."""
    return tuple(getattr(_kernels, n) for n in _kernels.__all__ if n.endswith("_LAUNCHES")) + (
        tcw.FWD_LAUNCHES, tcw.BWD_LAUNCHES)


def _launcher_args(name: str, device) -> tuple:
    """Arguments of the raw launcher ``name`` on ``device``: small tensors
    of the shapes and dtypes it takes."""
    def f32(*shape):
        return torch.zeros(shape, device=device)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    def b(*shape):
        return torch.ones(shape, dtype=torch.bool, device=device)

    if name in ("launch_transpose_moments", "launch_transpose_gather"):
        pts, nn, w, _ = _transpose_case("k32", "cpu")
        tg = tfeat.build_transpose_graph(nn, pts, w).to(device)
        if name == "launch_transpose_moments":
            return pts.to(device), tg, f32(nn.shape[0], 12)
        return f32(nn.numel(), 3), tg
    spans = (i32(1, 2), i32(1, 2), f32(1, 3))
    return {
        "launch_cellwin_fwd": (f32(128, 3), f32(3, 128), f32(3, 128)) + spans + (0.1,),
        "launch_cellwin_knockout": (0, f32(128, 3), f32(3, 128), f32(3, 128)) + spans + (0.1,),
        "launch_cellwin_bwd": (f32(128, 3), f32(3, 128), f32(3, 128), f32(9, 128)) + spans
        + (0.1,),
        "launch_slab_window": (f32(3, 128), b(128), i32(1, 3), i32(1, 3), f32(1, 3), 0.01),
        "launch_gather_moments": (f32(8, 3), i32(4, 2), f32(4, 2)),
        "launch_moment_dot": (3, f32(5, 16, 64), f32(5, 64, 128), 2),
        "launch_moment_window": (3, 0, f32(5, 8, 64), f32(8, 128), 0.0625, 2, 5, 64, 27),
        "launch_grid_query": (f32(4, 3), b(4), f32(3, 8), i32(8), i32(8), [0.0] * 3, [1, 1, 1],
                              1.0, 0.1, 4),
        "launch_layout_probe": (0, f32(8, 512), (512, 128)),
        "launch_gather_probe": (False, 1, f32(8, 256), i32(8, 256)),
        "launch_knn_brute": (f32(4, 3), None, f32(8, 3), b(8), 0.01, 4),
        "launch_gather_sum": (f32(3, 8), i32(2, 4)),
        "launch_icp_gate": (f32(8), i32(8), b(8)),
        "launch_icp_solve": (f32(8), torch.zeros(64, dtype=torch.uint8, device=device),
                             f32(4, 4), f32(8), i32(8), f32(8, 3), b(8), f32(16, 3), f32(16, 3),
                             0.8),
    }[name]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("launcher", sorted(n for n in _kernels.__all__
                                            if n.startswith("launch_")))
def test_launchers_take_cuda_tensors_only(monkeypatch, launcher, device):
    """Every kernel's raw launcher refuses CPU and meta tensors before the
    library is loaded, and counts nothing."""
    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_kernels, "load", no_library)
    before = _launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(_kernels, launcher)(*_launcher_args(launcher, device))
    assert _launch_counts() == before


def _knn_inputs(device, seed=0, n=20000, dup=0, quantum=0.0):
    """Half a noisy plane, half a volume, 10% invalid; ``dup`` rows repeat
    earlier points exactly and ``quantum`` > 0 snaps every point to a grid
    of that step (ties in d2 either way)."""
    rng = np.random.default_rng(seed)
    n1 = n // 2
    p = np.vstack([np.c_[rng.uniform(-4, 4, (n1, 2)), 0.01 * rng.standard_normal(n1)],
                   rng.uniform(-4, 4, (n - n1, 3)) * [1.0, 1.0, 0.3]]) + [12.0, -7.0, 1.5]
    if dup:
        p[-dup:] = p[rng.integers(0, n - dup, dup)]
    if quantum:
        p = np.round(p / quantum) * quantum
    valid = torch.as_tensor(rng.uniform(size=n) > 0.1, device=device)
    return torch.as_tensor(p, dtype=torch.float32, device=device), valid


@pytest.mark.cuda
@pytest.mark.parametrize("k,r,dup,quantum", [(16, 0.3, 0, 0.0), (64, 0.3, 3000, 0.0),
                                             (200, 0.3, 0, 0.05), (8, None, 0, 0.0),
                                             (40, None, 2000, 0.05)])
def test_cuda_knn_brute_matches_plain(cuda_device, k, r, dup, quantum):
    """X3 against its plain twin on the same float32 inputs: index tables
    equal, order included, d2 bit for bit (0 ulp), with a radius below and
    above the largest count, without one, and on ties (duplicated and
    grid-snapped points); then the counts, equal."""
    from depth_correction_tpu_torch.ops import knn as tknn

    pts, valid = _knn_inputs(cuda_device, dup=dup, quantum=quantum)
    q, qv = pts[::3].contiguous(), valid[::3].contiguous()
    before = _kernels.KNN_LAUNCHES
    d2, idx = tknn.knn_d2(pts, q, k, r, valid, qv)
    torch.cuda.synchronize()
    assert _kernels.KNN_LAUNCHES == before + 1
    pd2, pidx = tknn.knn_d2(pts, q, k, r, valid, qv, plain=True)
    assert torch.equal(idx, pidx)
    assert bit_equal(d2, pd2)
    assert int((idx[~qv] >= 0).sum()) == 0
    if r is not None:
        counts = tknn.neighbor_counts(pts, q, r, valid)
        pcounts = tknn.neighbor_counts(pts, q, r, valid, plain=True)
        assert _kernels.KNN_LAUNCHES == before + 2
        assert torch.equal(counts, pcounts)
        held = torch.minimum(counts, torch.tensor(k, device=cuda_device))
        assert torch.equal((idx >= 0).sum(1).to(torch.int32), torch.where(qv, held, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dup,quantum", [(0, 0.0), (2000, 0.05)], ids=["distinct", "ties"])
def test_cuda_knn_k1_no_radius_matches_plain(cuda_device, dup, quantum):
    """X3 at k = 1 with no radius, as eval_icp's 1-NN correspondences call
    it (loss._pair_correspondence: every point of the next scan, no query
    mask): one launch, the nearest distances equal to the plain twin's on
    the same float32 inputs, and an index that differs only where the two
    points lie at the same distance (a tie)."""
    from depth_correction_tpu_torch.ops import knn as tknn

    pts, valid = _knn_inputs(cuda_device, seed=0, n=30000, dup=dup, quantum=quantum)
    q, _ = _knn_inputs(cuda_device, seed=1, n=30000, dup=dup, quantum=quantum)
    before = _kernels.KNN_LAUNCHES
    dist, idx = tknn.nearest_neighbors(pts, q, k=1, valid_points=valid)
    torch.cuda.synchronize()
    assert _kernels.KNN_LAUNCHES == before + 1
    pdist, pidx = tknn.nearest_neighbors(pts, q, k=1, valid_points=valid, plain=True)
    assert bit_equal(dist, pdist)
    assert bool((idx >= 0).all()) and bool(valid[idx.long()].all())
    differ = (idx != pidx)[:, 0]

    def d2_rows(i):
        d = q[differ] - pts[i[differ, 0].long()]
        return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]

    assert bit_equal(d2_rows(idx), d2_rows(pidx))


def _x3_against_twin(pts, q, k, r, valid, qv):
    """X3 against its plain twin on the same float32 inputs: top-k index
    tables equal, d2 bit for bit, counts equal; each launches once. Returns
    X3's (d2, idx), counts."""
    from depth_correction_tpu_torch.ops import knn as tknn

    before = (_kernels.KNN_LAUNCHES, _kernels.KNN_NEAREST_LAUNCHES)
    d2, idx = tknn.knn_d2(pts, q, k, r, valid, qv)
    counts = tknn.neighbor_counts(pts, q, r, valid)
    torch.cuda.synchronize()
    # The nearest search takes k = 1 with no radius alone: these calls never.
    assert (_kernels.KNN_LAUNCHES, _kernels.KNN_NEAREST_LAUNCHES) == (
        before[0] + 2, before[1] + int(k == 1 and r is None))
    pd2, pidx = tknn.knn_d2(pts, q, k, r, valid, qv, plain=True)
    pcounts = tknn.neighbor_counts(pts, q, r, valid, plain=True)
    assert torch.equal(idx, pidx)
    assert bit_equal(d2, pd2)
    assert torch.equal(counts, pcounts)
    if qv is not None:
        assert int((idx[~qv] >= 0).sum()) == 0
    return (d2, idx), counts


X3_CASES = {
    "k1": dict(k=1), "k32": dict(k=32), "k88": dict(k=88), "k168": dict(k=168, n=12000),
    "no_radius": dict(k=16, r=None, n=6000),
    "no_radius_k88": dict(k=88, r=None, n=3000),
    "self": dict(k=32, self_query=True),
    "self_every_row": dict(k=32, self_query=True, every_row=True, dup=500),
    "self_no_radius": dict(k=8, r=None, n=4000, self_query=True),
    "cell_sorted": dict(k=32, cell_sorted=True),
    "queries_invalid": dict(k=32, no_valid_queries=True),
    "points_invalid": dict(k=32, no_valid_points=True),
    "n_below_32": dict(k=8, n=20, self_query=True),
    "n_tile_plus_one": dict(k=40, n=129, r=2.0, self_query=True),
    "dup_ties": dict(k=64, dup=3000),
    "snapped_ties": dict(k=200, quantum=0.05),
    "dup_snapped_no_radius": dict(k=40, r=None, n=5000, dup=1000, quantum=0.05),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(X3_CASES))
def test_cuda_knn_redesign_matches_twin(cuda_device, case):
    """The redesigned X3 (cell order, tile cull, one query per lane)
    against its plain twin: k from 1 to 200, no
    radius, self-search (the main paths' calls, which reuse the points'
    order for the queries: with the valid points as the queries, and with
    every row querying as the shadow filter's top-k does), input already in
    cell order, no valid query, no valid point, fewer points than a warp
    and than a tile plus one, and the duplicated and grid-snapped ties of
    :func:`_knn_inputs`."""
    from depth_correction_tpu_torch.scripts import knn_cull as kc

    c = dict(k=32, r=0.3, n=20000, dup=0, quantum=0.0)
    c.update(X3_CASES[case])
    pts, valid = _knn_inputs(cuda_device, seed=3, n=c["n"], dup=c["dup"], quantum=c["quantum"])
    if c.get("cell_sorted"):
        order = torch.as_tensor(kc.cell_order(pts.cpu(), valid.cpu(), c["r"]), device=cuda_device)
        pts, valid = pts[order].contiguous(), valid[order].contiguous()
    if c.get("no_valid_points"):
        valid = torch.zeros_like(valid)
    if c.get("self_query"):
        q, qv = pts, valid
    else:
        q, qv = pts[::3].contiguous(), valid[::3].contiguous()
    if c.get("no_valid_queries"):
        qv = torch.zeros_like(qv)
    if c.get("every_row"):
        qv = None
    (_, idx), counts = _x3_against_twin(pts, q, c["k"], c["r"], valid, qv)
    if c.get("no_valid_points"):
        assert int(counts.sum()) == 0 and int((idx >= 0).sum()) == 0
    elif not c.get("no_valid_queries"):
        assert int((idx >= 0).sum()) > 0


@pytest.mark.cuda
def test_cuda_knn_fewest_queries_per_block_and_the_limit(cuda_device):
    """The largest k whose lists fit one warp of 32 queries (one per lane)
    in the tiled body runs and equals its twin, as does the largest k of
    the warp-per-query body."""
    k_tiles, k_max = _kernels.knn_tiles_max_k(), _kernels.knn_max_k()
    assert 200 < k_tiles < k_max
    pts, valid = _knn_inputs(cuda_device, seed=4, n=2500)
    q, qv = pts[::2].contiguous(), valid[::2].contiguous()
    _x3_against_twin(pts, q, k_tiles, 1.0, valid, qv)
    _x3_against_twin(pts, q[:64].contiguous(), k_max, None, valid, qv[:64].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1.0, None], ids=["radius", "no_radius"])
def test_cuda_knn_large_k_takes_the_warp_body(cuda_device, monkeypatch, r):
    """launch_knn_brute at one k past the tiled body's limit takes the
    warp-per-query body (csrc/knn_warp.cu), with a radius and without one,
    and equals the plain twin on a few thousand points; one k past that
    body's limit is refused with the k and the limit, before any launch."""
    from depth_correction_tpu_torch.ops import knn as tknn

    k_tiles, k_max = _kernels.knn_tiles_max_k(), _kernels.knn_max_k()
    pts, valid = _knn_inputs(cuda_device, seed=8, n=3000)
    q, qv = pts[::2].contiguous(), valid[::2].contiguous()
    warp_calls = []
    warp_body = _kernels._knn_warp_body

    def spy(*args):
        warp_calls.append(args[5])
        return warp_body(*args)

    monkeypatch.setattr(_kernels, "_knn_warp_body", spy)
    r2 = math.inf if r is None else float(torch.tensor(r, dtype=torch.float32) ** 2)
    before = _kernels.KNN_LAUNCHES
    d2, idx = _kernels.launch_knn_brute(q, qv, pts, valid, r2, k_tiles + 1)
    torch.cuda.synchronize()
    assert warp_calls == [k_tiles + 1] and _kernels.KNN_LAUNCHES == before + 1
    pd2, pidx = tknn.knn_d2(pts, q, k_tiles + 1, r, valid, qv, plain=True)
    assert torch.equal(idx, pidx) and bit_equal(d2, pd2)
    assert int((idx >= 0).sum()) > 0
    with pytest.raises(ValueError, match="k = %d does not fit.*k = %d" % (k_max + 1, k_max)):
        _kernels.launch_knn_brute(q, qv, pts, valid, r2, k_max + 1)
    assert warp_calls == [k_tiles + 1] and _kernels.KNN_LAUNCHES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [30000, 16385, 16384, 12000, 129])
def test_cuda_knn_order_matches_the_host_model(cuda_device, n):
    """The launcher's cell order on the card equals the host model's
    (scripts/knn_cull.py), so the model's kept-tile counts are the
    kernel's: by CUB's device sort above 16,384 rows, by one block at and
    below."""
    from depth_correction_tpu_torch.scripts import knn_cull as kc

    pts, valid = _knn_inputs(cuda_device, seed=5, n=n, dup=n // 15)
    r2 = float(torch.tensor(0.25, dtype=torch.float32) ** 2)
    got = _kernels._knn_cell_order(pts, valid, math.sqrt(r2)).cpu().numpy()
    np.testing.assert_array_equal(got, kc.cell_order(pts.cpu(), valid.cpu(), 0.25))
    got = _kernels._knn_cell_order(pts, None, math.sqrt(r2)).cpu().numpy()
    np.testing.assert_array_equal(got, kc.cell_order(pts.cpu(), np.ones(len(pts), bool), 0.25))


def _nearest_against_twin(pts, valid, q, qv=None, model=True):
    """X3's nearest search (k = 1, no radius) against the generic call and
    the plain twin on the same float32 inputs: idx equal and d2 bit for bit;
    one launch, counted as the nearest search. With ``model``, the tiles
    each warp read (the kernel's tally) equal the host model's
    (scripts/knn_cull.py:nearest_cull), and so do its keys. Returns the
    tally's share of the (warp, tile) pairs."""
    from depth_correction_tpu_torch.ops import knn as tknn
    from depth_correction_tpu_torch.scripts import knn_cull as kc

    tally = torch.full(((q.shape[0] + 31) // 32,), -1, dtype=torch.int32, device=q.device)
    before = (_kernels.KNN_LAUNCHES, _kernels.KNN_NEAREST_LAUNCHES)
    d2, idx = _kernels.launch_knn_brute(q, qv, pts, valid, math.inf, 1, tally=tally)
    torch.cuda.synchronize()
    assert (_kernels.KNN_LAUNCHES, _kernels.KNN_NEAREST_LAUNCHES) == (before[0] + 1,
                                                                      before[1] + 1)
    gd2, gidx = tknn.knn_d2(pts, q, 1, None, valid, qv)
    pd2, pidx = tknn.knn_d2(pts, q, 1, None, valid, qv, plain=True)
    for other_d2, other_idx in ((gd2, gidx), (pd2, pidx)):
        assert torch.equal(idx, other_idx)
        assert bit_equal(d2, other_d2)
    if model:
        m = kc.nearest_cull(pts.cpu(), valid.cpu(), q.cpu(), None if qv is None else qv.cpu())
        np.testing.assert_array_equal(tally.cpu().numpy(), m["tiles_read"])
        np.testing.assert_array_equal(idx[:, 0].cpu().numpy(), m["idx"])
    n_tiles = -(-pts.shape[0] // 128)
    return float(tally.double().sum()) / (tally.numel() * n_tiles)


def _world(scan):
    """A benchmark scan (structured x, y, z in its sensor frame, pose) as
    float32 world points on the card."""
    s, T = scan
    p = np.stack([s["x"], s["y"], s["z"]], 1) @ T[:3, :3].T + T[:3, 3]
    return torch.as_tensor(p, dtype=torch.float32, device="cuda")


def _merged_map(scans, capacity=1 << 19):
    """The scans' world points merged at 0.1 m voxels, the first point of a
    voxel kept (slam_mapper's merge, in one step), past ``capacity`` the
    rows nearest the last scan's sensor."""
    from depth_correction_tpu_torch.ops.filters import grid_first_mask

    pts = torch.cat([_world(s) for s in scans])
    keep, bad = grid_first_mask(pts, 0.1, torch.ones(len(pts), dtype=torch.bool,
                                                     device=pts.device))
    assert not bool(bad)
    pts = pts[keep]
    if len(pts) > capacity:
        centre = torch.as_tensor(scans[-1][1][:3, 3], device=pts.device)
        d2 = ((pts.double() - centre) ** 2).sum(1)
        pts = pts[torch.sort(torch.topk(d2, capacity, largest=False).indices).values]
    return pts.contiguous()


def _cell_shape(shape):
    """(points, queries) at a SLAM cell's search: ``odometry`` box_r25's scan
    1 against scan 0 (~64k x ~62k), ``mapper`` its scan 5 against scans 0-4
    merged (~61k against the map), ``street`` box_seq50's scan 24 against
    scans 0-23 merged (~115k against ~446k rows), each in the world frame
    at its ground truth, from the benchmark's scenes."""
    import json
    import os

    from benchmark.scene import open_box
    from benchmark.street import street

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "box_seq50.json" if shape == "street" else "box_r25.json")) as f:
        scene = json.load(f)["scene"]
    seed = 2 ** 32 + 977
    if shape == "odometry":
        s0, s1 = open_box(scene, seed, "cuda", ids=[0, 1])
        return _world(s0), _world(s1)
    if shape == "mapper":
        scans = open_box(scene, seed, "cuda")
        return _merged_map(scans[:5]), _world(scans[5])
    scans = street(scene, seed, "cuda", ids=range(25))
    return _merged_map(scans[:24]), _world(scans[24])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["odometry", "mapper", "street"])
def test_cuda_knn_nearest_at_the_slam_shapes(cuda_device, shape):
    """The nearest search at the SLAM cells' shapes: bit-equal to the plain
    twin, the tally equal to the host model's, and
    under 5% of the (warp, tile) pairs read (1% on the street map)."""
    pts, q = _cell_shape(shape)
    share = _nearest_against_twin(pts, torch.ones(len(pts), dtype=torch.bool, device=cuda_device), q)
    assert share < (0.01 if shape == "street" else 0.05), share


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["empty_slab", "outliers", "duplicates", "equidistant_tiles",
                                  "invalid_points_nan_queries", "single_valid_point",
                                  "outside_the_box", "slam_padding"])
def test_cuda_knn_nearest_adversarial(cuda_device, name):
    """The host model's adversarial cases (tests/test_torch_knn_cull.py) on
    the card: queries whose warps walk in sweeps, outliers, duplicates,
    queries equidistant from points in two tiles, invalid points and NaN
    queries, a single valid point, queries outside the points' box, SLAM's
    padding rows."""
    from test_torch_knn_cull import NEAREST_CASES

    pts, valid, q, qv = NEAREST_CASES[name]()
    dev = lambda a: None if a is None else torch.as_tensor(a, device=cuda_device)
    _nearest_against_twin(dev(pts), dev(valid), dev(q), dev(qv))


@pytest.mark.cuda
def test_cuda_knn_nearest_below_one_block_and_tally_refused(cuda_device):
    """Both orders of the nearest search (one block while points and
    queries together are at most 16,384 rows, the device sort above), a
    query set smaller than a warp; a tally is refused for any other search,
    before any launch."""
    pts, valid = _knn_inputs(cuda_device, seed=6, n=9000)
    q, _ = _knn_inputs(cuda_device, seed=7, n=7385)
    _nearest_against_twin(pts, valid, q[:7384].contiguous())
    _nearest_against_twin(pts, valid, q)
    _nearest_against_twin(pts, valid, q[:7].contiguous())
    tally = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    before = _kernels.KNN_LAUNCHES
    for r2, k in ((0.09, 1), (math.inf, 2), (0.09, 0)):
        with pytest.raises(ValueError, match="tally"):
            _kernels.launch_knn_brute(q[:7].contiguous(), None, pts, valid, r2, k, tally=tally)
    assert _kernels.KNN_LAUNCHES == before


@pytest.mark.cuda
def test_cuda_gather_sum_matches_plain(cuda_device):
    """P7a at the TPU probe's stage-1 shapes and draws: bit-equal to its
    plain twin (the same order of additions)."""
    from depth_correction_tpu_torch.ops.gather_sum import gather_sum, gather_sum_plain
    from depth_correction_tpu_torch.scripts import exp_pallas_gather as p7

    pts, idx = p7.inputs(cuda_device)["probe"]
    before = _kernels.GATHER_SUM_LAUNCHES
    got = gather_sum(pts, idx)
    torch.cuda.synchronize()
    assert _kernels.GATHER_SUM_LAUNCHES == before + 1
    assert bit_equal(got, gather_sum_plain(pts, idx))
    with pytest.raises(TypeError, match="dtype"):
        gather_sum(pts.double(), idx)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 32, 33, 100])
def test_cuda_gather_sum_matches_plain_at_any_k(cuda_device, k):
    """P7a bit-equal to its plain twin at K below, at and past one warp's
    32 indices (K 33 and 100 take two and four rounds of 32, the last one
    partial), with T not a multiple of either block (1000 rows); one
    launch."""
    from depth_correction_tpu_torch.ops.gather_sum import gather_sum, gather_sum_plain

    rng = np.random.default_rng(k)
    m, t = 16384, 1000
    pts = torch.as_tensor(rng.normal(size=(3, m)), dtype=torch.float32, device=cuda_device)
    idx = torch.as_tensor(rng.integers(0, m, (t, k)), dtype=torch.int32, device=cuda_device)
    before = _kernels.GATHER_SUM_LAUNCHES
    got = gather_sum(pts, idx)
    torch.cuda.synchronize()
    assert _kernels.GATHER_SUM_LAUNCHES == before + 1
    assert bit_equal(got, gather_sum_plain(pts, idx))


@pytest.mark.cuda
def test_cuda_gather_sum_takes_a_table_past_shared_memory(cuda_device):
    """A (3, 100,000) table (1.2 MB) is past any block's shared memory: P7a,
    which stages nothing, takes it and equals the plain twin bit for
    bit."""
    from depth_correction_tpu_torch.ops.gather_sum import gather_sum, gather_sum_plain

    rng = np.random.default_rng(11)
    m = 100_000
    pts = torch.as_tensor(rng.normal(size=(3, m)), dtype=torch.float32, device=cuda_device)
    idx = torch.as_tensor(rng.integers(0, m, (777, 32)), dtype=torch.int32, device=cuda_device)
    got = gather_sum(pts, idx)
    torch.cuda.synchronize()
    assert bit_equal(got, gather_sum_plain(pts, idx))


def _p7_cases(k, n=20000, mq=3000, seed=0):
    """Seeded P7 inputs at K = k: points 20 m from the origin (the shift
    matters), -1 padding, indices past N and below -1, zero weights on valid
    indices, rows 0-19 with no contributor, rows 20-39 whose first
    contributor sits at slot min(40, K - 1) (past slot 31 for K > 32), with
    one more at slot K - 1 where that is later, and rows 40-59 whose only
    contributor is the last slot (past the first pass of 128 at K 168)."""
    rng = np.random.default_rng(seed + k)
    pts = rng.normal(size=(n, 3)) + 20.0
    idx = rng.integers(0, n, (mq, k))
    idx[rng.uniform(size=idx.shape) < 0.2] = -1
    idx[rng.uniform(size=idx.shape) < 0.03] = n + 5
    idx[rng.uniform(size=idx.shape) < 0.03] = -7
    w = rng.uniform(0.5, 1.5, (mq, k)) * (rng.uniform(size=(mq, k)) > 0.1)
    w[idx == -1] = 0.0
    w[:10] = 0.0  # no contributor: zero weights
    idx[10:20] = -1  # no contributor: padding only
    first = min(40, k - 1)
    w[20:60] = 0.0
    for rows, slots in ((slice(20, 40), {first, k - 1}), (slice(40, 60), {k - 1})):
        for j in slots:
            w[rows, j] = 1.0
            idx[rows, j] = rng.integers(0, n, 20)
    return pts, idx, w


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("k", [1, 8, 32, 33, 88, 168])
def test_cuda_gather_moments_lane_groupings_match_plain(cuda_device, monkeypatch, k, pack):
    """P7 at every lane grouping (K 1-32, 33-64, 65-128, > 128), its points
    read in place or packed into (N, 4) rows first: both layouts bit-equal;
    within 1e-5 of max |output| of the float64 plain twin, the rows whose
    first contributor sits past slot 31 (past the first pass at K 168)
    included; rows with no contributor at mean 0, comps 0, w_sum 1e-12; one
    launch each."""
    monkeypatch.setattr(_kernels, "GATHER_PACK_MIN_PAIRS", 0 if pack else 1 << 62)
    pts, idx, w = _p7_cases(k)
    pts = torch.as_tensor(pts, dtype=torch.float32, device=cuda_device)
    idx = torch.as_tensor(idx, dtype=torch.int32, device=cuda_device)
    w = torch.as_tensor(w, dtype=torch.float32, device=cuda_device)
    before = _kernels.GATHER_LAUNCHES
    got = tfeat.gather_moments(pts, idx, w)
    got_3n = tfeat.gather_moments(pts.T.contiguous(), idx, w)  # (3, N)
    torch.cuda.synchronize()
    assert _kernels.GATHER_LAUNCHES == before + 2
    for a, b in zip(got, got_3n):
        assert bit_equal(a, b)
    ref = tfeat.gather_moments_plain(pts.double(), idx, w.double())
    for g, r in zip(got, ref):
        assert float((g.double() - r).abs().max()) <= 1e-5 * float(r.abs().max())
    none = slice(0, 20)
    assert not bool(got[0][:, none].any()) and not bool(got[1][:, none].any())
    assert bool((got[2][none] == 1e-12).all())


def bit_equal(a, b) -> bool:
    """float32 tensors equal bit for bit (the same infinities included)."""
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


@pytest.mark.cuda
def test_cuda_icp_align_matches_float64_plain(cuda_device):
    """icp_align on the card in float32 (X3 at k = 1 in each iteration, one
    launch an iteration, no value read back between them) against the
    port's float64 plain path on a small open-box scan registered on its
    neighbour: the poses within 1e-4 m and 1e-5 rad."""
    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.ops.se3 import delta_transform, matrix_to_xyz_axis_angle
    from depth_correction_tpu_torch.preproc import local_feature_cloud
    from depth_correction_tpu_torch.slam_eval import icp_align, perturb_odometry

    cfg = Config()
    cfg.device = "cpu"
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 30.0, 0.3
    cfg.nn_r, cfg.nn_k, cfg.nn_backend = 0.6, 0, "scipy"
    cfg.vp_dispersion_bounds, cfg.eigenvalue_ratio_bounds = [], []
    cfg.min_valid_neighbors, cfg.depth_noise = 3, 0.005
    cfg.depth_bias_model_kwargs = {"w": [0.0], "exponent": [4.0]}
    (s0, p0), (s1, p1) = list(create_dataset("open_box/n_2_size_10_10_5_height_1_density_60",
                                             cfg))
    clouds = [local_feature_cloud(s, cfg) for s in (s0, s1)]
    prior = perturb_odometry(np.stack([p0, p1]), [1e-5] * 3 + [4e-3] * 3, seed=3)[1]
    out = {}
    for dtype, device, plain in ((torch.float32, cuda_device, False),
                                 (torch.float64, cuda_device, True)):
        src, tgt = (c.to(device=device, dtype=dtype) for c in clouds)
        tgt = tgt.transform(torch.as_tensor(p0, dtype=dtype, device=device)).with_points()
        before = (_kernels.KNN_LAUNCHES, _kernels.ICP_SOLVE_LAUNCHES)
        T, err = icp_align(src, tgt, T0=prior, n_iters=6, plain=plain)
        out[plain] = T.double().cpu()
        assert _kernels.KNN_LAUNCHES - before[0] == (0 if plain else 6)
        assert _kernels.ICP_SOLVE_LAUNCHES - before[1] == (0 if plain else 6)
        assert math.isfinite(float(err))
    # The angle by the quaternion: arccos of the trace would read the float32
    # rotation's departure from orthonormality as ~5e-4 rad.
    d = delta_transform(out[True], out[False])
    assert float(d[:3, 3].norm()) < 1e-4
    assert float(matrix_to_xyz_axis_angle(d)[3:].norm()) < 1e-5


# ---------------------------------------------------------------------------
# X6 (an ICP step's gate and normal equations).


def _box_pair(n_scans: int = 2):
    """A small open box's feature clouds (CPU, float64) and a noisy
    odometry prior, as test_cuda_icp_align_matches_float64_plain registers
    them."""
    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.preproc import local_feature_cloud
    from depth_correction_tpu_torch.slam_eval import perturb_odometry

    cfg = Config()
    cfg.device = "cpu"
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 30.0, 0.3
    cfg.nn_r, cfg.nn_k, cfg.nn_backend = 0.6, 0, "scipy"
    cfg.vp_dispersion_bounds, cfg.eigenvalue_ratio_bounds = [], []
    cfg.min_valid_neighbors, cfg.depth_noise = 3, 0.005
    cfg.depth_bias_model_kwargs = {"w": [0.0], "exponent": [4.0]}
    scans = list(create_dataset("open_box/n_%d_size_10_10_5_height_1_density_60" % n_scans,
                                cfg))
    clouds = [local_feature_cloud(s, cfg) for s, _ in scans]
    poses = np.stack([np.asarray(p) for _, p in scans])
    return clouds, poses, perturb_odometry(poses, [1e-5] * 3 + [4e-3] * 3, seed=3)


def _x6_inputs(device, case: str = "box"):
    """X6's inputs on ``device`` in float32: scan 1 placed by its prior and
    X3's 1-NN (d2, idx) in scan 0 posed at ground truth, then ``case``'s
    change: ``no_inlier`` (no valid source row), ``ties`` (d2 rounded to
    1e-3 m^2: many rows share the threshold's distance), ``one_row`` (one
    valid source row), ``single_row`` (a one-row source), ``invalid_targets``
    (every third target invalid), ``no_target`` (none valid)."""
    from depth_correction_tpu_torch.ops.knn import knn_d2
    from depth_correction_tpu_torch.ops.se3 import transform_points

    clouds, poses, prior = _box_pair()
    src, tgt = (c.to(device=device, dtype=torch.float32) for c in clouds)
    tgt = tgt.transform(torch.as_tensor(poses[0], dtype=torch.float32,
                                        device=device)).with_points()
    T = torch.as_tensor(prior[1], dtype=torch.float32, device=device)
    pts = transform_points(T, src.get_points())
    valid, tvalid = src.valid.clone(), tgt.valid.clone()
    if case == "invalid_targets":
        tvalid[::3] = False
    elif case == "no_target":
        tvalid[:] = False
    elif case == "single_row":
        pts, valid = pts[:1].contiguous(), valid[:1].contiguous()
    d2, idx = knn_d2(tgt.points, pts, k=1, valid_points=tvalid)
    d2, idx = d2[:, 0].contiguous(), idx[:, 0].contiguous()
    if case == "no_inlier":
        valid[:] = False
    elif case == "one_row":
        valid[:] = False
        valid[7] = True
    elif case == "ties":
        d2 = torch.round(d2 * 1e3) / 1e3
    return {"T": T, "d2": d2, "idx": idx, "src_pts": pts, "src_valid": valid,
            "tgt_pts": tgt.points, "tgt_normals": tgt.normals}


def _x6_update_f64(stats, T):
    """The update X6 makes from its own dx (stats[31:37]), in float64:
    (delta @ T in float64, dx)."""
    from depth_correction_tpu_torch.ops.se3 import xyz_axis_angle_to_matrix

    dx = stats[31:37].double().cpu()
    return xyz_axis_angle_to_matrix(torch.cat([dx[3:], dx[:3]])) @ T.double().cpu(), dx


def _x6(x, q):
    """One step of X6 through ``icp_update`` with its stats: (T, err, stats
    on the CPU)."""
    from depth_correction_tpu_torch.ops.icp import icp_update

    stats = torch.empty(_kernels.ICP_STATS, dtype=torch.float64, device=x["T"].device)
    T, err = icp_update(*x.values(), q, stats=stats)
    return T, err, stats.cpu()


def _upper(H):
    rows, cols = torch.triu_indices(6, 6)
    return H[rows, cols]


@pytest.mark.cuda
@pytest.mark.parametrize("case,q", [("box", 0.8), ("box", 1.0), ("ties", 0.8), ("one_row", 0.8),
                                    ("single_row", 0.8), ("invalid_targets", 0.8)])
def test_cuda_icp_solve_matches_plain(cuda_device, case, q):
    """X6 against its plain twin on the same float32 inputs (and the twin in
    float64 on them cast up), with every part of the step compared:

    - the threshold: bit for bit masked_quantile's over sqrt(d2) and the
      device pick's (test_torch_icp_step.inlier_threshold_plain): the same
      sorted values and the same float32 operations, each rounded on its own;
    - the ok rows and the inliers: equal (the same threshold and distances);
    - H and g: X6 sums exact float64 products of float32 J and r; against
      float64 sums of the twin's float32 J and r, within 1e-6 of the sums'
      scale (sum |J_a J_b|, sum |J_a r|): the library's cross product and
      sums may round a factor differently by an ulp (6e-8);
    - dx and T: X6's dx within 1e-14 cond(H) (at least 1e-12) of a float64
      solve of its own H and g (two backward-stable solves), and T within an
      ulp of float32 of delta(dx) @ T in float64;
    - T against the float64 twin within 2e-6 (X6 stores float32: half an
      ulp at |T| < 16 m is 9.5e-7, and J is float32), and against the
      float32 twin within 2e-5 (the twin's float32 sums carry ~1e-6 of H,
      which dx inherits times H's conditioning), but where one valid row
      makes H singular in float32: the 1e-9 of the twin's H + 1e-9 I is
      lost in float32 and its solve is no answer;
    - err: equal to X6's own float64 sum over its inliers, within 1e-5 of
      the float32 twin's mean (a float32 sum) and 1e-6 of the float64 twin's.
    """
    from test_torch_icp_step import inlier_threshold_plain

    from depth_correction_tpu_torch.ops.icp import icp_update_plain
    from depth_correction_tpu_torch.ops.reduce import masked_quantile

    x = _x6_inputs(cuda_device, case)
    before = _kernels.ICP_SOLVE_LAUNCHES
    T6, err6, stats = _x6(x, q)
    assert _kernels.ICP_SOLVE_LAUNCHES - before == 1
    d2, idx, valid = x["d2"], x["idx"], x["src_valid"]
    ok = (idx >= 0) & valid
    d = torch.sqrt(d2)
    thr = masked_quantile(d, ok, q)
    assert torch.equal(thr.cpu().view(torch.int32),
                       torch.tensor(float(stats[30]), dtype=torch.float32).view(torch.int32))
    assert torch.equal(inlier_threshold_plain(d2, ok, q).cpu(), thr.cpu())
    w = ok & (d <= thr)
    assert int(stats[29]) == int(ok.sum()) and int(stats[28]) == int(w.sum())
    # The twin's float32 J and r, summed in float64.
    i = torch.clamp(x["idx"], min=0).long()
    qp, n = x["tgt_pts"][i], x["tgt_normals"][i]
    r = (n * (qp - x["src_pts"])).sum(-1)
    J = torch.cat([torch.linalg.cross(x["src_pts"], n), n], -1)
    J64, r64, w64 = J.double().cpu(), r.double().cpu(), w.double().cpu()
    H = (J64 * w64[:, None]).T @ J64
    g = (J64 * w64[:, None]).T @ r64
    h_scale = (J64.abs() * w64[:, None]).T @ J64.abs()
    g_scale = (J64.abs() * w64[:, None]).T @ r64.abs()
    assert bool(((stats[:21] - _upper(H)).abs() <= 1e-6 * _upper(h_scale) + 1e-30).all())
    assert bool(((stats[21:27] - g).abs() <= 1e-6 * g_scale + 1e-30).all())
    assert float(stats[27]) == pytest.approx(float((r64.abs() * w64).sum()), rel=1e-6)
    A = torch.zeros(6, 6, dtype=torch.float64)
    rows, cols = torch.triu_indices(6, 6)
    A[rows, cols] = stats[:21]
    A[cols, rows] = stats[:21]
    want_dx = torch.linalg.solve(A + 1e-9 * torch.eye(6, dtype=torch.float64), stats[21:27])
    want_T, dx = _x6_update_f64(stats, x["T"])
    cond = float(torch.linalg.cond(A + 1e-9 * torch.eye(6, dtype=torch.float64)))
    assert float((dx - want_dx).abs().max()) <= \
        max(1e-14 * cond, 1e-12) * float(want_dx.abs().max()) + 1e-300
    T6c = T6.cpu().double()
    assert bool(((T6c - want_T).abs() <= want_T.abs() * 2.0 ** -23 + 1e-12).all())
    assert float(err6) == np.float32(float(stats[27]) / max(float(stats[28]), 1.0))
    # Against the twins.
    x64 = {k: (v.double() if v.is_floating_point() else v) for k, v in x.items()}
    T64, err64 = icp_update_plain(*x64.values(), q)
    T32, err32 = icp_update_plain(*x.values(), q)
    gap64 = float((T6c - T64.cpu()).abs().max())
    gap32 = float((T6c - T32.cpu().double()).abs().max())
    print("X6 %s q=%.1f: %d ok rows, %d inliers; T gap to the float64 twin %.3e, to the float32 "
          "twin %.3e; err %.9g (twins %.9g, %.9g)" % (case, q, int(stats[29]), int(stats[28]),
                                                       gap64, gap32, float(err6), float(err32),
                                                       float(err64)))
    assert gap64 <= 2e-6
    if case not in ("one_row", "single_row"):
        assert gap32 <= 2e-5
    assert float(err6) == pytest.approx(float(err32), rel=1e-5)
    assert float(err6) == pytest.approx(float(err64), rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_inlier", "no_target"])
def test_cuda_icp_solve_without_inliers_leaves_T(cuda_device, case):
    """No ok row (no valid source row, or no valid target): k = 0 gives the
    threshold NaN, as masked_quantile does, so no row is an inlier; H is
    1e-9 I and g 0, so dx is 0 and T comes back bit for bit, err 0."""
    x = _x6_inputs(cuda_device, case)
    T6, err6, stats = _x6(x, 0.8)
    assert torch.equal(T6.view(torch.int32), x["T"].view(torch.int32))
    assert float(err6) == 0.0
    assert int(stats[29]) == 0 and int(stats[28]) == 0 and math.isnan(float(stats[30]))
    assert bool((stats[:28] == 0).all()) and bool((stats[31:37] == 0).all())


@pytest.mark.cuda
def test_cuda_icp_solve_is_bit_equal_run_to_run(cuda_device):
    """Fixed-order float64 sums (no float atomics): two launches on the same
    inputs, with other work between them, give the same bits; so does the
    step without stats (the SLAM path's)."""
    from depth_correction_tpu_torch.ops.icp import icp_update

    x = _x6_inputs(cuda_device)
    a = _x6(x, 0.8)
    torch.randn(1 << 20, device=cuda_device).sort()
    b = _x6(x, 0.8)
    c = icp_update(*x.values(), 0.8)
    assert torch.equal(a[0].view(torch.int32), c[0].view(torch.int32))
    assert torch.equal(a[1].view(torch.int32), c[1].view(torch.int32))
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
    assert torch.equal(a[2].view(torch.int64), b[2].view(torch.int64))


@pytest.mark.cuda
def test_cuda_icp_update_never_takes_the_plain_twin(cuda_device, monkeypatch):
    """A CUDA float32 step launches X6; the twin is never called, and a
    float64 step without ``plain`` raises instead of falling back."""
    from depth_correction_tpu_torch.ops import icp as ticp

    def refuse(*args, **kw):
        raise AssertionError("took the plain twin")

    x = _x6_inputs(cuda_device)
    monkeypatch.setattr(ticp, "icp_update_plain", refuse)
    before = _kernels.ICP_SOLVE_LAUNCHES
    T, err = ticp.icp_update(*x.values(), 0.8)
    assert _kernels.ICP_SOLVE_LAUNCHES - before == 1 and T.shape == (4, 4)
    x64 = {k: (v.double() if v.is_floating_point() else v) for k, v in x.items()}
    with pytest.raises(TypeError, match="float32"):
        ticp.icp_update(*x64.values(), 0.8)


@pytest.mark.cuda
def test_cuda_icp_align_reads_nothing_back(cuda_device):
    """A whole alignment of 8 iterations (X3 and X6 each step) runs between
    T0's upload and T's read with every host sync an error, and gives the
    result of the same call without the check."""
    from depth_correction_tpu_torch.slam_eval import icp_align

    clouds, poses, prior = _box_pair()
    src, tgt = (c.to(device=cuda_device, dtype=torch.float32) for c in clouds)
    tgt = tgt.transform(torch.as_tensor(poses[0], dtype=torch.float32,
                                        device=cuda_device)).with_points()
    T0 = torch.as_tensor(prior[1], dtype=torch.float32, device=cuda_device)
    want = icp_align(src, tgt, T0=T0, n_iters=8)[0].cpu()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T, err = icp_align(src, tgt, T0=T0, n_iters=8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(T.cpu(), want) and math.isfinite(float(err))


@pytest.mark.cuda
def test_cuda_slam_odometry_launches_x6_each_iteration(cuda_device):
    """slam_odometry over S scans at n_iters: X3 and X6 each (S - 1) n_iters
    launches; plain, neither."""
    from depth_correction_tpu_torch.slam_eval import slam_odometry

    clouds, _, prior = _box_pair(3)
    clouds32 = [c.to(device=cuda_device, dtype=torch.float32) for c in clouds]
    for n_iters in (8, 3):
        before = (_kernels.KNN_LAUNCHES, _kernels.ICP_SOLVE_LAUNCHES)
        slam_odometry(clouds32, prior, n_iters=n_iters)
        assert (_kernels.KNN_LAUNCHES - before[0],
                _kernels.ICP_SOLVE_LAUNCHES - before[1]) == (2 * n_iters, 2 * n_iters)
    before = (_kernels.KNN_LAUNCHES, _kernels.ICP_SOLVE_LAUNCHES)
    slam_odometry(clouds32, prior, n_iters=2, plain=True)
    assert (_kernels.KNN_LAUNCHES, _kernels.ICP_SOLVE_LAUNCHES) == before


@pytest.mark.cuda
def test_cuda_slam_takes_the_nearest_search(cuda_device):
    """slam_odometry and slam_mapper over S scans at n_iters: every X3
    launch is the nearest search, (S - 1) n_iters of them; plain, none."""
    from depth_correction_tpu_torch.slam_eval import slam_mapper, slam_odometry

    clouds, _, prior = _box_pair(3)
    clouds32 = [c.to(device=cuda_device, dtype=torch.float32) for c in clouds]
    for fn in (slam_odometry, slam_mapper):
        for n_iters in (8, 3):
            before = (_kernels.KNN_LAUNCHES, _kernels.KNN_NEAREST_LAUNCHES)
            fn(clouds32, prior, n_iters=n_iters)
            assert (_kernels.KNN_LAUNCHES - before[0],
                    _kernels.KNN_NEAREST_LAUNCHES - before[1]) == (2 * n_iters, 2 * n_iters)
        before = _kernels.KNN_NEAREST_LAUNCHES
        fn(clouds32, prior, n_iters=2, plain=True)
        assert _kernels.KNN_NEAREST_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("size", [4, 3])
def test_cuda_sharded_cellwin_matches_single(cuda_device, size):
    """The sharded step's per-rank launches, rehearsed in one process
    (``parallel.cellwin_shard.rehearse``: K1 on each rank's row tiles with
    the empty padding tiles, K2 on each rank's point tiles against the
    joined 12-row blocks), equal the single launches bit for bit; and X2
    on each rank's query slice equals the single search."""
    from types import SimpleNamespace

    from depth_correction_tpu_torch.ops.grid_hash import grid_radius_neighbors
    from depth_correction_tpu_torch.parallel.collectives import query_slice
    from depth_correction_tpu_torch.parallel.cellwin_shard import rehearse

    pts, g = _slice_graph(3000, 0.4, 2, 64)  # 89 row tiles: padding at 3 and 4
    dev = tcw.graph_to_device(g, cuda_device)
    ps = torch.as_tensor(pts, dtype=torch.float32, device=cuda_device)[dev.perm].contiguous()
    args = (dev.q_est, dev.est_sorted, dev.f_start, dev.f_len, dev.f_ctr, dev.r2)
    raw = tcw.cellwin_fwd(ps, *args)
    gen = torch.Generator().manual_seed(size)
    gr = torch.randn((10, raw.shape[1]), generator=gen).to(cuda_device)
    gr = torch.where((dev.row_map >= 0)[None], gr, torch.zeros_like(gr))
    table = _cotangent_table(raw[0:3], raw[9], (gr[0:3], tuple(gr[3:9]))).contiguous()
    grad = tcw.cellwin_bwd(ps, dev.q_est, dev.est_sorted, table, dev.b_start, dev.b_len,
                           dev.b_ctr, dev.r2)
    f0, b0 = tcw.FWD_LAUNCHES, tcw.BWD_LAUNCHES
    raw_s, grad_s = rehearse(ps, dev, size, gr)
    assert (tcw.FWD_LAUNCHES - f0, tcw.BWD_LAUNCHES - b0) == (size, size)
    assert torch.equal(raw_s, raw) and torch.equal(grad_s, grad)

    p, valid = ps, torch.ones(ps.shape[0], dtype=torch.bool, device=cuda_device)
    valid[::13] = False
    d1, i1 = grid_radius_neighbors(p, r=0.4, k=64, valid_points=valid, valid_query=valid)
    parts = []
    for rank in range(size):
        lo, hi, _ = query_slice(p.shape[0], SimpleNamespace(rank=rank, size=size))
        parts.append(grid_radius_neighbors(p, p[lo:hi], r=0.4, k=64, valid_points=valid,
                                           valid_query=valid[lo:hi]))
    assert torch.equal(torch.cat([x[0] for x in parts]), d1)
    assert torch.equal(torch.cat([x[1] for x in parts]), i1)


# ---------------------------------------------------------------------------
# The gather engine's backward over a transpose graph: X4 (the moments' VJP)
# and X5 (the pair gather's VJP).


def _transpose_case(case: str, device, seed: int = 0):
    """(points (M, 3) float32, neighbors, weights float32, M) of one
    seeded graph: ``empty`` (no pair), ``in_degree_0`` (half the points
    referenced by no row), ``hub`` (a point in 500 pairs), ``k32`` (32
    columns, -1 padded) or ``uncapped`` (a within-r table of its widest
    row)."""
    rng = np.random.default_rng(seed)
    m = 6000
    pts = rng.uniform(-3, 3, (m, 3)) + np.array([400.0, -250.0, 30.0])
    if case == "empty":
        nn = np.full((200, 32), -1)
    elif case == "in_degree_0":
        nn = rng.integers(0, m // 2, (4000, 32))
        nn[rng.uniform(size=nn.shape) < 0.2] = -1
    elif case == "hub":
        nn = rng.integers(0, m, (4000, 32))
        nn[:500, 5] = 11
    elif case == "k32":
        nn = rng.integers(-1, m, (5000, 32))
    elif case == "uncapped":
        nn = uncapped_graph(pts, 0.5)
    else:
        raise ValueError(case)
    w = (nn >= 0) * rng.uniform(0.5, 1.5, nn.shape)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return t(pts, torch.float32), t(nn, torch.int64), t(w, torch.float32), m


TRANSPOSE_CASES = ["empty", "in_degree_0", "hub", "k32", "uncapped"]


def test_transpose_wrappers_never_take_the_plain_path(monkeypatch):
    """Non-CPU tensors go to the X4 / X5 launchers, never to the plain
    versions."""
    calls = []

    def fake_launch(*args, **kw):
        calls.append(args)
        raise RuntimeError("launched")

    for name in ("launch_transpose_moments", "launch_transpose_gather"):
        monkeypatch.setattr(_kernels, name, fake_launch)
    pts, nn, w, m = _transpose_case("k32", "cpu")
    tg = tfeat.build_transpose_graph(nn, pts, w).to("meta")
    with pytest.raises(RuntimeError, match="launched"):
        tfeat.transpose_moments(pts.to("meta"), tg, torch.zeros((nn.shape[0], 12), device="meta"))
    with pytest.raises(RuntimeError, match="launched"):
        tfeat.transpose_gather(torch.zeros(tuple(nn.shape) + (3,), device="meta"), tg)
    assert len(calls) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRANSPOSE_CASES)
def test_cuda_transpose_moments_matches_plain(cuda_device, case):
    """X4 against its plain version in float64 on the same inputs, within
    GRAD_REL_BAR of max |grad|; two launches bit-equal (no atomics); a point
    with no pairs exactly 0."""
    pts, nn, w, m = _transpose_case(case, cuda_device)
    tg = tfeat.build_transpose_graph(nn, pts, w)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    mean, comps, w_sum = tfeat.gather_moments(pts, nn, w)
    cot = (torch.randn(mean.shape, generator=gen, device=cuda_device),
           torch.randn(comps.shape, generator=gen, device=cuda_device))
    table = tfeat._cotangent_rows(mean, w_sum, cot)
    before = _kernels.TRANSPOSE_MOMENTS_LAUNCHES
    got = tfeat.transpose_moments(pts, tg, table)
    again = tfeat.transpose_moments(pts, tg, table)
    torch.cuda.synchronize()
    assert _kernels.TRANSPOSE_MOMENTS_LAUNCHES == before + 2
    assert torch.equal(got, again)
    ref = tfeat.transpose_moments_plain(pts.double(), tg.to(dtype=torch.float64),
                                        table.double())
    deg = tg.in_degree()
    assert torch.equal(got[deg == 0], torch.zeros_like(got[deg == 0]))
    err = float((got.double() - ref).abs().max())
    assert err <= GRAD_REL_BAR * max(float(ref.abs().max()), 1e-30)
    if case == "hub":
        assert int(deg[11]) >= 500


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRANSPOSE_CASES)
@pytest.mark.parametrize("dim", [1, 3])
def test_cuda_transpose_gather_matches_plain(cuda_device, case, dim):
    """X5 against its plain version in float64, D = 1 and 3, within
    GRAD_REL_BAR of max |grad|; two launches bit-equal."""
    pts, nn, _, m = _transpose_case(case, cuda_device)
    tg = tfeat.build_transpose_graph(nn, pts)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    g = torch.randn(tuple(nn.shape) + ((dim,) if dim == 3 else ()), generator=gen,
                    device=cuda_device)
    before = _kernels.TRANSPOSE_GATHER_LAUNCHES
    got, again = tfeat.transpose_gather(g, tg), tfeat.transpose_gather(g, tg)
    torch.cuda.synchronize()
    assert _kernels.TRANSPOSE_GATHER_LAUNCHES == before + 2
    assert torch.equal(got, again)
    ref = tfeat.transpose_gather_plain(g.double(), tg)
    assert got.shape == ref.shape
    err = float((got.double() - ref).abs().max())
    assert err <= GRAD_REL_BAR * max(float(ref.abs().max()), 1e-30)


def _hub_tiles(tg) -> int:
    """The tiles past the budget (X4 reads their rows from global memory)."""
    t = tg.tiles
    return int(((t.row_start[1:] - t.row_start[:-1]) > t.budget).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [tfeat.TILE_ROWS, 64])
@pytest.mark.parametrize("case", TRANSPOSE_CASES)
def test_cuda_transpose_tiles_match_plain(cuda_device, case, budget, monkeypatch):
    """X4 and X5 (D = 1 and 3) over cell-ordered tiles at the default budget
    and at 64 rows (the hub's tile and others past it take the hub path)
    against the float64 plain versions, within GRAD_REL_BAR of max
    |output|; two launches bit-equal; the launches counted."""
    pts, nn, w, m = _transpose_case(case, cuda_device)
    monkeypatch.setattr(tfeat, "TILE_ROWS", budget)
    tg = tfeat.build_transpose_graph(nn, pts, w)
    if case == "hub" and budget == 64:
        assert _hub_tiles(tg) >= 1
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    mean, comps, w_sum = tfeat.gather_moments(pts, nn, w)
    table = tfeat._cotangent_rows(mean, w_sum,
                                  (torch.randn(mean.shape, generator=gen, device=cuda_device),
                                   torch.randn(comps.shape, generator=gen, device=cuda_device)))
    before = (_kernels.TRANSPOSE_MOMENTS_LAUNCHES, _kernels.TRANSPOSE_GATHER_LAUNCHES)
    runs = [(tfeat.transpose_moments(pts, tg, table), tfeat.transpose_moments(pts, tg, table),
             tfeat.transpose_moments_plain(pts.double(), tg.to(dtype=torch.float64),
                                           table.double()))]
    for dim in (1, 3):
        g = torch.randn(tuple(nn.shape) + ((3,) if dim == 3 else ()), generator=gen,
                        device=cuda_device)
        runs.append((tfeat.transpose_gather(g, tg), tfeat.transpose_gather(g, tg),
                     tfeat.transpose_gather_plain(g.double(), tg)))
    torch.cuda.synchronize()
    assert (_kernels.TRANSPOSE_MOMENTS_LAUNCHES, _kernels.TRANSPOSE_GATHER_LAUNCHES) == (
        before[0] + 2, before[1] + 4)
    for got, again, ref in runs:
        assert got.shape == ref.shape and torch.equal(got, again)
        bar = GRAD_REL_BAR * max(float(ref.abs().max()), 1e-30)
        assert float((got.double() - ref).abs().max()) <= bar


@pytest.mark.cuda
def test_cuda_transpose_without_tiles_raises(cuda_device):
    """A TransposeGraph without its tiles (its cell-order CSR alone) raises
    on CUDA tensors before any launch."""
    pts, nn, w, m = _transpose_case("k32", cuda_device)
    tg = tfeat.build_transpose_graph(nn, pts, w)
    bare = dataclasses.replace(tg, tiles=None)
    table = torch.zeros((nn.shape[0], 12), device=cuda_device)
    g = torch.zeros(tuple(nn.shape) + (3,), device=cuda_device)
    before = (_kernels.TRANSPOSE_MOMENTS_LAUNCHES, _kernels.TRANSPOSE_GATHER_LAUNCHES)
    with pytest.raises(ValueError, match="tiles"):
        tfeat.transpose_moments(pts, bare, table)
    with pytest.raises(ValueError, match="tiles"):
        tfeat.transpose_gather(g, bare)
    assert (_kernels.TRANSPOSE_MOMENTS_LAUNCHES, _kernels.TRANSPOSE_GATHER_LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [tfeat.TILE_ROWS - 1, tfeat.TILE_ROWS])
def test_cuda_transpose_moments_tile_at_the_budget(cuda_device, rows):
    """X4 on a graph whose largest tile within the budget stages ``rows``
    rows (up to TILE_ROWS, 48 KB of shared memory) beside a hub tile in the
    same launch: against the float64 plain version within GRAD_REL_BAR of
    max |grad|, and bit-equal between two launches. The targets
    0..127 (one block) are referenced by ``rows`` one-per-row pairs plus
    a second neighbour each; target 200 by 1,100 rows of its own."""
    hub_rows = 1100
    rng = np.random.default_rng(12)
    m = 256
    nn = np.full((rows + hub_rows, 2), -1)
    nn[:rows, 0] = np.arange(rows) % 128
    nn[:rows, 1] = (7 * np.arange(rows) + 3) % 128
    nn[rows:, 0] = 200
    w = (nn >= 0) * rng.uniform(0.5, 1.5, nn.shape)
    pts = torch.as_tensor(rng.uniform(-3, 3, (m, 3)) + np.array([400.0, -250.0, 30.0]),
                          dtype=torch.float32, device=cuda_device)
    nn = torch.as_tensor(nn, device=cuda_device)
    w = torch.as_tensor(w, dtype=torch.float32, device=cuda_device)
    # Positions on a line: the cell order is the index order.
    line = torch.zeros((m, 3), dtype=torch.float64, device=cuda_device)
    line[:, 0] = torch.arange(m, dtype=torch.float64, device=cuda_device)
    tg = tfeat.build_transpose_graph(nn, line, w)
    assert tg.tiles.rows_max == rows and _hub_tiles(tg) == 1
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    mean, comps, w_sum = tfeat.gather_moments(pts, nn, w)
    table = tfeat._cotangent_rows(mean, w_sum,
                                  (torch.randn(mean.shape, generator=gen, device=cuda_device),
                                   torch.randn(comps.shape, generator=gen, device=cuda_device)))
    got = tfeat.transpose_moments(pts, tg, table)
    again = tfeat.transpose_moments(pts, tg, table)
    torch.cuda.synchronize()
    ref = tfeat.transpose_moments_plain(pts.double(), tg.to(dtype=torch.float64),
                                        table.double())
    bar = GRAD_REL_BAR * float(ref.abs().max())
    assert torch.equal(got, again)
    assert float((got.double() - ref).abs().max()) <= bar


@pytest.mark.cuda
def test_cuda_moments_gradient_takes_x4(cuda_device):
    """neighborhood_moments on the card: P7 forward, X4 backward, once
    each; the gradient within GRAD_REL_BAR of the float64 plain path;
    without a transpose the gradient path raises."""
    pts, nn, w, m = _transpose_case("uncapped", cuda_device)
    tg = tfeat.build_transpose_graph(nn, pts, w)
    gw = torch.randn(nn.shape[0], generator=torch.Generator(device=cuda_device).manual_seed(6),
                     device=cuda_device, dtype=torch.float64)

    def objective(p, tg, plain):
        mean, comps = tfeat.neighborhood_moments(p, nn, w, tg, plain=plain)
        return (gw * (comps[0] + 0.3 * comps[4] + 0.01 * mean[2])).sum()

    p32 = pts.clone().requires_grad_()
    before = (_kernels.GATHER_LAUNCHES, _kernels.TRANSPOSE_MOMENTS_LAUNCHES)
    objective(p32, tg, False).backward()
    torch.cuda.synchronize()
    assert (_kernels.GATHER_LAUNCHES, _kernels.TRANSPOSE_MOMENTS_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    p64 = pts.double().requires_grad_()
    objective(p64, tg.to(dtype=torch.float64), True).backward()
    err = float((p32.grad.double() - p64.grad).abs().max())
    assert err <= GRAD_REL_BAR * float(p64.grad.abs().max())
    with pytest.raises(ValueError, match="transpose"):
        objective(pts.clone().requires_grad_(), None, False)


@pytest.mark.cuda
def test_cuda_gather_moments_centred_matches_plain(cuda_device):
    """P7's two-pass form (the gather engine's differentiable forward) on
    points 500 m from the origin: within 1e-5 of max |output| of the
    float64 plain version, the mean and w_sum as the single pass's within
    the same bar; one P7 launch counted."""
    pts, nn, w, _ = _transpose_case("uncapped", cuda_device)
    before = _kernels.GATHER_LAUNCHES
    got = tfeat.gather_moments(pts, nn, w, centred=True)
    single = tfeat.gather_moments(pts, nn, w)
    torch.cuda.synchronize()
    assert _kernels.GATHER_LAUNCHES == before + 2
    ref = tfeat.gather_moments_plain(pts.double(), nn, w.double())
    for g, o, r in zip(got, single, ref):
        scale = float(r.abs().max())
        assert float((g.double() - r).abs().max()) <= 1e-5 * scale
        assert float((g - o).abs().max()) <= 1e-5 * scale
