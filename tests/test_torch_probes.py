"""The port's probes P1-P6 and P8 against the JAX package's scripts
(float64 unless said otherwise, CPU).

P1: scripts/exp_cellwin_knockout.py's ``make_kernel`` runs in Pallas
interpret mode with the grid of its ``run_variant`` (the JAX package's
``_fwd_call``), on the JAX graph of a seeded scene; the port's plain
knockout versions run on the port's (bit-equal) graph.

P2-P5: the Pallas kernels of scripts/exp_mosaic_dot_probe{,2,3,4}.py are
closures inside their ``main()``, so each body is restated here in jnp,
citing the script's lines, and fed the script's seeded data at a reduced
tile count T1. The restatements compute membership in float32 as the
scripts do (they are float32 programs) and everything else in float64. The
scripts' precision variants map to the port's (ops/moment_dot.py): the
bf16 splits become TF32 splits, written here with jnp bit masks.

P6: scripts/exp_mosaic_probe.py's ``k_*`` bodies run through
``pl.pallas_call(..., interpret=True)`` on the script's float32 input (and
with x[0, 0] = 200); their outputs are small integers, so the port's plain
versions must equal them. P8: scripts/exp_pallas_gather2.py's kernel
bodies (``jnp.take_along_axis`` / ``jnp.take``) restated in jnp on the
script's draws; error 0. P7a: scripts/exp_pallas_gather.py's stage-1
``probe_kernel`` (a closure of its ``main()``, restated with its lines
cited) through ``pl.pallas_call(..., interpret=True)`` on the script's
draws, against the port's plain version within 1e-6 relative.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from depth_correction_tpu.ops import cellwin as jcw
from depth_correction_tpu.ops.features import permute_rows as j_permute_rows
from depth_correction_tpu_torch.ops import cellwin as tcw
from depth_correction_tpu_torch.ops.cellwin_knockout import cellwin_knockout
from depth_correction_tpu_torch.ops.features import permute_rows as t_permute_rows
from depth_correction_tpu_torch.ops.gather_probe import FORMS, gather_probe
from depth_correction_tpu_torch.ops.gather_sum import gather_sum, gather_sum_plain
from depth_correction_tpu_torch.ops.layout_probe import PROBES, layout_probe
from depth_correction_tpu_torch.ops.moment_dot import TPU_VARIANTS, moment_dot
from depth_correction_tpu_torch.ops.moment_window import moment_window
from depth_correction_tpu_torch.scripts import exp_mosaic_dot_probe as p2
from depth_correction_tpu_torch.scripts import exp_mosaic_dot_probe2 as p3
from depth_correction_tpu_torch.scripts import exp_mosaic_dot_probe3 as p4
from depth_correction_tpu_torch.scripts import exp_mosaic_dot_probe4 as p5
from depth_correction_tpu_torch.scripts import exp_mosaic_probe as p6
from depth_correction_tpu_torch.scripts import exp_pallas_gather as p7
from depth_correction_tpu_torch.scripts import exp_pallas_gather2 as p8
from test_torch_kernels import scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T1 = 3  # reduced tile count of the P2-P5 checks


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# P1: the knockout modes against the TPU probe's kernel.


@pytest.fixture(scope="module")
def knockout_graphs():
    pts, qrows, nn = scene(1500, 0.35, 1)
    kw = dict(row_cap=64, pt_cap=64, span_limit=256)
    valid = np.ones(len(pts), bool)
    gj = jcw.build_cellwin_graph(pts, valid, qrows, nn, 0.35, **kw)
    gt = tcw.build_cellwin_graph(pts, valid, qrows, nn, 0.35, **kw)
    return pts, gj, gt


def _jax_knockout(pts, gj, mode):
    """scripts/exp_cellwin_knockout.py:make_kernel on the grid of its
    run_variant (:179-210), interpret mode, float64 -> raw (16, mq_pad)."""
    make_kernel = _load_script("exp_cellwin_knockout").make_kernel
    dev = jcw.graph_to_device(gj)
    t1, r_cap, s_cap, ns_f, _, _, _, _, r2 = dev.dims
    p = j_permute_rows(jnp.asarray(pts), dev.perm, dev.inv)
    m_pad, dt = p.shape[0], p.dtype
    mq_pad = dev.q_est.shape[1]
    c_tab = jnp.concatenate([
        jnp.concatenate([p.T, jnp.zeros((3, s_cap), dt)], 1),
        jnp.concatenate([dev.est_sorted[:3].astype(dt), jnp.full((3, s_cap), 1e15, dt)], 1),
        jnp.zeros((2, m_pad + s_cap), dt),
    ], axis=0)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4, grid=(t1,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec((8, r_cap), lambda t, *_: (0, t), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((16, r_cap), lambda t, *_: (0, t), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((ns_f, 8, s_cap), dt), pltpu.SemaphoreType.DMA((ns_f,))],
    )
    out = pl.pallas_call(
        make_kernel(ns_f, s_cap, r2, mode),
        out_shape=jax.ShapeDtypeStruct((16, mq_pad), dt), grid_spec=grid_spec, interpret=True,
    )(dev.f_start.reshape(-1), dev.f_lead.reshape(-1), dev.f_len.reshape(-1),
      dev.f_ctr.reshape(-1), c_tab, dev.q_est.astype(dt))
    return np.asarray(out), np.asarray(dev.f_ctr), r_cap


@pytest.mark.parametrize("mode", ["full", "no_d2", "no_feats", "empty"])
def test_knockout_plain_matches_jax_probe(knockout_graphs, mode):
    pts, gj, gt = knockout_graphs
    acc, ctr, r_cap = _jax_knockout(pts, gj, mode)
    dev = tcw.graph_to_device(gt)
    ps = t_permute_rows(torch.as_tensor(pts), dev.perm, dev.inv)
    got = cellwin_knockout(ps, dev.q_est, dev.est_sorted, dev.f_start, dev.f_len, dev.f_ctr,
                           dev.r2, mode).numpy()
    rows = gt.row_map >= 0
    if mode == "empty":  # both write q's x, y, z
        np.testing.assert_array_equal(got[0:3], acc[0:3])
        assert not got[3:].any()
        return
    if mode == "no_feats":  # every sum is the member count
        np.testing.assert_array_equal(got[:, rows], acc[0:10][:, rows])
        assert got[0, rows].min() >= 1
        return
    if mode == "no_d2":  # every span entry a member: the count is sum(len)
        np.testing.assert_array_equal(got[0, rows], acc[0, rows])
        np.testing.assert_array_equal(
            got[0], np.repeat(gt.f_span_len.sum(1), r_cap).astype(got.dtype))
        return
    # full: the TPU probe's raw tile-centred sums through _fwd_kernel's
    # epilogue (depth_correction_tpu/ops/cellwin.py:814-832).
    s0 = acc[0]
    np.testing.assert_array_equal(got[9, rows], np.maximum(s0, 1e-12)[rows])
    s0c = np.maximum(s0, 1e-12)
    m = acc[1:4] / s0c
    c = np.repeat(ctr, r_cap, axis=0).T
    den = np.maximum(s0 - 1.0, 1e-6)
    pairs = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    cov = np.stack([(acc[4 + k] - s0 * m[i] * m[j]) / den for k, (i, j) in enumerate(pairs)])
    np.testing.assert_allclose(got[0:3, rows], (m + c)[:, rows], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got[3:9, rows], cov[:, rows], rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# P2-P5: the scripts' bodies restated in jnp.


def _trunc(x):
    """TF32 truncation of float64 values (10 mantissa bits kept)."""
    bits = jax.lax.bitcast_convert_type(x, jnp.int64) & jnp.int64(-(1 << 42))
    return jax.lax.bitcast_convert_type(bits, jnp.float64)


def _dot(a, b, variant):
    """One span's product in the TPU script's variant, TF32 for bf16."""
    prec = TPU_VARIANTS.get(variant, variant)
    if prec == "fp32":
        return a @ b
    b = _trunc(b)
    hi = _trunc(a)
    if prec == "tf32":
        return hi @ b
    rem = a - hi
    mid = _trunc(rem)
    if prec == "tf32x2":
        return hi @ b + mid @ b
    return hi @ b + mid @ b + _trunc(rem - mid) @ b


def _epilogue(acc):
    """scripts/exp_mosaic_dot_probe3.py:86-98."""
    s0 = jnp.maximum(acc[0:1, :], 1e-12)
    m0, m1, m2 = acc[1:2] / s0, acc[2:3] / s0, acc[3:4] / s0
    den = jnp.maximum(acc[0:1, :] - 1.0, 1e-6)
    c00 = (acc[4:5] - s0 * m0 * m0) / den
    c11 = (acc[5:6] - s0 * m1 * m1) / den
    c22 = (acc[6:7] - s0 * m2 * m2) / den
    z = jnp.zeros_like(s0)
    return jnp.concatenate([m0, m1, m2, c00, c11, c22, acc[7:8], acc[8:9], acc[9:10], s0,
                            z, z, z, z, z, z], axis=0)


def _span_compute(w8, qx, qy, qz, cx, cy, cz, sl_col, sl_row, variant, r2=0.0625):
    """One span of scripts/exp_mosaic_dot_probe4.py:101-129 (and probe2's
    :46-71, probe3's :60-83 with zero shifts): membership in float32 from
    the float32 window and q, features and the dot in float64."""
    S = w8.shape[1]
    f = jnp.float32
    ex = (w8[3:4, :].astype(f) - f(cx)).reshape(S, 1)
    ey = (w8[4:5, :].astype(f) - f(cy)).reshape(S, 1)
    ez = (w8[5:6, :].astype(f) - f(cz)).reshape(S, 1)
    d2 = (ex - qx) ** 2 + (ey - qy) ** 2 + (ez - qz) ** 2
    wm = jnp.where((d2 <= f(r2)) & sl_col, 1.0, 0.0).astype(jnp.float64)
    w64 = w8.astype(jnp.float64)
    x0, x1, x2 = w64[0:1] - cx, w64[1:2] - cy, w64[2:3] - cz
    one = jnp.ones_like(x0)
    feats = jnp.concatenate([one, x0, x1, x2, x0 * x0, x1 * x1, x2 * x2, x0 * x1, x0 * x2,
                             x1 * x2, jnp.zeros((6, S))], axis=0)
    feats = jnp.where(sl_row, feats, 0.0)
    return _dot(feats, wm, variant)


def _q32(q, cx, cy, cz):
    f = jnp.float32
    q = jnp.asarray(q, f)
    return q[0:1, :] - f(cx), q[1:2, :] - f(cy), q[2:3, :] - f(cz)


def _masks(S, ln, lead=None):
    col = jnp.arange(S)[:, None]
    row = jnp.arange(S)[None, :]
    if lead is None:
        return col < ln, row < ln
    return (col >= lead) & (col < lead + ln), (row >= lead) & (row < lead + ln)


@pytest.mark.parametrize("variant", ["default", "highest", "split2_cast", "split2_bits",
                                     "split3_bits"])
def test_moment_dot_plain_matches_probe(variant):
    """exp_mosaic_dot_probe.py:50-82 (every grid step sums the NS span dots
    into the same block) against the port's plain P2, every tile's slot."""
    a, b, oracle = p2.inputs("cpu")
    a64, b64 = a.double(), b.double()
    want = sum(_dot(jnp.asarray(a64[s].numpy()), jnp.asarray(b64[s].numpy()), variant)
               for s in range(p2.NS))
    got = moment_dot(a64, b64, T1, TPU_VARIANTS[variant]).numpy()
    for t in range(T1):
        np.testing.assert_allclose(got[:, t * p2.R:(t + 1) * p2.R], np.asarray(want),
                                   rtol=1e-12, atol=1e-10)
    if variant == "highest":  # the script's own f64 einsum oracle (:91-93)
        np.testing.assert_allclose(got[:, :p2.R], oracle.numpy(), rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("variant", ["default", "highest", "split2_bits", "split3_bits"])
@pytest.mark.parametrize("n_tiles", [1, 5])
@pytest.mark.parametrize("s_len", [8, 72, 640])
@pytest.mark.parametrize("ns", [1, 5])
def test_moment_dot_plain_matches_probe_at_edge_shapes(ns, s_len, n_tiles, variant):
    """exp_mosaic_dot_probe.py:50-82's body (the NS span dots summed into
    one block) against the port's plain P2 at the shapes whose edges the
    kernel handles: one span, a single chunk of 8 k, a ragged last chunk
    (72 = 64 + 8), and one tile or a ragged last block of tiles; the
    script's draws (a normal, b {0, 1} of density 0.3) from a seed per
    shape."""
    rng = np.random.default_rng(1000 * ns + s_len)
    a = rng.normal(size=(ns, 16, s_len))
    b = (rng.random((ns, s_len, p2.R)) < 0.3).astype(np.float64)
    want = np.asarray(sum(_dot(jnp.asarray(a[s]), jnp.asarray(b[s]), variant)
                          for s in range(ns)))
    got = moment_dot(torch.as_tensor(a), torch.as_tensor(b), n_tiles,
                     TPU_VARIANTS[variant]).numpy()
    assert got.shape == (16, p2.R * n_tiles)
    for t in range(n_tiles):
        np.testing.assert_allclose(got[:, t * p2.R:(t + 1) * p2.R], want, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("variant", ["default", "highest", "split2_bits", "split3_bits"])
def test_moment_window_plain_matches_probe2(variant):
    """exp_mosaic_dot_probe2.py:39-71 against the port's plain P3."""
    win, q, ln = p3.inputs("cpu")
    w, qn = win.numpy(), q.numpy()
    qx, qy, qz = _q32(qn, 0.0, 0.0, 0.0)
    sl_col, sl_row = _masks(p3.S, ln)
    want = sum(_span_compute(jnp.asarray(w[s]), qx, qy, qz, 0.0, 0.0, 0.0, sl_col, sl_row,
                             variant) for s in range(p3.NS))
    got = moment_window(win.double(), q.double(), p3.R2, T1, p3.NS, p3.S, ln,
                        TPU_VARIANTS[variant]).numpy()
    for t in range(T1):
        np.testing.assert_allclose(got[:, t * 128:(t + 1) * 128], np.asarray(want),
                                   rtol=1e-10, atol=1e-10)


def _window_want(big, q, starts, lens, ns, ctr=None, leads=None, moving=False, fixed=None,
                 epilogue=True, len0=False):
    """Per tile, the span loop of exp_mosaic_dot_probe3.py (kA-kE) /
    exp_mosaic_dot_probe4.py (make_variant): windows from ``fixed`` or DMA'd
    from ``big`` at the tile's starts; per-tile q, shifts and lead masks as
    given; the epilogue. ``len0``: every span takes span 0's length
    (probe3's len_ref[t * NS])."""
    S, R = p4.S, 128
    outs = []
    for t in range(T1):
        cx, cy, cz = (float(ctr[t, k]) for k in range(3)) if ctr is not None else (0.0,) * 3
        qt = q[:, t * R:(t + 1) * R] if moving else q
        qx, qy, qz = _q32(qt, cx, cy, cz)
        acc = jnp.zeros((16, R))
        for s in range(ns):
            ln = int(lens[t, 0 if len0 else s]) if lens is not None else S - 37
            lead = int(leads[t, s]) if leads is not None else None
            sl_col, sl_row = _masks(S, ln, lead)
            w8 = fixed[s] if fixed is not None else big[:, starts[t, s]:starts[t, s] + S]
            acc = acc + _span_compute(jnp.asarray(w8), qx, qy, qz, cx, cy, cz, sl_col, sl_row,
                                      "split3_bits")
        outs.append(_epilogue(acc) if epilogue else acc)
    return np.concatenate([np.asarray(o) for o in outs], axis=1)


def _wide(kw):
    return {k: (v.double() if k == "ctr" else v) for k, v in kw.items()}


@pytest.mark.parametrize("name", p4.VARIANTS)
def test_moment_window_plain_matches_probe3(monkeypatch, name):
    """exp_mosaic_dot_probe3.py:129-222 (A-E) against the port's plain P4,
    on the script's draws at T1 tiles."""
    monkeypatch.setattr(p4, "T1", T1)
    d = p4.inputs("cpu")
    win, q, kw = p4.variant_args(name, d)
    got = moment_window(win.double(), q.double(), p3.R2, prec=p4.PREC, **_wide(kw)).numpy()
    staged = "starts" in kw
    want = _window_want(d["big"].numpy(), d["q"].numpy(), d["starts"].numpy(),
                        d["lens"].numpy() if isinstance(kw["lens"], torch.Tensor) else None,
                        p4.NS, fixed=None if staged else d["win"].numpy(),
                        epilogue=kw.get("epilogue", False), len0=True)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9)


def test_moment_window_plain_clamps_spans_to_the_table():
    """A staged span's columns outside the table are outside the span: the
    same sums as the span's in-table part, cut by leads and lengths on a
    padded table (float64)."""
    rng = np.random.default_rng(3)
    s_len, ncols, pad = 64, 300, 64
    big = torch.as_tensor(rng.normal(scale=0.2, size=(8, ncols)))
    q = torch.as_tensor(rng.normal(scale=0.2, size=(8, 128)))
    starts = torch.tensor([[-50, 10, ncols + 10], [ncols - 20, 200, -500]], dtype=torch.int32)
    lens = torch.full((2, 3), s_len - 5, dtype=torch.int32)
    got = moment_window(big, q, p3.R2, 2, 3, s_len, lens, "tf32x3", starts=starts)
    padded = torch.cat([torch.full((8, pad), 0.1, dtype=big.dtype), big,
                        torch.full((8, pad), 0.1, dtype=big.dtype)], 1)
    leads = (-starts).clamp(min=0)
    cut = torch.minimum(lens, ncols - starts) - leads
    want = moment_window(padded, q, p3.R2, 2, 3, s_len, cut, "tf32x3", starts=starts + pad,
                         leads=leads)
    assert got[0].abs().max() > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", list(p5.VARIANTS))
def test_moment_window_plain_matches_probe4(monkeypatch, name):
    """exp_mosaic_dot_probe4.py:66-186 (E-J) against the port's plain P5,
    on the script's draws (in its order) at T1 tiles."""
    monkeypatch.setattr(p5, "T1", T1)
    big, q, kw = p5.inputs("cpu")[name]
    ns, moving, _, _ = p5.VARIANTS[name]
    got = moment_window(big.double(), q.double(), p3.R2, prec=p5.PREC, **_wide(kw)).numpy()
    want = _window_want(big.numpy(), q.numpy(), kw["starts"].numpy(), kw["lens"].numpy(), ns,
                        ctr=kw["ctr"].numpy() if "ctr" in kw else None,
                        leads=kw["leads"].numpy() if "leads" in kw else None, moving=moving)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9)


# ---------------------------------------------------------------------------
# P6: the layout probes against the script's Pallas bodies (interpret mode).


@pytest.mark.parametrize("first", [None, 200.0])
@pytest.mark.parametrize("name", list(PROBES))
def test_layout_probe_plain_matches_pallas(name, first):
    mod = _load_script("exp_mosaic_probe")
    x = p6.inputs("cpu", first)
    out_shape = mod.o_s8 if PROBES[name][1] == 8 else mod.o_sr
    want = pl.pallas_call(getattr(mod, "k_" + name), out_shape=out_shape,
                          interpret=True)(jnp.asarray(x.numpy()))
    got = layout_probe(x.double(), name).numpy()
    assert got.shape == PROBES[name]
    np.testing.assert_array_equal(got, np.asarray(want))
    if name == "iota_col" and first:
        assert got[:, 0].sum() == first


# ---------------------------------------------------------------------------
# P8: the gather probes against the script's bodies restated in jnp.


@pytest.mark.parametrize("case", ["A", "B", "C", "D", "E"])
def test_gather_probe_plain_matches_script(case):
    """exp_pallas_gather2.py's kA / kC / kE bodies (:35, :61, :86) on its
    draws: take_along_axis along lanes (A, B, D) or sublanes (C), a 1-D take
    (E); both forms' wrappers on CPU tensors give the plain result."""
    x, idx, axis = p8.inputs("cpu")[case]
    xj, ij = jnp.asarray(x.numpy(), jnp.float64), jnp.asarray(idx.numpy())
    want = jnp.take(xj, ij) if case == "E" else jnp.take_along_axis(xj, ij, axis=axis)
    for form in FORMS:
        got = gather_probe(x.double(), idx, axis, form)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) == 0.0


@pytest.mark.parametrize("shape,axis,blocks", [
    ((8, 256), 1, 1), ((8, 131072), 1, 8), ((8, 256), 0, 1), ((2048,), 1, 1),
    ((8, 1024), 1, 1), ((3, 58112), 1, 1), ((3, 58113), 1, 8), ((1, 464896), 1, 8),
    ((1, 464897), 1, 0), ((1000, 100), 0, 0)])
def test_gather_probe_staged_blocks(shape, axis, blocks):
    """Where the staged form's table lives: one block's 227 KB of shared
    memory, a cluster of 8 blocks' (an axis-1 row in slices of a multiple
    of 4 floats), or nowhere (the wrapper then refuses the staged form on a
    card; on the CPU the plain version runs)."""
    from depth_correction_tpu_torch.ops.gather_probe import staged_blocks, staged_fits

    x = torch.zeros(shape)
    assert staged_blocks(x, axis) == blocks
    assert staged_fits(x, axis) == (blocks > 0)


# ---------------------------------------------------------------------------
# P7a: the gather-sum probe against the script's Pallas body (interpret mode).


def _probe_kernel(pts_ref, idx_ref, out_ref):
    """scripts/exp_pallas_gather.py:45-49 (``main.probe_kernel``), as
    written there with the script's T and K."""
    t, k = p7.PROBE_T, p7.PROBE_K
    pts = pts_ref[...]  # (3, M)
    idx = idx_ref[...].reshape(-1)  # (T*K,)
    g = jnp.take(pts, idx, axis=1)  # vector gather from VMEM
    out_ref[...] = jnp.sum(g.reshape(3, t, k), axis=2)


def test_gather_sum_plain_matches_pallas_probe():
    """The script's stage-1 draws (default_rng(0), first): the Pallas body
    in interpret mode (float32, its own summation order) and the port's
    plain version (float32, index order; float64) within 1e-6 of max
    |output|; the wrapper on CPU tensors is the plain version."""
    pts, idx = p7.inputs("cpu")["probe"]
    want = pl.pallas_call(
        _probe_kernel,
        out_shape=jax.ShapeDtypeStruct((3, p7.PROBE_T), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(pts.numpy()), jnp.asarray(idx.numpy()))
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    for got in (gather_sum_plain(pts, idx), gather_sum_plain(pts.double(), idx),
                gather_sum(pts, idx)):
        assert got.shape == (3, p7.PROBE_T)
        assert np.abs(got.double().numpy() - want).max() <= 1e-6 * scale
    assert torch.equal(gather_sum(pts, idx), gather_sum_plain(pts, idx))
