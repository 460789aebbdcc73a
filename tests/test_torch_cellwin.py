"""The port's cell-window engine against the JAX package's (float64, CPU).

The JAX side runs as tests/test_cellwin.py runs it: Pallas in interpret
mode. The port's wrappers take the plain torch kernels for CPU tensors;
tests/test_torch_kernels.py holds the CUDA kernels against those plain
versions on a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from depth_correction_tpu.ops import cellwin as jcw
from depth_correction_tpu.ops.features import permute_rows as j_permute_rows
from depth_correction_tpu_torch.ops import cellwin as tcw
from depth_correction_tpu_torch.ops.features import permute_rows as t_permute_rows
from test_torch_kernels import scene, uncapped_graph


def _exception_setup():
    """A pair exactly at distance r: boundary-ambiguous, so its rows must
    become exception rows (tests/test_cellwin.py:127)."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (400, 3))
    r = 0.5
    pts[1] = pts[0] + np.array([r, 0.0, 0.0])
    return pts, np.arange(len(pts)), uncapped_graph(pts, r), r


def _both_graphs(pts, qrows, nn, r, cap, span_limit=256):
    kw = dict(row_cap=cap, pt_cap=cap, span_limit=span_limit)
    valid = np.ones(len(pts), bool)
    return (jcw.build_cellwin_graph(pts, valid, qrows, nn, r, **kw),
            tcw.build_cellwin_graph(pts, valid, qrows, nn, r, **kw))


CASES = [
    # (n, r, seed, cap)
    (3000, 0.35, 0, 64),
    (1500, 0.35, 1, 64),
    (2000, 0.4, 3, 32),
]


@pytest.mark.parametrize("n,r,seed,cap", CASES)
def test_builder_bit_equal(n, r, seed, cap):
    gj, gt = _both_graphs(*scene(n, r, seed), r, cap)
    assert gj is not None and gt is not None
    for f in dataclasses.fields(gj):
        a, b = getattr(gj, f.name), getattr(gt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _jax_moments(pts, gj):
    dev = jcw.graph_to_device(gj)
    ps = j_permute_rows(jnp.asarray(pts), dev.perm, dev.inv)
    mean, comps = jcw.cellwin_moments(ps, dev)
    return np.asarray(mean), [np.asarray(c) for c in comps], np.asarray(dev.row_map)


@pytest.mark.parametrize("n,r,seed,cap", CASES[:2])
def test_forward_plain_matches_jax(n, r, seed, cap):
    pts, qrows, nn = scene(n, r, seed)
    gj, gt = _both_graphs(pts, qrows, nn, r, cap)
    jmean, jcomps, row_map = _jax_moments(pts, gj)
    dev = tcw.graph_to_device(gt)
    ps = t_permute_rows(torch.as_tensor(pts), dev.perm, dev.inv)
    raw = tcw.cellwin_fwd_plain(ps, dev.q_est, dev.est_sorted, dev.f_start,
                                dev.f_len, dev.f_ctr, dev.r2).numpy()
    sel = row_map >= 0
    sel_raw = sel.copy()
    sel_raw[gt.exc_slots] = False  # raw kernel rows: exception rows not merged
    np.testing.assert_allclose(raw[0:3][:, sel_raw], jmean[:, sel_raw], rtol=1e-9, atol=1e-10)
    # atol: the JAX kernel sums about the tile centre, and its cancellation
    # leaves up to ~1e-9 m^2 where the row-centred sums give 0 on a plane.
    for k in range(6):
        np.testing.assert_allclose(raw[3 + k][sel_raw], jcomps[k][sel_raw], rtol=1e-9,
                                   atol=1e-9)
    # The public op, exception rows merged, on every valid row.
    mean, comps = tcw.cellwin_moments(ps, dev)
    np.testing.assert_allclose(mean.numpy()[:, sel], jmean[:, sel], rtol=1e-9, atol=1e-10)
    for c, jc in zip(comps, jcomps):
        np.testing.assert_allclose(c.numpy()[sel], jc[sel], rtol=1e-8, atol=1e-9)


def _objective_weights(row_map, seed):
    """Fixed per-row weights so every cotangent is exercised."""
    rng = np.random.default_rng(seed)
    wg = np.zeros(row_map.shape[0])
    wg[row_map >= 0] = rng.standard_normal(int((row_map >= 0).sum()))
    return wg


@pytest.mark.parametrize("case", ["random", "exception_rows"])
def test_gradient_matches_jax(case):
    if case == "random":
        pts, qrows, nn = scene(1500, 0.35, 1)
        r, cap = 0.35, 64
    else:
        pts, qrows, nn, r = _exception_setup()
        cap = 32
    gj, gt = _both_graphs(pts, qrows, nn, r, cap)
    if case == "exception_rows":
        assert gt.n_exc >= 1
    jdev = jcw.graph_to_device(gj)
    wg = _objective_weights(np.asarray(jdev.row_map), 3)

    def f_jax(p):
        ps = j_permute_rows(p, jdev.perm, jdev.inv)
        mean, comps = jcw.cellwin_moments(ps, jdev)
        return jnp.sum(jnp.asarray(wg) * (comps[0] + 0.7 * comps[3] + 0.3 * comps[5]
                                           + 0.11 * mean[1]))

    jv, jg = jax.value_and_grad(f_jax)(jnp.asarray(pts))

    tdev = tcw.graph_to_device(gt)
    p = torch.tensor(pts, requires_grad=True)
    mean, comps = tcw.cellwin_moments(t_permute_rows(p, tdev.perm, tdev.inv), tdev)
    tv = (torch.as_tensor(wg) * (comps[0] + 0.7 * comps[3] + 0.3 * comps[5]
                                 + 0.11 * mean[1])).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-9)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-7, atol=1e-8)


def test_exception_rows_match_jax():
    pts, qrows, nn, r = _exception_setup()
    gj, gt = _both_graphs(pts, qrows, nn, r, 32)
    assert gt.n_exc >= 1
    jmean, jcomps, row_map = _jax_moments(pts, gj)
    dev = tcw.graph_to_device(gt)
    mean, comps = tcw.cellwin_moments(t_permute_rows(torch.as_tensor(pts), dev.perm, dev.inv), dev)
    sel = row_map >= 0
    np.testing.assert_allclose(mean.numpy()[:, sel], jmean[:, sel], rtol=1e-9, atol=1e-10)
    for c, jc in zip(comps, jcomps):
        np.testing.assert_allclose(c.numpy()[sel], jc[sel], rtol=1e-8, atol=1e-9)


def test_builder_declines_like_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (500, 3))
    nn = uncapped_graph(pts, 0.4)
    gj, gt = _both_graphs(pts, np.arange(500), nn, 0.4, 32, span_limit=8)
    assert gj is None and gt is None


def _decline_inputs(case):
    """(points, query rows, neighbours, r, builder options) of each case."""
    if case == "builds":
        pts, qrows, nn = scene(1500, 0.35, 1)
        return pts, qrows, nn, 0.35, {}
    if case == "exception_rows":
        pts, qrows, nn, r = _exception_setup()
        return pts, qrows, nn, r, {"max_exc_frac": 0.0}
    if case == "span_limit":
        rng = np.random.default_rng(0)
        pts = rng.uniform(-1, 1, (500, 3))
        return pts, np.arange(500), uncapped_graph(pts, 0.4), 0.4, {"span_limit": 8}
    pts, _, nn = scene(800, 0.35, 2)
    return pts, np.full(len(nn), -1), nn, 0.35, {}


@pytest.mark.parametrize("case", ["builds", "exception_rows", "span_limit", "no_rows"])
def test_builder_decline_reasons_match_jax(case, monkeypatch, capsys):
    """The port's builder declines, or builds, where the JAX builder does on
    the same graph, and keeps the text of the check that fired (the JAX
    builder's debug note) in LAST_NOTE; None after a build."""
    pts, qrows, nn, r, opts = _decline_inputs(case)
    kw = dict(row_cap=32, pt_cap=32, span_limit=256)
    kw.update(opts)
    valid = np.ones(len(pts), bool)
    monkeypatch.setenv("DC_CELLWIN_DEBUG", "1")
    capsys.readouterr()
    gj = jcw.build_cellwin_graph(pts, valid, qrows, nn, r, **kw)
    jnote = [line[len("[cellwin] "):] for line in capsys.readouterr().err.splitlines()
             if line.startswith("[cellwin] ")]
    gt = tcw.build_cellwin_graph(pts, valid, qrows, nn, r, **kw)
    tnote = [line for line in capsys.readouterr().err.splitlines() if line.startswith("[cellwin]")]
    assert (gj is None) == (gt is None) == (case != "builds")
    if gt is not None:
        assert tcw.LAST_NOTE is None and not jnote and not tnote
    elif case == "no_rows":
        # The JAX builder returns None here without a note.
        assert not jnote and tcw.LAST_NOTE == "declined: no query rows"
    else:
        assert jnote == [tcw.LAST_NOTE] and tnote == ["[cellwin] " + tcw.LAST_NOTE]
        assert tcw.LAST_NOTE.startswith("declined: ")
