"""The transpose graph in cell order (``ops.features.TransposeGraph``):
the targets in cell order, each run of pairs laid out in that order, and
the tiles X4 stages (``ops.features.TransposeTiles``), on the CPU.

X4 and X5 walk these tables on the card; here a torch emulation of that
walk, written below and reading the tables as the kernels do (a tile's
rows staged, each pair's row by its local index, a hub tile's rows
through its pairs), is held against the plain versions in float64. The
graph cases are ``tests/test_torch_transpose_vjp.py``'s, and a capped
K = 32 graph of a small synthetic scene. Budgets of 1,024 rows (the
default) and of 8 rows (most tiles split, many hubs) are both walked;
the point order (``features.index_order``) is built beside the cell order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from depth_correction_tpu_torch.ops import features as tfeat
from test_torch_transpose_vjp import _graph_case, _positions

CASES = ["padded", "in_degree_0", "hub", "out_of_range"]
BUDGETS = [tfeat.TILE_ROWS, 8]
REL = 1e-12  # of max |output|, float64


def _case(case, budget, ordered=True):
    """(neighbors, weights, positions, graph) of one case, built with a
    tile budget of ``budget`` rows; the targets in the cell order of
    positions seeded in a 10 m box, or in point order."""
    nn, m, w = _graph_case(case)
    nn, w, pos = torch.as_tensor(nn), torch.as_tensor(w), _positions(m)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfeat, "TILE_ROWS", budget)
        if ordered:
            tg = tfeat.build_transpose_graph(nn, pos, w)
        else:
            tg = tfeat.transpose_in_order(nn, m, w, tfeat.index_order)
    assert tg.tiles.budget == budget
    return nn, w, pos, tg


def _tiles(tg):
    """Each tile's (positions, rows, pair range) as the kernels read them."""
    t = tg.tiles
    for b in range(t.num_tiles):
        t0, t1 = int(t.tile_start[b]), int(t.tile_start[b + 1])
        r0, r1 = int(t.row_start[b]), int(t.row_start[b + 1])
        yield t0, t1, t.rows[r0:r1].long(), int(tg.start[t0]), int(tg.start[t1])


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("case", CASES)
def test_order_is_a_permutation_with_empty_targets_last(case, budget, ordered):
    """``order`` holds every target once; the targets with pairs come first
    (by their Morton key, or by index without positions), those without
    after them by index; ``start`` holds the points' in-degrees in that
    order."""
    nn, _, pos, tg = _case(case, budget, ordered)
    m = tg.num_points
    order = tg.order.long()
    assert tg.order.dtype == torch.int32 and sorted(order.tolist()) == list(range(m))
    flat = nn.reshape(-1)
    deg = torch.bincount(flat[(flat >= 0) & (flat < m)], minlength=m)
    assert torch.equal(tg.in_degree().long(), deg)
    active = deg[order] > 0
    n_act = int(active.sum())
    assert active[:n_act].all() and not active[n_act:].any()
    assert torch.equal(order[n_act:], torch.sort(order[n_act:]).values)
    assert torch.equal(torch.diff(tg.start.long()), deg[order])
    if not ordered:
        assert torch.equal(order[:n_act], torch.sort(order[:n_act]).values)
    else:
        assert torch.equal(order, tfeat.cell_order(pos, deg > 0))


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("case", CASES)
def test_every_pair_finds_its_row_in_its_tile(case, budget, ordered):
    """Each target's run is its slots in ascending order, with their
    weights, and ``point_csr`` moves the runs to point order; every pair's
    row is ``rows[row_start[tile] + local]``; a tile's rows are distinct,
    ascending and exactly those its pairs reference; every tile holds at
    most ``budget`` rows or is a lone hub target; the tiles cover every
    position; ``rows_max`` is the largest tile within the budget."""
    nn, w, _, tg = _case(case, budget, ordered)
    t = tg.tiles
    k = tg.k
    csr = tfeat.point_csr(tg)
    flat = nn.reshape(-1)
    assert csr.start.dtype == torch.int32 and csr.pair.dtype == torch.int32
    for pos in range(tg.num_points):
        j = int(tg.order[pos])
        slots = torch.nonzero(flat == j).reshape(-1).to(torch.int32)
        a, b = int(csr.start[j]), int(csr.start[j + 1])
        for pair, pw in ((tg.pair[tg.start[pos]:tg.start[pos + 1]],
                          tg.w[tg.start[pos]:tg.start[pos + 1]]),
                         (csr.pair[a:b], csr.w[a:b])):
            assert torch.equal(pair, slots)
            assert torch.equal(pw, w.reshape(-1)[slots.long()])
    covered, within = 0, [0]
    assert int(t.tile_start[0]) == 0 and int(t.tile_start[-1]) == tg.num_points
    for t0, t1, rows, p0, p1 in _tiles(tg):
        assert 1 <= t1 - t0 <= tfeat.TILE_TARGETS
        covered += t1 - t0
        pair_rows = tg.pair[p0:p1].long() // k
        assert (torch.diff(rows) > 0).all()
        assert set(rows.tolist()) == set(pair_rows.tolist())
        local = t.local[p0:p1].long() & 0xFFFF
        assert torch.equal(rows[local], pair_rows)
        if len(rows) > budget:
            assert t1 - t0 == 1
        else:
            within.append(len(rows))
    assert covered == tg.num_points and t.rows_max == max(within)
    assert t.rows.shape[0] == int(t.row_start[-1])


def _walk_moments(points, tg, table):
    """X4's walk: a tile's rows staged from ``table``, each pair's row read
    by its local index (through ``pair // k`` in a hub tile), the
    target's sum written to ``grad[order[t]]``."""
    t = tg.tiles
    grad = torch.full((tg.num_points, 3), float("nan"), dtype=table.dtype)
    for t0, t1, rows, _, _ in _tiles(tg):
        staged = table[rows]
        for p in range(t0, t1):
            j = int(tg.order[p])
            s, e = int(tg.start[p]), int(tg.start[p + 1])
            if len(rows) > t.budget:
                r = table[tg.pair[s:e].long() // tg.k]
            else:
                r = staged[t.local[s:e].long() & 0xFFFF]
            d = points[j] - r[:, 6:9]
            s00, s11, s22, s01, s02, s12 = r[:, :6].unbind(1)
            g = torch.stack([s00 * d[:, 0] + s01 * d[:, 1] + s02 * d[:, 2],
                             s01 * d[:, 0] + s11 * d[:, 1] + s12 * d[:, 2],
                             s02 * d[:, 0] + s12 * d[:, 1] + s22 * d[:, 2]], 1) + r[:, 9:12]
            grad[j] = (tg.w[s:e, None] * g).sum(0)
    return grad


def _walk_gather(g, tg):
    """X5's walk: each position's run in cell order summed into
    ``out[order[t]]``."""
    flat = g.reshape(-1, 1 if g.dim() == 2 else g.shape[-1])
    out = torch.full((tg.num_points, flat.shape[1]), float("nan"), dtype=g.dtype)
    for p in range(tg.num_points):
        out[int(tg.order[p])] = flat[tg.pair[tg.start[p]:tg.start[p + 1]].long()].sum(0)
    return out[:, 0] if g.dim() == 2 else out


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("case", CASES)
def test_walk_matches_plain_versions(case, budget):
    """The emulated walks of X4 and X5 (D = 1 and 3) equal
    ``transpose_moments_plain`` and ``transpose_gather_plain`` within 1e-12
    of max |output| in float64; every target is written, those without
    pairs with 0."""
    nn, _, _, tg = _case(case, budget)
    rng = np.random.default_rng(8)
    m = tg.num_points
    points = torch.as_tensor(rng.uniform(-5, 5, (m, 3)) + np.array([300.0, -40.0, 7.0]))
    table = torch.as_tensor(rng.standard_normal((nn.shape[0], 12)))
    table[:, 6:9] += points.mean(0)
    got, ref = _walk_moments(points, tg, table), tfeat.transpose_moments_plain(points, tg, table)
    assert not torch.isnan(got).any()
    assert float((got - ref).abs().max()) <= REL * float(ref.abs().max())
    for dim in (1, 3):
        g = torch.as_tensor(rng.standard_normal(tuple(nn.shape) + ((3,) if dim == 3 else ())))
        got5, ref5 = _walk_gather(g, tg), tfeat.transpose_gather_plain(g, tg)
        assert got5.shape == ref5.shape and not torch.isnan(got5).any()
        assert float((got5 - ref5).abs().max()) <= REL * float(ref5.abs().max())
    assert (got[tg.in_degree() == 0] == 0).all()


def test_budget_splits_tiles_and_makes_hubs():
    """At a budget of 8 rows the hub case's point 7 (in-degree >= 400) is a
    tile alone past the budget, and the other tiles split below TILE_TARGETS
    targets; at the default budget no tile of it is a hub."""
    _, _, _, small = _case("hub", 8)
    _, _, _, full = _case("hub", tfeat.TILE_ROWS)
    hubs = [(t0, t1, len(rows)) for t0, t1, rows, _, _ in _tiles(small) if len(rows) > 8]
    assert any(int(small.order[t0]) == 7 for t0, _, _ in hubs)
    assert all(t1 - t0 == 1 for t0, t1, _ in hubs)
    assert small.tiles.num_tiles > full.tiles.num_tiles
    assert all(len(rows) <= tfeat.TILE_ROWS for _, _, rows, _, _ in _tiles(full))


def test_graph_without_tiles_raises_off_the_cpu():
    """X4 and X5 on a non-CPU tensor need the tiles: a graph without them
    (its cell-order CSR alone) raises before any launch; ``to`` moves the
    tables and casts the weights."""
    nn, _, _, tg = _case("padded", tfeat.TILE_ROWS)
    bare = dataclasses.replace(tg, tiles=None).to("meta")
    pts = torch.zeros((tg.num_points, 3), device="meta")
    with pytest.raises(ValueError, match="tiles"):
        tfeat.transpose_moments(pts, bare, torch.zeros((nn.shape[0], 12), device="meta"))
    with pytest.raises(ValueError, match="tiles"):
        tfeat.transpose_gather(torch.zeros(tuple(nn.shape) + (3,), device="meta"), bare)
    moved = tg.to("meta", torch.float32)
    assert moved.w.dtype == torch.float32 and moved.order.device.type == "meta"
    assert moved.tiles.local.device.type == "meta" and moved.tiles.rows_max == tg.tiles.rows_max


@pytest.fixture(scope="module")
def scene_graph():
    """A capped K = 32 graph of a small open box (the bench's capped
    configuration, float64 on the CPU) and its points' positions."""
    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.preproc import global_cloud
    from depth_correction_tpu_torch.scripts import bench_config
    from depth_correction_tpu_torch.train import prepare_sequences

    cfg = bench_config(device="cpu", uncapped=False)
    cfg.float_type = "float64"
    cfg.train_names = ["open_box/n_4_size_8_8_3_height_1_density_50"]
    data = prepare_sequences([create_dataset(cfg.train_names[0], cfg)], cfg)
    return data, global_cloud(data.batches[0]).get_points()


def test_scene_cell_order_reuses_rows(scene_graph, capsys):
    """On the capped scene prep's transpose is in cell order, and its tiles
    reuse rows: more pairs a row than the same graph in point order (both
    printed); X4's and X5's walks there equal the plain versions."""
    data, pos = scene_graph
    nn, w, tg = data.neighbors[0], data.weights[0], data.transposes[0]
    assert nn.shape[1] == 32
    m = tg.num_points
    point = tfeat.transpose_in_order(nn, m, w, tfeat.index_order)
    assert torch.equal(tg.order, tfeat.build_transpose_graph(nn, pos, w).order)
    cell, flat = tg.pairs_per_row(), point.pairs_per_row()
    with capsys.disabled():
        print("\ncapped K = 32 scene: %d pairs, pairs a row %.3f in cell order, %.3f in point "
              "order" % (tg.pair.shape[0], cell, flat))
    assert cell > 2 * flat
    rng = np.random.default_rng(9)
    table = torch.as_tensor(rng.standard_normal((nn.shape[0], 12)))
    points = pos.double()
    ref = tfeat.transpose_moments_plain(points, tg, table)
    got = _walk_moments(points, tg, table)
    assert float((got - ref).abs().max()) <= REL * float(ref.abs().max())
    g = torch.as_tensor(rng.standard_normal(tuple(nn.shape) + (3,)))
    ref5 = tfeat.transpose_gather_plain(g, tg)
    assert float((_walk_gather(g, tg) - ref5).abs().max()) <= REL * float(ref5.abs().max())
