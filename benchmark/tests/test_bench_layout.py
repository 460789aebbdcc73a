"""The manifest, the files it names, and that a later change can add a
configuration, a traffic mix and a per-layer metric as files of their own."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

from benchmark import harness, roofline

CONTRACT = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.mark.parametrize("unproven", [False, True])
def test_manifest_has_the_contract_keys(unproven):
    """BENCHMARK.json, and with it the dormant cells of unproven.json."""
    man = harness.load_manifest(unproven=unproven)
    assert set(man) == CONTRACT
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_manifest(unproven=True)["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    man = harness.load_manifest(unproven=True)
    c = harness.Cell(cell, man)
    assert c.name == "%s.%s" % (c.workload["config"], c.traffic_name)
    assert {"settings", "scene", "source", "reduced", "assumed"} <= set(c.config)
    assert hasattr(c.driver, "setup") and hasattr(c.driver, "window")
    assert hasattr(c.driver, "judge") and hasattr(c.driver, "calibrate")
    assert c.end_to_end and c.per_layer
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    reported = {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(c.reader(m["name"]))


def test_added_files_are_found_without_editing(tmp_path):
    """A configuration, a traffic mix and a metric added as new files in a
    copy, with their manifest entries, are picked up; no existing file of
    the copy changes."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = root / "benchmark"
    conf = json.loads((bench / "configs" / "box_r25.json").read_text())
    conf["name"] = "box_r40"
    conf["settings"]["nn_r"] = 0.4
    (bench / "configs" / "box_r40.json").write_text(json.dumps(conf))
    slam = json.loads((bench / "traffic" / "slam.json").read_text())
    (bench / "traffic" / "slam_long.json").write_text(json.dumps(dict(slam, n_iters=16)))
    (bench / "limits" / "box_r40.slam_long.json").write_text(
        (bench / "limits" / "box_r25.slam.json").read_text())
    (bench / "metrics" / "iters_per_scan.py").write_text(
        "def read(ctx):\n    return ctx['cell'].traffic['n_iters']\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "box_r40", "source": "x", "file": "benchmark/configs/box_r40.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "box_r40.slam_long", "config": "box_r40",
                             "traffic": "slam_long", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "iters_per_scan", "unit": "iterations", "better": "lower",
                             "source": "program_counter", "layer": "SLAM",
                             "moves": "slam_scan_ms", "workloads": ["box_r40.slam_long"]})
    for m in man["end_to_end"]:
        if m["name"] == "slam_scan_ms":
            m["workloads"].append("box_r40.slam_long")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.Cell("box_r40.slam_long", harness.load_manifest(str(root)),
                        bench_dir=str(bench), root=str(root))
    assert cell.config["settings"]["nn_r"] == 0.4
    assert cell.traffic["n_iters"] == 16
    assert [m["name"] for m in cell.per_layer] == ["iters_per_scan"]
    assert [m["name"] for m in cell.end_to_end] == ["slam_scan_ms", "setup_s"]
    assert cell.reader("iters_per_scan")({"cell": cell}) == 16
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("part", ["cellwin_build", "global_neighbors"])
def test_a_metric_without_a_file_of_its_own_reads_through_its_base(part):
    """prep_s.<part> has no file: metrics/prep_s.py serves it, told the
    metric's name; mfu.<kind> likewise reads the driver's item work."""
    cell = harness.Cell("box_r25.train", harness.load_manifest(unproven=True))
    state = {"prep_seconds": {"cellwin_build": 1.5, "global_neighbors": 0.25}}
    assert cell.reader("prep_s." + part)({"state": state}) == state["prep_seconds"][part]
    ctx = {"verdict": {"item_work": roofline.Work(3.35e10, 0.0)},
           "window": {"items": 10, "window_s": 1.0}}
    assert cell.reader("mfu.train")(ctx) == pytest.approx(10.0)
    assert cell.reader("mfu.train")({"verdict": {}, "window": {}}) is None


def test_roofline_counts_hand_counted_work():
    # 4 points, 2 rows, 5 pairs, no table: 4 * 12 + 2 * 40 bytes, 5 * 15 flops.
    assert tuple(roofline.moments_fwd(4, 2, 5)) == (128.0, 75.0)
    # The VJP: 2 rows' cotangents (48 B each), the points in and their
    # gradient out (2 * 4 * 12 B), a 2 x 3 table (8 B a slot); 5 * 21 flops.
    assert tuple(roofline.moments_bwd(4, 2, 5, slots=6)) == (96.0 + 96.0 + 48.0, 105.0)
    w = roofline.Work(3.35e12, 0.0)
    assert w.seconds() == pytest.approx(1.0)
    assert roofline.share(w, 2.0) == pytest.approx(50.0)
    assert roofline.share(roofline.Work(0.0, 67e12), 4.0) == pytest.approx(25.0)
    assert roofline.share(w, 0.0) is None


def test_radius_pairs_count_a_hand_counted_graph():
    import torch

    from benchmark.reference.common import mutual, radius_pairs

    # Four points 0.2 apart on a line, r = 0.25: each with itself and its
    # neighbours, 4 + 2 * 3 = 10 pairs; capped at 2 nearest, 8; those
    # mutual: the ends keep (0, 1) and (3, 2), the middle rows (1, 0) and
    # (2, 3) besides themselves.
    p = torch.tensor([[0.0, 0, 0], [0.2, 0, 0], [0.4, 0, 0], [0.6, 0, 0]], dtype=torch.float64)
    v = torch.ones(4, dtype=torch.bool)
    rows, cols = radius_pairs(p, v, 0.25)
    assert rows.numel() == 10
    rows, cols = radius_pairs(p, v, 0.25, cap=2)
    assert rows.numel() == 8
    rows, cols = mutual(rows, cols, 4)
    assert sorted(zip(rows.tolist(), cols.tolist())) == [
        (0, 0), (0, 1), (1, 0), (1, 1), (2, 2), (2, 3), (3, 2), (3, 3)]


def test_no_jax_check_compares_whole_top_level_names():
    mods = {"depth_correction_tpu": 1, "depth_correction_tpu.ops": 1,
            "depth_correction_tpu_torch": 1, "depth_correction_tpu_torch.train": 1,
            "jaxtyping": 1, "jax.numpy": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == ["depth_correction_tpu",
                                               "depth_correction_tpu.ops", "jax.numpy"]
    assert harness.forbidden_modules({"depth_correction_tpu_torch": 1, "flaxen": 1}) == []
    assert sys.modules.get("benchmark.harness") is harness


def test_every_manifest_entry_names_cells_the_manifest_has():
    """In BENCHMARK.json alone: each configuration serves a cell, and each
    metric's cells are cells of the manifest."""
    man = harness.load_manifest()
    cells = {w["name"] for w in man["workloads"]}
    assert {c["name"] for c in man["configs"]} == {w["config"] for w in man["workloads"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
