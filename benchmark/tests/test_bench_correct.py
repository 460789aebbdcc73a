"""The comparison that decides ``correct``, on a tiny copy of each cell on
the CPU: the program agrees with the plain reference, the result line has
the contract's keys, the control (the reference in float32 with TF32
products) fails a limit, and a run with its timed path broken underneath
comes out not correct, once for each fault the cell can have."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from .common import TINY_TRAFFIC, run_tiny, tiny_cell

CELLS = ["box_r25.train", "box_k32_scale.train", "box_r25.node", "box_r25.slam"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(cell, tmp_path):
    out = run_tiny(cell, tmp_path)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(tiny_cell(cell, tmp_path).limits)


def test_result_line_has_the_contract_keys(tmp_path):
    out = run_tiny("box_r25.train", tmp_path)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["metrics"]) == {"train_step_ms", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert list(json.loads(json.dumps(out)))[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell, tmp_path):
    c = tiny_cell(cell, tmp_path, traffic=TINY_TRAFFIC[cell])
    got = c.driver.calibrate(c, 2 ** 31 + 5, "cpu", 0.3, with_control=True)
    assert all(got["program"][k] <= c.limits[k] for k in c.limits), got["program"]
    assert any(got["control"][k] > c.limits[k] for k in c.limits), got["control"]


def _run_broken(cell, tmp_path):
    return run_tiny(cell, tmp_path)


def test_a_step_that_leaves_the_weights_unchanged_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = _run_broken("box_r25.train", tmp_path)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["box_r25.train", "box_k32_scale.train"])
def test_half_the_batch_left_out_fails(cell, tmp_path, monkeypatch):
    from depth_correction_tpu_torch import train

    make = train.make_loss_fn

    def halved(cfg, *a, **kw):
        fn = make(cfg, *a, **kw)

        def loss_fn(model, data, pose_deltas=None):
            masks = []
            for m in data.masks:
                keep = torch.zeros_like(m)
                keep[torch.nonzero(m).reshape(-1)[::2]] = True
                masks.append(m & keep)
            return fn(model, dataclasses.replace(data, masks=tuple(masks)), pose_deltas)

        return loss_fn

    monkeypatch.setattr(train, "make_loss_fn", halved)
    out = _run_broken(cell, tmp_path)
    assert not out["correct"]


def test_an_answer_altered_where_it_is_produced_fails(tmp_path, monkeypatch):
    from depth_correction_tpu_torch import node

    process = node.DepthCorrector.process

    def altered(self, scan, stamp=None):
        out = process(self, scan, stamp)
        out = out.copy()
        out["z"][len(out) // 2] += np.float32(0.01)
        return out

    monkeypatch.setattr(node.DepthCorrector, "process", altered)
    out = _run_broken("box_r25.node", tmp_path)
    assert not out["correct"]
    assert out["checks"]["point_err"]["value"] > 0.009


def test_a_pose_altered_where_it_is_produced_fails(tmp_path, monkeypatch):
    from depth_correction_tpu_torch import slam_eval

    odometry = slam_eval.slam_odometry

    def altered(*a, **kw):
        est = odometry(*a, **kw)
        est[-1, 0, 3] += 0.01
        return est

    monkeypatch.setattr(slam_eval, "slam_odometry", altered)
    out = _run_broken("box_r25.slam", tmp_path)
    assert not out["correct"]
    assert out["checks"]["trans_err"]["value"] > 0.009


def test_a_run_without_a_card_prints_no_result(capsys):
    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "box_r25.train", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
