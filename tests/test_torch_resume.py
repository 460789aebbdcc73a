"""Checkpoint and resume of the port's train() (the port against itself, as
the JAX package's tests/test_checkpoint_resume.py holds its own), float64
on the CPU.

A run interrupted after a checkpoint and resumed ends where an
uninterrupted run ends, bit for bit: the saved train state (model,
optimizer state with L-BFGS's memory, validation's deltas and optimizer),
the history and the best model. A resumed run that does not beat the
restored minima returns the earlier best; resume = False starts again.
"""
import os

import numpy as np
import pytest
import torch

from depth_correction_tpu_torch.config import Config
from depth_correction_tpu_torch.datasets import create_dataset
from depth_correction_tpu_torch.train import TrainCallbacks, prepare_sequences, train

SEQ, VAL = "ground_plane/4", "ground_plane/2"
STEPS = 4


def _cfg(log_dir, **kw):
    cfg = Config()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.log_dir = str(log_dir)
    cfg.train_names = [SEQ]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.nn_backend = "scipy"
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.lr = 5e-4
    cfg.n_opt_iters = STEPS
    cfg.checkpoint_period = 2
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


RUNS = {"adam": {}, "lbfgs": {"optimizer": "lbfgs"},
        "adam_sequence_val": {"pose_correction": "sequence", "val_names": [VAL]}}


@pytest.fixture(scope="module")
def data():
    cfg = _cfg("unused")
    return prepare_sequences([create_dataset(SEQ, cfg)], cfg)


class _Interrupt(Exception):
    pass


class _StopAt(TrainCallbacks):
    """Raises when iteration ``it`` starts: a run killed mid-training."""

    def __init__(self, cfg, it):
        super().__init__(cfg)
        self.it = it

    def iteration_started(self, it):
        if it == self.it:
            raise _Interrupt(it)


def _state(log_dir, it):
    return torch.load(os.path.join(log_dir, "train_state", str(it)), weights_only=True)


def _flat(x):
    """The tensors and numbers of a saved state, in order."""
    if isinstance(x, dict):
        return [v for k in sorted(x, key=str) for v in _flat(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _flat(e)]
    return [x]


def _rows(log_dir):
    with open(os.path.join(log_dir, "train_history.csv")) as f:
        return [line.split()[:3] for line in f][1:]


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and (x == y or (x != x and y != y))


@pytest.mark.parametrize("run", list(RUNS))
def test_resume_reproduces_an_uninterrupted_run(tmp_path, data, run):
    kw = RUNS[run]
    full_cfg = _cfg(tmp_path / "full", **kw)
    full_best = train(full_cfg, train_data=data)
    cut_cfg = _cfg(tmp_path / "cut", **kw)
    with pytest.raises(_Interrupt):
        train(cut_cfg, callbacks=_StopAt(cut_cfg, 3), train_data=data)
    assert sorted(os.listdir(os.path.join(cut_cfg.log_dir, "train_state"))) == ["1"]
    resumed_best = train(_cfg(tmp_path / "cut", **kw), train_data=data)
    assert sorted(os.listdir(os.path.join(cut_cfg.log_dir, "train_state"))) == ["1", "3"]

    full, resumed = _state(full_cfg.log_dir, 3), _state(cut_cfg.log_dir, 3)
    # step_ms differs between runs; everything else is bit-equal.
    for s in (full, resumed):
        s["history"] = [r[:3] for r in s["history"]]
    _assert_states_equal(resumed, full)
    assert _rows(cut_cfg.log_dir) == _rows(full_cfg.log_dir)
    assert len(_rows(cut_cfg.log_dir)) == STEPS
    assert os.path.basename(resumed_best.model_state_dict) == \
        os.path.basename(full_best.model_state_dict)
    with np.load(resumed_best.model_state_dict) as a, np.load(full_best.model_state_dict) as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
    if run == "lbfgs":
        assert full["opt"]["count"] == STEPS and full["opt"]["weights"].abs().sum() > 0
    if "val_names" in kw:
        assert full["val_deltas"] is not None and full["val_opt"] is not None


def test_resume_returns_the_earlier_best(tmp_path, data):
    """With a step too large the loss rises after step 0: a run resumed
    after the interruption improves on nothing and returns best.yaml's
    config, the step-0 model."""
    cfg = _cfg(tmp_path, lr=0.05)
    with pytest.raises(_Interrupt):
        train(cfg, callbacks=_StopAt(cfg, 3), train_data=data)
    best = train(_cfg(tmp_path, lr=0.05), train_data=data)
    assert best is not None
    assert os.path.basename(best.model_state_dict).startswith("000_")
    losses = [float(r[1]) for r in _rows(cfg.log_dir)]
    assert min(losses[1:]) > losses[0]


def test_resume_false_starts_again(tmp_path, data):
    """resume = False ignores the checkpoints: the run starts at iteration
    0 and equals an uninterrupted one."""
    cfg = _cfg(tmp_path / "cut")
    with pytest.raises(_Interrupt):
        train(cfg, callbacks=_StopAt(cfg, 3), train_data=data)

    class Seen(TrainCallbacks):
        its = []

        def iteration_started(self, it):
            self.its.append(it)

    train(_cfg(tmp_path / "cut", resume=False), callbacks=Seen(cfg), train_data=data)
    assert Seen.its == list(range(STEPS))
    full_cfg = _cfg(tmp_path / "full")
    train(full_cfg, train_data=data)
    _assert_states_equal(
        {k: v for k, v in _state(cfg.log_dir, 3).items() if k != "history"},
        {k: v for k, v in _state(full_cfg.log_dir, 3).items() if k != "history"})
