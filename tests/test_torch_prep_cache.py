"""The port's prep cache (utils/prep_cache.py, after the JAX package's
tests/test_prep_cache.py), float64 on the CPU.

A hit gives back the prepared data bit for bit (tensors of the same
dtypes, a cell-window graph, the loss offset's and ICP's tables); a change
of a prep knob or of the data misses; a corrupt entry is rebuilt.
"""
import dataclasses
import os

import pytest
import torch

from depth_correction_tpu_torch.config import Config
from depth_correction_tpu_torch.datasets import create_dataset
from depth_correction_tpu_torch.train import prepare_sequences

SEQ = "ground_plane/4"


def _cfg(cache_dir, **kw):
    cfg = Config()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.prep_cache_dir = str(cache_dir)
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.nn_backend = "scipy"
    cfg.moments_backend = "cellwin"
    cfg.cellwin_row_cap = cfg.cellwin_pt_cap = 32
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _prep(cfg, name=SEQ):
    return prepare_sequences([create_dataset(name, cfg)], cfg)


def _leaves(x, path="data"):
    """(path, value) of every tensor and plain value in prepared data."""
    if isinstance(x, torch.Tensor):
        return [(path, x)]
    if dataclasses.is_dataclass(x):
        return [leaf for f in dataclasses.fields(x) if f.name != "prep_seconds"
                for leaf in _leaves(getattr(x, f.name), "%s.%s" % (path, f.name))]
    if isinstance(x, (list, tuple)):
        return [leaf for i, v in enumerate(x) for leaf in _leaves(v, "%s[%d]" % (path, i))]
    return [(path, x)]


def _assert_identical(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, path
            assert torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x == y, path


def _entries(cache_dir):
    return sorted(f for f in os.listdir(cache_dir) if f.endswith(".pkl"))


@pytest.mark.parametrize("kw", [{}, {"loss_offset": True},
                                {"loss": "icp_loss", "moments_backend": None}],
                         ids=["cellwin", "offset", "icp"])
def test_hit_is_bit_identical(tmp_path, kw):
    cfg = _cfg(tmp_path, **kw)
    built = _prep(cfg)
    assert len(_entries(tmp_path)) == 1 and "cache_save" in built.prep_seconds
    loaded = _prep(_cfg(tmp_path, **kw))
    assert "cache_load" in loaded.prep_seconds and "local_features" not in loaded.prep_seconds
    _assert_identical(loaded, built)
    if not kw:
        assert loaded.cellwin[0] is not None
    if "loss_offset" in kw:
        assert loaded.off_neighbors[0] is not None
    if "loss" in kw:
        assert loaded.icp_idx[0] is not None and loaded.batches[0].cloud.normals is not None


def test_knob_or_data_change_misses(tmp_path):
    """Another radius, another depth bias (other scans) or another loss
    mode each build an entry of their own; the model, optimizer and log
    directory do not."""
    _prep(_cfg(tmp_path))
    _prep(_cfg(tmp_path, lr=1.0, optimizer="sgd", log_dir=str(tmp_path / "other"),
               model_kwargs={"w": [0.5], "exponent": [4.0]}))
    assert len(_entries(tmp_path)) == 1
    other_r = _prep(_cfg(tmp_path, nn_r=0.45))
    assert len(_entries(tmp_path)) == 2
    _prep(_cfg(tmp_path, depth_bias_model_kwargs={"w": [-0.003], "exponent": [4.0]}))
    assert len(_entries(tmp_path)) == 3
    _prep(_cfg(tmp_path, loss="icp_loss", moments_backend=None))
    assert len(_entries(tmp_path)) == 4
    base = _prep(_cfg(tmp_path))
    assert other_r.neighbors[0].shape[1] > base.neighbors[0].shape[1]


def test_corrupt_entry_is_rebuilt(tmp_path):
    built = _prep(_cfg(tmp_path))
    (entry,) = _entries(tmp_path)
    with open(os.path.join(tmp_path, entry), "wb") as f:
        f.write(b"not a pickle")
    rebuilt = _prep(_cfg(tmp_path))
    assert "cache_load" not in rebuilt.prep_seconds and "cache_save" in rebuilt.prep_seconds
    _assert_identical(rebuilt, built)
    loaded = _prep(_cfg(tmp_path))
    assert "cache_load" in loaded.prep_seconds
    _assert_identical(loaded, built)
    assert _entries(tmp_path) == [entry]
