"""Disk cache of prepared (frozen) training graphs (counterpart of
``depth_correction_tpu/utils/prep_cache.py``).

``prepare_sequences`` consults a content-addressed cache in
``cfg.prep_cache_dir``: a second ``train()`` on the same data, or a run
that differs only in model, optimizer or loss reduction, reloads each
sequence's frozen graphs (batch, neighbour tables, offset and ICP tables,
the cell-window graph) instead of building them again.

- The fingerprint hashes the scan content consumed (structured bytes and
  poses) and every config field except an exclude-list
  (:data:`_PREP_IRRELEVANT`): a new config field changes the fingerprint
  by default. The device type is folded in as such: kernels and plain
  twins may round differently.
- Entries are per sequence, pickled as CPU numpy arrays (tensors are
  tagged, so a load gives back tensors where there were tensors) to a
  temporary file and renamed into place. A load is bit-identical to the
  build; an entry that does not unpickle is rebuilt.
- Entries are keyed by this package's :data:`CACHE_VERSION` and are not
  meant to be read by the JAX package.
- Transpose graphs (``ops.features.TransposeGraph``) are not stored: a
  cell-window graph's exception-row transpose is written as None, and
  ``prepare_sequences`` builds the transposes on the device after a load
  as after a build, so entries and fingerprints are those of a prep
  without transposes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from ..ops.features import TransposeGraph

__all__ = ["CACHE_VERSION", "load_record", "save_record", "sequence_fingerprint"]

# Bump when the record layout changes incompatibly.
CACHE_VERSION = 1

# Config fields that cannot change what prepare_sequences returns for a
# given sequence of scans (the JAX package's list): dataset fields act
# through the scans, whose content is hashed; model, optimizer, loop and
# IO fields act after prep; the loss enters as its ICP bits; the device as
# its type.
_PREP_IRRELEVANT = frozenset({
    "dataset", "dataset_args", "dataset_kwargs",
    "data_start", "data_step", "data_stop",
    "depth_bias_model_args", "depth_bias_model_class", "depth_bias_model_kwargs",
    "depth_noise", "pose_noise", "pose_noise_mode",
    "train_names", "val_names", "test_names",
    "train_poses_path", "val_poses_path", "test_poses_path", "pose_provider",
    "model_class", "model_args", "model_kwargs", "model_state_dict",
    "optimizer", "optimizer_args", "optimizer_kwargs", "lr",
    "n_opt_iters", "optimize_model", "pose_correction",
    "train_pose_deltas", "test_pose_deltas",
    "loss", "loss_kwargs",
    "log_dir", "out_dir", "pkg_dir", "loss_eval_csv", "slam_eval_csv",
    "slam_poses_csv", "show_results", "force", "launch_prefix",
    "num_jobs", "items_per_job", "eval_losses", "eval_pose_providers",
    "eval_slams", "plot_period", "log_filters", "profile_dir",
    "checkpoint_period", "resume", "world_frame",
    "slam", "slam_command", "odom_cov",
    "mesh_shape", "dist_coordinator", "dist_num_processes", "dist_process_id",
    "device",
    "prep_cache_dir",
})


def _hash_update_array(h, a) -> None:
    a = np.asarray(a)
    h.update(str(a.dtype.descr if a.dtype.names else a.dtype.str).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())


def sequence_fingerprint(scans, cfg, for_grad: bool, mesh: bool = False) -> str:
    """Content fingerprint of one sequence's prep inputs.

    :param scans: the ``(structured scan, 4x4 pose)`` pairs prep consumes.
    :param mesh: prep runs under a data mesh (the JAX package keys the
        flag, train.py:186: a mesh routes the establishment).
    """
    h = hashlib.sha256()
    h.update(b"dctpu-torch-prep-v%d" % CACHE_VERSION)
    for scan, pose in scans:
        _hash_update_array(h, scan)
        _hash_update_array(h, np.asarray(pose, np.float64))
    knobs = {k: v for k, v in sorted(vars(cfg).items()) if k not in _PREP_IRRELEVANT}
    knobs["__icp_mode"] = cfg.loss == "icp_loss"
    if knobs["__icp_mode"]:
        knobs["__icp_inlier_ratio"] = float((cfg.loss_kwargs or {}).get("icp_inlier_ratio", 0.5))
    knobs["__device_type"] = cfg.torch_device().type
    knobs["__for_grad"] = bool(for_grad)
    if mesh:
        knobs["__mesh"] = True
    h.update(repr(knobs).encode())
    return h.hexdigest()[:32]


class _Tensor:
    """A tensor's data on the host, pickled in place of the tensor."""

    def __init__(self, array: np.ndarray):
        self.array = array


def _to_host(x):
    if isinstance(x, TransposeGraph):
        return None
    if isinstance(x, torch.Tensor):
        return _Tensor(x.detach().cpu().numpy())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _to_host(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _from_host(x, device):
    if isinstance(x, _Tensor):
        return torch.from_numpy(x.array).to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _from_host(getattr(x, f.name), device)
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _from_host(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_from_host(v, device) for v in x)
    return x


def _entry_path(cache_dir: str, fp: str) -> str:
    return os.path.join(cache_dir, "prep_%s.pkl" % fp)


def load_record(cache_dir: str, fp: str, device=None) -> Optional[dict]:
    """One sequence's record with its tensors on ``device``; None when the
    entry is missing or does not unpickle."""
    path = _entry_path(cache_dir, fp)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            rec = pickle.load(f)
    except Exception as e:  # a partial or corrupt entry is a miss
        print("[prep-cache] unreadable entry %s (%s); rebuilding" % (path, e), file=sys.stderr)
        return None
    return _from_host(rec, device)


def save_record(cache_dir: str, fp: str, rec: dict) -> None:
    """Write one sequence's record as host arrays, atomically."""
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(_to_host(rec), f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, _entry_path(cache_dir, fp))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
