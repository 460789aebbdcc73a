"""Pytree files in the JAX package's npz format (counterpart of
``depth_correction_tpu/utils/checkpoint.py:32-49``).

A tree of dicts, lists and tuples whose leaves are tensors or arrays is
stored as a compressed ``.npz``, one array a leaf, keyed by the leaf's
path joined with ``/`` (a dict key or a sequence index, as JAX's tree
paths name them). So a file written by either package
loads in the other: the pose deltas of ``train()`` (a tuple of (1, 6) or
(S, 6) arrays, keys ``0``, ``1``, ...) among them. The orbax train-state
checkpoints of the JAX package are not ported.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

__all__ = ["load_pytree", "save_pytree"]


def _flatten(tree: Any, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if tree is None:
            return
        leaf = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
        out[prefix or "value"] = leaf
        return
    for key, sub in items:
        _flatten(sub, "%s/%s" % (prefix, key) if prefix else str(key), out)


def save_pytree(path: str, tree: Any) -> str:
    """Save the leaves of ``tree`` as npz; returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves: dict = {}
    _flatten(tree, "", leaves)
    np.savez_compressed(path, **leaves)
    return path


def load_pytree(path: str) -> dict:
    """A saved tree as a flat {last path component: array} dict (the JAX
    package's reading); ``path`` may leave out the ``.npz`` suffix."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        return {k.split("/")[-1]: data[k] for k in data.files}
