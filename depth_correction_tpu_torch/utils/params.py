"""Model parameters between the two packages.

The tests build a model in the JAX package, turn its leaves into numpy
arrays (``jax.tree_util.tree_map(np.asarray, model)``) and hand that object
to :func:`params_from_jax`, so both packages compute from the same
weights; :func:`params_to_numpy` goes the other way. Neither function
imports JAX: the JAX model is read by its class name and fields.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import _STATE_FIELDS as _FIELDS
from ..models import model_by_name

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(tree, dtype=None, device=None):
    """The port's model module holding the weights of a JAX-package model
    whose leaves are numpy arrays (``dtype`` defaults to theirs)."""
    cls = model_by_name(type(tree).__name__)
    kw = {k: np.array(getattr(tree, k)) for k in _FIELDS if hasattr(tree, k)}
    if hasattr(tree, "learnable_exponents"):
        kw["learnable_exponents"] = bool(tree.learnable_exponents)
    return cls(dtype=dtype, device=device, **kw)


def params_to_numpy(model) -> dict:
    """{"class": name, field: numpy array, "learnable_exponents": bool} of
    a port model; ``jax_model_class(**{k: v for k, v in d.items() if k !=
    "class"})`` rebuilds it in the JAX package."""
    out = {"class": type(model).__name__}
    for k in _FIELDS:
        v = getattr(model, k, None)
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy().copy()
    if hasattr(model, "learnable_exponents"):
        out["learnable_exponents"] = bool(model.learnable_exponents)
    return out
