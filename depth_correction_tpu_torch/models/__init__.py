"""Depth-correction model families as ``nn.Module``s (counterpart of
``depth_correction_tpu/models/__init__.py``).

Each model (reference: src/depth_correction/model.py:70-354) offers

- ``bias(inc_angles)``      -> per-point depth bias,
- ``correct_depth(d, inc)`` -> corrected depth,
- ``inverse_depth(d, inc)`` -> un-corrected depth (used to inject synthetic
  bias into datasets, reference: dataset.py:850-873),
- ``apply(cloud)`` / ``inverse(cloud)`` -> new Cloud with corrected /
  un-corrected depth where ``cloud.mask`` holds (model.py:250-261).

Trainable weights are ``nn.Parameter``s; exponents are buffers (frozen, as
in the reference, model.py:170) unless ``learnable_exponents``. ``apply``
deliberately shadows ``nn.Module.apply``: these modules have no children.
A saved state (``model_state_dict``) is the JAX package's npz checkpoint
(``utils/checkpoint.py:save_pytree``): one array a weight field, keyed by
the field's name. :func:`save_state_file` writes it, :func:`load_state_file`
reads it.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..cloud import Cloud

__all__ = [
    "BaseModel",
    "InvCos",
    "Linear",
    "Polynomial",
    "ScaledInvCos",
    "ScaledPolynomial",
    "load_model",
    "load_state_file",
    "model_by_name",
    "model_state",
    "save_state_file",
]


def _apply_masked(cloud: Cloud, depth_corr: torch.Tensor) -> Cloud:
    """New cloud with corrected depth on masked points only."""
    if cloud.mask is not None:
        depth_corr = torch.where(cloud.mask, depth_corr, cloud.depth)
    return cloud.replace(depth=depth_corr, points=None)


class BaseModel(nn.Module):
    """Identity correction (reference: model.py:70-98)."""

    def bias(self, inc_angles: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(inc_angles)

    def correct_depth(self, depth, inc_angles):
        return depth

    def inverse_depth(self, depth, inc_angles):
        return depth

    def apply(self, cloud: Cloud) -> Cloud:
        return _apply_masked(cloud, self.correct_depth(cloud.depth, cloud.inc_angles))

    def inverse(self, cloud: Cloud) -> Cloud:
        return _apply_masked(cloud, self.inverse_depth(cloud.depth, cloud.inc_angles))

    def forward(self, cloud: Cloud) -> Cloud:
        return self.apply(cloud)


def _scalar(value, default: float, dtype, device) -> nn.Parameter:
    v = torch.as_tensor(default if value is None else value, dtype=dtype, device=device)
    return nn.Parameter(v.reshape(()).clone())


class Linear(BaseModel):
    """depth' = w0 * depth + w1 * inc_angle + b (reference: model.py:113-146;
    JAX package, models/__init__.py:81-100)."""

    def __init__(self, w0=None, w1=None, b=None, dtype=None, device=None):
        super().__init__()
        self.w0 = _scalar(w0, 1.0, dtype, device)
        self.w1 = _scalar(w1, 0.0, self.w0.dtype, self.w0.device)
        self.b = _scalar(b, 0.0, self.w0.dtype, self.w0.device)

    def correct_depth(self, depth, inc_angles):
        return self.w0 * depth + self.w1 * inc_angles + self.b

    def inverse_depth(self, depth, inc_angles):
        return (depth - self.w1 * inc_angles - self.b) / self.w0

    def __str__(self):
        return "Linear(%.6g, %.6g, %.6g)" % (float(self.w0), float(self.w1), float(self.b))


def _poly_bias(w, exponent, inc_angles, learnable_exponents: bool = False):
    """bias = sum_i w_i * gamma^e_i (reference: model.py:172-177).

    Shapes: w, exponent (E,), inc_angles (..., N) -> (..., N). Exponents
    are detached unless learnable (the reference freezes them, model.py:170).
    """
    if not learnable_exponents:
        exponent = exponent.detach()
    x = torch.pow(inc_angles[..., None], exponent)  # (..., N, E)
    return x @ w  # full precision: TF32 is off for the package


class _PolyBase(BaseModel):
    def __init__(self, w=None, exponent=None, learnable_exponents: bool = False,
                 dtype=None, device=None):
        super().__init__()
        exponent = torch.as_tensor(
            [2.0, 4.0] if exponent is None else exponent, dtype=dtype,
            device=device,
        ).reshape(-1)
        w = (torch.zeros_like(exponent) if w is None
             else torch.as_tensor(w, dtype=exponent.dtype,
                                  device=exponent.device).reshape(-1))
        self.learnable_exponents = bool(learnable_exponents)
        self.w = nn.Parameter(w.clone())
        if self.learnable_exponents:
            self.exponent = nn.Parameter(exponent.clone())
        else:
            self.register_buffer("exponent", exponent.clone())

    def bias(self, inc_angles):
        return _poly_bias(self.w, self.exponent, inc_angles,
                          self.learnable_exponents)

    def _terms(self):
        return ", ".join(
            "%.6gx^%.6g" % (float(w), float(e))
            for w, e in zip(self.w.detach().reshape(-1).tolist(),
                            self.exponent.detach().reshape(-1).tolist())
        )


class Polynomial(_PolyBase):
    """depth' = depth - sum_i w_i * gamma^e_i (reference: model.py:149-215)."""

    def correct_depth(self, depth, inc_angles):
        return depth - self.bias(inc_angles)

    def inverse_depth(self, depth, inc_angles):
        # Exact inverse of the subtractive correction (the JAX package's
        # choice; the reference's unmasked branch divides, model.py:197).
        return depth + self.bias(inc_angles)

    def __str__(self):
        return "Polynomial(%s)" % self._terms()


class ScaledPolynomial(_PolyBase):
    """depth' = depth * (1 - sum_i w_i * gamma^e_i) (reference: model.py:218-286)."""

    def correct_depth(self, depth, inc_angles):
        return depth * (1.0 - self.bias(inc_angles))

    def inverse_depth(self, depth, inc_angles):
        return depth / (1.0 - self.bias(inc_angles))

    def __str__(self):
        return "ScaledPolynomial(%s)" % self._terms()


class InvCos(BaseModel):
    """depth' = depth - p0 / cos(gamma) (reference: model.py:289-313; JAX
    package, models/__init__.py:192-209)."""

    def __init__(self, p0=None, dtype=None, device=None):
        super().__init__()
        self.p0 = _scalar(p0, 0.0, dtype, device)

    def bias(self, inc_angles):
        return self.p0 / torch.cos(inc_angles)

    def correct_depth(self, depth, inc_angles):
        return depth - self.bias(inc_angles)

    def inverse_depth(self, depth, inc_angles):
        return depth + self.bias(inc_angles)

    def __str__(self):
        return "InvCos(%.6g)" % float(self.p0)


class ScaledInvCos(BaseModel):
    """depth' = depth * (1 - p0 / |cos(gamma)|) (reference: model.py:316-349;
    JAX package, models/__init__.py:212-229)."""

    def __init__(self, p0=None, dtype=None, device=None):
        super().__init__()
        self.p0 = _scalar(p0, 0.0, dtype, device)

    def bias(self, inc_angles):
        return self.p0 / torch.abs(torch.cos(inc_angles))

    def correct_depth(self, depth, inc_angles):
        return depth * (1.0 - self.bias(inc_angles))

    def inverse_depth(self, depth, inc_angles):
        return depth / (1.0 - self.bias(inc_angles))

    def __str__(self):
        return "ScaledInvCos(%.6g)" % float(self.p0)


_MODELS = {
    "BaseModel": BaseModel,
    "Linear": Linear,
    "InvCos": InvCos,
    "Polynomial": Polynomial,
    "ScaledInvCos": ScaledInvCos,
    "ScaledPolynomial": ScaledPolynomial,
}


def model_by_name(name: str):
    """Whitelisted model lookup (reference: model.py:352-354)."""
    if name not in _MODELS:
        raise ValueError("Unknown model: %s" % name)
    return _MODELS[name]


def _coerce(cls, kwargs: dict) -> dict:
    """Normalize constructor kwargs (scalar w, legacy p0/p1 form)."""
    kwargs = {k: v for k, v in dict(kwargs).items() if k != "device"}
    if cls in (Polynomial, ScaledPolynomial):
        # Legacy two-term form: p0, p1 with exponents (2, 4)
        # (reference: model.py:151-160).
        p0 = kwargs.pop("p0", None)
        p1 = kwargs.pop("p1", None)
        if "exponent" not in kwargs and (p0 is not None or p1 is not None):
            kwargs["w"] = [p0 or 0.0, p1 or 0.0]
            kwargs["exponent"] = [2.0, 4.0]
        if isinstance(kwargs.get("w"), float):
            kwargs["w"] = [kwargs["w"]]
        if kwargs.get("exponent") is not None and kwargs.get("w") is None:
            kwargs["w"] = [0.0] * len(list(kwargs["exponent"]))
    return {k: v for k, v in kwargs.items() if v is not None}


# The weight fields a model may have, the JAX package's dataclass leaves.
_STATE_FIELDS = ("w", "exponent", "w0", "w1", "b", "p0")


def model_state(model) -> dict:
    """{field: tensor} of the model's weight fields, detached clones on the
    model's device (taken without a sync)."""
    return {k: getattr(model, k).detach().clone() for k in _STATE_FIELDS
            if isinstance(getattr(model, k, None), torch.Tensor)}


def save_state_file(path: str, state: dict) -> str:
    """Write ``state`` ({field: tensor or array}) as the npz file the JAX
    package's ``save_pytree`` writes for a model (one array a field);
    returns ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                 else np.asarray(v) for k, v in state.items()})
    return path


def load_state_file(path: str) -> dict:
    """A saved model state as a flat {name: array} dict: the npz file the
    JAX package writes (utils/checkpoint.py:32-49), keys matched by their
    trailing name; ``path`` may leave out the ``.npz`` suffix."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        return {k.split("/")[-1]: data[k] for k in data.files}


def load_model(class_name: Optional[str] = None,
               model_args: Optional[Sequence] = None,
               model_kwargs: Optional[dict] = None,
               state_dict=None, cfg=None, dtype=None, device=None):
    """Construct a model from config and/or a saved state: a dict of
    arrays or the path of an npz file (:func:`load_state_file`)
    (reference: model.py:19-67; JAX package, models/__init__.py:274-310).
    ``cfg`` supplies the class, arguments, dtype (``cfg.torch_dtype()``)
    and device (``cfg.torch_device()``)."""
    if cfg is not None:
        class_name = class_name or cfg.model_class
        if model_args is None:
            model_args = list(cfg.model_args or [])
        if model_kwargs is None:
            model_kwargs = dict(cfg.model_kwargs or {})
        if state_dict is None:
            state_dict = cfg.model_state_dict
        dtype = dtype or cfg.torch_dtype()
        device = device or cfg.torch_device()
    if isinstance(state_dict, str) and state_dict:
        state_dict = load_state_file(state_dict)
    cls = model_by_name(class_name)
    kw = _coerce(cls, model_kwargs or {})
    if state_dict:
        kw.update(_coerce(cls, dict(state_dict)))
    if cls is BaseModel:
        return BaseModel().to(device)
    return cls(*(model_args or []), dtype=dtype, device=device, **kw)
