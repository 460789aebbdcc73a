"""Loss-landscape sweeps over model parameters (counterpart of
``depth_correction_tpu/loss_landscape.py``).

The reference's landscape probe (reference: src/depth_correction/
loss_landscape.py:102-217): sweep a model weight over a grid with FROZEN
neighbourhoods and evaluate the loss at every value. The sweep is a loop
over the weights, forward only, on ``cfg.torch_device()``: on the
cell-window graph one launch of kernel K1 a weight, and no K2; the losses
are read back once, after the last weight.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .config import Config
from .train import TrainData, make_loss_fn, prepare_sequences

__all__ = ["loss_landscape", "sweep_weight"]


def sweep_weight(cfg: Config, data: TrainData, weights: Sequence[float],
                 exponent: Optional[Sequence[float]] = None, weight_index: int = 0,
                 plain: bool = False):
    """The loss at each value of the model's weight ``w[weight_index]``,
    the other weights as loaded.

    :param weights: grid of values (the reference sweeps e.g. 21 points in
        +-0.005, loss_landscape.py:132).
    :param plain: the plain torch moments on any device and float type
        (a reference run). The sweep runs in ``data``'s float type.
    :return: (weights, losses) numpy arrays.
    """
    from .models import load_model

    dtype = data.batches[0].poses.dtype  # the model and grid in the data's float type
    model = load_model(cfg=cfg, dtype=dtype)
    loss_fn = make_loss_fn(cfg, plain=plain)
    grid = torch.as_tensor(np.asarray(weights), dtype=dtype).numpy()
    losses = []
    with torch.no_grad():
        w0 = model.w.detach().clone()
        if exponent is not None:
            model.exponent.copy_(torch.as_tensor(np.asarray(exponent), dtype=model.exponent.dtype))
        for w in grid:
            model.w.copy_(w0)
            model.w[weight_index] = float(w)
            losses.append(loss_fn(model, data))
        losses = torch.stack(losses).cpu().numpy()
    return grid, losses


def loss_landscape(cfg: Config, datasets=None, weights: Optional[Sequence[float]] = None,
                   **sweep_kwargs):
    """Prepare the data (frozen neighbourhoods) once and sweep; returns
    (w, loss). The sanity property this probes (reference:
    loss_landscape.py:148-209): with a known injected bias the loss minimum
    sits at the ground-truth weight."""
    from .datasets import create_dataset

    if datasets is None:
        datasets = [create_dataset(n, cfg) for n in cfg.train_names]
    data = prepare_sequences(datasets, cfg)
    if weights is None:
        weights = np.linspace(-0.005, 0.005, 21)
    return sweep_weight(cfg, data, weights, **sweep_kwargs)
