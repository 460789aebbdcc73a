"""Train, then evaluate the best model (counterpart of
``depth_correction_tpu/train_and_eval.py``; reference:
src/depth_correction/train_and_eval.py:8-30)."""
from __future__ import annotations

from .config import Config
from .eval import eval_loss_all, eval_slam_all
from .train import train

__all__ = ["train_and_eval"]


def train_and_eval(cfg: Config):
    """train -> eval_loss_all(best) -> eval_slam_all(best) (reference:
    train_and_eval.py:8-11); returns (best_cfg, eval results). Set
    ``cfg.eval_slams = []`` to skip the SLAM half."""
    best_cfg = train(cfg)
    if best_cfg is None:
        best_cfg = cfg
    results = eval_loss_all(best_cfg)
    if cfg.eval_slams:
        results.update(eval_slam_all(best_cfg))
    return best_cfg, results
