"""Model-only training on static scans with the ICP objective.

Port of the JAX package's scripts/model_learning.py (reference:
scripts/model_learning:1-232): optimize the depth-correction model alone
(no pose deltas) on static stop-and-scan pairs with the point-to-plane ICP
loss, tracking mapping accuracy against the GT map; the protocol of
:mod:`model_poses_learning` with ``pose_correction`` none.

Usage: python -m depth_correction_tpu_torch.studies.model_learning
           [--loss icp_loss] [--out DIR] [--device cuda]
"""
from __future__ import annotations

import sys

from .model_poses_learning import run


def main(argv=None):
    return run(argv, pose_correction="none", loss="icp_loss", out="gen/model_learning")


if __name__ == "__main__":
    main(sys.argv[1:])
