"""Joint model and pose optimization trained on the ICP objective.

Port of the JAX package's scripts/model_poses_learning_icp.py (reference:
scripts/model_poses_learning_icp): the protocol of
:mod:`model_poses_learning` with the symmetric point-to-plane ICP loss over
consecutive scan pairs (frozen correspondences, reference
train.py:179-210), with the same map and pose accuracy probes.

Usage: python -m depth_correction_tpu_torch.studies.model_poses_learning_icp
           [--out DIR] [--device cuda]
"""
from __future__ import annotations

import sys

from .model_poses_learning import run


def main(argv=None):
    return run(argv, loss="icp_loss", out="gen/model_poses_learning_icp")


if __name__ == "__main__":
    main(sys.argv[1:])
