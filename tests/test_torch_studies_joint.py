"""The joint-learning studies (``model_learning``, ``model_poses_learning``,
``model_poses_learning_icp``) against the JAX package's joint learning
with the JAX scripts' ``make_cfg``, float64 on the CPU
(tests/torch_studies_common.py: ``check_joint_learning_study``).
"""
import pytest

from torch_studies_common import (JOINT_STUDIES, check_joint_learning_study,  # noqa: F401
                                   small_chunks)


@pytest.mark.parametrize("study", sorted(JOINT_STUDIES))
def test_joint_learning_study_follows_jax(study, tmp_path, monkeypatch, small_chunks):
    check_joint_learning_study(study, tmp_path, monkeypatch)
