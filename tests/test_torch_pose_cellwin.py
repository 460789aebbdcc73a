"""The pose-mode checks of tests/test_torch_pose.py on the cell-window
graph (float64, CPU): the JAX package's Pallas kernels in interpret mode,
the port's plain twins of K1 and K2; a pose delta's gradient reaches it
through K2's twin, the inverse permutation and the pose transform."""
import pytest

from test_torch_pose import (MODES, check_deltas_across_r_match_jax,
                             check_optimize_model_false_freezes_w,
                             check_pose_modes_match_jax,
                             check_validation_trains_its_own_deltas, prepare_both)


@pytest.fixture(scope="module")
def prepared():
    return prepare_both("cellwin")


@pytest.mark.parametrize("mode", MODES)
def test_pose_modes_match_jax_cellwin(prepared, mode):
    check_pose_modes_match_jax(prepared, mode)


def test_optimize_model_false_freezes_w_cellwin(prepared):
    check_optimize_model_false_freezes_w(prepared)


def test_deltas_across_r_match_jax_cellwin(prepared):
    check_deltas_across_r_match_jax(prepared)


@pytest.mark.parametrize("mode", ["common", "sequence", "pose"])
def test_validation_trains_its_own_deltas_cellwin(prepared, mode):
    check_validation_trains_its_own_deltas(prepared, mode)
