"""The pose-mode checks of tests/test_torch_pose.py on the cell-window
graph (float64, CPU): the port's plain twins of K1 and K2 against the JAX
package's gather moments on the same uncapped within-r graph, the
reference semantics. A pose delta's gradient reaches the port through K2's
twin, the inverse permutation and the pose transform; the scans' invalid
(padding) points get none. (The JAX package's own cell-window path hands
them the gradient of the first point slot, which moves a delta's
translation gradient; the port does not follow it there.)"""
import pytest

from test_torch_pose import (MODES, check_deltas_across_r_match_jax,
                             check_optimize_model_false_freezes_w,
                             check_pose_modes_match_jax,
                             check_validation_trains_its_own_deltas, prepare_both)


@pytest.fixture(scope="module")
def prepared():
    return prepare_both("cellwin", ref="uncapped")


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
