"""The port's pose inputs and pose-corrected training against the JAX
package's, float64 on the CPU.

Pose inputs: OverridePosesDataset (poses from a CSV file, aligned by id or
by position) and NoisyPoseDataset (per-pose or common SE(3) noise) give the
JAX package's poses bit for bit. Pose modes: none, common, sequence and
pose on two sequences over a capped gather graph (the same checks on the
cell-window graph are in tests/test_torch_pose_cellwin.py): the loss and
its gradients with respect to the model and to nonzero deltas, and six
Adam steps of both, against the JAX package's step (its make_optimizer and
_grad_mask). Then the frozen leaves, validation's own deltas (and both
packages' train() with a validation sequence), and deltas large enough to
move points across r.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from depth_correction_tpu import models as jmodels
from depth_correction_tpu.config import Config as JConfig
from depth_correction_tpu.datasets import create_dataset as j_create_dataset
from depth_correction_tpu.datasets import synthetic as jsyn
from depth_correction_tpu.datasets.asl_laser import write_poses as j_write_poses
from depth_correction_tpu.datasets.wrappers import NoisyPoseDataset as JNoisy
from depth_correction_tpu.datasets.wrappers import OverridePosesDataset as JOverride
from depth_correction_tpu.train import _grad_mask, bind_cellwin_static
from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
from depth_correction_tpu.train import make_optimizer as j_make_optimizer
from depth_correction_tpu.train import prepare_sequences as j_prepare_sequences
from depth_correction_tpu.train import train as j_train
from depth_correction_tpu_torch import models as tmodels
from depth_correction_tpu_torch.config import Config as TConfig
from depth_correction_tpu_torch.datasets import create_dataset as t_create_dataset
from depth_correction_tpu_torch.datasets import synthetic as tsyn
from depth_correction_tpu_torch.datasets.wrappers import NoisyPoseDataset as TNoisy
from depth_correction_tpu_torch.datasets.wrappers import OverridePosesDataset as TOverride
from depth_correction_tpu_torch.train import TrainCallbacks
from depth_correction_tpu_torch.train import fit as t_fit
from depth_correction_tpu_torch.train import init_pose_deltas
from depth_correction_tpu_torch.train import make_loss_fn as t_make_loss_fn
from depth_correction_tpu_torch.train import prepare_sequences as t_prepare_sequences
from depth_correction_tpu_torch.train import train as t_train

MODES = ["none", "common", "sequence", "pose"]
STEPS = 6


# ---------------------------------------------------------------------------
# Pose inputs.


def _ground(pkg, name="ground_plane/5"):
    return (jsyn if pkg == "jax" else tsyn).GroundPlaneDataset(name)


def _poses(ds):
    """Each scan's pose through both access paths: indexing and cloud_pose."""
    by_item = [np.asarray(ds[i][1]) for i in range(len(ds))]
    by_id = [np.asarray(ds.cloud_pose(i)) for i in ds.ids]
    return np.stack(by_item), np.stack(by_id)


def _write_csv(path, ids, seed):
    rng = np.random.default_rng(seed)
    poses = []
    for _ in ids:
        T = jsyn.euler_matrix(*rng.normal(scale=0.1, size=3))
        T[:3, 3] = rng.normal(size=3)
        poses.append(T)
    j_write_poses(list(ids), poses, str(path))
    return poses


@pytest.mark.parametrize("align", ["by_id", "by_position"])
def test_override_poses_match_jax(tmp_path, align):
    """Poses read from a CSV: by id when every scan id is a pose id (here a
    longer file in another order), else by position; bit for bit as the JAX
    package reads them."""
    ids = list(_ground("jax").ids)
    csv_ids = ids[::-1] + [100, 101] if align == "by_id" else [10 + i for i in ids]
    written = _write_csv(tmp_path / "poses.csv", csv_ids, 0)
    jds, tds = JOverride(_ground("jax"), str(tmp_path / "poses.csv")), \
        TOverride(_ground("port"), str(tmp_path / "poses.csv"))
    for a, b in zip(_poses(jds), _poses(tds)):
        np.testing.assert_array_equal(a, b)
    want = {i: p for i, p in zip(csv_ids, written)}
    first = want[ids[0]] if align == "by_id" else written[0]
    np.testing.assert_allclose(_poses(tds)[0][0], first, atol=1e-9)


def test_override_poses_count_mismatch_raises(tmp_path):
    """Unmatched ids and another count: both packages refuse."""
    ids = list(_ground("jax").ids)
    _write_csv(tmp_path / "poses.csv", [50 + i for i in range(len(ids) + 1)], 1)
    for cls, pkg in ((JOverride, "jax"), (TOverride, "port")):
        with pytest.raises(ValueError, match="poses for"):
            cls(_ground(pkg), str(tmp_path / "poses.csv"))


@pytest.mark.parametrize("mode,first_noisy", [("pose", False), ("pose", True),
                                              ("common", False)])
@pytest.mark.parametrize("noise", [0.05, [0.01, 0.02, 0.03, 0.1, 0.2, 0.3]])
def test_noisy_poses_match_jax(mode, first_noisy, noise):
    """Per-pose (seeded by each pose) and common (seed 135) noise, bit for
    bit through both access paths; the first pose untouched in pose mode
    unless first_noisy."""
    jds = JNoisy(_ground("jax"), noise=noise, mode=mode, first_noisy=first_noisy)
    tds = TNoisy(_ground("port"), noise=noise, mode=mode, first_noisy=first_noisy)
    (ja, jb), (ta, tb) = _poses(jds), _poses(tds)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ta, tb)
    clean = _poses(_ground("port"))[0]
    assert np.array_equal(ta[0], clean[0]) == (mode == "pose" and not first_noisy)
    assert not np.array_equal(ta[1], clean[1])


def test_create_dataset_poses_path_and_noise_match_jax(tmp_path):
    """create_dataset with a poses file under the filter and pose noise
    after the depth noise: the same clouds and poses. (No depth bias: the
    depth noise is seeded by the bits of each scan's depths, which the two
    packages' bias models round differently.)"""
    name = "ground_plane/5"
    _write_csv(tmp_path / "poses.csv", list(_ground("jax", name).ids), 2)
    kw = dict(pose_noise=0.02, pose_noise_mode="pose", depth_noise=0.01,
              depth_bias_model_kwargs={"w": [0.0], "exponent": [4.0]})
    jcfg, tcfg = _cfg(JConfig, **kw), _cfg(TConfig, **kw)
    jds = j_create_dataset(name, jcfg, poses_path=str(tmp_path / "poses.csv"))
    tds = t_create_dataset(name, tcfg, poses_path=str(tmp_path / "poses.csv"))
    assert len(jds) == len(tds) == 5
    for (jc, jp), (tc, tp) in zip(jds, tds):
        np.testing.assert_array_equal(np.asarray(tp), np.asarray(jp))
        for f in ("x", "y", "z"):
            np.testing.assert_array_equal(tc[f], jc[f])


# ---------------------------------------------------------------------------
# Pose modes.

# Two sequences of the synthetic open box (floor and walls, so every pose
# degree of freedom moves the loss), thinned to points with at least 4
# neighbours within r in their scan: a sparser neighbourhood's normal, and
# so its incidence angle and the model's gradient, is decided by rounding
# in either package (ROADMAP, standing cautions).
SEQS = ["open_box/n_2_size_4_4_2_height_1_density_40",
        "open_box/n_3_size_4_4_2_height_1_density_60"]


def _cfg(cls, **kw):
    """tests/test_torch_slice.py's configuration on the open box."""
    cfg = cls()
    cfg.float_type = "float64"
    cfg.device = "cpu"
    cfg.train_names = list(SEQS)
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.2
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.moments_backend = "cellwin"
    cfg.nn_backend = "scipy"
    cfg.cellwin_row_cap = cfg.cellwin_pt_cap = 32
    cfg.lr = 5e-4
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _thinned(name, cfg):
    """The sequence's (scan, pose) pairs as the port's create_dataset gives
    them (filtered, depth-biased), each scan thinned until every point has
    at least 4 other points within r."""
    from scipy.spatial import cKDTree

    out = []
    for scan, pose in t_create_dataset(name, cfg):
        while True:
            p = np.c_[scan["x"], scan["y"], scan["z"]]
            counts = np.array([len(b) for b in cKDTree(p).query_ball_point(p, cfg.nn_r)])
            if counts.min() >= 5:
                break
            scan = scan[counts >= 5]
        out.append((scan, np.asarray(pose)))
    return out


GRAPHS = {"cellwin": {},
          "capped": {"nn_max_neighbors": 16, "moments_backend": "gather"},
          # The uncapped within-r graph through the gather moments: the
          # reference semantics the cell-window path computes.
          "uncapped": {"moments_backend": "gather"}}


def prepare_both(graph, ref=None):
    """Both packages' prepared sequences from the same thinned scans: the
    port's on ``graph``, the JAX package's on ``ref`` (default the same).
    Returns (ref, the port's config options, JAX data, port data)."""
    ref = ref or graph
    kw = GRAPHS[graph]
    jcfg, tcfg = _cfg(JConfig, **GRAPHS[ref]), _cfg(TConfig, **kw)
    seqs = [_thinned(n, tcfg) for n in SEQS]
    jdata = j_prepare_sequences(seqs, jcfg)
    tdata = t_prepare_sequences(seqs, tcfg)
    assert all(c is not None for c in tdata.cellwin) == (graph == "cellwin")
    assert all(c is not None for c in jdata.cellwin) == (ref == "cellwin")
    return ref, kw, jdata, tdata


# The capped gather graph here; tests/test_torch_pose_cellwin.py runs the
# same checks on the cell-window graph.
@pytest.fixture(scope="module")
def prepared():
    return prepare_both("capped")


def _seed_deltas(mode, data, scale=1e-3, seed=0):
    """Nonzero deltas of a few mm and mrad (numpy), shaped for ``mode``;
    the first pose's row zero in pose mode, as training keeps it."""
    if mode == "none":
        return None
    rng = np.random.default_rng(seed)
    shapes = ([(1, 6)] if mode == "common" else
              [(1 if mode == "sequence" else b.num_scans, 6) for b in data.batches])
    out = [scale * rng.standard_normal(s) for s in shapes]
    if mode == "pose":
        for d in out:
            d[0] = 0.0
    return out


# The JAX package's jitted value and gradient, by (graph, mode): compiled
# once for each (the cell-window kernels in interpret mode compile slowly).
_JAX_GRAD = {}


def _jax_run(graph, mode, jdata, deltas, steps=STEPS, **cfg_kw):
    """(value, grads) at the start (the gradient unmasked, as the loss
    gives it) and the (w, deltas) after each of ``steps`` Adam steps of the
    JAX package's step (train.py:1099-1115: masked by _grad_mask) on
    ``graph``'s options."""
    jcfg = _cfg(JConfig, pose_correction=mode, **GRAPHS[graph], **cfg_kw)
    if (graph, mode) not in _JAX_GRAD:
        loss_fn, data = bind_cellwin_static(j_make_loss_fn(jcfg), jdata)
        _JAX_GRAD[graph, mode] = jax.jit(jax.value_and_grad(loss_fn)), data
    grad_fn, data = _JAX_GRAD[graph, mode]
    params = {"model": jmodels.load_model(cfg=jcfg)}
    if deltas is not None:
        params["pose_deltas"] = tuple(jnp.asarray(d) for d in deltas)
    tx = j_make_optimizer(jcfg)
    gmask = _grad_mask(params, jcfg)
    state = tx.init(params)
    first, traj = None, []
    for it in range(max(steps, 1)):
        value, grads = grad_fn(params, data)
        if first is None:
            first = (float(value), jax.tree_util.tree_map(np.asarray, grads))
        if it >= steps:
            break
        grads = jax.tree_util.tree_map(lambda g, m: g * m, grads, gmask)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        traj.append((np.asarray(params["model"].w),
                     [np.asarray(d) for d in params.get("pose_deltas", ())]))
    return first, traj


class _Record(TrainCallbacks):
    """The model's w and the deltas each step starts from."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.w, self.deltas = [], []

    def train_loss(self, it, model, pose_deltas, loss):
        self.w.append(model.w.detach().numpy().copy())
        self.deltas.append([d.detach().numpy().copy() for d in pose_deltas or ()])


def _port_run(mode, kw, tdata, deltas, steps=STEPS, **cfg_kw):
    """The port's (value, w grad, delta grads) at the start, and fit()'s
    (w, deltas) after each of ``steps`` Adam steps (read at the next step's
    start, so fit runs one step more); with ``steps`` 0 no fit."""
    tcfg = _cfg(TConfig, pose_correction=mode, **kw, **cfg_kw)
    model = tmodels.load_model(cfg=tcfg)
    leaves = (None if deltas is None else
              tuple(torch.tensor(d, requires_grad=True) for d in deltas))
    value = t_make_loss_fn(tcfg)(model, tdata, leaves)
    value.backward()
    first = (float(value.detach()), model.w.grad.numpy().copy(),
             [d.grad.numpy().copy() for d in leaves or ()])
    if not steps:
        return first, [], None
    leaves = (None if deltas is None else
              tuple(torch.tensor(d, requires_grad=True) for d in deltas))
    tcfg.n_opt_iters = steps + 1
    rec = _Record(tcfg)
    t_fit(tcfg, tdata, callbacks=rec, pose_deltas=leaves)
    return first, list(zip(rec.w[1:], rec.deltas[1:])), leaves


def _check_grads(port_first, jax_first):
    tv, tgw, tgd = port_first
    jv, jg = jax_first
    np.testing.assert_allclose(tv, jv, rtol=1e-9)
    np.testing.assert_allclose(tgw, np.asarray(jg["model"].w), rtol=1e-9)
    assert len(tgd) == len(jg.get("pose_deltas", ()))
    for a, b in zip(tgd, jg.get("pose_deltas", ())):
        np.testing.assert_allclose(a, b, rtol=1e-9)


def check_pose_modes_match_jax(prepared, mode):
    """Loss and gradients (w and the deltas) at nonzero deltas within rtol
    1e-9; six Adam steps of w and the deltas within 1e-8; the first pose
    exactly 0 throughout in pose mode."""
    graph, kw, jdata, tdata = prepared
    deltas = _seed_deltas(mode, tdata)
    jfirst, jtraj = _jax_run(graph, mode, jdata, deltas)
    tfirst, ttraj, leaves = _port_run(mode, kw, tdata, deltas)
    _check_grads(tfirst, jfirst)
    assert len(ttraj) == len(jtraj) == STEPS
    for (tw, td), (jw, jd) in zip(ttraj, jtraj):
        np.testing.assert_allclose(tw, jw, rtol=1e-8)
        assert len(td) == len(jd)
        for a, b in zip(td, jd):
            np.testing.assert_allclose(a, b, rtol=1e-8)
            if mode == "pose":
                assert not a[0].any() and not b[0].any()
    for d, s in zip(leaves or (), deltas or ()):
        moved = d.detach().numpy() != s
        assert moved[1:].all() if mode == "pose" else moved.all()
        assert not moved[0].any() or mode != "pose"


def check_optimize_model_false_freezes_w(prepared):
    """optimize_model = False: w stays exactly as loaded while the deltas
    move, as in the JAX package."""
    graph, kw, jdata, tdata = prepared
    deltas = _seed_deltas("sequence", tdata)
    _, jtraj = _jax_run(graph, "sequence", jdata, deltas, steps=3, optimize_model=False)
    _, ttraj, leaves = _port_run("sequence", kw, tdata, deltas, steps=3, optimize_model=False)
    for (tw, td), (jw, jd) in zip(ttraj, jtraj):
        assert not tw.any() and not np.asarray(jw).any()
        for a, b in zip(td, jd):
            np.testing.assert_allclose(a, b, rtol=1e-8)
    assert all((d.detach().numpy() != s).all() for d, s in zip(leaves, deltas))


def check_deltas_across_r_match_jax(prepared):
    """Deltas of up to 0.3 m and 0.2 rad move points across r = 0.4 m.
    Membership is frozen at establishment in both packages, so the loss
    and its gradients still agree."""
    graph, kw, jdata, tdata = prepared
    deltas = _seed_deltas("pose", tdata, scale=0.15, seed=3)
    jfirst, _ = _jax_run(graph, "pose", jdata, deltas, steps=0)
    tfirst, _, _ = _port_run("pose", kw, tdata, deltas, steps=0)
    assert max(np.abs(d[:, :3]).max() for d in deltas) > 0.3
    _check_grads(tfirst, jfirst)


def test_init_pose_deltas_shapes(prepared):
    """Zero leaves that require grad: one (1, 6) for common, one a sequence
    for sequence, (S, 6) a sequence for pose, None for none."""
    _, _, _, tdata = prepared
    shapes = {}
    for mode in MODES:
        d = init_pose_deltas(tdata, _cfg(TConfig, pose_correction=mode))
        shapes[mode] = None if d is None else [tuple(x.shape) for x in d]
        assert d is None or all(x.requires_grad and not x.detach().any() for x in d)
    scans = [b.num_scans for b in tdata.batches]
    assert shapes == {"none": None, "common": [(1, 6)], "sequence": [(1, 6)] * 2,
                      "pose": [(s, 6) for s in scans]}


def test_sgd_pose_mode_matches_jax(prepared):
    """SGD with momentum in pose mode: three steps of w and the deltas
    within 1e-8 of the JAX package's, the first pose exactly 0 (its zero
    gradient leaves it, and its momentum, at 0)."""
    graph, kw, jdata, tdata = prepared
    deltas = _seed_deltas("pose", tdata)
    opt = dict(optimizer="sgd", optimizer_kwargs={"momentum": 0.9})
    _, jtraj = _jax_run(graph, "pose", jdata, deltas, steps=3, **opt)
    _, ttraj, leaves = _port_run("pose", kw, tdata, deltas, steps=3, **opt)
    assert len(ttraj) == len(jtraj) == 3
    for (tw, td), (jw, jd) in zip(ttraj, jtraj):
        np.testing.assert_allclose(tw, jw, rtol=1e-8)
        for a, b in zip(td, jd):
            np.testing.assert_allclose(a, b, rtol=1e-8)
            assert not a[0].any() and not b[0].any()
    assert all((d.detach()[1:].numpy() != s[1:]).all() for d, s in zip(leaves, deltas))


@pytest.mark.parametrize("data_dtype,delta_dtype", [(torch.float32, torch.float64),
                                                     (torch.float64, torch.float32)])
def test_mixed_precision_gradient_reaches_the_leaf(prepared, data_dtype, delta_dtype):
    """Deltas in another float type than the poses: corrected_poses casts
    them to the poses' type, and the gradient reaches the optimizer's leaf
    in the leaf's own type, within float32 rounding of the float64 one."""
    _, kw, _, tdata = prepared
    tcfg = _cfg(TConfig, pose_correction="pose", **kw)
    deltas = _seed_deltas("pose", tdata)
    (_, _, want), _, _ = _port_run("pose", kw, tdata, deltas, steps=0)
    data = tdata.to(dtype=data_dtype)
    assert data.batches[0].poses.dtype == data_dtype
    model = tmodels.load_model(cfg=tcfg, dtype=data_dtype)
    leaves = tuple(torch.tensor(d, dtype=delta_dtype, requires_grad=True) for d in deltas)
    t_make_loss_fn(tcfg)(model, data, leaves).backward()
    for leaf, g in zip(leaves, want):
        assert leaf.grad.dtype == delta_dtype
        np.testing.assert_allclose(leaf.grad.double().numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max())


# ---------------------------------------------------------------------------
# Validation deltas.


def check_validation_trains_its_own_deltas(prepared, mode):
    """fit() with validation data: in sequence and pose modes the validation
    loss is taken at the validation sequences' own deltas, zero at the
    first step and moved by their own optimizer after it; in common mode at
    the training delta the step starts from."""
    _, kw, _, tdata = prepared
    tcfg = _cfg(TConfig, pose_correction=mode, n_opt_iters=3, **kw)
    loss_fn = t_make_loss_fn(tcfg)
    seen = []

    class Rec(TrainCallbacks):
        def train_loss(self, it, model, pose_deltas, loss):
            self.deltas = tuple(d.detach().clone() for d in pose_deltas)

        def val_loss(self, it, model, pose_deltas, loss):
            with torch.no_grad():
                at_zero = float(loss_fn(model, tdata))
                at_train = float(loss_fn(model, tdata, self.deltas))
            seen.append((float(loss.detach()), at_zero, at_train))

    t_fit(tcfg, tdata, callbacks=Rec(tcfg), val_data=tdata,
          pose_deltas=tuple(torch.tensor(d, requires_grad=True)
                            for d in _seed_deltas(mode, tdata)))
    assert len(seen) == 3
    for it, (val, at_zero, at_train) in enumerate(seen):
        if mode == "common":
            assert val == at_train and val != at_zero
        elif it == 0:
            assert val == at_zero
        else:
            assert val != at_zero and val != at_train


@pytest.mark.parametrize("mode", MODES)
def test_pose_modes_match_jax(prepared, mode):
    check_pose_modes_match_jax(prepared, mode)


def test_optimize_model_false_freezes_w(prepared):
    check_optimize_model_false_freezes_w(prepared)


def test_deltas_across_r_match_jax(prepared):
    check_deltas_across_r_match_jax(prepared)


@pytest.mark.parametrize("mode", ["common", "sequence", "pose"])
def test_validation_trains_its_own_deltas(prepared, mode):
    check_validation_trains_its_own_deltas(prepared, mode)


# Both packages' train() with a validation sequence.


@pytest.mark.parametrize("mode", ["common", "sequence", "pose"])
def test_validation_deltas_match_jax(tmp_path, mode):
    """Both packages' train() on the first sequence with the second as
    validation (the capped graph): the histories (train and val losses)
    agree within rtol 1e-9 and both save the best step's deltas under the
    same tag."""
    kw = dict(n_opt_iters=3, pose_correction=mode, lr=2e-3, **GRAPHS["capped"])
    jcfg = _cfg(JConfig, log_dir=str(tmp_path / "jax"), **kw)
    tcfg = _cfg(TConfig, log_dir=str(tmp_path / "port"), **kw)
    train_seq, val_seq = (_thinned(n, tcfg) for n in SEQS)
    jbest = j_train(jcfg, train_datasets=[train_seq], val_datasets=[val_seq])
    tbest = t_train(tcfg, train_datasets=[train_seq], val_datasets=[val_seq])

    def rows(d):
        return np.loadtxt(os.path.join(d, "train_history.csv"), skiprows=1, ndmin=2)

    jrows, trows = rows(jcfg.log_dir), rows(tcfg.log_dir)
    np.testing.assert_allclose(trows[:, 1:3], jrows[:, 1:3], rtol=1e-9)
    assert not np.array_equal(trows[:, 2], trows[:, 1])
    assert os.path.basename(tbest.train_pose_deltas) == os.path.basename(jbest.train_pose_deltas)
    assert tbest.train_pose_deltas.endswith("_pose_deltas.npz")
    tdeltas = np.load(tbest.train_pose_deltas)
    jdeltas = np.load(jbest.train_pose_deltas)
    assert sorted(tdeltas.files) == sorted(jdeltas.files) == ["0"]
    np.testing.assert_allclose(tdeltas["0"], jdeltas["0"], rtol=1e-8, atol=1e-15)
