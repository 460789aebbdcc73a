"""Multi-GPU training and evaluation over ``torch.distributed`` (the port's
``parallel/``), on the CPU, against the port's one-rank run and the JAX
package's single-device run.

One module fixture starts six processes of tests/torch_parallel_worker.py
(they import the port only): four ranks of a gloo group, a one-rank group
and one process without a group, each joining through a ``file://`` store
in ``tmp_path``. Each runs every scenario in float64 on ground_plane/3
(1,536 padded points; a cell-window graph of 89 row and 89 point tiles of
32, so 3 empty padding tiles over 4 ranks, and 46 exception rows) and
pickles its results. Meanwhile this process computes the JAX package's
single-device references on the tables the port's single-device prep
freezes (the uncapped graph through the JAX gather moments, which compute
the cell-window engine's moments; its gradients are autodiff's).

Every scenario is held to the port's one-rank group within 1e-10 and to
the JAX package within 1e-9, relative to the largest magnitude of the
compared values; the one-rank group is also held to the ungrouped run
within 1e-10. The four ranks must hold the same losses and gradients, bit
for bit, and each a quarter of every point and row table. A run resumed
with a log_dir a rank resumes every rank from rank 0's checkpoint, and
the ICP evaluation under the group writes one row.
"""
import dataclasses
import os
import pickle
import socket
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_worker as worker  # noqa: E402

from depth_correction_tpu_torch.config import Config as TConfig  # noqa: E402
from depth_correction_tpu_torch.parallel import sharding  # noqa: E402
from depth_correction_tpu_torch.parallel.dryrun import dryrun_multichip, start, wait_all  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_SCENARIOS = list(worker.SCENARIOS)
SCENARIOS = LOSS_SCENARIOS + ["grid_est", "knn_est", "train", "eval", "lbfgs", "resume",
                              "eval_all"]
# (world, rank) of each process: four ranks, a one-rank group, no group.
RUNS = [(4, 0), (4, 1), (4, 2), (4, 3), (1, 0), (0, 0)]


class _Runs:
    """The worker processes, started at once; :meth:`results` waits."""

    def __init__(self, out_dir):
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.out_dir = str(out_dir)
        script = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
        self.procs = [start([sys.executable, script, str(r), str(w),
                             os.path.join(self.out_dir, "store%d" % w), self.out_dir],
                            env=env, cwd=self.out_dir) for w, r in RUNS]
        self._results = None

    def results(self):
        if self._results is None:
            wait_all(self.procs, timeout=600)
            self._results = {}
            for w, r in RUNS:
                with open(os.path.join(self.out_dir, "rank%d_%d.pkl" % (w, r)), "rb") as f:
                    self._results[(w, r)] = pickle.load(f)
        return self._results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    handle = _Runs(tmp_path_factory.mktemp("ranks"))
    yield handle
    wait_all(handle.procs, timeout=600)


def _to_jax(tdata):
    """The JAX package's TrainData holding the port's prepared tables: the
    gather path's compacted rows (the cell-window graph's offset rows
    mapped back through its row_map), planes, ICP correspondences."""
    import jax.numpy as jnp

    from depth_correction_tpu.cloud import Cloud as JCloud
    from depth_correction_tpu.preproc import SequenceBatch as JBatch
    from depth_correction_tpu.segmentation import Planes as JPlanes
    from depth_correction_tpu.train import TrainData as JData

    def arr(x, dtype=None):
        if x is None:
            return None
        x = x.detach().cpu().numpy()
        return jnp.asarray(x if dtype is None else x.astype(dtype))

    def seq(i, b):
        cloud = JCloud(**{f.name: arr(getattr(b.cloud, f.name))
                          for f in dataclasses.fields(b.cloud)})
        nn = tdata.neighbors[i]
        if nn is not None and hasattr(nn, "member_idx"):
            nn = JPlanes(params=arr(nn.params), member_idx=arr(nn.member_idx, np.int32),
                         member_weights=arr(nn.member_weights), valid=arr(nn.valid))
        else:
            nn = arr(nn, np.int32)
        onn = tdata.off_neighbors[i] if tdata.off_neighbors else None
        cw = tdata.cellwin[i] if tdata.cellwin else None
        if onn is not None and cw is not None:
            rm = cw.row_map
            back = onn.new_full((tdata.neighbors[i].shape[0], onn.shape[1]), -1)
            back[rm[rm >= 0]] = onn[rm >= 0]
            onn = back
        icp = bool(tdata.icp_idx) and tdata.icp_idx[i] is not None
        return (JBatch(cloud=cloud, poses=arr(b.poses)), nn, arr(tdata.weights[i]),
                arr(tdata.masks[i]), arr(tdata.query_rows[i], np.int32),
                arr(onn, np.int32), None if onn is None else arr((onn >= 0).double()),
                arr(tdata.icp_idx[i], np.int32) if icp else None,
                arr(tdata.icp_w[i]) if icp else None)

    cols = list(zip(*[seq(i, b) for i, b in enumerate(tdata.batches)]))
    none = tuple(None for _ in cols[0])
    return JData(batches=cols[0], neighbors=cols[1], weights=cols[2], masks=cols[3],
                 query_rows=cols[4], off_neighbors=cols[5], off_weights=cols[6],
                 off_transpose=none, t_neighbors=none, t_slots=none, t_weights=none,
                 icp_idx=cols[7], icp_w=cols[8])


def _jax_refs():
    """The JAX package's single-device loss, gradients and steps of every
    scenario, on the tables the port's single-device prep froze (prep
    parity is held elsewhere: tests/test_torch_slice.py, test_torch_offset.py,
    test_torch_icp.py, test_torch_segmentation.py), and its searches."""
    import jax
    import jax.numpy as jnp
    import optax

    from depth_correction_tpu.config import Config as JConfig
    from depth_correction_tpu.models import ScaledPolynomial as JScaledPolynomial
    from depth_correction_tpu.ops import knn as jknn
    from depth_correction_tpu.ops.grid_hash import grid_radius_neighbors as j_grid
    from depth_correction_tpu.train import make_loss_fn as j_make_loss_fn
    from depth_correction_tpu.train import make_optimizer as j_make_optimizer
    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.train import prepare_sequences

    def value_and_grad(kw):
        tcfg = worker.config(TConfig, **kw)
        data = _to_jax(prepare_sequences([create_dataset(worker.SEQ, tcfg)], tcfg))
        kw = dict(kw)
        kw.pop("moments_backend", None)
        loss_fn = j_make_loss_fn(worker.config(JConfig, **kw))

        def f(w, deltas):
            params = {"model": JScaledPolynomial(w=w, exponent=jnp.asarray([4.0]))}
            if deltas is not None:
                params["pose_deltas"] = deltas
            return loss_fn(params, data)

        return jax.jit(jax.value_and_grad(f, argnums=(0, 1))), f, data

    refs = {}
    w0 = jnp.asarray([worker.W])
    base = base_f = None
    for name, kw in worker.SCENARIOS.items():
        vg, f, data = value_and_grad(kw)
        deltas = None
        if kw.get("pose_correction") == "pose":
            deltas = tuple(jnp.asarray(worker.pose_deltas(b.num_scans)) for b in data.batches)
        value, (gw, gd) = vg(w0, deltas)
        refs[name] = {"loss": float(value), "grad_w": np.asarray(gw),
                      "grad_deltas": [np.asarray(g) for g in gd or ()]}
        if name == "cellwin":
            base, base_f = vg, f
    # The cell-window path's deltas too are held to the gather path's: its
    # invalid (padding) points take no gradient.
    refs["eval"] = {"loss": refs["cellwin"]["loss"]}

    def steps(optimizer, n):
        tx = j_make_optimizer(worker.config(JConfig, optimizer=optimizer))
        w, state, losses = w0, tx.init(w0), []
        for _ in range(n):
            value, (g, _) = base(w, None)
            losses.append(float(value))
            updates, state = tx.update(g, state, w, value=value, grad=g,
                                       value_fn=lambda v: base_f(v, None))
            w = optax.apply_updates(w, updates)
        return losses, float(w[0])

    refs["train"] = {"losses": steps("adam", worker.TRAIN_STEPS)[0]}
    # Resumed from its checkpoint, the run takes the same steps.
    refs["resume"] = refs["train"]
    # The ICP evaluation is held to the JAX package in tests/test_torch_icp.py.
    refs["eval_all"] = {}
    losses, w = steps("lbfgs", worker.LBFGS_STEPS)
    refs["lbfgs"] = {"losses": losses, "w": w}

    pts = jnp.asarray(worker.cloud())
    valid = np.ones(pts.shape[0], bool)
    valid[::17] = False
    valid = jnp.asarray(valid)
    d, i = j_grid(pts, r=0.3, k=32, valid_points=valid, valid_query=valid)
    refs["grid_est"] = {"d": np.asarray(d), "idx": np.asarray(i)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn, "_QUERY_CHUNK", 1024)
        d, i = jknn.nearest_neighbors(pts, pts, k=8, valid_points=valid, valid_query=valid)
    refs["knn_est"] = {"d": np.asarray(d), "idx": np.asarray(i)}
    return refs


@pytest.fixture(scope="module")
def jax_refs(runs):
    # Computed while the ranks run.
    return _jax_refs()


def _close(x, ref, rtol, what):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    assert x.shape == ref.shape, (what, x.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    err = float(np.max(np.abs(x - ref))) / scale
    assert err <= rtol, "%s: %.3e relative (tolerance %.0e)" % (what, err, rtol)


def _values(res: dict) -> dict:
    """The compared numbers of one scenario's result."""
    out = {k: res[k] for k in ("loss", "grad_w", "losses", "w") if k in res}
    for j, g in enumerate(res.get("grad_deltas", ())):
        out["grad_deltas%d" % j] = g
    return out


def _errors(runs):
    res = runs.results()
    bad = {k: v["error"] for k, v in res.items() if "error" in v}
    assert not bad, "\n".join("%s:\n%s" % kv for kv in bad.items())
    return res


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_one_rank_and_jax(runs, jax_refs, name):
    """Four ranks against the one-rank group (1e-10), the one-rank group
    against the ungrouped run (1e-10), four ranks against the JAX package
    (1e-9). The sharded searches equal the single ones bit for bit, and
    the JAX package's tables."""
    res = _errors(runs)
    four, one, single, ref = (res[(4, 0)][name], res[(1, 0)][name], res[(0, 0)][name],
                              jax_refs[name])
    if name.endswith("_est"):
        assert four["bitwise"] and one["bitwise"]
        np.testing.assert_array_equal(four["idx"], single["idx"])
        np.testing.assert_array_equal(four["d"], single["d"])
        np.testing.assert_array_equal(four["idx"], ref["idx"])
        np.testing.assert_allclose(four["d"], ref["d"], rtol=1e-12)
        return
    for key, value in _values(four).items():
        _close(value, _values(one)[key], 1e-10, "%s %s, 4 ranks vs 1" % (name, key))
        _close(_values(one)[key], _values(single)[key], 1e-10,
               "%s %s, 1 rank vs no group" % (name, key))
        if key in _values(ref):
            _close(value, _values(ref)[key], 1e-9, "%s %s vs JAX" % (name, key))
    if name in ("train", "lbfgs", "resume"):
        assert len(four["losses"]) == len(ref["losses"])


def test_ranks_hold_the_same_bits(runs):
    """Every rank's loss, gradients, histories and trained weight are the
    same bits (all-reduced), so L-BFGS's line search branches alike."""
    res = _errors(runs)
    for name in SCENARIOS:
        if name.endswith("_est"):
            continue
        ref = _values(res[(4, 0)][name])
        for r in (1, 2, 3):
            got = _values(res[(4, r)][name])
            for key, value in ref.items():
                np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value),
                                              err_msg="%s %s rank %d" % (name, key, r))


def test_each_rank_holds_a_quarter(runs):
    """Each of the 4 ranks holds 1/4 of the scan batches' points, of the
    gather path's rows, of the cell-window graph's row and point tiles
    (padded with empty tiles to a multiple of 4), of the ICP
    correspondences and of the plane members; the exception rows split by
    the rank that owns their slot."""
    res = _errors(runs)
    exc = 0
    for r in range(4):
        sh = {name: res[(4, r)][name]["shares"] for name in LOSS_SCENARIOS}
        for name, s in sh.items():
            mine, whole = s["n"]
            assert mine * 4 == whole, (name, s["n"])
            assert s["bytes"][0]["points"] * 4 == s["bytes"][1]["points"], (name, s["bytes"])
        cw = sh["cellwin"]
        assert cw["t1"] == (23, 89) and cw["t2"] == (23, 89), cw
        assert cw["rows"] == (23 * 32, 89 * 32) and cw["m_local"] == (23 * 32, 89 * 32), cw
        exc += cw["exc"][0]
        assert cw["exc"][1] == 46
        assert sh["capped"]["rows"][0] * 4 == sh["capped"]["rows"][1]
        assert sh["nn_scale"]["rows"][0] * 4 == sh["nn_scale"]["rows"][1]
        assert sh["icp"]["icp"][0] * 4 == sh["icp"]["icp"][1]
        assert sh["plane"]["members"][0] * 4 == sh["plane"]["members"][1]
    assert exc == 46


def test_resume_reads_rank_0s_files(runs):
    """With a log_dir a rank, rank 0's alone holds the checkpoints and
    best.yaml: every rank resumes at the same iteration and returns a best
    config naming rank 0's model file, also where it comes from best.yaml
    (a resumed run with no step left)."""
    res = _errors(runs)
    for world, ranks in ((4, range(4)), (1, [0]), (0, [0])):
        zero = res[(world, 0)]["resume"]
        rank0_dir = os.path.join(runs.out_dir, "resume%d_0" % world)
        for b in zero["best"]:
            assert b is not None and os.path.dirname(b) == rank0_dir and os.path.exists(b), b
        for r in ranks:
            got = res[(world, r)]["resume"]
            assert got["its"] == [worker.RESUME_AT], (world, r, got["its"])
            assert got["best"] == zero["best"], (world, r)
    for r in (1, 2, 3):
        assert not os.path.exists(os.path.join(runs.out_dir, "resume4_%d" % r))


def test_unsharded_evaluation_writes_once(runs):
    """eval_loss_all with icp_loss under the group: every rank computes the
    ICP evaluation whole, rank 0 alone appends its row to the shared
    CSV."""
    _errors(runs)
    for world in (4, 1, 0):
        path = os.path.join(runs.out_dir, "evalall%d" % world, "loss_eval_icp_loss_train.csv")
        with open(path) as f:
            rows = [line for line in f if line.strip()]
        assert len(rows) == 1, (world, rows)


def test_dryrun_multichip():
    """The rehearsal of the JAX package's dryrun_multichip: 4 gloo ranks,
    one sharded Adam step, the same loss and weight on every rank."""
    out = dryrun_multichip(4)
    assert out["n"] == 4 and np.isfinite(out["loss"]) and out["w"] != 0.0


def _no_launcher_env(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)


def test_mesh_from_config_variants(monkeypatch):
    """No mesh_shape, or one of 1 rank, is one device (None); more ranks
    without a process group raise ValueError naming torchrun and
    dist_coordinator."""
    _no_launcher_env(monkeypatch)
    cfg = TConfig()
    cfg.device = "cpu"
    assert sharding.mesh_from_config(cfg) is None
    for shape in ({"data": 1}, 1):
        cfg.mesh_shape = shape
        assert sharding.mesh_from_config(cfg) is None
    for shape in ({"data": 4}, 2, "all"):
        cfg.mesh_shape = shape
        with pytest.raises(ValueError, match="torchrun") as err:
            sharding.mesh_from_config(cfg)
        assert "dist_coordinator" in str(err.value)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def tcp_group(monkeypatch):
    """A config whose dist_coordinator starts a 1-process gloo group at a
    free localhost port; the group is destroyed afterwards."""
    import torch.distributed as dist

    _no_launcher_env(monkeypatch)
    cfg = TConfig()
    cfg.device = "cpu"
    cfg.dist_coordinator = "127.0.0.1:%d" % _free_port()
    cfg.dist_num_processes, cfg.dist_process_id = 1, 0
    yield cfg
    if dist.is_initialized():
        dist.destroy_process_group()


def test_multihost_mesh_via_dist_coordinator(tcp_group):
    """dist_coordinator initialises the group at tcp://<address> (the
    JAX package's single-process jax.distributed test,
    tests/test_parallel.py:594): a collective runs over it, and a second
    call reuses the live group."""
    import torch.distributed as dist

    mesh = sharding.mesh_from_config(tcp_group)
    assert dist.is_initialized() and (mesh.rank, mesh.size) == (0, 1)
    assert mesh.device.type == "cpu" and mesh.backend == "gloo"
    x = torch.arange(4.0)
    dist.all_reduce(x)
    assert x.tolist() == [0.0, 1.0, 2.0, 3.0]
    again = sharding.make_multihost_mesh(coordinator_address=tcp_group.dist_coordinator,
                                         num_processes=1, process_id=0, device="cpu")
    assert (again.rank, again.size) == (0, 1)


def test_mesh_shape_must_match_the_group(tcp_group):
    """A mesh_shape that is not the group's size raises ValueError naming
    both numbers; a custom loss_fun cannot be sharded (JAX package,
    eval.py:123-130)."""
    from depth_correction_tpu_torch.eval import eval_loss
    from depth_correction_tpu_torch.loss import create_loss

    tcp_group.mesh_shape = {"data": 2}
    with pytest.raises(ValueError, match="2 ranks.*has 1"):
        sharding.mesh_from_config(tcp_group)
    tcp_group.mesh_shape = None
    tcp_group.test_names = [worker.SEQ]
    with pytest.raises(NotImplementedError, match="loss_fun"):
        eval_loss(tcp_group, loss_fun=create_loss(tcp_group))
