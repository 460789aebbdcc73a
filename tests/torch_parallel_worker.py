"""One rank of tests/test_torch_parallel.py's process group.

Run as ``python tests/torch_parallel_worker.py RANK WORLD STORE OUT_DIR``:
the rank joins a gloo group of WORLD ranks through the ``file://`` STORE,
runs every scenario of :data:`SCENARIOS` through the port's sharded path
in float64 on the CPU, and pickles its results to
``OUT_DIR/rank<WORLD>_<RANK>.pkl``. WORLD 0 runs each scenario without a
group or a mesh (the port's single-device path). The resumed run keeps a
``log_dir`` a rank, ``OUT_DIR/resume<WORLD>_<RANK>``; the ICP evaluation
one a group, ``OUT_DIR/evalall<WORLD>``. The worker imports the port
only, never jax.
"""
import os
import pickle
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

SEQ = "ground_plane/3"
W = -1e-3
# A cell-window graph of 89 row and 89 point tiles of 32 (so 3 empty
# padding tiles over 4 ranks) with 46 exception rows (eps_rel 1e-3).
CELLWIN = {"moments_backend": "cellwin", "cellwin_row_cap": 32, "cellwin_pt_cap": 32,
           "cellwin_eps_rel": 1e-3, "cellwin_max_exc_frac": 0.5}
SCENARIOS = {
    "cellwin": dict(CELLWIN),
    "capped": {"nn_max_neighbors": 32},
    "offset": dict(CELLWIN, loss_offset=True),
    "trim": dict(CELLWIN, loss_kwargs={"sqrt": False, "normalization": True,
                                       "inlier_ratio": 0.7}),
    "nn_scale": {"nn_scale": 0.3},
    "icp": {"loss": "icp_loss"},
    # 5 mm of depth noise: the ground plane's smallest eigenvalue is then
    # ~1e-5 of its trace, where a sum in another order moves it by ~1e-12
    # (on the noise-free plane, ~1e-8 of its trace, by ~4e-10).
    "plane": {"nn_type": "plane", "depth_noise": 0.005},
    "pose": {"pose_correction": "pose"},
    "pose_cellwin": dict(CELLWIN, pose_correction="pose"),
}
TRAIN_STEPS = 3
LBFGS_STEPS = 2
RESUME_AT = 2


def config(cls, **kw):
    """The scene: ground_plane/3 with the JAX package's tiny settings,
    grid establishment, float64 on the CPU."""
    cfg = cls()
    cfg.device = "cpu"
    cfg.float_type = "float64"
    cfg.train_names = [SEQ]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.nn_backend = "grid"
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.model_kwargs = {"w": [W], "exponent": [4.0]}
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.lr = 1e-4
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def pose_deltas(n_scans: int) -> np.ndarray:
    """Seeded (S, 6) deltas for the pose scenario."""
    return np.random.default_rng(7).normal(scale=1e-3, size=(n_scans, 6))


def cloud(n: int = 2001) -> np.ndarray:
    """A seeded cloud for the establishment scenarios (n not a multiple of
    4, so the last rank's query slice is short)."""
    rng = np.random.default_rng(3)
    return rng.uniform(0.0, 3.0, size=(n, 3)) * np.array([1.0, 1.0, 0.3])


def _loss_and_grads(cfg, data, loss_fn, mesh):
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.parallel.collectives import all_reduce_grads

    model = ScaledPolynomial(w=[W], exponent=[4.0], dtype=torch.float64)
    deltas = None
    if cfg.pose_correction == "pose":
        deltas = tuple(torch.tensor(pose_deltas(b.num_scans), requires_grad=True)
                       for b in data.batches)
    value = loss_fn(model, data, deltas)
    value.backward()
    tensors = [model.w] + list(deltas or ())
    if mesh is not None:
        all_reduce_grads(tensors, mesh)
    return {"loss": float(value.detach()), "grad_w": model.w.grad.numpy().copy(),
            "grad_deltas": [d.grad.numpy().copy() for d in deltas or ()]}


def _shares(whole, data):
    """The sizes of the rank's tables beside the whole tables'."""
    from depth_correction_tpu_torch.parallel import resident_bytes

    out = {"n": (data.batches[0].cloud.depth.shape[1], whole.batches[0].cloud.depth.shape[1]),
           "bytes": (resident_bytes(data), resident_bytes(whole))}
    cw, cw_all = data.cellwin[0], whole.cellwin[0]
    if cw is not None:
        out["t1"] = (cw.f_start.shape[0], cw_all.f_start.shape[0])
        out["t2"] = (cw.b_start.shape[0], cw_all.b_start.shape[0])
        out["rows"] = (cw.row_map.shape[0], cw_all.row_map.shape[0])
        out["m_local"] = (cw.est_local.shape[1], cw_all.est_sorted.shape[1])
        out["exc"] = (int(cw.exc_slots.numel()), int(cw_all.n_exc))
    elif isinstance(data.neighbors[0], torch.Tensor):
        out["rows"] = (data.neighbors[0].shape[0], whole.neighbors[0].shape[0])
    if data.icp_idx and data.icp_idx[0] is not None:
        out["icp"] = (data.icp_idx[0].shape[1], whole.icp_idx[0].shape[1])
    if data.neighbors[0] is not None and hasattr(data.neighbors[0], "member_idx"):
        out["members"] = (data.neighbors[0].member_idx.shape[1],
                          whole.neighbors[0].member_idx.shape[1])
    return out


class _Losses:
    """train()'s callback: the loss of every step."""

    def __init__(self):
        self.losses, self.its = [], []

    def __call__(self, cfg):
        from depth_correction_tpu_torch.train import TrainCallbacks

        rec = self

        class Cb(TrainCallbacks):
            def train_loss(self, it, model, pose_deltas, loss):
                rec.losses.append(float(loss.detach()))
                rec.its.append(it)

        return Cb(cfg)


def run(rank: int, world: int, mesh_cfg: dict, mesh, out_dir: str, single: bool) -> dict:
    """Every scenario under ``mesh`` (``single``: without a mesh)."""
    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.eval import eval_loss, eval_loss_all
    from depth_correction_tpu_torch.ops.grid_hash import grid_radius_neighbors, \
        grid_radius_neighbors_sharded
    from depth_correction_tpu_torch.ops.knn import nearest_neighbors, nearest_neighbors_sharded
    from depth_correction_tpu_torch.parallel import make_sharded_loss_fn, shard_train_data
    from depth_correction_tpu_torch.train import fit, make_loss_fn, prepare_sequences, train

    res, wholes = {}, {}
    for name, kw in SCENARIOS.items():
        cfg = config(Config, **kw)
        whole = wholes[name] = prepare_sequences([create_dataset(SEQ, cfg)], cfg, mesh=mesh)
        if single:
            res[name] = _loss_and_grads(cfg, whole, make_loss_fn(cfg), None)
            continue
        data = shard_train_data(whole, mesh)
        res[name] = _loss_and_grads(cfg, data, make_sharded_loss_fn(cfg, mesh), mesh)
        res[name]["shares"] = _shares(whole, data)
        if name == "cellwin":
            lb = config(Config, optimizer="lbfgs", n_opt_iters=LBFGS_STEPS, **kw)
            model, history = fit(lb, data)
            res["lbfgs"] = {"losses": [h[1] for h in history],
                            "w": float(model.w.detach()[0])}
    if single:
        lb = config(Config, optimizer="lbfgs", n_opt_iters=LBFGS_STEPS, **CELLWIN)
        whole = prepare_sequences([create_dataset(SEQ, lb)], lb)
        model, history = fit(lb, whole)
        res["lbfgs"] = {"losses": [h[1] for h in history], "w": float(model.w.detach()[0])}

    pts = torch.as_tensor(cloud())
    q_valid = torch.ones(pts.shape[0], dtype=torch.bool)
    q_valid[::17] = False
    for name, fn, one, kw in (
            ("grid_est", grid_radius_neighbors_sharded, grid_radius_neighbors, {"r": 0.3, "k": 32}),
            ("knn_est", nearest_neighbors_sharded, nearest_neighbors, {"k": 8})):
        d1, i1 = one(pts, valid_points=q_valid, valid_query=q_valid, **kw)
        if single:
            res[name] = {"d": d1.numpy(), "idx": i1.numpy()}
            continue
        d, i = fn(pts, valid_points=q_valid, valid_query=q_valid, mesh=mesh, **kw)
        res[name] = {"d": d.numpy(), "idx": i.numpy(),
                     "bitwise": bool(torch.equal(d, d1) and torch.equal(i, i1))}

    losses = _Losses()
    tcfg = config(Config, n_opt_iters=TRAIN_STEPS, **CELLWIN)
    tcfg.log_dir = os.path.join(out_dir, "train%d%s" % (world, "_single" if single else ""))
    ecfg = config(Config, test_names=[SEQ])
    if not single:
        for c in (tcfg, ecfg):
            for k, v in mesh_cfg.items():
                setattr(c, k, v)
    train(tcfg, callbacks=losses(tcfg))
    res["train"] = {"losses": losses.losses}
    res["eval"] = {"loss": float(eval_loss(ecfg))}
    res["resume"] = resume(rank, world, mesh_cfg, out_dir, wholes["cellwin"])

    # The ICP evaluation runs whole on every rank; rank 0 alone appends
    # its row to the CSV in the group's shared log_dir.
    acfg = config(Config, eval_losses=["icp_loss"], **mesh_cfg)
    acfg.log_dir = os.path.join(out_dir, "evalall%d" % world)
    os.makedirs(acfg.log_dir, exist_ok=True)
    res["eval_all"] = {"loss": float(eval_loss_all(acfg)[("train", "icp_loss")])}
    return res


def resume(rank: int, world: int, mesh_cfg: dict, out_dir: str, whole) -> dict:
    """train() for RESUME_AT steps, checkpointed each step, then resumed
    twice with a log_dir a rank, so that rank 0's alone holds the
    checkpoints and best.yaml: once with nothing left to run (the best
    config then comes from best.yaml), once to TRAIN_STEPS.

    :return: the losses of every step run, the iterations the last run
        took, and the model files the resumed runs' best configs name.
    """
    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.train import train

    cfg = config(Config, n_opt_iters=RESUME_AT, checkpoint_period=1, **CELLWIN, **mesh_cfg)
    cfg.log_dir = os.path.join(out_dir, "resume%d_%d" % (world, rank))
    first, last = _Losses(), _Losses()
    train(cfg, callbacks=first(cfg), train_data=whole)
    cfg.resume = True
    bests = [train(cfg, train_data=whole)]
    cfg.n_opt_iters = TRAIN_STEPS
    bests.append(train(cfg, callbacks=last(cfg), train_data=whole))
    return {"losses": first.losses + last.losses, "its": last.its,
            "best": [None if b is None else b.model_state_dict for b in bests]}


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    from depth_correction_tpu_torch import train as ttrain
    from depth_correction_tpu_torch.parallel import make_mesh

    # No TensorBoard summaries: its writer imports TensorFlow where it is
    # installed, seconds a process.
    ttrain._summary_writer = lambda log_dir: None

    if world:
        dist.init_process_group("gloo", init_method="file://" + store, world_size=world,
                                rank=rank)
    try:
        if world == 0:
            out = run(rank, world, {}, None, out_dir, single=True)
        else:
            mesh = make_mesh(world, device="cpu")
            if world == 1:
                # A one-rank group: train() and eval_loss() take it through
                # dist_coordinator (the group is up, so nothing is started);
                # mesh_shape of 1 means one device without a group.
                mesh_cfg = {"dist_coordinator": "127.0.0.1:1", "dist_num_processes": 1,
                            "dist_process_id": 0}
            else:
                mesh_cfg = {"mesh_shape": {"data": world}}
            out = run(rank, world, mesh_cfg, mesh, out_dir, single=False)
    except Exception:
        out = {"error": traceback.format_exc()}
    finally:
        path = os.path.join(out_dir, "rank%d_%d.pkl" % (world, rank))
        with tempfile.NamedTemporaryFile(dir=out_dir, delete=False) as f:
            pickle.dump(out, f)
        os.replace(f.name, path)
    if world:
        dist.destroy_process_group()
    if "error" in out:
        print(out["error"], file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
