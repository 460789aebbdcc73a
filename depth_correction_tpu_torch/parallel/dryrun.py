"""A CPU rehearsal of the sharded step (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, which compiles and runs one sharded
step on n virtual CPU devices).

:func:`dryrun_multichip` starts ``n`` processes (``python -m
depth_correction_tpu_torch.parallel.dryrun --worker ...``; they import the
port only, never jax), which join a ``gloo`` group through a ``file://``
store, prepare the JAX package's tiny scene (``ground_plane/4``) under the
mesh, split it and take one sharded Adam step. Each rank asserts that it
holds 1/n of the scan batch's point axis and of the row tables, that the
loss is finite, and that every rank holds the same loss and the same
updated weight, bit for bit.

    python -m depth_correction_tpu_torch.parallel.dryrun 4
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

__all__ = ["dryrun_multichip", "tiny_config"]


def tiny_config():
    """The JAX package's tiny scene (``__graft_entry__._tiny_cfg``) on the
    CPU."""
    from ..config import Config

    cfg = Config()
    cfg.device = "cpu"
    cfg.float_type = "float32"
    cfg.train_names = ["ground_plane/4"]
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.1, 20.0, 0.25
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.min_valid_neighbors = 3
    cfg.loss = "min_eigval_loss"
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.lr = 1e-4
    cfg.n_opt_iters = 1
    return cfg


def _worker(rank: int, n: int, store: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from ..datasets import create_dataset
    from ..train import fit, prepare_sequences
    from .sharding import mesh_from_config, shard_train_data

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, world_size=n, rank=rank)
    try:
        cfg = tiny_config()
        cfg.mesh_shape = {"data": n}
        mesh = mesh_from_config(cfg)
        whole = prepare_sequences([create_dataset(cfg.train_names[0], cfg)], cfg, mesh=mesh)
        data = shard_train_data(whole, mesh)
        # Memory scales with the mesh: each rank holds 1/n of the point
        # table's source fields and of the query-row tables.
        depth, depth_all = data.batches[0].cloud.depth, whole.batches[0].cloud.depth
        assert depth.shape[1] * n == depth_all.shape[1], (depth.shape, depth_all.shape)
        nn, nn_all = data.neighbors[0], whole.neighbors[0]
        assert nn.shape[0] * n == -(-nn_all.shape[0] // n) * n, (nn.shape, nn_all.shape)
        del whole
        model, history = fit(cfg, data)
        loss = history[0][1]
        w = float(model.w.detach().reshape(-1)[0])
        assert loss == loss and abs(loss) != float("inf"), loss
        assert w != 0.0, "the step did not move w"
        seen = [None] * n
        dist.all_gather_object(seen, (loss, w))
        assert all(s == (loss, w) for s in seen), seen
        if rank == 0:
            with open(os.path.join(out_dir, "dryrun.json"), "w") as f:
                json.dump({"n": n, "loss": loss, "w": w, "points_per_rank": depth.shape[1],
                           "rows_per_rank": nn.shape[0]}, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> dict:
    """Run the rehearsal on ``n_devices`` gloo ranks; raise if any rank
    fails. Returns rank 0's summary: the loss, the updated weight and the
    rows and points a rank holds."""
    n = int(n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        procs = [start([sys.executable, "-m", "depth_correction_tpu_torch.parallel.dryrun",
                        "--worker", str(r), str(n), store, tmp], env=env) for r in range(n)]
        wait_all(procs, timeout)
        with open(os.path.join(tmp, "dryrun.json")) as f:
            summary = json.load(f)
    print("dryrun_multichip(%d): loss %.6e, w=%.6e on every rank, %d points and %d rows "
          "a rank OK" % (n, summary["loss"], summary["w"], summary["points_per_rank"],
                         summary["rows_per_rank"]))
    return summary


def start(cmd, **kw) -> subprocess.Popen:
    """One rank's process, its output (stdout and stderr) to a temporary
    file, so that no pipe fills while the others wait on it."""
    log = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True, **kw)
    proc.log = log
    return proc


def _output(proc) -> str:
    proc.log.seek(0)
    return proc.log.read()


def wait_all(procs, timeout: float):
    """Wait for every process of :func:`start`; on a failure or at
    ``timeout`` seconds stop the rest and raise with each failed rank's
    output. Returns every process's output."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if any(p.returncode for p in procs) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    outs = [_output(p) for p in procs]
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError("ranks %s failed:\n%s" % (bad, "\n".join(
            "--- rank %d ---\n%s" % (i, outs[i][-4000:]) for i in bad)))
    return outs


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
