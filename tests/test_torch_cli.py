"""The port's CLI (depth_correction_tpu_torch.main), results tables and
norlab adapter against the JAX package's, on the CPU.

create_splits; print_config's YAML; train_and_eval_all's experiment grid
(train_and_eval replaced in both packages by a recorder); the commands of
the three fan-outs (train_and_eval_all, eval_configs, render_meshes, with
subprocess.run captured) name depth_correction_tpu_torch.main and never the
JAX package's module; bench exits naming the port's benchmark item;
eval_configs; results.render_all's tables on one CSV tree; the norlab
configs byte for byte and the command template; an eval_slam drive through
the CLI.
"""
import os

import numpy as np
import pytest

from depth_correction_tpu import main as jmain
from depth_correction_tpu import results as jresults
from depth_correction_tpu import slam_norlab as jnorlab
from depth_correction_tpu import train_and_eval as jtae
from depth_correction_tpu_torch import main as tmain
from depth_correction_tpu_torch import results as tresults
from depth_correction_tpu_torch import slam_norlab as tnorlab
from depth_correction_tpu_torch import train_and_eval as ttae
from depth_correction_tpu_torch.config import Config as TConfig

PORT_MODULE = "depth_correction_tpu_torch.main"


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 9])
@pytest.mark.parametrize("num_splits", [2, 4])
def test_create_splits_match_jax(n, num_splits):
    names = ["seq_%d" % i for i in range(n)]
    assert tmain.create_splits(names, num_splits) == jmain.create_splits(names, num_splits)


def test_print_config_matches_jax(capsys, tmp_path):
    """The same YAML from the same arguments, a --from-yaml base included;
    an unknown argument is reported and ignored."""
    base = tmp_path / "base.yaml"
    base.write_text("lr: 0.003\nnn_r: 0.5\n")
    args = ["--from-yaml", str(base), "--log-dir", str(tmp_path), "--out-dir", str(tmp_path),
            "--train-names", "[open_box/n_2]", "--nn-r", "0.7", "--bogus", "--", "print_config"]
    outs = []
    for mod in (jmain, tmain):
        mod.main(list(args))
        outs.append(capsys.readouterr())
    assert outs[1].out == outs[0].out
    assert "lr: 0.003" in outs[1].out and "nn_r: 0.7" in outs[1].out
    assert "Ignored arguments: ['--bogus']" in outs[1].err


def _grid_cfg(cls, tmp_path, **kw):
    cfg = cls()
    cfg.out_dir = str(tmp_path / "out")
    cfg.log_dir = str(tmp_path / "log")
    cfg.train_names = ["a", "b", "c", "d"]
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _record_grid(monkeypatch, tae_module, main_module, cfg):
    """train_and_eval_all with train_and_eval recorded, not run."""
    runs = []
    monkeypatch.setattr(tae_module, "train_and_eval",
                        lambda c: runs.append((c.log_dir, c.to_yaml())) or (c, {}))
    main_module.train_and_eval_all(cfg)
    return runs


@pytest.mark.parametrize("provider", ["ground_truth", "icp_mapper"])
def test_train_and_eval_all_grid_matches_jax(monkeypatch, tmp_path, provider):
    """The grid product(pose providers, models, losses, splits): the same
    directories and configs in the same order; a finished experiment
    (best.yaml) is skipped in both."""
    from depth_correction_tpu.config import Config as JConfig

    kw = {"eval_pose_providers": [provider], "loss": "min_eigval_loss"}
    jruns = _record_grid(monkeypatch, jtae, jmain, _grid_cfg(JConfig, tmp_path, **kw))
    truns = _record_grid(monkeypatch, ttae, tmain, _grid_cfg(TConfig, tmp_path, **kw))
    assert len(truns) == len(jruns) > 8
    assert [r[0] for r in truns] == [r[0] for r in jruns]
    assert [r[1] for r in truns] == [r[1] for r in jruns]
    done = truns[0][0]
    os.makedirs(done)
    open(os.path.join(done, "best.yaml"), "w").close()
    again = _record_grid(monkeypatch, ttae, tmain, _grid_cfg(TConfig, tmp_path, **kw))
    assert [r[0] for r in again] == [r[0] for r in truns[1:]]


def _captured(monkeypatch, fn):
    """Run ``fn`` with the port's subprocess.run captured; returns the
    commands."""
    cmds = []
    monkeypatch.setattr(tmain.subprocess, "run", lambda cmd, check: cmds.append(list(cmd)))
    fn()
    return cmds


def _spawns_port(cmds, verb):
    assert cmds
    for cmd in cmds:
        i = cmd.index("-m")
        assert cmd[i + 1] == PORT_MODULE
        assert "depth_correction_tpu.main" not in cmd
        assert cmd[-1] == verb and cmd[cmd.index("--from-yaml") + 1].endswith(".yaml")
        assert os.path.exists(cmd[cmd.index("--from-yaml") + 1])


def test_fan_out_train_and_eval_all_spawns_port(monkeypatch, tmp_path):
    """launch_prefix with num_jobs: every job runs the port's CLI on the
    config it wrote, as many as num_jobs allows."""
    cfg = _grid_cfg(TConfig, tmp_path, launch_prefix="sbatch --job-name {name} -o {log_dir}",
                    num_jobs=3)
    cmds = _captured(monkeypatch, lambda: tmain.train_and_eval_all(cfg))
    assert len(cmds) == 3 and cmds[0][:3] == ["sbatch", "--job-name", "exp_0"]
    _spawns_port(cmds, "train_and_eval")


def test_fan_out_eval_configs_spawns_port(monkeypatch, tmp_path):
    """eval_configs with launch_prefix: one job a config, with the
    eigenvalue-bounds override passed on."""
    for i in range(2):
        TConfig().to_yaml(str(tmp_path / ("exp%d" % i) / "config.yaml"))
    cfg = _grid_cfg(TConfig, tmp_path, launch_prefix="run {name}",
                    eigenvalue_bounds=[[0, None, 0.01]])
    cmds = _captured(monkeypatch,
                     lambda: tmain.eval_configs(cfg, str(tmp_path / "exp*" / "config.yaml"),
                                                "slam_all"))
    assert len(cmds) == 2 and cmds[1][:2] == ["run", "eval_1"]
    _spawns_port(cmds, "eval_slam_all")
    assert "--eigenvalue-bounds" in cmds[0]


def test_fan_out_render_meshes_spawns_port(monkeypatch, tmp_path):
    """render_meshes with launch_prefix: items_per_job meshes a job."""
    cfg_args = ["--out-dir", str(tmp_path), "--log-dir", str(tmp_path),
                "--train-names", "[rendered_mesh/a, rendered_mesh/b, c.obj]",
                "--launch-prefix", "job {name}", "--items-per-job", "2", "--", "render_meshes"]
    cmds = _captured(monkeypatch, lambda: tmain.main(cfg_args))
    assert [c[:2] for c in cmds] == [["job", "render_0"], ["job", "render_2"]]
    _spawns_port(cmds, "render_meshes")


def test_bench_exits_naming_the_port_benchmark():
    with pytest.raises(SystemExit, match="item 10"):
        tmain.main(["--", "bench"])
    with pytest.raises(SystemExit, match="Unknown verb"):
        tmain.main(["--", "no_such_verb"])


def test_eval_configs_matches_jax(monkeypatch, tmp_path):
    """eval_configs in-process: the configs it loads, their log dirs (the
    {dirname} placeholder) and the evaluations it runs per arg."""
    from depth_correction_tpu import eval as jeval
    from depth_correction_tpu_torch import eval as teval

    for i in range(2):
        cfg = TConfig()
        cfg.train_names = ["seq_%d" % i]
        cfg.to_yaml(str(tmp_path / "cfgs" / ("exp%d" % i) / "config.yaml"))
    seen = {}
    for tag, main_mod, eval_mod in (("jax", jmain, jeval), ("port", tmain, teval)):
        calls = seen[tag] = []
        monkeypatch.setattr(eval_mod, "eval_loss_all",
                            lambda c, calls=calls: calls.append(("loss", c.log_dir,
                                                                 c.train_names)) or 1)
        monkeypatch.setattr(eval_mod, "eval_slam_all",
                            lambda c, calls=calls: calls.append(("slam", c.log_dir,
                                                                 c.eigenvalue_bounds)) or 2)
        for arg in ("all", "loss_all", "slam_all"):
            run = TConfig()
            run.log_dir = str(tmp_path / tag / "{basename}_{dirname}")
            run.eigenvalue_bounds = [[0, None, 0.02]]
            main_mod.eval_configs(run, str(tmp_path / "cfgs" / "*" / "config.yaml"), arg)
    assert [c[0] for c in seen["port"]] == ["loss", "slam"] * 2 + ["loss"] * 2 + ["slam"] * 2
    norm = [(c[0], c[1].replace(str(tmp_path / "port"), ""), c[2]) for c in seen["port"]]
    jnorm = [(c[0], c[1].replace(str(tmp_path / "jax"), ""), c[2]) for c in seen["jax"]]
    assert norm == jnorm and len(norm) == 8
    assert norm[0] == ("loss", "/config.yaml_" + str(tmp_path / "cfgs" / "exp0"), ["seq_0"])


def _write_results_tree(root):
    """Two experiments' loss and SLAM CSVs and a poses file."""
    from depth_correction_tpu_torch.datasets.asl_laser import write_poses

    rng = np.random.default_rng(0)
    for exp in ("exp_a/split_0", "exp_b/split_1"):
        d = os.path.join(root, exp)
        os.makedirs(d)
        for loss in ("min_eigval_loss", "trace_loss"):
            for sub in ("train", "test"):
                with open(os.path.join(d, "loss_eval_%s_%s.csv" % (loss, sub)), "w") as f:
                    for name in ("seq/1", "seq/2"):
                        f.write("%s %.9f\n" % (name, rng.uniform()))
        for slam in ("icp_mapper", "icp_odometry"):
            with open(os.path.join(d, "slam_eval_%s_test.csv" % slam), "w") as f:
                for name in ("seq/1", "seq/2"):
                    f.write("%s %s\n" % (name, " ".join("%.9f" % v for v in rng.uniform(size=4))))
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5.0)
    os.makedirs(os.path.join(root, "pre", "seq_1"))
    write_poses(list(range(5)), poses,
                os.path.join(root, "pre", "seq_1", "slam_poses_icp_mapper.csv"))


def test_render_all_matches_jax(tmp_path):
    """The same artifacts, and the same text and LaTeX tables."""
    root = str(tmp_path / "gen")
    _write_results_tree(root)
    jart = jresults.render_all(root, str(tmp_path / "jax"))
    tart = tresults.render_all(root, str(tmp_path / "port"))
    assert sorted(tart) == sorted(jart)
    assert {"mean_min_eigval_loss", "mean_trace_loss", "mean_slam_error",
            "slam_error_per_sequence", "pre_seq_1_slam_poses_icp_mapper"} == set(tart)
    for name in os.listdir(str(tmp_path / "jax")):
        jb, tb = (open(str(tmp_path / d / name), "rb").read() for d in ("jax", "port"))
        if name.endswith((".txt", ".tex")):
            assert tb == jb, name
        else:
            assert tb[:8] == b"\x89PNG\r\n\x1a\n"
    for fn, kw in (("mean_loss_table", {"loss": "trace_loss", "subset": "test"}),
                   ("mean_slam_table", {"slam": "icp_mapper"}),
                   ("slam_error_per_sequence", {})):
        assert getattr(tresults, fn)(root, **kw) == getattr(jresults, fn)(root, **kw)


def test_norlab_configs_byte_equal(tmp_path):
    """icp.yaml, input_filters.yaml and mapper.yaml (defaults and an
    override), and the command template naming the repository's driver."""
    for kw in ({}, {"mapper_params": {"alpha": 0.5, "is_3D": False}}):
        jp = jnorlab.write_norlab_configs(str(tmp_path / "jax"), **kw)
        tp = tnorlab.write_norlab_configs(str(tmp_path / "port"), **kw)
        for a, b in zip(jp, tp):
            assert open(b, "rb").read() == open(a, "rb").read()
    jcmd = jnorlab.norlab_slam_command(str(tmp_path / "w"), python="py")
    tcmd = tnorlab.norlab_slam_command(str(tmp_path / "w"), python="py")
    assert tcmd == jcmd
    driver = tcmd.split()[1]
    assert os.path.samefile(driver, os.path.join(os.path.dirname(__file__), "..", "scripts",
                                                 "norlab_mapper_driver.py"))
    filled = tcmd.format(input_dir="IN", poses_csv="OUT.csv")
    assert filled.endswith("--input-dir IN --poses-csv OUT.csv")


def test_cli_eval_slam_drive(tmp_path, capsys):
    """python -m depth_correction_tpu_torch.main ... -- eval_slam on the CPU
    writes slam_eval_<slam>.csv in the log dir, one row of five fields."""
    args = ["--device", "cpu", "--float-type", "float64", "--log-dir", str(tmp_path),
            "--test-names", "[open_box/n_2_size_6_6_3_height_1_density_40]",
            "--min-depth", "0.1", "--max-depth", "30.0", "--grid-res", "0.3", "--nn-r", "0.6",
            "--nn-backend", "scipy", "--vp-dispersion-bounds", "[]",
            "--eigenvalue-ratio-bounds", "[]", "--min-valid-neighbors", "3",
            "--slam", "icp_odometry", "--", "eval_slam"]
    tmain.main(args)
    with open(os.path.join(str(tmp_path), "slam_eval_icp_odometry.csv")) as f:
        rows = [line.split() for line in f]
    assert len(rows) == 1 and len(rows[0]) == 5
    assert rows[0][0] == "open_box/n_2_size_6_6_3_height_1_density_40"
    assert all(np.isfinite(float(v)) for v in rows[0][1:])
