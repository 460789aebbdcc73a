"""Experiment orchestration CLI (counterpart of ``depth_correction_tpu/
main.py``; reference: src/depth_correction/main.py:44-500):

    python -m depth_correction_tpu_torch.main [--key value ...] -- <verb>

Verbs: ``print_config``, ``train``, ``eval_loss``, ``eval_loss_all``,
``eval_slam``, ``eval_slam_all``, ``eval_all``, ``train_and_eval``,
``train_and_eval_all``, ``eval_loss_baselines``, ``eval_slam_baselines``,
``eval_configs <glob> [all|loss_all|slam_all]``, ``export_corrected``,
``render_meshes``, ``results``; ``bench`` exits (the port's benchmark is
still to be written).

``train_and_eval_all`` runs the experiment grid
product(pose providers, models, losses, dataset splits)
(reference: main.py:249-313), with per-experiment config dirs derived from
semantic descriptors, skip-if-exists resume (main.py:133-135), and optional
``launch_prefix`` subprocess fan-out for cluster schedulers
(main.py:140-157). Non-ground-truth pose providers consume the
``slam_poses_<provider>.csv`` files ``eval_slam_baselines`` writes;
``eval_configs`` re-evaluates existing experiment configs by glob
(main.py:320-393). Every job the fan-outs launch runs this module,
``depth_correction_tpu_torch.main``.
"""
from __future__ import annotations

import itertools
import os
import subprocess
import sys
from typing import List, Sequence

from .config import Config, Loss, Model, PoseCorrection, loss_eval_csv

__all__ = ["main", "create_splits"]

# The module every fanned-out job runs.
MODULE = "depth_correction_tpu_torch.main"


def create_splits(names: Sequence[str], num_splits: int = 4) -> List[dict]:
    """Rotating k-fold train/val/test splits over sequence names
    (reference: main.py:44-67): each fold uses one name as val, the next as
    test, the rest for training.
    """
    names = list(names)
    n = len(names)
    if n < 3:
        return [{"train_names": names, "val_names": names, "test_names": names}]
    splits = []
    step = max(n // num_splits, 1)
    for i in range(0, min(num_splits * step, n), step):
        val = [names[i % n]]
        test = [names[(i + 1) % n]]
        train = [x for x in names if x not in val + test]
        splits.append({"train_names": train, "val_names": val, "test_names": test})
    return splits


def eval_loss_baselines(cfg: Config):
    """Consistency losses of the *uncorrected* data on all subsets
    (reference: main.py:70-160): BaseModel, ground-truth poses."""
    from .eval import eval_loss_all

    base = cfg.copy()
    base.model_class = "BaseModel"
    base.model_args = []
    base.model_kwargs = {}
    base.model_state_dict = ""
    base.pose_correction = PoseCorrection.none
    return eval_loss_all(base)


def train_and_eval_all(cfg: Config, pose_providers=None, models=None, losses=None):
    """Experiment grid product(pose providers, models, losses, splits)
    (reference: main.py:240-313). Non-ground-truth pose providers read
    ``slam_poses_<provider>.csv`` files from ``<preproc_dir>/<name>/``
    (written by ``eval_slam_baselines``) and switch to per-pose correction
    (reference: main.py:288-293)."""
    from .config import PoseProvider, slam_poses_csv
    from .train_and_eval import train_and_eval

    pose_providers = pose_providers or cfg.eval_pose_providers or [cfg.pose_provider]
    models = models or list(Model)
    losses = losses or [l for l in Loss if l != "icp_loss"]
    names = cfg.train_names or cfg.test_names or cfg.val_names
    splits = create_splits(names)

    results = {}
    n_scheduled = 0
    # Grid experiments that differ only in model / loss reduction / lr
    # re-prepare IDENTICAL frozen graphs; share them through the prep
    # cache (utils/prep_cache.py) unless the caller pinned a directory.
    if not cfg.prep_cache_dir:
        cfg = cfg.copy()
        cfg.prep_cache_dir = os.path.join(cfg.out_dir, "prep_cache")
    for i_exp, (provider, model, loss, (i_split, split)) in enumerate(
        itertools.product(pose_providers, models, losses, enumerate(splits))
    ):
        if cfg.launch_prefix and cfg.num_jobs and n_scheduled >= cfg.num_jobs:
            # Reference: cap the number of scheduled batch jobs
            # (main.py:251-255).
            print("Maximum number of jobs scheduled.")
            break
        exp_cfg = cfg.copy()
        exp_cfg.pose_provider = provider
        exp_cfg.model_class = model
        exp_cfg.loss = loss
        exp_cfg.from_dict(split)
        if provider != PoseProvider.ground_truth:
            base = cfg.get_preproc_dir()
            exp_cfg.train_poses_path = [
                slam_poses_csv(base, n, provider) for n in exp_cfg.train_names
            ]
            exp_cfg.val_poses_path = [
                slam_poses_csv(base, n, provider) for n in exp_cfg.val_names
            ]
            exp_cfg.test_poses_path = [
                slam_poses_csv(base, n, provider) for n in exp_cfg.test_names
            ]
            exp_cfg.pose_correction = PoseCorrection.pose
        exp_cfg.log_dir = os.path.join(
            exp_cfg.get_exp_dir(), "split_%i" % i_split
        )

        done_marker = os.path.join(exp_cfg.log_dir, "best.yaml")
        if os.path.exists(done_marker) and not cfg.force:
            print("Experiment %s exists, skipping." % exp_cfg.log_dir)
            continue

        if cfg.launch_prefix:
            # Fan out as an independent job (reference: main.py:140-157).
            os.makedirs(exp_cfg.log_dir, exist_ok=True)
            cfg_path = os.path.join(exp_cfg.log_dir, "config.yaml")
            exp_cfg.to_yaml(cfg_path)
            launch_args = cfg.launch_prefix.format(
                log_dir=exp_cfg.log_dir, name="exp_%i" % i_exp
            ).split()
            cmd = launch_args + [
                sys.executable,
                "-m",
                MODULE,
                "--from-yaml",
                cfg_path,
                "--",
                "train_and_eval",
            ]
            print("Launching: %s" % " ".join(cmd))
            subprocess.run(cmd, check=True)
            n_scheduled += 1
        else:
            results[(provider, model, loss, i_split)] = train_and_eval(exp_cfg)
    return results


def eval_slam_baselines(cfg: Config):
    """Uncorrected-SLAM baselines per (sequence, slam) pair
    (reference: main.py:70-160): BaseModel, per-sequence log dirs under
    ``<preproc_dir>/<name>/``, writing ``slam_eval_<slam>.csv`` AND
    ``slam_poses_<slam>.csv`` — the pose files the PoseProvider axis of
    ``train_and_eval_all`` reads back."""
    from .config import slam_eval_csv, slam_poses_csv
    from .slam_eval import eval_slam

    names = cfg.test_names or cfg.train_names or cfg.val_names
    slams = cfg.eval_slams or [cfg.slam]
    results = {}
    for name, slam in itertools.product(names, slams):
        run = cfg.copy()
        run.model_class = "BaseModel"
        run.model_args = []
        run.model_kwargs = {}
        run.model_state_dict = ""
        run.log_dir = os.path.join(cfg.get_preproc_dir(), name)
        run.train_names, run.val_names, run.test_names = [], [], [name]
        run.slam = slam
        run.slam_eval_csv = slam_eval_csv(run.log_dir, slam)
        run.slam_poses_csv = slam_poses_csv(cfg.get_preproc_dir(), name, slam)
        if os.path.exists(run.slam_poses_csv) and not cfg.force:
            print("Baseline %s exists, skipping." % run.slam_poses_csv)
            continue
        results[(name, slam)] = eval_slam(run, apply_correction=False)
    return results


def eval_configs(cfg: Config, pattern: str, arg: str = "all"):
    """Re-evaluate existing experiment configs matched by a glob
    (reference: main.py:320-393): for each config YAML, load it, adjust the
    log dir (``cfg.log_dir`` may use ``{dirname}``/``{basename}``
    placeholders; default = alongside the config), optionally override the
    eigenvalue bounds, and run the requested eval set.

    :param arg: ``all`` | ``loss_all`` | ``slam_all``.
    """
    from glob import glob

    from .eval import eval_loss_all, eval_slam_all

    configs = sorted(glob(pattern, recursive=True))
    print("Configs to evaluate (%d):" % len(configs))
    for c in configs:
        print("  %s" % c)

    results = {}
    for i, config_path in enumerate(configs):
        run = Config()
        run.from_yaml(config_path)
        dirname, basename = os.path.split(config_path)
        if cfg.log_dir and ("{dirname}" in cfg.log_dir or "{basename}" in cfg.log_dir):
            run.log_dir = cfg.log_dir.format(dirname=dirname, basename=basename)
        else:
            run.log_dir = dirname or "."
        os.makedirs(run.log_dir, exist_ok=True)
        if cfg.eigenvalue_bounds:
            run.eigenvalue_bounds = cfg.eigenvalue_bounds
        if cfg.launch_prefix:
            launch_args = cfg.launch_prefix.format(
                log_dir=run.log_dir, name="eval_%i" % i
            ).split()
            cmd = launch_args + [
                sys.executable, "-m", MODULE,
                "--from-yaml", config_path, "--log-dir", run.log_dir,
            ]
            if cfg.eigenvalue_bounds:
                # The in-process path applies this override; the launched
                # child must see it too.
                import yaml as _yaml

                cmd += ["--eigenvalue-bounds",
                        _yaml.safe_dump(cfg.eigenvalue_bounds,
                                        default_flow_style=True).strip()]
            cmd += [
                "--", "eval_" + ("loss_all" if arg == "loss_all"
                                 else "slam_all" if arg == "slam_all"
                                 else "all"),
            ]
            print("Launching: %s" % " ".join(cmd))
            subprocess.run(cmd, check=True)
            continue
        out = {}
        if arg in ("all", "loss_all"):
            out["loss"] = eval_loss_all(run)
        if arg in ("all", "slam_all"):
            out["slam"] = eval_slam_all(run)
        results[config_path] = out
    return results


def print_config(cfg: Config):
    print(cfg.to_yaml())


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split_at = argv.index("--")
        cfg_args, verbs = argv[:split_at], argv[split_at + 1 :]
    else:
        cfg_args, verbs = argv, ["print_config"]

    cfg = Config()
    # --from-yaml loads a base config before the remaining overrides.
    if "--from-yaml" in cfg_args:
        i = cfg_args.index("--from-yaml")
        cfg.from_yaml(cfg_args[i + 1])
        cfg_args = cfg_args[:i] + cfg_args[i + 2 :]
    rest = cfg.from_args(cfg_args)
    if rest:
        print("Ignored arguments: %s" % rest, file=sys.stderr)
    cfg.sanitize()

    if verbs and verbs[0] == "eval_configs":
        # eval_configs <glob> [all|loss_all|slam_all]
        # (reference: main.py:320-393, 456-500 parses the same tail args).
        if len(verbs) < 2:
            raise SystemExit("eval_configs needs a glob pattern")
        eval_configs(cfg, verbs[1], verbs[2] if len(verbs) > 2 else "all")
        return

    for verb in verbs:
        if verb == "print_config":
            print_config(cfg)
        elif verb == "train":
            from .train import train

            train(cfg)
        elif verb == "eval_loss":
            from .eval import eval_loss

            eval_loss(cfg)
        elif verb == "eval_loss_all":
            from .eval import eval_loss_all

            eval_loss_all(cfg)
        elif verb == "train_and_eval":
            from .train_and_eval import train_and_eval

            train_and_eval(cfg)
        elif verb == "train_and_eval_all":
            train_and_eval_all(cfg)
        elif verb == "eval_loss_baselines":
            eval_loss_baselines(cfg)
        elif verb == "eval_slam":
            from .config import slam_eval_csv
            from .slam_eval import eval_slam

            if not cfg.slam_eval_csv:
                cfg.slam_eval_csv = slam_eval_csv(cfg.log_dir, cfg.slam)
            eval_slam(cfg)
        elif verb == "eval_slam_all":
            from .eval import eval_slam_all

            eval_slam_all(cfg)
        elif verb == "eval_all":
            from .eval import eval_loss_all, eval_slam_all

            eval_loss_all(cfg)
            eval_slam_all(cfg)
        elif verb == "eval_slam_baselines":
            eval_slam_baselines(cfg)
        elif verb == "export_corrected":
            from .slam_eval import export_corrected_clouds

            export_corrected_clouds(cfg, os.path.join(cfg.log_dir, "corrected"))
        elif verb == "render_meshes":
            # Pre-render every rendered_mesh dataset's scans into the disk
            # cache (reference: main.py:396-453 fans this out as jobs).
            from .datasets import create_dataset

            names = [
                n
                for n in (cfg.train_names or [])
                + (cfg.val_names or [])
                + (cfg.test_names or [])
                if "rendered_mesh" in n or n.endswith((".obj", ".ply"))
            ]
            cache = os.path.join(cfg.out_dir, "cache", "rendered_mesh")
            if cfg.launch_prefix:
                # Fan out as jobs of cfg.items_per_job datasets each
                # (reference: main.py:396-453, renders_per_job).
                per_job = max(1, int(cfg.items_per_job or 1))
                for i_job in range(0, len(names), per_job):
                    chunk = names[i_job : i_job + per_job]
                    job_cfg = cfg.copy()
                    job_cfg.launch_prefix = None
                    job_cfg.train_names = chunk
                    job_cfg.val_names = []
                    job_cfg.test_names = []
                    job_dir = os.path.join(cfg.out_dir, "render_jobs")
                    os.makedirs(job_dir, exist_ok=True)
                    cfg_path = os.path.join(job_dir, "render_%i.yaml" % i_job)
                    job_cfg.to_yaml(cfg_path)
                    launch_args = cfg.launch_prefix.format(
                        log_dir=job_dir, name="render_%i" % i_job
                    ).split()
                    cmd = launch_args + [
                        sys.executable, "-m", MODULE,
                        "--from-yaml", cfg_path, "--", "render_meshes",
                    ]
                    print("Launching: %s" % " ".join(cmd))
                    subprocess.run(cmd, check=True)
                continue
            for name in names:
                kw = (
                    {}
                    if "cache_dir" in (cfg.dataset_kwargs or {})
                    else {"cache_dir": cache}
                )
                ds = create_dataset(name, cfg, noisy=False, **kw)
                n = ds.render_all() if hasattr(ds, "render_all") else 0
                print("rendered %d scans for %s -> %s" % (n, name, cache))
        elif verb == "results":
            # Render the full table/figure set from out_dir's CSVs
            # (reference: results.py:498-598).
            from .results import render_all

            artifacts = render_all(cfg.out_dir)
            for k, v in sorted(artifacts.items()):
                print("%s: %s" % (k, v))
        elif verb == "bench":
            # bench.py measures the JAX package; the port's benchmark file
            # is ROADMAP queue 1, item 10.
            raise SystemExit("bench: the port has no benchmark yet (ROADMAP queue 1, item 10: "
                             "the port's benchmark file); chip_smoke.py is its smoke run")
        else:
            raise SystemExit("Unknown verb: %s" % verb)


if __name__ == "__main__":
    main()
