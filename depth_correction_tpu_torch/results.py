"""Results aggregation: collect experiment CSVs into summary tables
(counterpart of ``depth_correction_tpu/results.py``).

Re-design of the reference aggregator (reference: src/depth_correction/
results.py:50-598): glob ``loss_eval_*`` / ``slam_eval_*`` CSVs across
experiment directories, compute per-(config, subset) means, and render
plain-text / LaTeX tables. Dependency-light (numpy only).
"""
from __future__ import annotations

import glob
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "read_loss_eval_csv",
    "read_slam_eval_csv",
    "collect_results",
    "mean_loss_table",
    "mean_slam_table",
    "slam_error_per_sequence",
    "plot_slam_trajs",
    "render_all",
    "format_table",
    "to_latex",
]


def read_loss_eval_csv(path: str) -> List[Tuple[str, float]]:
    """Rows ``"<names> <loss>"`` (reference schema, eval.py:184)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            out.append((parts[0], float(parts[1])))
    return out


def read_slam_eval_csv(path: str) -> List[Tuple[str, float, float, float, float]]:
    """Rows ``"<name> <r_angle> <t_norm> <rel_angle> <rel_offset>"``
    (reference schema, scripts/robot_data:186-187)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 5:
                continue
            out.append((parts[0],) + tuple(float(x) for x in parts[1:]))
    return out


def collect_results(root: str, pattern: str = "loss_eval_*.csv") -> Dict:
    """Glob CSVs under experiment directories.

    :return: {(exp_dir_relative, csv_name): rows}.
    """
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", pattern), recursive=True)):
        rel = os.path.relpath(os.path.dirname(path), root)
        out[(rel, os.path.basename(path))] = read_loss_eval_csv(path)
    return out


def mean_loss_table(
    root: str, loss: str = "min_eigval_loss", subset: Optional[str] = None
):
    """Mean loss per experiment config (reference: results.py:318-...).

    :return: (header, rows) where rows are [config, subset, mean, count].
    """
    pattern = "loss_eval_%s%s.csv" % (loss, "_%s" % subset if subset else "*")
    table = defaultdict(list)
    for (exp, csv_name), rows in collect_results(root, pattern).items():
        m = re.search(r"loss_eval_%s_?(\w*)\.csv" % re.escape(loss), csv_name)
        sub = m.group(1) if m and m.group(1) else "all"
        for _, value in rows:
            table[(exp, sub)].append(value)
    header = ["config", "subset", "mean_%s" % loss, "n"]
    out_rows = [
        [exp, sub, float(np.mean(vals)), len(vals)]
        for (exp, sub), vals in sorted(table.items())
    ]
    return header, out_rows


def mean_slam_table(root: str, slam: str = "*", subset: Optional[str] = None):
    """Mean +- std SLAM errors per experiment config (reference:
    results.py:139-196 ``get_slam_error`` / the localization-error tables).
    Orientation errors are reported in degrees like the reference tables.

    :return: (header, rows) with rows [config, subset, slam, r_angle_deg,
        r_std_deg, t_norm_m, t_std_m, n].
    """
    pattern = "slam_eval_%s%s.csv" % (slam, "_%s" % subset if subset else "*")
    table = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(root, "**", pattern), recursive=True)):
        rel = os.path.relpath(os.path.dirname(path), root)
        m = re.search(r"slam_eval_(\w+?)(?:_(train|val|test))?\.csv",
                      os.path.basename(path))
        slam_name = m.group(1) if m else "unknown"
        sub = m.group(2) if m and m.group(2) else "all"
        for row in read_slam_eval_csv(path):
            table[(rel, sub, slam_name)].append(row[1:3])
    header = ["config", "subset", "slam", "r_angle_deg", "r_std_deg",
              "t_norm_m", "t_std_m", "n"]
    out_rows = []
    for (rel, sub, slam_name), vals in sorted(table.items()):
        arr = np.asarray(vals, np.float64)
        out_rows.append([
            rel, sub, slam_name,
            float(np.degrees(arr[:, 0].mean())),
            float(np.degrees(arr[:, 0].std())),
            float(arr[:, 1].mean()),
            float(arr[:, 1].std()),
            len(vals),
        ])
    return header, out_rows


def slam_error_per_sequence(root: str, slam: str = "*"):
    """Per-SEQUENCE mean SLAM errors over every matching experiment
    (reference: results.py:558-586 ``slam_error_for_sequences``).

    :return: (header, rows) with rows [sequence, r_angle_deg, t_norm_m, n].
    """
    pattern = "slam_eval_%s*.csv" % slam
    per_seq = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(root, "**", pattern), recursive=True)):
        for row in read_slam_eval_csv(path):
            per_seq[row[0]].append(row[1:3])
    header = ["sequence", "r_angle_deg", "t_norm_m", "n"]
    rows = []
    for seq, vals in sorted(per_seq.items()):
        arr = np.asarray(vals, np.float64)
        rows.append([
            seq,
            float(np.degrees(arr[:, 0].mean())),
            float(arr[:, 1].mean()),
            len(vals),
        ])
    return header, rows


def plot_slam_trajs(runs: Dict[str, np.ndarray], out_path: str,
                    title: Optional[str] = None) -> str:
    """x/y trajectory comparison plot — GT vs SLAM vs SLAM+correction
    (reference: results.py:498-556 ``plot_slam_trajs``), saved to disk.

    :param runs: label -> (S, 4, 4) pose array (e.g. {"GT": ..., "SLAM": ...,
        "SLAM+DC": ...}); the first entry draws thickest.
    :return: the saved figure path.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    for i, (label, poses) in enumerate(runs.items()):
        poses = np.asarray(poses)
        ax.plot(poses[:, 0, 3], poses[:, 1, 3], linewidth=4 - min(i, 2),
                label=label)
    ax.grid(True)
    ax.axis("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="best")
    if title:
        ax.set_title(title)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def render_all(root: str, out_dir: Optional[str] = None) -> Dict[str, str]:
    """One command for the reference's table/figure set from ``gen/``:
    mean-loss tables (per eval loss), mean SLAM tables, the per-sequence
    SLAM table, and trajectory plots for every ``slam_poses_*.csv`` that has
    a GT-comparable dataset name in its path.

    :return: {artifact name: path}.
    """
    out_dir = out_dir or os.path.join(root, "results")
    os.makedirs(out_dir, exist_ok=True)
    artifacts = {}

    def write_table(name, header, rows):
        """txt + LaTeX pair for one table."""
        if not rows:
            return
        base = os.path.join(out_dir, name)
        with open(base + ".txt", "w") as f:
            f.write(format_table(header, rows) + "\n")
        with open(base + ".tex", "w") as f:
            f.write(to_latex(header, rows) + "\n")
        artifacts[name] = base + ".txt"

    for loss in ("min_eigval_loss", "trace_loss", "icp_loss"):
        write_table("mean_%s" % loss, *mean_loss_table(root, loss=loss))
    write_table("mean_slam_error", *mean_slam_table(root))
    write_table("slam_error_per_sequence", *slam_error_per_sequence(root))

    # Trajectory plots from every slam_poses CSV found.
    from .datasets.asl_laser import read_poses

    for path in sorted(glob.glob(os.path.join(root, "**", "slam_poses_*.csv"),
                                 recursive=True)):
        try:
            _, poses = read_poses(path)
        except Exception:
            continue
        rel = os.path.relpath(path, root).replace(os.sep, "_")
        name = os.path.splitext(rel)[0]
        fig_path = os.path.join(out_dir, name + ".png")
        plot_slam_trajs({"SLAM": np.stack(poses)}, fig_path, title=name)
        artifacts[name] = fig_path
    return artifacts


def format_table(header, rows, float_fmt: str = "%.6g") -> str:
    """Plain-text aligned table."""
    def fmt(x):
        return float_fmt % x if isinstance(x, float) else str(x)

    cells = [header] + [[fmt(c) for c in row] for row in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(header))]
    lines = [
        "  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip() for row in cells
    ]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def to_latex(header, rows, float_fmt: str = "%.6g") -> str:
    """LaTeX tabular (the reference renders result tables to LaTeX,
    results.py:50-598)."""
    def fmt(x):
        return float_fmt % x if isinstance(x, float) else str(x).replace("_", r"\_")

    lines = [r"\begin{tabular}{%s}" % ("l" * len(header))]
    lines.append(" & ".join(fmt(h) for h in header) + r" \\")
    lines.append(r"\hline")
    for row in rows:
        lines.append(" & ".join(fmt(c) for c in row) + r" \\")
    lines.append(r"\end{tabular}")
    return "\n".join(lines)
