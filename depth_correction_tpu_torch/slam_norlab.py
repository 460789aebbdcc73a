"""norlab_icp_mapper adapter: config + command template for the external
SLAM runner (counterpart of ``depth_correction_tpu/slam_norlab.py``; the
YAML it writes is the same, byte for byte).

The reference drives norlab_icp_mapper through roslaunch with a
libpointmatcher ICP config and input-filter chain plus mapper parameters
(reference: launch/slam.launch:42-80, config/slam/icp.yaml,
config/slam/input_filters.yaml). This framework replaces the ROS transport
with the ``run_external_slam`` subprocess contract (slam_eval.py): per-scan
``scan_%04d.npz`` in, robot_data-schema poses CSV out.

This module closes the glue gap: :func:`write_norlab_configs` materializes
the same ICP/filter/mapper knobs as YAML files a libpointmatcher-based
mapper consumes, and :func:`norlab_slam_command` returns a ready
``cfg.slam_command`` template that runs ``scripts/norlab_mapper_driver.py``
(the npz<->mapper bridge; needs the ``pypointmatcher`` +
``norlab_icp_mapper`` Python bindings in the target environment — not
bundled with this repository). A user with the norlab stack gets parity drift
CSVs with::

    cfg.slam = "norlab_icp_mapper"
    cfg.slam_command = norlab_slam_command(workdir)
"""
from __future__ import annotations

import os
import shlex
import sys
from typing import Optional

__all__ = [
    "DEFAULT_ICP",
    "DEFAULT_INPUT_FILTERS",
    "DEFAULT_MAPPER_PARAMS",
    "write_norlab_configs",
    "norlab_slam_command",
]

# libpointmatcher ICP chain — the knob set the reference tunes
# (reference: config/slam/icp.yaml): kd-tree matching with trimmed-distance
# + surface-normal outlier rejection, point-to-plane minimization, and
# differential/count/bound stopping.
DEFAULT_ICP = {
    "matcher": {
        "KDTreeMatcher": {"knn": 3, "maxDist": 10.0, "epsilon": 0},
    },
    "outlierFilters": [
        {"TrimmedDistOutlierFilter": {"ratio": 0.80}},
        {"SurfaceNormalOutlierFilter": {"maxAngle": 1.57}},
    ],
    "errorMinimizer": {"PointToPlaneErrorMinimizer": None},
    "transformationCheckers": [
        {
            "DifferentialTransformationChecker": {
                "minDiffRotErr": 0.001,
                "minDiffTransErr": 0.01,
                "smoothLength": 2,
            }
        },
        {"CounterTransformationChecker": {"maxIterationCount": 100}},
        {
            "BoundTransformationChecker": {
                "maxRotationNorm": 0.8,
                "maxTranslationNorm": 30.0,
            }
        },
    ],
    "inspector": {"NullInspector": None},
    "logger": {"NullLogger": None},
}

# Input-filter chain (reference: config/slam/input_filters.yaml): estimate
# 9-NN surface normals, attach observation directions, orient the normals
# toward the sensor. Our exporter already ships corrected normals in the
# npz, but the mapper re-derives them for map points it accumulates.
DEFAULT_INPUT_FILTERS = [
    {
        "SurfaceNormalDataPointsFilter": {
            "knn": 9,
            "epsilon": 0,
            "keepNormals": 1,
        }
    },
    {"ObservationDirectionDataPointsFilter": None},
    {"OrientNormalsDataPointsFilter": {"towardCenter": 1}},
]

# Mapper-node parameters (reference: launch/slam.launch:44-80) that are
# meaningful without ROS transport; frame/publish-rate knobs are dropped.
DEFAULT_MAPPER_PARAMS = {
    "map_update_condition": "overlap",
    "map_update_overlap": 0.9,
    "min_dist_new_point": 0.1,
    "sensor_max_range": 25.0,
    "prior_dynamic": 0.6,
    "threshold_dynamic": 0.9,
    "beam_half_angle": 0.01,
    "epsilon_a": 0.01,
    "epsilon_d": 0.01,
    "alpha": 0.8,
    "beta": 0.99,
    "is_3D": True,
    "is_online": True,
    "compute_prob_dynamic": True,
    "is_mapping": True,
}


def _to_yaml(obj, indent: int = 0) -> str:
    """Minimal YAML writer for the nested dict/list/scalar configs above
    (libpointmatcher's reader wants plain block style; avoid a pyyaml
    dependency in the export path)."""
    pad = "  " * indent
    lines = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if v is None:
                lines.append("%s%s:" % (pad, k))
            elif isinstance(v, (dict, list)):
                lines.append("%s%s:" % (pad, k))
                lines.append(_to_yaml(v, indent + 1))
            else:
                lines.append("%s%s: %s" % (pad, k, _scalar(v)))
    elif isinstance(obj, list):
        for item in obj:
            if isinstance(item, dict) and len(item) == 1:
                (k, v), = item.items()
                if v is None:
                    lines.append("%s- %s:" % (pad, k))
                else:
                    lines.append("%s- %s:" % (pad, k))
                    lines.append(_to_yaml(v, indent + 2))
            else:
                lines.append("%s- %s" % (pad, _scalar(item)))
    else:
        lines.append("%s%s" % (pad, _scalar(obj)))
    return "\n".join(l for l in lines if l.strip())


def _scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def write_norlab_configs(
    workdir: str,
    icp: Optional[dict] = None,
    input_filters: Optional[list] = None,
    mapper_params: Optional[dict] = None,
):
    """Write icp.yaml / input_filters.yaml / mapper.yaml into ``workdir``.

    :return: (icp_path, filters_path, mapper_path).
    """
    os.makedirs(workdir, exist_ok=True)
    icp_path = os.path.join(workdir, "icp.yaml")
    filt_path = os.path.join(workdir, "input_filters.yaml")
    map_path = os.path.join(workdir, "mapper.yaml")
    with open(icp_path, "w") as f:
        f.write(_to_yaml(icp or DEFAULT_ICP) + "\n")
    with open(filt_path, "w") as f:
        f.write(_to_yaml(input_filters or DEFAULT_INPUT_FILTERS) + "\n")
    with open(map_path, "w") as f:
        f.write(_to_yaml(mapper_params or DEFAULT_MAPPER_PARAMS) + "\n")
    return icp_path, filt_path, map_path


def norlab_slam_command(
    workdir: str,
    python: Optional[str] = None,
    driver: Optional[str] = None,
    **config_overrides,
) -> str:
    """A ``cfg.slam_command`` template driving the real norlab mapper.

    Writes the config YAMLs into ``workdir`` and returns::

        <python> scripts/norlab_mapper_driver.py --icp-config ...
            --input-filters-config ... --mapper-config ...
            --input-dir {input_dir} --poses-csv {poses_csv}

    The ``{input_dir}``/``{poses_csv}`` placeholders are filled by
    ``run_external_slam`` at eval time (slam_eval.py contract).
    """
    icp_path, filt_path, map_path = write_norlab_configs(
        workdir, **config_overrides
    )
    driver = driver or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts",
        "norlab_mapper_driver.py",
    )
    python = python or sys.executable
    return (
        "%s %s --icp-config %s --input-filters-config %s --mapper-config %s "
        "--input-dir {input_dir} --poses-csv {poses_csv}"
        % (
            shlex.quote(python),
            shlex.quote(driver),
            shlex.quote(icp_path),
            shlex.quote(filt_path),
            shlex.quote(map_path),
        )
    )
