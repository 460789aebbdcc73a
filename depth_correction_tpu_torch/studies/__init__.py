"""The repo's study scripts and examples on the port (``scripts/*.py`` and
``examples/*.py`` of the JAX package, one module each).

Each module keeps its script's arguments, defaults, printed lines, output
files and synthetic fallback, runs as
``python -m depth_correction_tpu_torch.studies.<name>`` and exposes
``main(argv=None)``. Every study takes ``--device`` (default ``cuda``, the
``Config`` default): without a card it raises, as ``Config.torch_device``
does; ``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

__all__ = ["STUDIES", "add_device_arg", "default_float_type", "torch_device"]

STUDIES = [
    "train_at_scale", "bench_knn", "weights_search", "bias_estimation",
    "paths_alignment", "map_bias_removal", "depth_denoising", "mapping_accuracy",
    "reconstruction_eval", "localization_accuracy", "model_learning",
    "model_poses_learning", "model_poses_learning_icp", "optimization_pair_of_scans",
    "train_demo", "create_dataset_npz", "generate_scans_wo_dynamic_objects_kitti360",
    "optimization", "optimization_icp",
]


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device the study runs on (default cuda; cpu for a "
                             "run without a card)")


def torch_device(name: str):
    """``name`` as a torch device; raises without a card as
    ``Config.torch_device`` does."""
    from ..config import Config

    cfg = Config()
    cfg.device = name
    return cfg.torch_device()


def default_float_type(device: str) -> str:
    """The float type of a study whose JAX script sets float64: float64 on
    the CPU, float32 on a card, whose kernels take float32 (as the JAX
    script computes in float32 on a TPU without x64)."""
    return "float64" if torch_device(device).type == "cpu" else "float32"
