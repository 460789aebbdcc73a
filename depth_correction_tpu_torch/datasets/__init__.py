"""Datasets: synthetic fixtures, meshes, the real-data loaders (ASL laser,
SemanticKITTI, Newer College, KITTI-360, FEE Corridor) and corruption
wrappers (counterpart of ``depth_correction_tpu/datasets/__init__.py``).

All datasets share the reference's duck-typed protocol
(reference: src/depth_correction/dataset.py): ``ds.ids``,
``ds.local_cloud(id) -> structured array``, ``ds.cloud_pose(id) -> (4, 4)``,
integer indexing yielding ``(cloud, pose)``, slicing, len, iteration.
"""
from .synthetic import (
    AngleDataset,
    BaseDataset,
    GroundPlaneDataset,
    OpenBoxDataset,
    PlaneDataset,
    box_point_cloud,
    make_structured,
)
from .wrappers import (
    DepthBiasDataset,
    FilteredDataset,
    NoisyDepthDataset,
    NoisyPoseDataset,
    OverridePosesDataset,
    Subscriptable,
)

__all__ = [
    "AngleDataset",
    "BaseDataset",
    "DepthBiasDataset",
    "FilteredDataset",
    "GroundPlaneDataset",
    "NoisyDepthDataset",
    "NoisyPoseDataset",
    "OpenBoxDataset",
    "OverridePosesDataset",
    "PlaneDataset",
    "Subscriptable",
    "box_point_cloud",
    "create_dataset",
    "dataset_by_name",
    "make_structured",
    "noisy_dataset",
]


def dataset_by_name(name: str):
    """Resolve a dataset class from a name prefix, in the JAX package's
    order (datasets/__init__.py:47-80; reference: dataset.py:912-930): the
    synthetic scenes, a rendered mesh, a mesh file, then the real-data
    loaders."""
    prefix = name.split("/")[0]
    if prefix == "ground_plane":
        return GroundPlaneDataset
    if prefix == "open_box":
        return OpenBoxDataset
    if prefix == "plane":
        return PlaneDataset
    if prefix == "angle":
        return AngleDataset
    if "rendered_mesh" in name:
        from .rendered_mesh import RenderedMeshDataset

        return RenderedMeshDataset
    if ".obj" in name or ".ply" in name:
        from .mesh import MeshDataset

        return MeshDataset
    if prefix in ("asl_laser", "semantic_kitti", "newer_college", "kitti360", "fee_corridor"):
        import importlib

        return importlib.import_module("%s.%s" % (__name__, prefix)).Dataset
    raise ValueError("Unknown dataset: %s" % name)


def noisy_dataset(ds, cfg):
    """Wrap with synthetic corruption per config (reference:
    dataset.py:933-950): a known depth bias (the self-supervision ground
    truth, a float64 model), depth noise, then pose noise (the JAX
    package's order, datasets/__init__.py:106-124)."""
    import numpy as np
    import torch

    if cfg.depth_bias_model_class:
        from ..models import load_model

        gt_model = load_model(
            class_name=cfg.depth_bias_model_class,
            model_args=list(cfg.depth_bias_model_args or []),
            model_kwargs=dict(cfg.depth_bias_model_kwargs or {}),
            dtype=torch.float64,
            device="cpu",
        )
        w = getattr(gt_model, "w", None)
        p0 = getattr(gt_model, "p0", None)
        has_bias = ((w is not None and bool(np.any(w.detach().numpy() != 0.0)))
                    or (p0 is not None and float(p0) != 0.0))
        if has_bias:
            ds = DepthBiasDataset(ds, gt_model, cfg=cfg)
    if cfg.depth_noise:
        ds = NoisyDepthDataset(ds, noise=cfg.depth_noise)
    if cfg.pose_noise_mode is not None and cfg.pose_noise:
        ds = NoisyPoseDataset(ds, noise=cfg.pose_noise, mode=cfg.pose_noise_mode)
    return ds


def create_dataset(name: str, cfg, noisy: bool = True, poses_path=None, **kwargs):
    """Dataset factory: base -> poses override -> filtered -> corrupted ->
    sliced (reference: dataset.py:953-962; ``poses_path`` replaces the
    poses with a CSV file's, JAX package datasets/__init__.py:116-125)."""
    cls = dataset_by_name(name)
    if "rendered_mesh" in name and "device" not in (cfg.dataset_kwargs or {}):
        # The ray casting runs where the config runs.
        kwargs.setdefault("device", cfg.torch_device())
    ds = cls(name, *list(cfg.dataset_args or []), **dict(cfg.dataset_kwargs or {}), **kwargs)
    if poses_path:
        ds = OverridePosesDataset(ds, poses_path)
    ds = FilteredDataset(ds, cfg)
    if noisy:
        ds = noisy_dataset(ds, cfg)
    return Subscriptable(ds)[cfg.data_slice()]
