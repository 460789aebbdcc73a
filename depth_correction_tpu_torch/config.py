"""Experiment configuration.

Field names and defaults follow the reference config
(reference: src/depth_correction/config.py:143-292) so configs are
recognizable to users of the original package, minus ROS-specific knobs.

The field set is the JAX package's (``depth_correction_tpu/config.py``), so
one YAML file configures both packages; the only framework hooks are
:meth:`Config.torch_dtype` and :meth:`Config.torch_device`. Options outside
the port's training slice are kept for config-file parity and rejected with
``NotImplementedError`` by the code that would consume them.
"""
from __future__ import annotations

import os
from datetime import datetime

import yaml

from .configurable import Configurable, ValueEnum

__all__ = [
    "Config",
    "Loss",
    "Model",
    "NeighborhoodType",
    "PoseCorrection",
    "PoseProvider",
    "SLAM",
    "fix_bounds",
    "loss_eval_csv",
    "nonempty",
    "slam_eval_csv",
    "slam_poses_csv",
]


class NeighborhoodType(metaclass=ValueEnum):
    ball = "ball"
    plane = "plane"


class Loss(metaclass=ValueEnum):
    min_eigval_loss = "min_eigval_loss"
    trace_loss = "trace_loss"
    icp_loss = "icp_loss"


class Model(metaclass=ValueEnum):
    Polynomial = "Polynomial"
    ScaledPolynomial = "ScaledPolynomial"


class PoseCorrection(metaclass=ValueEnum):
    """Pose correction modes (reference: config.py:63-79)."""

    none = "none"  # no pose correction
    common = "common"  # one correction shared by all sequences
    sequence = "sequence"  # one correction per sequence
    pose = "pose"  # one correction per pose (first pose kept fixed)


class SLAM(metaclass=ValueEnum):
    # In-framework pipelines (slam_eval.py): scan-to-map ICP with a
    # maintained voxel map (the norlab mapper's role) and plain
    # scan-to-previous odometry.
    icp_mapper = "icp_mapper"
    icp_odometry = "icp_odometry"
    # External C++ mapper, via the corrected-cloud export harness
    # (slam_eval.export_corrected_clouds).
    norlab_icp_mapper = "norlab_icp_mapper"


class PoseProvider(metaclass=ValueEnum):
    """Pose sources for training/eval (reference: config.py:76-93): ground
    truth, or SLAM-estimated poses read back from ``slam_poses_<provider>``
    CSVs produced by ``eval_slam_baselines``. The in-framework pipelines
    (icp_mapper / icp_odometry) play the norlab mapper's role here."""

    ground_truth = "ground_truth"
    icp_mapper = "icp_mapper"
    icp_odometry = "icp_odometry"
    norlab_icp_mapper = "norlab_icp_mapper"


def fix_bounds(bounds):
    import math

    return [
        float(x) if x is not None and math.isfinite(x) else float("nan")
        for x in bounds
    ]


def nonempty(iterable):
    return list(filter(bool, iterable))


def loss_eval_csv(log_dir, loss, subset=None):
    name = "loss_eval_%s%s.csv" % (loss, "_%s" % subset if subset else "")
    return os.path.join(log_dir, name) if log_dir else name


def slam_eval_csv(log_dir, slam, subset=None):
    name = "slam_eval_%s%s.csv" % (slam, "_%s" % subset if subset else "")
    return os.path.join(log_dir, name) if log_dir else name


def slam_poses_csv(log_dir, name, slam):
    path = "slam_poses_%s.csv" % slam
    if name:
        path = os.path.join(name, path)
    return os.path.join(log_dir, path) if log_dir else path


class Config(Configurable):
    """All experiment knobs. Only basic Python types as values."""

    def __init__(self, **kwargs):
        super().__init__()

        # Scheduling / reproducibility.
        self.launch_prefix = None
        self.num_jobs = 0
        self.items_per_job = 1
        self.force = False
        self.random_seed = 135

        # Output locations.
        self.pkg_dir = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
        self.out_dir = os.path.join(self.pkg_dir, "gen")
        self.log_dir = os.path.join(
            self.out_dir, datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        )

        # Model / device.
        self.pose_provider = PoseProvider.ground_truth
        self.slam = SLAM.icp_mapper
        self.model_class = Model.ScaledPolynomial
        self.optimize_model = True
        self.model_args = []
        self.model_kwargs = {}
        self.model_state_dict = ""
        # The cell-window kernels are float32; the reference defaults to
        # float64 on CPU (config.py:179). Use float64 for CPU parity runs.
        self.float_type = "float32"
        # A torch device string ("cuda", "cuda:1", "cpu"); None means
        # "cuda". train() places data and parameters there (reference:
        # config.py:180). Without a card, "cpu" must be asked for: nothing
        # falls back to the CPU (torch_device raises).
        self.device = None

        # Cloud preprocessing (reference: config.py:183-201).
        self.min_depth = 5.0
        self.max_depth = 25.0
        self.grid_res = 0.2
        # Neighborhood.
        self.nn_type = NeighborhoodType.ball
        self.nn_k = 0
        self.nn_r = 0.25
        # Kept for config-file parity: the reference defines this knob but
        # never consumes it either (reference: config.py:190).
        self.nn_grid_res = 0.5
        self.min_valid_neighbors = 5
        self.max_neighborhoods = None
        self.nn_scale = None
        # Static width of the radius-neighbor matrix. None = exact (sized to
        # the global max in-degree like the reference's ragged
        # query_ball_point, nearest_neighbors.py:69-73); an int K caps it.
        # PARITY NOTE: capping truncates dense neighborhoods one-sidedly —
        # with nn_symmetrize the trimmed sets deviate from the reference
        # whenever any neighborhood exceeds K. Leave None for parity runs;
        # set (e.g. 32) for speed/memory at scale.
        self.nn_max_neighbors = None
        # Neighbor-search backend for (one-time) neighborhood establishment,
        # as in the JAX package: None picks the grid-hash search (kernel X2
        # on the card) at >= 65,536 points and the tiled scan below; 'grid'
        # forces the grid; 'scipy' takes the host cKDTree (the reference's
        # index); 'native' the port's build of the C++ KD-tree
        # (utils/native.py; a failed build raises). All give the same
        # within-r sets. The online corrector reads its engine from here
        # too ('slab', 'brute', 'grid'; node.py).
        self.nn_backend = None
        # Hot-loop moments engine. 'gather' recomputes the frozen
        # neighborhoods' moments by indexing with torch autograd. 'cellwin'
        # uses the cell-window kernels (ops/cellwin.py, csrc/cellwin.cu)
        # with membership recomputed from static establishment positions —
        # implies UNCAPPED within-r establishment (the reference's
        # query_ball_point semantics; nn_max_neighbors is ignored) and
        # falls back to 'gather' when ineligible (nn_scale, kNN graphs) or
        # when the build declines. 'auto' (default) selects cellwin on a
        # CUDA device when the config is already uncapped-radius, gather
        # otherwise — auto never changes the objective.
        self.moments_backend = "auto"
        # cellwin tile z-extent limit in cells (None = unlimited): small
        # values shrink the dense candidate windows (less masked-matmul
        # work) at the cost of more tiles (more DMA issues) — a
        # per-workload tuning knob for the cell-window engine.
        self.cellwin_z_max = None
        # cellwin tile capacities (rows per forward tile / points per
        # backward tile; multiples of 128). Smaller tiles cut padding (and
        # with it window span lengths on the padded axes) at the cost of
        # more tiles/DMAs.
        # 128/128 measured ~1.8x fewer dense pairs than 256/256 on the
        # bench workload (padding 1.21x vs 2.18x) at ~7% more DMAs.
        self.cellwin_row_cap = 128
        self.cellwin_pt_cap = 128
        # cellwin boundary-ambiguity overrides (None = builder defaults,
        # ops/cellwin.py:build_cellwin_graph): eps_rel widens the d2~r2
        # band whose rows route through the gather exception path;
        # max_exc_frac bounds the declined fraction. Exposed mainly so
        # validation harnesses (e.g. the multichip dryrun) can force
        # exception rows on tiny scenes that otherwise have none.
        self.cellwin_eps_rel = None
        self.cellwin_max_exc_frac = None
        # Cross-run persistence of the frozen graphs (the JAX package's
        # utils/prep_cache.py). Not ported yet: the port ignores it and
        # always rebuilds.
        self.prep_cache_dir = None
        # Mutual-pair trimming when neighbor lists are truncated (kNN or
        # nn_max_neighbors): bounds the transpose in-degree by K, keeping the
        # analytic gradient's gather as cheap as the forward. No-op for
        # exact (uncapped) radius graphs, which are symmetric already.
        self.nn_symmetrize = True
        # RANSAC plane neighborhoods (nn_type == plane). model_size is
        # fixed to 3 (a plane) in practice — the reference force-sets it
        # the same way (reference: preproc.py:263, segmentation.py:306).
        self.ransac_model_size = 3
        self.ransac_dist_thresh = 0.03
        self.num_ransac_iters = 500

        # Depth correction masks (reference: config.py:204-218).
        self.shadow_neighborhood_angle = 0.017453  # 1 degree
        self.shadow_angle_bounds = []
        self.dir_dispersion_bounds = []
        self.vp_dispersion_bounds = [0.36, float("inf")]
        self.vp_dispersion_to_depth2_bounds = []
        self.vp_dist_to_depth_bounds = []
        self.eigenvalue_bounds = []
        self.eigenvalue_ratio_bounds = [[0, 1, 0, 0.25], [1, 2, 0.25, 1.0]]

        # Data.
        self.dataset = "asl_laser"
        self.dataset_args = []
        self.dataset_kwargs = {}
        self.train_names = []
        self.val_names = []
        self.test_names = []
        self.train_poses_path = []
        self.val_poses_path = []
        self.test_poses_path = []
        self.data_start = None
        self.data_stop = None
        self.data_step = 1
        self.world_frame = "world"

        # Artificial data corruption (reference: config.py:239-244).
        self.depth_bias_model_class = Model.ScaledPolynomial
        self.depth_bias_model_args = []
        self.depth_bias_model_kwargs = {}
        self.depth_noise = 0.0
        self.pose_noise = 0.0
        self.pose_noise_mode = None

        # Training (reference: config.py:247-274).
        self.loss = Loss.min_eigval_loss
        self.loss_offset = False
        self.loss_kwargs = {
            "sqrt": False,
            "normalization": True,
            "inlier_max_loss": None,
            "inlier_loss_mult": 1.0,
            "inlier_ratio": 1.0,
            "icp_inlier_ratio": 0.3,
            "icp_point_to_plane": True,
        }
        self.n_opt_iters = 100

        self.optimizer = "adam"
        self.optimizer_args = []
        self.optimizer_kwargs = {}
        self.lr = 2e-4

        # External-SLAM parity runs (cfg.slam == norlab_icp_mapper): command
        # template launched per sequence with the exported corrected clouds;
        # ``{input_dir}`` = npz export directory (one file per scan:
        # points/normals/mask/prior pose), ``{poses_csv}`` = path where the
        # mapper must write its estimated poses (robot_data CSV schema).
        # The reference drives roslaunch the same way (eval.py:234-259).
        self.slam_command = None

        self.pose_correction = PoseCorrection.none
        self.train_pose_deltas = None
        self.test_pose_deltas = None
        self.loss_eval_csv = None
        self.slam_eval_csv = None
        self.slam_poses_csv = None
        self.odom_cov = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
        self.eval_losses = list(Loss)
        # In-framework pipelines only by default; the external
        # norlab mapper needs the export harness + its own binary.
        self.eval_slams = [SLAM.icp_mapper]
        # PoseProvider grid axis for train_and_eval_all (reference
        # main.py:249-250 iterates the whole enum): non-ground-truth
        # providers read slam_poses_<provider>.csv files written by
        # eval_slam_baselines under <preproc_dir>/<name>/ and switch
        # pose_correction to per-pose (main.py:288-293).
        self.eval_pose_providers = [PoseProvider.ground_truth]

        self.log_filters = False
        self.show_results = False
        self.plot_period = 10

        # Parallelism, layout, profiling and checkpointing knobs of the JAX
        # package. mesh_shape and the dist_* options run train() and
        # eval_loss() over a torch.distributed group (parallel/sharding.py,
        # mesh_from_config); spatial_sort turns the cell-window engine off,
        # as in the JAX package, and leaves the rows in their order (the
        # Morton permutation is a TPU layout workaround); profile_dir takes
        # a torch.profiler trace of iterations 2 to 6 (train.fit), with the
        # program's spans (utils/trace.py), and writes beside it
        # idle_by_span_it002-006.json: the device-idle seconds of the same
        # profile by the span open on the host.
        self.mesh_shape = None  # e.g. {'data': 8}; None = single device
        self.dist_coordinator = None
        self.dist_num_processes = None
        self.dist_process_id = None
        self.spatial_sort = False
        self.profile_dir = None
        self.checkpoint_period = 0
        self.resume = True

        self.from_dict(kwargs)

    # --- typed helpers ----------------------------------------------------
    def data_slice(self):
        return slice(self.data_start, self.data_stop, self.data_step)

    def numpy_float_type(self):
        import numpy as np

        return getattr(np, self.float_type)

    def torch_dtype(self):
        import torch

        return getattr(torch, self.float_type)

    def torch_device(self):
        """Resolve ``cfg.device`` ("cuda", "cuda:1", "cpu", ...; None means
        "cuda") to a torch device.

        :raises RuntimeError: a CUDA device is asked for (or left to the
            default) and no card is present.
        """
        import torch

        device = torch.device(str(self.device) if self.device else "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "cfg.device is %r but no CUDA device is available; set "
                'cfg.device = "cpu" to run on the CPU' % (self.device,))
        return device

    def sanitize(self):
        """Coerce YAML-string bound fields to lists (reference: config.py:305-336)."""
        for key in (
            "shadow_angle_bounds",
            "dir_dispersion_bounds",
            "vp_dispersion_bounds",
            "vp_dispersion_to_depth2_bounds",
        ):
            val = getattr(self, key)
            if isinstance(val, str):
                val = yaml.safe_load(val)
            val = val or []
            setattr(self, key, fix_bounds(val))

        if isinstance(self.eigenvalue_bounds, str):
            self.eigenvalue_bounds = yaml.safe_load(self.eigenvalue_bounds)
        bounds = []
        for i, lo, hi in self.eigenvalue_bounds or []:
            if not isinstance(i, int) or i < 0:
                continue
            lo, hi = fix_bounds([lo, hi])
            bounds.append([i, lo, hi])
        self.eigenvalue_bounds = bounds

        if isinstance(self.eigenvalue_ratio_bounds, str):
            self.eigenvalue_ratio_bounds = yaml.safe_load(self.eigenvalue_ratio_bounds)

    # --- experiment naming (reference: config.py:338-462) ------------------
    def get_depth_filter_desc(self):
        return "d%.0f-%.0f" % (self.min_depth, self.max_depth)

    def get_grid_filter_desc(self):
        return "g%.2f" % self.grid_res

    def get_nn_desc(self):
        parts = []
        if self.nn_k:
            parts.append("k%i" % self.nn_k)
        if self.nn_r:
            parts.append("r%.2f" % self.nn_r)
        return "_".join(parts)

    def get_eigval_bounds_desc(self):
        return "_".join(
            "e%i_%.3g-%.3g" % (i, lo, hi) for i, lo, hi in self.eigenvalue_bounds
        )

    def get_eigval_ratio_bounds_desc(self):
        return "_".join(
            "e%ie%i_%.3g-%.3g" % (i, j, lo, hi)
            for i, j, lo, hi in self.eigenvalue_ratio_bounds
        )

    def get_loss_desc(self):
        desc = self.loss
        kw = self.loss_kwargs
        desc += "_norm%i" % bool(kw.get("normalization", False))
        desc += "_sqrt%i" % bool(kw.get("sqrt", False))
        if kw.get("inlier_max_loss"):
            desc += "_iml%.3g" % kw["inlier_max_loss"]
        if kw.get("inlier_ratio", 1.0) != 1.0:
            desc += "_ir%.3g" % kw["inlier_ratio"]
        if kw.get("inlier_loss_mult", 1.0) != 1.0:
            desc += "_ilm%.3g" % kw["inlier_loss_mult"]
        desc += "_lr%.3g" % self.lr
        return desc

    def get_preproc_desc(self):
        self.sanitize()
        return "_".join(
            nonempty(
                [self.dataset, self.get_depth_filter_desc(), self.get_grid_filter_desc()]
            )
        )

    def get_exp_desc(self, sep="_"):
        return sep.join(
            nonempty(
                [
                    self.pose_provider,
                    self.pose_correction,
                    self.model_class,
                    self.get_nn_desc(),
                    self.get_eigval_bounds_desc(),
                    self.get_eigval_ratio_bounds_desc(),
                    self.get_loss_desc(),
                ]
            )
        )

    def get_preproc_dir(self):
        return os.path.join(self.out_dir, self.get_preproc_desc())

    def get_exp_dir(self):
        return os.path.join(self.get_preproc_dir(), self.get_exp_desc())
