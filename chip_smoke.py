#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):

1. build   — compile the CUDA kernels of depth_correction_tpu_torch/csrc.
2. kernels — K1 (cell-window moments forward) and K2 (backward) against
   their plain torch versions, float32 and float64, on a seeded synthetic
   graph at row_cap = pt_cap = 128; the pair tests the warps' box cull
   keeps, counted on the host, beside all of them.
3. slice   — the uncapped min-eigenvalue training step at the JAX bench's
   configuration (bench.py:bench_config(uncapped=True)), scene
   open_box/n_6_size_20_20_5_height_1_density_400 (its scans generated
   once and kept for phases 9 and 12), prepared with the
   bench's grid establishment (X2 for the 6 scans and the global cloud;
   prep seconds per part are printed beside the 26 s that scipy's cKDTree
   establishment took on an H100, and local_features beside the 1.274 s it
   took with the eager brute count; X3 sizes each scan's K),
   trained for 8 Adam steps through train() (its log_dir in a temporary
   directory; losses and step times read from the step_ms and train_loss
   columns of its train_history.csv); X2, K1 and K2 must have
   launched, the loss at w=0 must match the float64 plain path within 1e-5
   relative, and K1/K2 are checked as in phase 2 and timed at the slice's
   shapes; one step is profiled.
4. node    — the online corrector at the JAX bench's node workload
   (bench.py:build_node_scan: the raw 129,000-point scan of
   open_box/n_6_size_20_20_5_height_1_density_215, slab engine, float32)
   through DepthCorrector.process and correct_cloud; X1 must have launched
   and meet its bars against the float64 plain version on the node's own
   sorted inputs; it is timed there, with the share of pair tests the
   warps' cull keeps (host model, scripts/slab_cull.py); the corrected
   points are held
   against the port's plain float64 node path; node_ms, node_e2e_ms and
   node_points are printed.
5. small   — a scan of the same box below 65,536 padded points
   (density 100), routed to the brute engine (K = 32): X3 and P7 must have
   launched; node_ms is printed beside the 358.307 ms of the eager
   sort-based search that preceded X3; X3 is held against its plain twin
   on the node's own points (top-k: index tables equal and d2 bit for bit;
   counts equal) and timed in both modes, with the search kernel's own
   time, the share of pair tests the cull keeps (host model,
   scripts/knn_cull.py) and the bounds of the kept and of all pair tests;
   P7 must meet its bars on the node's own neighbour table, and is timed
   there (by events and by the profiler's kernel durations);
   then P7 and its plain version are timed at the shapes of
   scripts/exp_pallas_gather.py's stage 2 and held within 1e-5 relative.
6. probes  — the port's probe scripts (depth_correction_tpu_torch/scripts),
   each run with the launch counts zeroed just before and read just after:
   P1 (exp_cellwin_knockout: K1's knockout modes on the slice's own table
   from phase 3; `full` and `no_cull` must be bit-equal to K1, every mode
   meet its bars against its float64 plain version), P2 (exp_mosaic_dot_probe: the
   moment product in fp32 / tf32 / tf32x2 / tf32x3, torch.bmm timed beside
   it), P3-P5 (exp_mosaic_dot_probe2-4: the product with in-kernel
   operands and K1's structural pieces), at the TPU scripts' seeds and
   shapes, every variant timed by events and by the profiler's kernel
   durations. Every variant must be within 1e-5 (relative, per output row)
   of its float32 plain version; fp32 and tf32x3 within 1e-5 of the
   float64 oracle; a table of ms per variant is printed.
7. grid    — X2 (the grid radius search) against its plain twin on the
   card, on phase 3's global cloud and on its first scan: index tables
   equal, distances within one float32 ulp, counts equal; against scipy's
   float64 sets on the scan (a pair may differ only within 1e-6 r of the
   radius); timed at both sizes, top-k and counts. P7 on the global
   cloud's X2 table (prep's largest call) against its float64 plain
   version (the node's bars), timed. X2 at the grid node's shapes (the
   traced 2^21-cell grid of phase 4's filtered scan; k = 32, the node's,
   and k = 16, below the scan's largest count, so the top-k cuts) against
   its plain twin, as above, and timed. Then the node's grid
   engine (X2 + P7, K = 32) on phase 4's scan, held within 1e-4 m of the
   float64 plain grid node, with node_ms and node_e2e_ms as phase 4
   measures them.
8. probes  — P6 (exp_mosaic_probe: the seven layout probes), P8
   (exp_pallas_gather2: gather cases A-E, global and staged, B's staged
   form on a cluster of 8 blocks; B's global and cluster forms,
   torch.gather and the global form on sorted indices timed in turns by
   the profiler's kernel durations and by events) and P7's two stages
   (exp_pallas_gather: P7a, the gather-sum probe, bit-equal to its plain
   version; P7 at stage 2 within 1e-5), each script run with the launch
   counts zeroed just before and read just after; every P6 and P8 form
   exact against its plain version, every P6 probe on both inputs and
   timed by the profiler's kernel durations, torch.matmul beside dot_tlhs
   and x.T.contiguous() beside transpose_f32; embedding_bag, one PyTorch
   call computing P7a's function, timed and held within 1e-6 of its plain
   version; P7a's device time printed beside embedding_bag's (slower or
   not); P7 at stage 2's shapes timed.

Every main path (phases 3-5, 7, 9-14, 16-17, 19) runs with all launch counts zeroed
before it.
9. capped  — the bench's capped row (bench.py:bench_config(uncapped=False):
   K = 32 with mutual trimming, the gather moments: P7 forward, X4
   backward over the transpose prep builds) on
   the slice's scene (phase 3's scans), 8 Adam steps through train() (step times from its
   step_ms column): capped32_ms, X4 once a step, the
   loss at w=0 within 1e-5 relative of the float64 plain path, and a
   profiled step without autograd's indexing_backward_kernel.
10. default — a default Config() (only log_dir, train_names, n_opt_iters,
   float_type, the data directory and shadow_angle_bounds set) on an open
   box written as ASL-laser CSV files into a temporary directory. X3 and
   P7 must have launched in prep. On one scan, X3's counts (which size
   k_dir) and top-k over the view directions equal their plain twins
   (timed and bounded as in phase 5), the shadow mask
   drops some points and keeps others, and local_feature_cloud keeps as
   many. X3 on the global cloud at the establishment's r and a K sized by
   its counts, held and timed the same way (prep itself routes this cloud
   to X2: its padded size is above 65,536). On the global cloud,
   vp_dispersion (P7 on the viewpoints) agrees with the float64 plain
   moments to 1e-5 of its largest value, its mask equals the float64 one
   and keeps the rows prep kept, and the bound drops some rows. The loss
   at w=0 must be within 1e-5 of the float64 plain path. Why the
   cell-window build declined is printed (the builder's note). Then end
   to end with pose inputs: the poses perturbed and written as a poses
   CSV, train() with train_poses_path, pose_correction = sequence and the
   sequence with its own poses for validation, then eval_loss with
   test_pose_deltas = the best deltas; the files must exist and the eval
   loss be finite and no higher than the first step's.
11. pose   — pose correction at full width on phase 3's prepared slice
   (390,144 padded points, 6 scans): pose mode with deltas of a few mm and
   mrad seeded on scans 1-5, 8 Adam steps of train.fit. The loss at the
   seeded deltas within 1e-5 of the float64 plain path on the same graph;
   the deltas' gradient against float64 printed; scan 0's delta exactly 0
   after the steps; K1 and K2 launched once a step each; pose_step_ms
   (median of steps 1..7) and the profiled step's device-busy share.

12. new paths (the loss offset, ICP, L-BFGS, nn_scale, resume, the prep
   cache), each with the launch counts zeroed just before it: (a) the
   loss offset on phase 3's scene (prep keeps the per-scan neighbours),
   8 Adam steps of train.fit on K1 and K2 and the offset's gather (X4
   once a step for the offset graph, once for the exception rows), the
   loss at w=0 within 1e-5 of the float64 plain path, offset_step_ms and
   the profiled step (no indexing_backward_kernel); (f) that prep written to the prep cache and
   prepared again: a hit, equal bit for bit, its seconds beside the
   build's; (b) ICP training on the scene (prep through X3, X2 and P7, the
   correspondences on the host), 8 Adam steps, the loss at w=0 within
   1e-5 of float64, then eval_icp on the same sequence: each of X3's k = 1
   calls without a radius launched once, its distances bit-equal to the
   plain twin's on the same float32 inputs and an index differing only at
   a tie, the share of correspondences that differ from float64 plain,
   the eval loss within 1e-5 of float64 plain (the same feature clouds,
   the model, poses and 1-NN in float64), X3's time a pair against its
   all-pairs bound; (c) 4 L-BFGS steps with the zoom line search on phase
   3's prepared slice: the loss falls, K1 and K2 launch at each trial
   point; (d) (run inside phase 10, while its files exist) nn_scale on the
   default config's data: P7 exactly once more in prep than without
   nn_scale, its features (mean, eigenvalues, re-weighted weights; P7
   twice) within 1e-5 of float64 plain, 4 Adam steps (X5 once a step, the
   scaled gather's backward), the loss at w=0
   within 1e-5 of float64; (e) train() for 4 steps with
   checkpoint_period 2, interrupted when step 2 starts and resumed, against
   an uninterrupted run: the largest |dw| and whether the saved states are
   bit-equal.

13. plane  — plane neighbourhoods (nn_type = plane, the RANSAC defaults:
   distance 0.03, 500 hypotheses, at most 10 planes of at least 5 points,
   clustered at 2 sqrt(3) grid_res) on phase 3's loaded scans: prep (no
   kernel launches), the planes fitted again on the card (RANSAC seconds
   per model, the clustering's seconds, the scoring's peak device memory)
   and on the CPU from the same float32 cloud: as many planes, params
   within 1e-6, supports equal but for points within 1e-6 m of the
   threshold (counted); 8 Adam steps of train.fit (plane_step_ms, the
   profiled step); the loss at w=0 within 1e-5 of float64 on the same
   members.
14. kitti360 — phase 3's six scans written as a KITTI-360 drive (float32
   velodyne records, cam0_to_world poses through a non-identity
   cam-to-velo calibration) in a temporary directory and loaded through
   create_dataset("kitti360/..."): the points equal the written float32
   ones less the ego filter's, the poses the chain's within 1e-12; then
   the main path on it (uncapped, grid establishment, no second synthetic
   bias) twice. First at the default exception-row budget (5%): the
   build's outcome printed, 8 Adam steps on the path it leaves (declined:
   the gather path, P7 and X4 once a step, no K1 or K2), the step
   time, the loss at w=0 within 1e-5 of float64. Then with exception rows
   allowed up to 25% (the first pose's frame tilts the scene against the
   cells): X2, X3 and P7 in prep, K1 and K2 each step;
   kitti360_step_ms, prep seconds, the loss at w=0 within 1e-5 of
   float64. Then nn_backend = native on phase 5's small scan: the
   library's build timed, its
   within-r sets equal X3's on the same points but for pairs within
   1e-6 m of r (counted).
15. render — a room mesh made in code (walls, floor and ceiling, each a
   41 x 41 grid of quads: 20,172 triangles) written as an OBJ file and
   rendered by RenderedMeshDataset at 1,024 x 64 beams from 8 poses on the
   card; per pose, 512 of its rays cast again on the CPU in float32: t
   within 1e-5 relative, the same triangle but at near-ties (counted);
   raycast_ms per pose and the render's device-busy share.
16. slam   — on phase 3's six scans, corrected by the model phase 3
   trained (features computed again, P7): the ground-truth poses perturbed
   (perturb_odometry, seeded, a few mm and mrad); slam_odometry and
   slam_mapper, 8 ICP iterations a scan, each run with the launch counts
   zeroed: X3 and X6 exactly 8 launches each a registered scan and no
   other kernel;
   slam_odometry_ms_per_scan and slam_mapper_ms_per_scan, and one profiled
   registration of each (device-busy share); X3 (its nearest search) in
   the mapper's last (largest) registration and at a street-sized map
   (benchmark/street.py's scan 24 against its scans 0-23 merged at 0.1 m,
   ~115k against ~446k rows): events, device time, the plain twin's time
   and the tiles its warps read (the kernel's tally) as a share of all,
   against the all-pairs and bytes bounds, the distances and indices bit
   for bit the plain twin's; X6 on that
   registration's first step against its plain twin in float32 and float64 (the threshold bit for bit the float32
   twin's, the inliers both twins', T within 2e-6 of the float64 twin's),
   timed against its bound. Both pipelines again on the same clouds and priors in
   float64 on the plain path: every pose within 1e-4 m and 1e-5 rad, the
   share of first-iteration correspondences that differ printed; the
   mapper's mean translation error below the prior's. Then eval_slam_all
   with icp_mapper and icp_odometry on the sequence (one 5-field row in
   each slam_eval_<slam>_test.csv), and the external route
   (norlab_icp_mapper through scripts/stub_slam_mapper.py): one pose read
   back a scan.
17. analysis — on phase 3's prepared slice: sweep_weight over 21 weights
   (K1 exactly 21 launches, K2 none; the losses against the float64 plain
   sweep: within 1e-5 at the first, middle and last weight, the same
   argmin; landscape_ms_per_weight); joint_learning for 4 Adam steps with
   sequence deltas, metrics every 2 iterations, a synthetic ground-truth
   map and positions (K1 and K2 once a step; joint_step_ms; the first
   probe's map accuracy within 1e-5 of float64 plain on the same global
   cloud; X3 in mapping_accuracy timed against its all-pairs bound).
18. multi-GPU — (a) phase 3's slice through train() over a one-rank NCCL
   group (dist_coordinator at a free localhost port, dist_num_processes 1,
   dist_process_id 0; prep under the mesh, X2 through
   grid_radius_neighbors_sharded): its losses and w against phase 3's
   (bit-equal expected, else the largest relative difference, at most
   1e-6), K1 and K2 once a step, dist1_step_ms beside train_step_ms, three
   profiled sharded steps on the rank's tables (wall, device busy,
   kernels) beside phase 3's profiled step, the ungrouped and the sharded
   step in turns (CUDA events over 10 steps each), the rank's resident
   bytes of its point and row tables, the whole tables prep holds on every
   rank before the split and the rank's peak device bytes over train();
   the group is destroyed at the end. (b) 4 ranks rehearsed in one
   process on phase 3's graph (parallel.cellwin_shard.rehearse: K1 on each rank's row tiles
   with the empty padding tiles, K2 on each rank's point tiles against the
   joined cotangent table; X2 on each rank's query slice of the global
   cloud): bit for bit the single launches. (c) with two cards or more,
   one NCCL rank a card (``chip_smoke.py --dist-rank``), within 1e-5 of
   phase 3; with one card it says so and claims no scaling.
19. studies — depth_correction_tpu_torch/studies on the card. (a)
   train_at_scale at its defaults (open_box 32_32_6 at density 300, about
   843k global points, grid establishment, 3 warm-up and 10 timed Adam
   steps), the scans loaded once and prepared for each engine
   (DC_MOMENTS_BACKEND gather, K = 32; cellwin, uncapped), each with the
   launch counts zeroed before its prep and read after its steps (X2 and
   P7 in prep; K1 and K2 once a step on the cell-window engine, none on
   the gather engine): global points, query rows, K, prep seconds by
   part, scale_step_ms (median, spread), the f32 kernels' loss at w = 0
   within 1e-5 of the float64 plain path on the same graph, w against the
   injected -0.002, the peak device bytes, one profiled step; K1 and K2 on
   the scale graph against their plain twins, timed
   there. If the cell-window build declines at density 300 the run is the
   gather path (the JAX package's fallback) and K1 / K2 run on the
   largest neighbouring density whose build the builder accepts. (b)
   bench_knn at 131,072, 524,288 and 1,048,576 points: X2 and X3 (r 0.25,
   k 48), scipy's cKDTree, the mean and largest ball; at 131,072 X2's sets
   equal X3's and scipy's but for radius ties. (c) every other study's
   main() once on the card (iterations cut where a study takes them, the
   joint-learning studies on a 10 x 10 x 5 m box; the KITTI-360 filter on
   two of phase 3's scans written as a drive with one dynamic window):
   its device, seconds and result line.

20. transpose — X4 (the gather moments' backward) and X5 (the pair
   gather's backward under nn_scale), csrc/transpose_gather.cu, on the
   capped row's graph (phase 9's prepared data and transpose) and on the
   scale run's gather graph (phase 19(a)'s), at w = 0 with seeded
   cotangents: each within 1e-4 of max |output| of its float64 plain
   version and two launches bit-equal; timed by CUDA events and by the
   profiler's kernel durations beside its plain version, its bound, and,
   for X5, index_add_ (one PyTorch call computing its function); the
   tiles' pairs a row in cell order and in point order (the same graph
   built over features.index_order) and prep's transpose seconds (the
   variants of scripts/exp_transpose_variants.py run alone); the step's
   gradient in w within 1e-4
   of the float64 plain path's, and in the points X4 within 1e-4 of its
   float64 plain version inside the float32 step (the float32 step
   against the float64 plain path printed). Then the pairs a row of phase
   3's exception-row transpose in the cell-sorted layout's order and in
   cell order.

Every gather-engine path counts X4 and X5 (check_transposes): one X4 a
loss evaluation for a gather sequence (X5 under nn_scale), one for an
offset graph and one for a cell-window graph with exception rows (phases
3, 9-12, 14, 18, 19(a)).

Device-busy times (profile_calls) sum kernels, memcpys and memsets; user
annotations (record_function spans such as Optimizer.step#Adam.step),
which enclose kernels already counted, are left out, and how much the
count with them would overstate is printed.

The last two lines of stdout are a JSON object with per-kernel numbers
(time, plain time, launches, error, the bound and what sets it, the
library call's time where one PyTorch call computes the same function;
for K1 and K2 also the kernels' own durations by the profiler
`kernel_ms`, the pair tests the box cull keeps `pairs_kept`, counted by
the host model of the cull (scripts/cellwin_cull.py) and not read from
the kernels, and the bound `bound_all_pairs_ms`, which charges every span
pair test; for X1 the same, by scripts/slab_cull.py; for X2 its time at
each input; for X3 the same two bounds on each of its three inputs; for
P2, P3-P5 and P6 the kernel durations `kernel_ms` and per-variant times;
for P7a and P7 the kernel durations too, and for P7 per shape (the
probe's, the small scan's node table, the global cloud's top-k table)
with its bound, and its launches in the slice's and the default config's
prep; for
P2, P6, P7a and P8 the library call's device time by the profiler beside
its events time; for X3 also eval_icp's k = 1 calls, ``inputs.icp_pairs``,
and their count ``launches_icp_eval``) and {"ok": true, "device": {...}}. Before them, one line
carries the end-to-end numbers of the bench's keys (train_step_ms,
capped32_ms, node_ms, ...).
Without a CUDA device the script fails before printing any result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

STEPS = 8
DEVICE = "cuda"
NODE_SCENE = "open_box/n_6_size_20_20_5_height_1_density_215"
SMALL_SCENE = "open_box/n_6_size_20_20_5_height_1_density_100"
NODE_REPS = 20  # chained calls per node_ms batch
E2E_REPS = 10
# The brute engine's node_ms and prep's local_features seconds with the
# eager sort-based brute search that preceded kernel X3 (measured by this
# script on an NVIDIA H100 80GB HBM3, 700 W).
EAGER_BRUTE_NODE_MS = 358.307
EAGER_LOCAL_FEATURES_S = 1.274
# The default-config phase's open box (ASL-laser CSV files).
DEFAULT_SCENE = "open_box/n_6_size_20_20_5_height_1_density_50"
POINTS_ABS_BAR = 1e-4  # m, corrected points against the float64 plain node
# X2's cut check at the grid node's shapes: below the node scan's largest
# within-r count (27), so the top-k drops neighbours.
GRID_CUT_K = 16
PROBE_REL_BAR = 1e-5  # P7 at the probe's shapes, relative to max |output|
# Bars against the float64 plain version.
MEAN_ABS_BAR = 1e-5  # m
COMPS_ABS_BAR = 1e-6  # m^2
GRAD_REL_BAR = 1e-4  # relative to max |grad|
LOSS_REL_BAR = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_ms(fn, device, reps: int) -> float:
    """Mean ms per call of ``fn``'s kernels alone (torch.profiler)."""
    from depth_correction_tpu_torch.scripts import kernel_ms as timer

    return timer(fn, device, reps)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call, by CUDA events around ``reps`` calls."""
    from depth_correction_tpu_torch.scripts import device_ms

    return device_ms(fn, DEVICE, reps, warmup)


# Published peaks of one H100 SXM (NVIDIA data sheet; dense): the bounds
# below are the larger of bytes / HBM rate and the operations of each type
# over that type's peak rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "fp64": 34e12}


def bound(nbytes: float, ops: dict) -> tuple:
    """(bound_ms, "bytes" or "operations") for ``nbytes`` moved once and
    ``ops`` {type: count} done at the card's published peaks. fp32 runs on
    the CUDA cores and tf32 on the tensor cores, pipes that issue side by
    side, so the operations take the longest type's time, not the sum."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Float operations of one pair test (3 subtractions, a multiply and two
# fmas) and of one warp's box test of a window entry (per axis 2
# subtractions and 2 max, then the same distance).
PAIR_OPS, BOX_OPS = 8, 17


def cellwin_fwd_bound(graph, pairs: int, members: int, box_tests: int = 0) -> tuple:
    """K1's bound on ``graph`` (P1's ``full`` does the same work): ``pairs``
    membership tests and ``box_tests`` warp box tests (the box cull's kept
    tests and its tests, or every span pair test and none for the first
    version), ~19 float ops per member, an epilogue per row; positions,
    establishment positions, span tables and centres read once,
    (10, mq_pad) written once."""
    m_pad, mq_pad = graph.est_sorted.shape[1], graph.q_est.shape[1]
    t1, ns = graph.f_start.shape
    return bound(m_pad * 24 + mq_pad * 12 + t1 * (ns * 8 + 12) + mq_pad * 40,
                 {"fp32": PAIR_OPS * pairs + BOX_OPS * box_tests + 19 * members + 30 * mq_pad})


def cellwin_bwd_bound(graph, pairs: int, members: int, box_tests: int = 0) -> tuple:
    """K2's bound on ``graph``: its own pair tests and box tests as in
    :func:`cellwin_fwd_bound`, 9 adds per member (the same member pairs as
    K1's), 15 float ops per point; positions, establishment positions,
    cotangents, span tables and centres read once, (m_pad, 3) written once."""
    m_pad, mq_pad = graph.est_sorted.shape[1], graph.q_est.shape[1]
    t2, ns_b = graph.b_start.shape
    return bound(m_pad * 24 + mq_pad * 48 + t2 * (ns_b * 8 + 12) + m_pad * 12,
                 {"fp32": PAIR_OPS * pairs + BOX_OPS * box_tests + 9 * members + 15 * m_pad})


def phase_build() -> float:
    from depth_correction_tpu_torch.ops import _kernels

    info = _kernels.build()
    _kernels.load()
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())
    log("build: %.2f s (%s)" % (info["seconds"], os.path.basename(info["path"])))
    return info["seconds"]


def _uncapped_graph(pts, r):
    from scipy.spatial import cKDTree

    lists = cKDTree(pts).query_ball_point(pts, r, workers=-1)
    import numpy as np

    nn = np.full((len(pts), max(len(l) for l in lists)), -1, np.int64)
    for i, l in enumerate(lists):
        nn[i, : len(l)] = sorted(l)
    return nn


def synthetic_graph(seed: int = 0, n: int = 40000, r: float = 0.35):
    """The tests' kind of scene (half a noisy plane, half a volume), larger."""
    import numpy as np

    from depth_correction_tpu_torch.ops.cellwin import build_cellwin_graph

    rng = np.random.default_rng(seed)
    n1 = n // 2
    p1 = np.c_[rng.uniform(-6, 6, (n1, 2)), 0.02 * rng.standard_normal(n1)]
    p2 = rng.uniform(-6, 6, (n - n1, 3))
    pts = np.vstack([p1, p2])
    nn = _uncapped_graph(pts, r)
    # Query rows as the slice's prep keeps them: a random 70% among the
    # points with at least min_valid_neighbors (5) neighbors. Rows with
    # fewer have a covariance normalizer of max(s0 - 1, 1e-6), whose
    # cotangents the loss never produces.
    keep = (rng.uniform(size=n) < 0.7) & ((nn >= 0).sum(1) >= 5)
    qrows = np.flatnonzero(keep)
    g = build_cellwin_graph(pts, np.ones(n, bool), qrows, nn[qrows], r,
                            row_cap=128, pt_cap=128, span_limit=512)
    if g is None:
        raise RuntimeError("synthetic cellwin graph declined")
    return pts, g


def bit_equal(a, b) -> bool:
    """float32 tensors equal bit for bit (-0.0 and 0.0 differ)."""
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def pairs_kept(dev) -> dict:
    """(pair tests K1's / K2's warps make after the box cull, all pair tests
    (span lengths x tile slots), the warps' box tests), from the host model
    of the cull (scripts/cellwin_cull.py) on the graph in the kernels'
    float32 form: the kernels count nothing."""
    from depth_correction_tpu_torch.scripts import cellwin_cull as cull

    t0 = time.perf_counter()
    res = {"fwd": cull.cull_pair_tests(dev.q_est, cull.ROW_PAD, dev.est_sorted, dev.f_start,
                                       dev.f_len, dev.f_ctr, dev.r2),
           "bwd": cull.cull_pair_tests(dev.est_sorted, cull.POINT_PAD, dev.q_est, dev.b_start,
                                       dev.b_len, dev.b_ctr, dev.r2)}
    log("  pair tests kept by the box cull (host model): K1 %d of %d (%.4f), %d box tests; "
        "K2 %d of %d (%.4f), %d box tests (%.1f s)"
        % (res["fwd"][0], res["fwd"][1], res["fwd"][0] / res["fwd"][1], res["fwd"][2],
           res["bwd"][0], res["bwd"][1], res["bwd"][0] / res["bwd"][1], res["bwd"][2],
           time.perf_counter() - t0))
    return res


def in_turns(first, second, reps: int = 50) -> tuple:
    """(first ms, second ms): CUDA-event means over ``reps`` launches each,
    timed in turns first, second, second, first; each the mean of its two."""
    a1 = cuda_ms(first, reps=reps)
    b1 = cuda_ms(second, reps=reps)
    b2 = cuda_ms(second, reps=reps)
    a2 = cuda_ms(first, reps=reps)
    log("    turns (ms): %.4f, %.4f, %.4f, %.4f" % (a1, b1, b2, a2))
    return (a1 + a2) / 2, (b1 + b2) / 2


def compare_kernels(pts_sorted, dev, seed: int, label: str, card: str = ""):
    """K1/K2 against the plain versions (float32 and float64) on the same
    float32 inputs; raises on a missed bar. Returns per-kernel numbers, with
    times when ``card`` (the nvidia-smi line) is given."""
    import numpy as np
    import torch

    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.ops.features import _cotangent_table

    f_args = (dev.q_est, dev.est_sorted, dev.f_start, dev.f_len, dev.f_ctr, dev.r2)
    raw_k = cw.cellwin_fwd(pts_sorted, *f_args)
    raw_32 = cw.cellwin_fwd_plain(pts_sorted, *f_args)
    raw_64 = cw.cellwin_fwd_plain(pts_sorted.double(), *f_args)
    rows = (dev.row_map >= 0).clone()
    rows[dev.exc_slots] = False  # exception rows are recomputed by gather
    res = {}
    for name, ref in (("f32", raw_32), ("f64", raw_64)):
        d = (raw_k.double() - ref.double())[:, rows].abs()
        res[name] = (float(d[0:3].max()), float(d[3:9].max()))
        log("  %s K1 vs plain %s: mean max abs %.3e m, comps max abs %.3e m^2 "
            "(%d rows, %d exception rows excluded)"
            % (label, name, res[name][0], res[name][1], int(rows.sum()), dev.n_exc))
    if not (res["f64"][0] <= MEAN_ABS_BAR and res["f64"][1] <= COMPS_ABS_BAR):
        raise RuntimeError("%s K1 misses its bars vs float64: %s" % (label, res["f64"]))

    gen = torch.Generator(device="cpu").manual_seed(seed)
    g_rows = torch.randn((9, raw_k.shape[1]), generator=gen, dtype=torch.float64)
    g_rows = torch.where(rows.cpu()[None], g_rows, torch.zeros_like(g_rows)).to(pts_sorted.device)
    table_64 = _cotangent_table(raw_64[0:3], raw_64[9], (g_rows[0:3], tuple(g_rows[3:9])))
    table_32 = table_64.float().contiguous()
    b_args = (dev.b_start, dev.b_len, dev.b_ctr, dev.r2)
    grad_k = cw.cellwin_bwd(pts_sorted, dev.q_est, dev.est_sorted, table_32, *b_args)
    grad_32 = cw.cellwin_bwd_plain(pts_sorted, dev.q_est, dev.est_sorted, table_32, *b_args)
    grad_64 = cw.cellwin_bwd_plain(pts_sorted.double(), dev.q_est, dev.est_sorted,
                                   table_32.double(), *b_args)
    gres = {}
    for name, ref in (("f32", grad_32), ("f64", grad_64)):
        d = (grad_k.double() - ref.double()).abs()
        scale = float(ref.double().abs().max())
        gres[name] = (float(d.max()), float(d.max()) / max(scale, 1e-30))
        log("  %s K2 vs plain %s: grad max abs %.3e, relative to max |grad| %.3e"
            % (label, name, gres[name][0], gres[name][1]))
    if not np.isfinite(gres["f64"][1]) or gres["f64"][1] > GRAD_REL_BAR:
        raise RuntimeError("%s K2 misses its bar vs float64: %s" % (label, gres["f64"]))
    out = {"fwd_err": max(res["f64"]), "bwd_err": gres["f64"][0], "kept": pairs_kept(dev)}
    if card:
        bargs = (pts_sorted, dev.q_est, dev.est_sorted, table_32) + b_args
        calls = {"fwd": lambda: cw.cellwin_fwd(pts_sorted, *f_args),
                 "bwd": lambda: cw.cellwin_bwd(*bargs)}
        for name, call in calls.items():
            out[name + "_ms"] = cuda_ms(call, reps=50)
            # The kernel's own duration (profiler).
            out[name + "_kernel_ms"] = kernel_ms(call, DEVICE, reps=20)
        out["fwd_plain_ms"] = cuda_ms(lambda: cw.cellwin_fwd_plain(pts_sorted, *f_args), reps=5)
        out["bwd_plain_ms"] = cuda_ms(lambda: cw.cellwin_bwd_plain(*bargs), reps=5)
        log("  %s timing (float32): K1 %.4f ms (kernel alone %.4f) vs plain %.4f ms; K2 %.4f ms "
            "(kernel alone %.4f) vs plain %.4f ms (%s)"
            % (label, out["fwd_ms"], out["fwd_kernel_ms"], out["fwd_plain_ms"], out["bwd_ms"],
               out["bwd_kernel_ms"], out["bwd_plain_ms"], card))
    return out


def phase_kernels():
    import torch

    from depth_correction_tpu_torch.ops.cellwin import graph_to_device

    pts, g = synthetic_graph()
    log("synthetic graph: %d rows -> %d row tiles, %d point tiles, ns_f %d, ns_b %d, "
        "%d exception rows" % (g.n_rows, g.n_row_tiles, g.n_pt_tiles, g.ns_f, g.ns_b, g.n_exc))
    dev = graph_to_device(g, DEVICE)
    pts_sorted = torch.as_tensor(pts, dtype=torch.float32, device=DEVICE)[dev.perm].contiguous()
    compare_kernels(pts_sorted, dev, seed=1, label="synthetic")


def bench_config():
    """bench.py:bench_config(uncapped=True), grid establishment."""
    from depth_correction_tpu_torch.scripts import bench_config as config

    return config(DEVICE, STEPS)


def train_logged(cfg, callbacks=None, train_data=None, train_datasets=None):
    """train() with ``cfg.log_dir`` in a temporary directory.

    :return: (the best model train() saved, the history rows of its
        train_history.csv as {column: value}; step times from its step_ms
        column).
    """
    import shutil
    import tempfile

    from depth_correction_tpu_torch.models import load_model
    from depth_correction_tpu_torch.train import train

    root = tempfile.mkdtemp(prefix="dc_train_")
    try:
        cfg.log_dir = os.path.join(root, "log")
        best = train(cfg, callbacks=callbacks, train_data=train_data,
                     train_datasets=train_datasets)
        if best is None:
            raise RuntimeError("train() saved no best model")
        with open(os.path.join(cfg.log_dir, "train_history.csv")) as f:
            header = f.readline().split()
            rows = [dict(zip(header, map(float, line.split()))) for line in f]
        if header != ["iter", "train_loss", "val_loss", "step_ms"] or len(rows) != cfg.n_opt_iters:
            raise RuntimeError("train_history.csv has %s and %d rows" % (header, len(rows)))
        return load_model(cfg=best), rows
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_slice(card: str):
    import math

    import torch

    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.scripts.exp_cellwin_knockout import points_at_w0
    from depth_correction_tpu_torch.train import (
        TrainCallbacks, make_loss_fn, make_optimizer, prepare_sequences,
    )

    cfg = bench_config()

    class Record(TrainCallbacks):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.w, self.loss = {}, {}

        def train_loss(self, it, model, pose_deltas, loss):
            self.w[it] = float(model.w.detach()[0])
            self.loss[it] = float(loss.detach())

    # The main path: datasets -> prep -> train(); counts from this run only.
    # The scans are loaded once (load_sequence) and kept for phases 9 and 12,
    # which train on the same scene; prep_s counts their load.
    reset_all_launch_counts()
    t0 = time.perf_counter()
    seq = load_sequence(cfg)
    data = prepare_sequences([seq], cfg)
    prep_s = time.perf_counter() - t0
    grid_launches, knn_launches = _kernels.GRID_LAUNCHES, _kernels.KNN_LAUNCHES
    gather_launches = _kernels.GATHER_LAUNCHES
    notes = {"global_neighbors": " (scipy's cKDTree on an H100: 26 s)",
             "local_features": " (with the eager brute count before X3: %.3f s)"
                               % EAGER_LOCAL_FEATURES_S}
    for part, s in data.prep_seconds.items():
        log("prep %s: %.3f s%s" % (part, s, notes.get(part, "")))
    log("prep total: %.3f s (nn_backend %r; launches in prep X2 %d, X3 %d, P7 %d)"
        % (prep_s, cfg.nn_backend, grid_launches, knn_launches, gather_launches))
    if grid_launches <= 0:
        raise RuntimeError("X2 was not launched by the grid establishment of the prep")
    if knn_launches <= 0:
        raise RuntimeError("X3 was not launched by the per-scan K sizing of the prep")
    graph = data.cellwin[0]
    if graph is None:
        raise RuntimeError("the cellwin build declined: the slice would not run the kernels")
    rec = Record(cfg)
    trained, history = train_logged(cfg, callbacks=rec, train_data=data)
    check_transposes("slice (exception rows)", cfg, data, STEPS)
    launches = {"fwd": cw.FWD_LAUNCHES, "bwd": cw.BWD_LAUNCHES, "grid": grid_launches,
                "knn": knn_launches, "gather_prep": gather_launches}
    log("main path launches: K1 %d, K2 %d, X2 %d" % (launches["fwd"], launches["bwd"],
                                                   launches["grid"]))
    if launches["fwd"] <= 0 or launches["bwd"] <= 0:
        raise RuntimeError("a kernel of the path was not launched: %s" % launches)
    losses = [h["train_loss"] for h in history]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError("non-finite loss: %s" % losses)
    step_ms = statistics.median(h["step_ms"] for h in history[1:])
    log("slice: %d points, %d rows -> %d row tiles x %d, %d point tiles, %d exception rows"
        % (data.batches[0].cloud.depth.numel(), int((graph.row_map >= 0).sum()),
           graph.f_start.shape[0], graph.q_est.shape[1] // graph.f_start.shape[0],
           graph.b_start.shape[0], graph.n_exc))
    log("losses: %s" % ", ".join("%.9e" % v for v in losses))
    log("w: %s" % ", ".join("%.6e" % rec.w[i] for i in sorted(rec.w)))

    # float64 plain reference on the same graph: loss at w=0 and 6 Adam steps.
    data64 = data.to(dtype=torch.float64)
    loss_plain = make_loss_fn(cfg, plain=True)
    ref = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=torch.float64, device=DEVICE)
    opt = make_optimizer(cfg, [ref.w])
    ref_losses = []
    for _ in range(6):
        opt.zero_grad()
        value = loss_plain(ref, data64)
        value.backward()
        ref_losses.append(float(value.detach()))
        opt.step()
    w6_ref = float(ref.w.detach()[0])
    loss_rel = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
    w_rel = abs(rec.w[6] - w6_ref) / max(abs(w6_ref), 1e-30)
    log("loss at w=0: kernels %.9e vs float64 plain %.9e (rel %.3e)"
        % (losses[0], ref_losses[0], loss_rel))
    log("w after 6 steps: kernels %.6e vs float64 plain %.6e (rel %.3e)"
        % (rec.w[6], w6_ref, w_rel))
    if not loss_rel <= LOSS_REL_BAR:
        raise RuntimeError("loss at w=0 misses the 1e-5 bar: %.3e" % loss_rel)

    profile = profile_steps(cfg, data, card)

    # Kernels at the slice's own shapes, on the step's inputs at w=0.
    ps = points_at_w0(data, graph, DEVICE)
    with torch.no_grad():
        k = compare_kernels(ps, graph, seed=2, label="slice", card=card)
    return {
        "launches": launches, "kernels": k, "step_ms": step_ms, "prep_s": prep_s,
        "loss_rel": loss_rel, "w_rel": w_rel, "profile": profile,
        "graph": graph, "ps": ps, "data": data, "cfg": cfg,
        "seq": seq, "model": trained, "losses": [rec.loss[i] for i in sorted(rec.loss)],
        "w": [rec.w[i] for i in sorted(rec.w)],
    }



def profile_steps(cfg, data, card: str, n: int = 3):
    """Where a step's time goes: ``n`` training steps under torch.profiler."""
    from depth_correction_tpu_torch.models import load_model
    from depth_correction_tpu_torch.train import make_loss_fn, make_optimizer

    model = load_model(cfg=cfg)
    loss_fn = make_loss_fn(cfg)
    opt = make_optimizer(cfg, [model.w])

    def step():
        opt.zero_grad()
        loss_fn(model, data).backward()
        opt.step()

    return profile_calls(step, card, "step", n)


def is_annotation(e) -> bool:
    """Whether a profiler event is a user annotation (a ``record_function``
    span such as ``Optimizer.step#Adam.step``, recorded on the device's
    timeline beside the kernels it encloses) rather than a kernel, memcpy
    or memset: ``is_user_annotation`` where the installed torch has it,
    else by its key."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None:
        return bool(flag)
    return "#" in e.key or e.key.startswith(("ProfilerStep", "Optimizer."))


def profile_calls(fn, card: str, unit: str, n: int = 3):
    """``n`` calls of ``fn`` under torch.profiler, after one warm call:
    wall ms per call, device-busy ms per call (sum of the durations of
    kernels, memcpys and memsets; user annotations, which enclose kernels
    already counted, left out, and the count with them printed beside),
    device kernels per call and the kernels that take the most device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n

    # Kernels (and copies) only: the CPU-side ops that launched them report
    # the same device time again, and so do the annotations' device spans.
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    events = [e for e in device if not is_annotation(e)]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    kernels = sum(e.count for e in events) / n
    old_ms = sum(e.self_device_time_total for e in device) / 1e3 / n
    log("profile: %.3f ms/%s wall, %.3f ms/%s device busy (%.1f%%), %.0f device "
        "kernels/%s (%s)" % (wall_ms, unit, busy_ms, unit, 100.0 * busy_ms / wall_ms,
                             kernels, unit, card))
    log("  annotations left out of the busy time: %s; the count with them %.3f ms/%s and "
        "%.0f events/%s overstated it by %.3f ms (%.1f%%)"
        % (", ".join("%s x%d" % (e.key, e.count // n) for e in device if is_annotation(e))
           or "none", old_ms, unit, sum(e.count for e in device) / n, unit, old_ms - busy_ms,
           100.0 * (old_ms - busy_ms) / max(busy_ms, 1e-12)))
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log("  %-60s %9.3f ms/%s  x%d" % (e.key[:60], e.self_device_time_total / 1e3 / n,
                                          unit, e.count // n))
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "kernels_per_call": kernels,
            "busy_ms_with_annotations": old_ms, "names": sorted(e.key for e in events)}


def node_config(backend):
    """bench.py:build_node_scan's configuration: bench_config(True) with
    the node's engine (None routes by scan size)."""
    cfg = bench_config()
    cfg.nn_backend = backend
    return cfg


def node_scan(name: str):
    """A raw scan as the node receives it (bench.py:build_node_scan)."""
    from depth_correction_tpu_torch.datasets.synthetic import OpenBoxDataset

    return OpenBoxDataset(name=name).local_cloud(0)


def drive_node(scan, cfg, card: str, label: str, batches: int, reps: int, e2e_reps: int):
    """The node's main path on the card: DepthCorrector.process (structured
    scan in, numpy out) and correct_cloud on a device-resident cloud; the
    launch counts of that run; per-scan times; the outputs against the
    port's plain float64 node path on the same kept points."""
    import copy

    import numpy as np
    import torch

    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.node import DepthCorrector, correct_cloud
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.preproc import pad_size

    model = ScaledPolynomial(w=[-0.002], exponent=[4.0], dtype=torch.float32, device=DEVICE)
    node = DepthCorrector(cfg, model=model)
    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=DEVICE)
    cloud = cloud.pad(pad_size(cloud.size))

    # The main path; counts from this run only.
    reset_all_launch_counts()
    out = node.process(scan)
    outs = correct_cloud(model, cloud, cfg)
    torch.cuda.synchronize()
    launches = {"slab": _kernels.SLAB_LAUNCHES, "gather": _kernels.GATHER_LAUNCHES,
                "grid": _kernels.GRID_LAUNCHES, "knn": _kernels.KNN_LAUNCHES}
    kept = int(outs[4].sum())
    log("%s: %d raw points, padded %d, %d kept, %d corrected; launches X1 %d, P7 %d, X2 %d, "
        "X3 %d" % (label, len(scan), cloud.size, kept, int(outs[3].sum()), launches["slab"],
                   launches["gather"], launches["grid"], launches["knn"]))
    if len(out) != kept or not all(np.isfinite(out[f]).all() for f in out.dtype.names):
        raise RuntimeError("%s: DepthCorrector output malformed (%d rows, %d kept)"
                           % (label, len(out), kept))
    for x in outs[:3]:
        if not bool(torch.isfinite(x[outs[4]]).all()):
            raise RuntimeError("%s: non-finite corrected output" % label)

    # Float64 plain reference on the same kept points (the voxel filter draws
    # its ranks in the cloud's float type, so the reference takes the kept
    # mask of the float32 run and skips the filter).
    cfg64 = copy.deepcopy(cfg)
    cfg64.grid_res = 0.0
    cloud64 = Cloud.from_structured_array(scan, dtype=torch.float64, device=DEVICE)
    cloud64 = cloud64.pad(cloud.size).replace(valid=outs[4])
    model64 = ScaledPolynomial(w=[-0.002], exponent=[4.0], dtype=torch.float64, device=DEVICE)
    ref = correct_cloud(model64, cloud64, cfg64, plain=True)
    both = outs[3] & ref[3]
    pts_err = float((outs[0].double() - ref[0])[both].abs().max())
    log("%s vs float64 plain node: kept %d / %d, corrected %d / %d, mask differs on %d rows, "
        "points max abs %.3e m on %d rows corrected in both"
        % (label, kept, int(ref[4].sum()), int(outs[3].sum()), int(ref[3].sum()),
           int((outs[3] != ref[3]).sum()), pts_err, int(both.sum())))
    # The plain path in float32 on the same rows: the masks that float32
    # rounding flips without any kernel.
    ref32 = correct_cloud(model, cloud.replace(valid=outs[4]), cfg64, plain=True)
    log("%s: float32 plain node corrects %d; its mask differs from float64 plain on %d rows, "
        "from the kernels' on %d" % (label, int(ref32[3].sum()), int((ref32[3] != ref[3]).sum()),
                                    int((ref32[3] != outs[3]).sum())))
    if not pts_err <= POINTS_ABS_BAR:
        raise RuntimeError("%s: corrected points miss the %.0e m bar: %.3e"
                           % (label, POINTS_ABS_BAR, pts_err))

    # node_ms: chained calls on device-resident inputs, ending in a sync.
    batch_ms = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(reps):
            outs = correct_cloud(model, cloud, cfg)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3 / reps)
    e2e = []
    for _ in range(e2e_reps):
        t0 = time.perf_counter()
        node.process(scan)
        e2e.append((time.perf_counter() - t0) * 1e3)
    res = {"launches": launches, "points": kept, "ms": statistics.median(batch_ms),
           "e2e_ms": statistics.median(e2e), "pts_err": pts_err, "outs": outs}
    log("%s: node_ms %.3f (median of %d batches of %d chained calls: %s), node_e2e_ms %.3f "
        "(median of %d, %.3f-%.3f), node_points %d (%s)"
        % (label, res["ms"], batches, reps, ", ".join("%.3f" % t for t in batch_ms),
           res["e2e_ms"], e2e_reps, min(e2e), max(e2e), kept, card))
    res["profile"] = profile_calls(lambda: correct_cloud(model, cloud, cfg), card, "scan")
    return res


def phase_node(card: str):
    import torch

    from depth_correction_tpu_torch.node import NODE_N_CELLS_PAD, _slab_layout
    from depth_correction_tpu_torch.ops import slabwin
    from depth_correction_tpu_torch.scripts import slab_cull

    cfg = node_config("slab")
    t0 = time.perf_counter()
    scan = node_scan(NODE_SCENE)
    log("node scan %s: %d points (%.1f s)" % (NODE_SCENE, len(scan), time.perf_counter() - t0))
    res = drive_node(scan, cfg, card, "node", batches=3, reps=NODE_REPS, e2e_reps=E2E_REPS)
    if res["launches"]["slab"] <= 0:
        raise RuntimeError("X1 was not launched on the node's main path: %s" % res["launches"])

    # X1 on the node's own sorted inputs, against the float64 plain version.
    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.preproc import pad_size

    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=DEVICE)
    cloud = cloud.pad(pad_size(cloud.size))
    keep = res["outs"][4]
    pts_T, valid, ids, _, dims = _slab_layout(cloud.to_points(), keep, cfg.nn_r)
    lo, width, ctr, has = slabwin.slab_tile_spans(pts_T, valid, ids, dims, NODE_N_CELLS_PAD)
    r2 = float(cfg.nn_r) ** 2
    out = slabwin.slab_window_kernel(pts_T, valid, lo, width, ctr, r2)
    torch.cuda.synchronize()
    ref = slabwin.slab_window_moments_plain(pts_T.double(), valid, lo, width, ctr.double(), r2)
    d = (out.double() - ref)[:, valid].abs()
    err = (float(d[0:3].max()), float(d[3:9].max()))
    log("X1 vs plain float64 (%d slots, %d tiles, %d live, widest span %d): mean max abs "
        "%.3e m, comps max abs %.3e m^2" % (pts_T.shape[1], lo.shape[0], int(has.sum()),
                                          int(width.max()), err[0], err[1]))
    if not (err[0] <= MEAN_ABS_BAR and err[1] <= COMPS_ABS_BAR):
        raise RuntimeError("X1 misses its bars vs float64: %s" % (err,))
    res["x1_err"] = max(err)
    # The pair tests the warps' cull keeps (host model, scripts/slab_cull.py).
    kept, all_pairs, box = slab_cull.cull_pair_tests(pts_T, valid, lo, width, ctr, r2)
    log("X1 host model: %d of %d pair tests kept (%.4f), %d box tests"
        % (kept, all_pairs, kept / all_pairs, box))
    # Bound: the pair tests the cull keeps and its box tests (PAIR_OPS and
    # BOX_OPS float ops), ~19 per member, an epilogue per row; all pairs:
    # every row of a live tile tests every slot of its three spans. Bytes:
    # positions, validity, span tables and centres read once, (10, n)
    # written once.
    n, t = pts_T.shape[1], lo.shape[0]
    members = float(out[9][valid].sum())
    x1_bytes = n * (12 + 1 + 40) + t * 36
    res["x1_bound"] = bound(x1_bytes, {"fp32": PAIR_OPS * kept + BOX_OPS * box
                                       + 19 * members + 30 * n})
    res["x1_bound_all_pairs"] = bound(x1_bytes, {"fp32": PAIR_OPS * all_pairs + 19 * members
                                                 + 30 * n})
    res["x1_ms"] = cuda_ms(lambda: slabwin.slab_window_kernel(pts_T, valid, lo, width, ctr, r2),
                           reps=50)
    res["x1_kept"] = (kept, all_pairs, box)
    res["x1_plain_ms"] = cuda_ms(
        lambda: slabwin.slab_window_moments_plain(pts_T, valid, lo, width, ctr, r2), reps=3)
    log("X1 timing (float32, node shapes): kernel %.4f ms, plain %.4f ms; bound %.4f ms (%s; "
        "all pairs %.4f) (%s)"
        % (res["x1_ms"], res["x1_plain_ms"], res["x1_bound"][0], res["x1_bound"][1],
           res["x1_bound_all_pairs"][0], card))
    res["scan"] = scan
    return res


def phase_small(card: str):
    import numpy as np
    import torch

    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.ops import features
    from depth_correction_tpu_torch.ops.grid_hash import GRID_NN_MIN_POINTS
    from depth_correction_tpu_torch.ops.knn import radius_neighbors
    from depth_correction_tpu_torch.preproc import pad_size

    cfg = node_config(None)  # routed by size
    scan = node_scan(SMALL_SCENE)
    if pad_size(len(scan)) >= GRID_NN_MIN_POINTS:
        raise RuntimeError("the small scan would not route to the brute engine")
    res = drive_node(scan, cfg, card, "small", batches=3, reps=NODE_REPS, e2e_reps=E2E_REPS)
    if res["launches"]["gather"] <= 0 or res["launches"]["knn"] <= 0:
        raise RuntimeError("X3 / P7 were not launched on the brute engine: %s"
                           % res["launches"])
    log("small scan (brute engine): node_ms %.3f, node_e2e_ms %.3f; with the eager search "
        "before X3 node_ms was %.3f (%s)" % (res["ms"], res["e2e_ms"], EAGER_BRUTE_NODE_MS,
                                             card))

    # P7 on the node's own neighbour table, against the float64 plain version.
    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=DEVICE)
    cloud = cloud.pad(pad_size(cloud.size))
    keep = res["outs"][4]
    points = cloud.to_points()
    res["x3"] = check_knn("small scan", points, keep, float(cfg.nn_r), 32, card)
    _, nn = radius_neighbors(points, points, r=cfg.nn_r, k=32, valid_points=keep,
                             valid_query=keep)
    w = (nn >= 0).float()
    got = features.gather_moments(points, nn, w)
    torch.cuda.synchronize()
    ref = features.gather_moments_plain(points.double(), nn, w.double())
    err = (float((got[0].double() - ref[0])[:, keep].abs().max()),
           float((got[1].double() - ref[1])[:, keep].abs().max()))
    log("P7 vs plain float64 (node table %d x %d, %d kept rows): mean max abs %.3e m, comps "
        "max abs %.3e m^2" % (nn.shape[0], nn.shape[1], int(keep.sum()), err[0], err[1]))
    if not (err[0] <= MEAN_ABS_BAR and err[1] <= COMPS_ABS_BAR):
        raise RuntimeError("P7 misses its bars vs float64 on the node's table: %s" % (err,))
    res["p7_err"] = max(err)
    node_ms = cuda_ms(lambda: features.gather_moments(points, nn, w), reps=50)
    node_plain_ms = cuda_ms(lambda: features.gather_moments_plain(points, nn, w), reps=5)
    log("P7 timing (float32, node table): kernel %.4f ms vs plain %.4f ms (%s)"
        % (node_ms, node_plain_ms, card))
    res["p7_node"] = p7_timing("small scan's node table", points, nn, w, card, reps=50)
    res["native_inputs"] = points, keep, float(cfg.nn_r)  # phase 14's native KD-tree

    # The probe's stage-2 shapes (scripts/exp_pallas_gather.py:75-81).
    rng = np.random.default_rng(0)
    m, mq, k = 390144, 223744, 32
    pts = torch.as_tensor(rng.normal(size=(3, m)), dtype=torch.float32, device=DEVICE)
    idx = torch.as_tensor(rng.integers(0, m, (mq, k)), dtype=torch.int32, device=DEVICE)
    wp = torch.as_tensor(rng.random((mq, k)) > 0.1, dtype=torch.float32, device=DEVICE)
    got = features.gather_moments(pts, idx, wp)
    ref = features.gather_moments_plain(pts.T.double(), idx, wp.double())
    rel = max(float((g.double() - r).abs().max()) / float(r.abs().max())
              for g, r in zip(got, ref))
    log("P7 vs plain float64 at the probe's shapes (M %d, MQ %d, K %d): max error %.3e of "
        "max |output|" % (m, mq, k, rel))
    if not rel <= PROBE_REL_BAR:
        raise RuntimeError("P7 misses the %.0e relative bar at the probe's shapes: %.3e"
                           % (PROBE_REL_BAR, rel))
    res["p7_ms"] = cuda_ms(lambda: features.gather_moments(pts, idx, wp), reps=20)
    res["p7_bound"] = p7_bound(m, mq, k)
    pts_n3 = pts.T.contiguous()
    res["p7_plain_ms"] = cuda_ms(lambda: features.gather_moments_plain(pts_n3, idx, wp), reps=3)
    log("P7 timing (float32, probe shapes): kernel %.4f ms vs plain %.4f ms (%s)"
        % (res["p7_ms"], res["p7_plain_ms"], card))
    return res


def kernels_by_name(fn, reps: int = 10) -> dict:
    """{kernel name: device ms per call} of ``fn``'s kernels (torch.profiler,
    after one warm call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def check_knn(label: str, points, valid, r: float, k: int, card: str,
              every_row: bool = False) -> dict:
    """X3 on ``points`` querying themselves (``valid`` marks the points; the
    top-k's queries are the valid rows, or every row with ``every_row``, as
    the shadow filter's radius_neighbors call passes no valid_query; the
    counts' are every row), called as the path calls it, against its plain
    twin on the card, in both modes: the top-k within r (index tables
    equal, d2 bit for bit) and the counts (equal). Timed, the search
    kernel's own time apart from the ordering's (profiler), and two bounds:
    every pair test and the pair and box tests the cull keeps, counted by
    the host model scripts/knn_cull.py on these inputs (the kernel counts
    nothing). Raises on a missed bar."""
    import torch

    from depth_correction_tpu_torch.ops import knn
    from depth_correction_tpu_torch.scripts import knn_cull

    q_valid = None if every_row else valid
    args = (points, points, k, r, valid, q_valid)
    d2, idx = knn.knn_d2(*args)
    counts = knn.neighbor_counts(points, points, r, valid)
    torch.cuda.synchronize()
    pd2, pidx = knn.knn_d2(*args, plain=True)
    pcounts = knn.neighbor_counts(points, points, r, valid, plain=True)
    same = (bool(torch.equal(idx, pidx)), bit_equal(d2, pd2), bool(torch.equal(counts, pcounts)))
    n, nv = points.shape[0], int(valid.sum())
    held = int((idx >= 0).sum())
    log("X3 %s: %d points (%d valid), k %d, r %g (largest count %d, %d pairs held); against "
        "the plain twin: index tables equal %s, d2 bit-equal %s, counts equal %s"
        % (label, n, nv, k, r, int(counts.max()), held, *same))
    if not all(same):
        raise RuntimeError("X3 %s misses its bars against the plain twin" % label)
    t0 = time.perf_counter()
    cull = {"topk": knn_cull.cull_stats(points, valid, r, k, q_valid=q_valid),
            "counts": knn_cull.cull_stats(points, valid, r, 0)}
    for mode, st in cull.items():
        log("  cull (host model, %s, %.1f s): %d of %d pair tests kept (%.4f), %d of %d tiles "
            "loaded, %d box tests, the most pair tests of one warp %d, members %d%s"
            % (mode, time.perf_counter() - t0, st["kept_pairs"], st["all_pairs"],
               st["pair_share"], st["tiles_loaded"], st["blocks"] * st["tiles"],
               st["box_tests"], st["max_block_pairs"], st["members"],
               ", list insertions %d (most %d a query)" % (st["insertions"],
                                                           st["max_insertions"])
               if "insertions" in st else ""))
    members = (int(counts.sum() if every_row else counts[valid].sum()), int(counts.sum()))
    if (cull["topk"]["members"], cull["counts"]["members"]) != members:
        raise RuntimeError("X3 %s: the host model's members (%d, %d) differ from the kernel's "
                           "counts (%d, %d)" % (label, cull["topk"]["members"],
                                                cull["counts"]["members"], *members))
    res = {"err": 0.0, "k": k, "largest_count": int(counts.max()), "cull": cull}
    res["ms"] = cuda_ms(lambda: knn.knn_d2(*args), reps=20)
    res["counts_ms"] = cuda_ms(lambda: knn.neighbor_counts(points, points, r, valid), reps=20)
    for mode, fn in (("", lambda: knn.knn_d2(*args)),
                     ("counts_", lambda: knn.neighbor_counts(points, points, r, valid))):
        names = kernels_by_name(fn)
        res[mode + "tiles_ms"] = sum(v for n_, v in names.items() if "knn_tiles_kernel" in n_)
        res[mode + "order_ms"] = sum(names.values()) - res[mode + "tiles_ms"]
    res["plain_ms"] = cuda_ms(lambda: knn.knn_d2(*args, plain=True), reps=1, warmup=1)
    res["counts_plain_ms"] = cuda_ms(lambda: knn.neighbor_counts(points, points, r, valid,
                                                                 plain=True), reps=1, warmup=1)
    # Bounds: 8 float ops per pair test (without FMA, 8 instructions); the
    # top-k's queries are the valid rows (every row with ``every_row``), the
    # counts' every row. All pairs:
    # every query against every valid point. Kept: the pair tests and box
    # tests (BOX_OPS each) the cull leaves, from the host model. Queries
    # and points (12 bytes and a validity byte each) read once, the (Q, k)
    # tables or (Q,) counts written once.
    topk_bytes, counts_bytes = n * 26 + n * k * 8, n * 13 + n * 13 + n * 4
    res["bound_all_pairs"] = bound(topk_bytes, {"fp32": PAIR_OPS * (n if every_row else nv)
                                                * nv})
    res["counts_bound_all_pairs"] = bound(counts_bytes, {"fp32": PAIR_OPS * n * nv})
    res["bound"] = bound(topk_bytes, {"fp32": PAIR_OPS * cull["topk"]["kept_pairs"]
                                      + BOX_OPS * cull["topk"]["box_tests"]})
    res["counts_bound"] = bound(counts_bytes, {"fp32": PAIR_OPS * cull["counts"]["kept_pairs"]
                                               + BOX_OPS * cull["counts"]["box_tests"]})
    log("X3 %s timing (float32): top-%d %.4f ms (search kernel %.4f, ordering and packing "
        "%.4f; plain %.4f; bound %.4f kept pairs, %.4f all pairs), counts %.4f ms (search "
        "kernel %.4f, ordering and packing %.4f; plain %.4f; bound %.4f kept pairs, %.4f all "
        "pairs) (%s)"
        % (label, k, res["ms"], res["tiles_ms"], res["order_ms"], res["plain_ms"],
           res["bound"][0], res["bound_all_pairs"][0], res["counts_ms"], res["counts_tiles_ms"],
           res["counts_order_ms"], res["counts_plain_ms"], res["counts_bound"][0],
           res["counts_bound_all_pairs"][0], card))
    return res


def x3_summary(res: dict) -> dict:
    """X3's numbers on one input for the kernels line."""
    return {"k": res["k"], "largest_count": res["largest_count"], "ms": res["ms"],
            "search_kernel_ms": res["tiles_ms"],
            "order_ms": res["order_ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound"][0], "bound_all_pairs_ms": res["bound_all_pairs"][0],
            "counts_ms": res["counts_ms"],
            "counts_search_kernel_ms": res["counts_tiles_ms"],
            "counts_plain_ms": res["counts_plain_ms"],
            "counts_bound_ms": res["counts_bound"][0],
            "counts_bound_all_pairs_ms": res["counts_bound_all_pairs"][0],
            "pair_share": res["cull"]["topk"]["pair_share"],
            "counts_pair_share": res["cull"]["counts"]["pair_share"],
            "insertions": res["cull"]["topk"].get("insertions")}


def _window_bound(win, q, kw, passes: int) -> tuple:
    """Bound of one moment_window call (P3-P5) from its inputs: the span
    columns the spans need (features, 10 x 128 TF32 products per pass over
    the non-zero feature rows, and ~8 float ops per membership test), the
    window columns read once (the union of the spans' columns of a staged
    table), q, the tables and the (16, 128 T1) output."""
    import torch

    from depth_correction_tpu_torch.ops.moment_window import span_bounds

    t1, ns, s_len = kw["n_tiles"], kw["ns"], kw["s_len"]
    lo, hi = span_bounds(kw["lens"], kw.get("leads"), s_len, t1, ns)
    cols = int((hi - lo).clamp(min=0).sum())
    if "starts" in kw:
        col = torch.arange(s_len, device=lo.device)
        pos = kw["starts"].long()[..., None] + col
        read = ((col >= lo[..., None]) & (col < hi[..., None]) & (pos >= 0)
                & (pos < win.shape[1]))
        cols = int(read.sum())
        win_bytes = int(torch.unique(pos[read]).numel()) * 6 * 4
    else:
        win_bytes = ns * 6 * s_len * 4
    tables = sum(kw[k].numel() * 4 for k in ("lens", "starts", "leads", "ctr")
                 if isinstance(kw.get(k), torch.Tensor))
    nbytes = win_bytes + 3 * q.shape[1] * 4 + tables + 16 * 128 * t1 * 4
    ops = {"fp32": 8 * 128 * cols + 12 * cols}
    if passes:
        ops["tf32"] = passes * 2 * 10 * 128 * cols
    else:
        ops["fp32"] += 2 * 10 * 128 * cols
    return bound(nbytes, ops)


def phase_probes(card: str, graph, ps, kept: tuple):
    """The probe scripts P1-P5 on the card; each script's launches are
    counted alone. ``kept`` is K1's (kept pair tests, all pair tests, box
    tests) on ``graph`` (:func:`pairs_kept`), for P1's bound. Returns the
    kernels-line entries of P1-P5 and the slice table's pair tests and
    members (P1's counts)."""
    import torch

    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.ops.cellwin_knockout import cellwin_knockout_plain
    from depth_correction_tpu_torch.ops.moment_dot import moment_dot, moment_dot_plain
    from depth_correction_tpu_torch.ops.moment_window import moment_window, moment_window_plain
    from depth_correction_tpu_torch.scripts import (
        exp_cellwin_knockout as p1, exp_mosaic_dot_probe as p2, exp_mosaic_dot_probe2 as p3,
        exp_mosaic_dot_probe3 as p4, exp_mosaic_dot_probe4 as p5,
    )

    failures = []

    def bar(ok: bool, what: str):
        if not ok:
            failures.append(what)

    # P1 on the slice's own table (the w = 0 positions of phase 3).
    r1, n1 = counted(lambda: p1.run(ps, graph), "KNOCKOUT_LAUNCHES")
    args = (graph.q_est, graph.est_sorted, graph.f_start, graph.f_len, graph.f_ctr, graph.r2)
    k1 = cw.cellwin_fwd(ps, *args)
    same = bit_equal(k1, r1["modes"]["full"]["out"])
    same_nc = bit_equal(k1, r1["modes"]["no_cull"]["out"])
    log("P1 on the slice's table: %d row tiles x %d, %d rows held, %d pair tests, %d members; "
        "full bit-equal to K1: %s, no_cull bit-equal to K1: %s"
        % (r1["t1"], r1["row_cap"], r1["rows"], r1["pairs"], r1["members"], same, same_nc))
    bar(same, "P1 full is not bit-equal to K1")
    bar(same_nc, "P1 no_cull is not bit-equal to K1")
    full_ms = r1["modes"]["full"]["ms"]
    for mode, e in r1["modes"].items():
        er = e["errors"]
        log("  P1 %-9s %9.4f ms  %5.0f%% of full; kernel alone %9.4f ms  %5.0f%%  %s"
            % (mode, e["ms"], 100.0 * e["ms"] / full_ms, e["kernel_ms"],
               100.0 * e["kernel_ms"] / r1["modes"]["full"]["kernel_ms"],
               ", ".join("%s %.3e" % kv for kv in sorted(er.items()))))
        bar(er["count"] == 0, "P1 %s member counts differ" % mode)
        if mode in ("full", "no_cull"):
            bar(er["mean_abs"] <= MEAN_ABS_BAR and er["comps_abs"] <= COMPS_ABS_BAR,
                "P1 full misses K1's bars: %s" % er)
        else:
            bar(er["rel"] <= PROBE_REL_BAR, "P1 %s misses %.0e: %s" % (mode, PROBE_REL_BAR, er))
    plain1 = cuda_ms(lambda: cellwin_knockout_plain(ps, *args, "full"), reps=1, warmup=1)
    full = r1["modes"]["full"]["errors"]
    entries = [{
        "name": "cellwin_knockout (P1)", "route": "cuda",
        "source": "depth_correction_tpu_torch/csrc/cellwin_knockout.cu",
        "replaces": "scripts/exp_cellwin_knockout.py:35", "launches": n1,
        "max_abs_err": max(full["mean_abs"], full["comps_abs"]),
        "ms": r1["modes"]["full"]["ms"], "plain_ms": plain1,
        "bound": cellwin_fwd_bound(graph, kept[0], r1["members"], kept[2]),
        "bound_all_pairs_ms": cellwin_fwd_bound(graph, r1["pairs"], r1["members"])[0],
        "library_ms": None, "variants": {m: e["ms"] for m, e in r1["modes"].items()}}]

    # P2 at the TPU script's shapes, with torch.bmm beside it.
    dev = torch.device(DEVICE)
    r2, n2 = counted(lambda: p2.run(dev, library=True), "DOT_LAUNCHES")
    for v, e in r2["variants"].items():
        log("  P2 %-7s %9.4f ms  oracle %.3e, plain f32 %.3e, f64 %.3e"
            % (v, e["ms"], e["oracle"], e["err32"], e["err64"]))
        bar(e["err32"] <= PROBE_REL_BAR, "P2 %s misses %.0e vs its plain version: %.3e"
            % (v, PROBE_REL_BAR, e["err32"]))
        if v in ("fp32", "tf32x3"):
            bar(e["oracle"] <= PROBE_REL_BAR, "P2 %s misses %.0e vs the oracle: %.3e"
                % (v, PROBE_REL_BAR, e["oracle"]))
    lib = r2["library"]
    log("  P2 torch.bmm (one call, the same %d products): fp32 %.4f ms, TF32 allowed %.4f ms; "
        "allow_tf32 back to %s" % (p2.T1, lib["fp32"], lib["tf32"],
                                   torch.backends.cuda.matmul.allow_tf32))
    a, b, _ = p2.inputs(dev)
    e = r2["variants"]["tf32x3"]
    k2 = kernel_ms(lambda: moment_dot(a, b, p2.T1, "tf32x3"), DEVICE, p2.STEPS)
    log("  P2 device time (profiler): tf32x3 %.4f ms, torch.bmm fp32 %.4f ms (%s)"
        % (k2, lib["fp32_device"], card))
    dot_bytes = a.numel() * 4 + b.numel() * 4 + e["out"].numel() * 4
    entries.append({
        "name": "moment_dot (P2)", "route": "cuda",
        "source": "depth_correction_tpu_torch/csrc/moment_dot.cu",
        "replaces": "scripts/exp_mosaic_dot_probe.py:50", "launches": n2,
        "max_abs_err": e["abs64"], "ms": e["ms"], "kernel_ms": k2,
        "plain_ms": cuda_ms(lambda: moment_dot_plain(a, b, p2.T1, "tf32x3"), reps=3, warmup=1),
        "bound": bound(dot_bytes, {"tf32": 3 * 2 * 16 * p2.NS * p2.S * p2.R * p2.T1}),
        "fp32_bound_ms": bound(dot_bytes, {"fp32": 2 * 16 * p2.NS * p2.S * p2.R * p2.T1})[0],
        "library_ms": lib["fp32"], "library_device_ms": lib["fp32_device"],
        "variants": {v: x["ms"] for v, x in r2["variants"].items()}})

    # P3-P5: the product with in-kernel operands; headline variants
    # tf32x3, E_all and J_all.
    win, q, ln = p3.inputs(dev)
    p3_kw = dict(n_tiles=p3.T1, ns=p3.NS, s_len=p3.S, lens=ln)
    cases = {
        "P3": (p3, "tf32x3", "scripts/exp_mosaic_dot_probe2.py:39",
               lambda: (win, q, p3_kw)),
        "P4": (p4, "E_all", "scripts/exp_mosaic_dot_probe3.py:133",
               lambda: p4.variant_args("E_all", p4.inputs(dev))),
        "P5": (p5, "J_all", "scripts/exp_mosaic_dot_probe4.py:66",
               lambda: p5.inputs(dev, ("J_all",))["J_all"]),
    }
    for label, (mod, head, replaces, head_args) in cases.items():
        res, n = counted(lambda: mod.run(dev), "WINDOW_LAUNCHES")
        for v, e in res["variants"].items():
            log("  %s %-18s %9.4f ms  %splain f32 %.3e, f64 %.3e"
                % (label, v, e["ms"], "oracle %.3e, " % e["oracle"] if "oracle" in e else "",
                   e["err32"], e["err64"]))
            bar(e["err32"] <= PROBE_REL_BAR, "%s %s misses %.0e vs its plain version: %.3e"
                % (label, v, PROBE_REL_BAR, e["err32"]))
            # fp32 and tf32x3 (every P4/P5 variant) are exact products of
            # float32 features: held against float64 too, except after the
            # epilogue, whose float32 division by s0 - 1 on few-member
            # columns measures float32 rounding, not the product.
            key = "oracle" if "oracle" in e else "err64"
            exact = v in ("fp32", "tf32x3") if label == "P3" else v in p4.VARIANTS[:3]
            if exact:
                bar(e[key] <= PROBE_REL_BAR, "%s %s misses %.0e vs float64: %.3e"
                    % (label, v, PROBE_REL_BAR, e[key]))
        hw, hq, hkw = head_args()
        prec = "tf32x3"
        e = res["variants"][head]
        k = kernel_ms(lambda: moment_window(hw, hq, p3.R2, prec=prec, **hkw), DEVICE, mod.STEPS)
        log("  %s device time (profiler): %s %.4f ms (%s)" % (label, head, k, card))
        entries.append({
            "name": "moment_window (%s)" % label, "route": "cuda",
            "source": "depth_correction_tpu_torch/csrc/moment_window.cu",
            "replaces": replaces, "launches": n, "max_abs_err": e["abs64"], "ms": e["ms"],
            "kernel_ms": k,
            "plain_ms": cuda_ms(lambda: moment_window_plain(hw, hq, p3.R2, prec=prec, **hkw),
                                reps=2, warmup=1),
            "bound": _window_bound(hw, hq, hkw, passes=3), "library_ms": None,
            "variants": {v: x["ms"] for v, x in res["variants"].items()}})

    log("probe table (ms per call, %s):" % card)
    log("  %-26s %10s %10s %10s  %s" % ("kernel", "ms", "plain ms", "bound ms", "variants"))
    for en in entries:
        log("  %-26s %10.4f %10.4f %10.4f  %s" % (
            en["name"], en["ms"], en["plain_ms"], en["bound"][0],
            ", ".join("%s %.4f" % kv for kv in en["variants"].items())))
    if failures:
        raise RuntimeError("probe bars missed: " + "; ".join(failures))
    return entries, (r1["pairs"], r1["members"])


def counted(fn, attr: str):
    """Run ``fn`` with the launch counts zeroed just before and read just
    after; raises if the counter ``attr`` of ops/_kernels.py stayed 0."""
    import torch

    from depth_correction_tpu_torch.ops import _kernels

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    n = getattr(_kernels, attr)
    log("  script: %d launches (%s), %.2f s" % (n, attr, time.perf_counter() - t0))
    if n <= 0:
        raise RuntimeError("%s was not launched by its probe script" % attr)
    return res, n


def reset_all_launch_counts() -> None:
    """Zero every kernel's launch count (ops/_kernels.py and K1/K2's in
    ops/cellwin.py)."""
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.ops import cellwin as cw

    _kernels.reset_launch_counts()
    cw.reset_launch_counts()



def transpose_launches() -> dict:
    """X4's and X5's launch counts since they were last zeroed."""
    from depth_correction_tpu_torch.ops import _kernels

    return {"x4": _kernels.TRANSPOSE_MOMENTS_LAUNCHES, "x5": _kernels.TRANSPOSE_GATHER_LAUNCHES}


def transposes_per_eval(cfg, data) -> dict:
    """X4 and X5 launches one loss evaluation (forward and backward) makes
    on ``data``: one X4 a gather sequence (one X5 under nn_scale), one X4
    a sequence's offset graph and one X4 a cell-window graph with
    exception rows (any rank's, under a mesh)."""
    x4 = x5 = 0
    for i in range(len(data.batches)):
        cw = data.cellwin[i] if data.cellwin else None
        if cw is None and data.transposes and data.transposes[i] is not None:
            if cfg.nn_scale is None:
                x4 += 1
            else:
                x5 += 1
        elif cw is not None and cw.n_exc:
            x4 += 1
        if data.off_transposes and data.off_transposes[i] is not None:
            x4 += 1
    return {"x4": x4, "x5": x5}


def check_transposes(label: str, cfg, data, evals: int, got: dict = None) -> dict:
    """Raises unless X4 and X5 launched ``evals`` times
    :func:`transposes_per_eval` since the counts were last zeroed (``got``:
    counts read earlier)."""
    got = transpose_launches() if got is None else {k: got[k] for k in ("x4", "x5")}
    per = transposes_per_eval(cfg, data)
    want = {k: v * evals for k, v in per.items()}
    log("%s: X4 %d, X5 %d launches (%d loss evaluations, %d X4 and %d X5 each)"
        % (label, got["x4"], got["x5"], evals, per["x4"], per["x5"]))
    if got != want:
        raise RuntimeError("%s: X4 / X5 launched %s, expected %s" % (label, got, want))
    return got


def check_no_index_backward(profile: dict, label: str) -> None:
    """Raises if a profiled step ran autograd's index backward
    (``indexing_backward_kernel``): the gather engine's backward is X4 /
    X5."""
    hits = [n for n in profile["names"] if "indexing_backward" in n]
    log("%s: profiled step %s indexing_backward_kernel" % (label, "shows" if hits else
                                                           "has no"))
    if hits:
        raise RuntimeError("%s: the profiled step ran %s" % (label, hits))


def p7_bound(n_pts: int, mq: int, k: int) -> tuple:
    """P7's bound: each index and weight read once (8 bytes a slot), each
    point once (12 bytes), (10, MQ) written once; ~22 float ops per
    (row, neighbour)."""
    return bound(mq * k * 8 + n_pts * 12 + mq * 10 * 4, {"fp32": 22 * mq * k})


def p7_timing(label: str, points, nn, w, card: str, reps: int = 20) -> dict:
    """P7 on one table timed by the profiler's kernel durations
    (``kernel_ms``) and by events (``ms``), with this shape's ``bound``."""
    from depth_correction_tpu_torch.ops import features

    def call():
        return features.gather_moments(points, nn, w)

    n_pts = points.shape[0] if points.shape[1] == 3 else points.shape[1]
    res = {"kernel_ms": kernel_ms(call, DEVICE, reps), "ms": cuda_ms(call, reps=reps),
           "bound": p7_bound(n_pts, nn.shape[0], nn.shape[1])}
    log("P7 timing (%s: N %d, MQ %d, K %d): device %.4f ms, events %.4f ms; bound %.4f ms (%s) "
        "(%s)" % (label, n_pts, nn.shape[0], nn.shape[1], res["kernel_ms"], res["ms"],
                  res["bound"][0], res["bound"][1], card))
    return res


def p7_shape(res: dict) -> dict:
    """P7's timing on one table as the kernels line carries it per shape."""
    return {"ms": res["ms"], "kernel_ms": res["kernel_ms"], "bound_ms": res["bound"][0],
            "bound_by": res["bound"][1]}


def _f32_ulps(a, b) -> int:
    """Largest distance in float32 ulps between finite a and b."""
    import torch

    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def x2_query(points, valid, r: float, k: int, grid):
    """X2 on ``points`` (every row queries, in the grid's slot order) over
    the sorted ``grid`` (the first 7 fields of grid_hash._build_grid's):
    a call of it, as the path makes it, at ``k`` (0: the counts)."""
    import torch

    from depth_correction_tpu_torch.ops import grid_hash as gh

    pts_T, val_s, ids_s, order, mins, dims, cell = grid
    r2 = torch.full((), r, dtype=torch.float32) ** 2
    return lambda: gh.grid_query(points, valid, pts_T, val_s, ids_s, order, mins, dims, r2, k,
                                 None, cell, own_points=True)


def check_grid_query(label: str, points, valid, r: float, card: str) -> dict:
    """X2 on ``points`` (all rows query) against its plain twin on the card:
    top-k (k = the prep's suggest_k_max) and counts, both timed; its bound
    from the runs it reads. Raises on a missed bar."""
    import torch

    from depth_correction_tpu_torch.ops import grid_hash as gh
    from depth_correction_tpu_torch.ops.knn import suggest_k_max

    k = suggest_k_max(points, r=r, valid_points=valid)
    grid, _ = gh._build_grid(points, valid, r, None, None)
    (pts_T, val_s, ids_s, order, mins, dims, cell, _) = grid
    r2 = torch.full((), r, dtype=torch.float32) ** 2
    args = (points, valid, pts_T, val_s, ids_s, order, mins, dims, r2)
    topk, count = x2_query(points, valid, r, k, grid[:7]), x2_query(points, valid, r, 0, grid[:7])
    d, idx = topk()
    counts = count()
    # The plain twin's window: the JAX query's dense table and width.
    starts, width = gh._query_window(ids_s, int(dims.prod()))
    pd, pidx = gh._grid_query_plain(*args, k, width, cell, starts)
    pcounts = gh._grid_query_plain(*args, 0, width, cell, starts)
    fin = torch.isfinite(pd)
    same_idx = bool(torch.equal(idx, pidx))
    same_fin = bool(torch.equal(fin, torch.isfinite(d)))
    ulps = _f32_ulps(d[fin], pd[fin]) if same_fin and bool(fin.any()) else -1
    same_counts = bool(torch.equal(counts, pcounts))
    err = float((d[fin] - pd[fin]).abs().max()) if same_fin else float("inf")
    # The runs X2 reads: each valid query's 9 columns, [lower_bound(lo),
    # lower_bound(hi + 1)) in the sorted ids.
    col_ok, lo, hi, _, _ = gh._query_columns(points, mins, dims, cell)
    ids64 = ids_s.long()
    runs = torch.searchsorted(ids64, hi + 1) - torch.searchsorted(ids64, lo)
    pairs = int((torch.where(col_ok, runs, 0).sum(1) * valid).sum())
    members = int(counts.sum())
    log("X2 %s: %d points (%d valid), k %d (largest count %d), window %d; kernel vs plain: "
        "index tables equal %s, finite pattern equal %s, distances within %d ulp, counts equal "
        "%s; %d pair tests, %d members"
        % (label, points.shape[0], int(valid.sum()), k, int(counts.max()), width, same_idx,
           same_fin, ulps, same_counts, pairs, members))
    if not (same_idx and same_fin and 0 <= ulps <= 1 and same_counts):
        raise RuntimeError("X2 %s misses its bars against the plain twin" % label)
    n, nq = pts_T.shape[1], points.shape[0]
    res = {"k": k, "pairs": pairs, "members": members, "err": err, "idx": idx, "counts": counts,
           "ms": cuda_ms(topk, reps=20), "counts_ms": cuda_ms(count, reps=20),
           "plain_ms": cuda_ms(lambda: gh._grid_query_plain(*args, k, width, cell, starts),
                               reps=1, warmup=1),
           # Bound: 8 float ops per pair test; queries, the sorted table
           # (positions, ids, order) and the (Q, k) outputs moved once.
           "bound": bound(nq * 13 + n * 20 + nq * k * 8, {"fp32": 8 * pairs})}
    log("X2 %s timing (float32): top-%d %.4f ms, counts %.4f ms, plain %.4f ms, bound %.4f ms "
        "(%s) (%s)" % (label, k, res["ms"], res["counts_ms"], res["plain_ms"], res["bound"][0],
                       res["bound"][1], card))
    return res


def check_grid_node_neighbors(scan, ks, card: str) -> dict:
    """X2 at the grid node's shapes: the traced grid of 2^21 cells over the
    node scan's filtered float32 points, for each k of ``ks``, against the
    plain twin on the same grid, with the launch count zeroed just before
    each kernel call, and timed on the node's grid. Raises on a missed bar
    or when no row has more than the smallest k neighbours (the kernel's
    merge then drops keys). Returns {k: {"over": rows with more than k,
    "ms"}}."""
    import numpy as np
    import torch

    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.node import NODE_N_CELLS_PAD, _filter_impl, _grid_neighbors
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.ops.grid_hash import grid_sort_traced
    from depth_correction_tpu_torch.preproc import pad_size

    cfg = node_config("grid")
    r = float(cfg.nn_r)
    cloud = Cloud.from_structured_array(scan, dtype=torch.float32, device=DEVICE)
    cloud = cloud.pad(pad_size(cloud.size))
    keep = _filter_impl(cloud, float(cfg.min_depth or 0.0), float(cfg.max_depth or np.inf),
                        float(cfg.grid_res or 0.0))
    points = cloud.replace(valid=keep).to_points()
    counts = _grid_neighbors(points, keep, r, 0, plain=True)
    grid = grid_sort_traced(points, keep, r, NODE_N_CELLS_PAD)  # the node's own sort
    res = {}
    for k in ks:
        _kernels.reset_launch_counts()
        d, idx = _grid_neighbors(points, keep, r, k, plain=False)
        torch.cuda.synchronize()
        launches = _kernels.GRID_LAUNCHES
        pd, pidx = _grid_neighbors(points, keep, r, k, plain=True)
        fin = torch.isfinite(pd)
        same_idx = bool(torch.equal(idx, pidx))
        same_fin = bool(torch.equal(fin, torch.isfinite(d)))
        ulps = _f32_ulps(d[fin], pd[fin]) if same_fin and bool(fin.any()) else -1
        over = int((counts > k).sum())
        log("X2 grid node (traced grid, k %d): %d kept rows, %d with more than %d within r "
            "(largest count %d); kernel vs plain: index tables equal %s, finite pattern equal "
            "%s, distances within %d ulp; %d launch"
            % (k, int(keep.sum()), over, k, int(counts.max()), same_idx, same_fin, ulps,
               launches))
        if launches != 1 or not (same_idx and same_fin and 0 <= ulps <= 1):
            raise RuntimeError("X2 misses its bars against the plain twin at the grid node's "
                               "shapes (k %d)" % k)
        topk = x2_query(points, keep, r, k, grid)
        if not bool(torch.equal(topk()[1], idx)):
            raise RuntimeError("X2 on the node's grid differs from the node's own call")
        res[k] = {"over": over, "ms": cuda_ms(topk, reps=20)}
        log("X2 grid node timing (k %d): %.4f ms (%s)" % (k, res[k]["ms"], card))
    if res[min(ks)]["over"] <= 0:
        raise RuntimeError("no row of the grid node has more than %d neighbours: the top-k "
                           "cut was not exercised" % min(ks))
    return res


def check_p7_global(g, idx, card: str) -> dict:
    """P7 at the largest call a main path makes: prep's global features on
    the slice's global cloud ``g`` with X2's top-k table ``idx`` (weight 1
    on every neighbour), held to the node's bars against the float64 plain
    version on the valid rows, and timed."""
    from depth_correction_tpu_torch.ops import features

    points = g.get_points().contiguous()
    w = (idx >= 0).float()
    got = features.gather_moments(points, idx, w)
    ref = features.gather_moments_plain(points.double(), idx, w.double())
    rows = g.valid
    err = (float((got[0].double() - ref[0])[:, rows].abs().max()),
           float((got[1].double() - ref[1])[:, rows].abs().max()))
    log("P7 vs plain float64 (global cloud, %d x %d, %d valid rows): mean max abs %.3e m, "
        "comps max abs %.3e m^2" % (idx.shape[0], idx.shape[1], int(rows.sum()), err[0], err[1]))
    if not (err[0] <= MEAN_ABS_BAR and err[1] <= COMPS_ABS_BAR):
        raise RuntimeError("P7 misses its bars vs float64 on the global cloud: %s" % (err,))
    return dict(p7_timing("global cloud, X2's top-%d" % idx.shape[1], points, idx, w, card),
                err=max(err))


def phase_grid(card: str, data, cfg, scan):
    """X2 on the slice's global cloud and first scan, against its plain
    twin and scipy's float64 sets; P7 on the global cloud's X2 table; X2
    at the grid node's shapes; the node's grid engine on the bench node
    scan."""
    from depth_correction_tpu_torch.preproc import global_cloud
    from depth_correction_tpu_torch.scripts.exp_grid_prep_diff import scipy_pairs_differ

    r = float(cfg.nn_r)
    batch = data.batches[0]
    g = global_cloud(batch)
    res = {"global": check_grid_query("global cloud", g.get_points().contiguous(), g.valid, r,
                                      card)}
    res["p7_global"] = check_p7_global(g, res["global"]["idx"], card)
    scan0 = batch.cloud.map(lambda x: x[0])
    pts, valid = scan0.to_points().contiguous(), scan0.valid
    res["scan"] = check_grid_query("scan 0", pts, valid, r, card)
    # Against scipy's float64 sets on the scan's float32 points (the global
    # cloud's take minutes of host time: scripts/exp_grid_prep_diff.py).
    t0 = time.perf_counter()
    differ, worst = scipy_pairs_differ(pts, valid, res["scan"]["idx"], r)
    log("X2 scan 0 vs scipy float64 sets: %d ordered pairs differ, largest |d - r| %.3e m "
        "(bar %.1e m; %.1f s)" % (differ, worst, 1e-6 * r, time.perf_counter() - t0))
    if worst > 1e-6 * r:
        raise RuntimeError("X2 differs from scipy's sets away from the radius: %.3e" % worst)
    res["scipy_differ"] = differ

    # The node's own k, and a k below the scan's largest count, so the
    # kernel's merge drops keys.
    k_node = int(node_config("grid").nn_max_neighbors or 32)
    res["node_x2"] = check_grid_node_neighbors(scan, (k_node, GRID_CUT_K), card)
    # The node's grid engine on the bench node scan (phase 4's).
    node = drive_node(scan, node_config("grid"), card, "grid node", batches=3, reps=NODE_REPS,
                      e2e_reps=E2E_REPS)
    if node["launches"]["grid"] <= 0 or node["launches"]["gather"] <= 0:
        raise RuntimeError("X2 / P7 were not launched by the grid node: %s" % node["launches"])
    res["node"] = node
    return res


def phase_probes_p6_p8(card: str):
    """The P6, P8 and P7 scripts on the card; each script's launches are
    counted alone. Returns their kernels-line entries and P7's timing at
    the probe's shapes."""
    import torch

    from depth_correction_tpu_torch.ops.layout_probe import layout_probe_plain
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.scripts import exp_mosaic_probe as p6
    from depth_correction_tpu_torch.scripts import exp_pallas_gather as p7
    from depth_correction_tpu_torch.scripts import exp_pallas_gather2 as p8

    dev = torch.device(DEVICE)
    failures = []
    r6, n6 = counted(lambda: p6.run(dev), "LAYOUT_LAUNCHES")
    r6b, n6b = counted(lambda: p6.run(dev, reps=1, first=200.0), "LAYOUT_LAUNCHES")
    for name, e in r6["probes"].items():
        e2 = r6b["probes"][name]
        # The profiler's kernel durations are the device time; at these
        # sizes the events time the host's issue rate.
        lib = (", %s %.4f ms (events %.4f)" % (e["library"], e["library_kernel_ms"],
                                               e["library_ms"]) if "library" in e else "")
        log("  P6 %-22s %-4s (sum %.3e; x[0,0] = 200: %s, sum %.3e) %9.4f ms (kernel %.4f)%s"
            % (name, "OK" if e["err"] == 0 else "FAIL", e["sum"],
               "OK" if e2["err"] == 0 else "FAIL", e2["sum"], e["ms"], e["kernel_ms"], lib))
        if e["err"] != 0 or e2["err"] != 0:
            failures.append("P6 %s differs from its plain version" % name)
    x = p6.inputs(dev)
    head = "dot_tlhs"
    h6 = r6["probes"][head]
    log("  P6 device time (profiler): %s %.4f ms, torch.matmul %.4f ms (%s)"
        % (head, h6["kernel_ms"], h6["library_kernel_ms"], card))
    entries = [{
        "name": "layout_probe (P6)", "route": "cuda",
        "source": "depth_correction_tpu_torch/csrc/layout_probe.cu",
        "replaces": "scripts/exp_mosaic_probe.py:37", "launches": n6 + n6b,
        "max_abs_err": max(max(e["err"] for e in r["probes"].values()) for r in (r6, r6b)),
        "ms": h6["ms"], "kernel_ms": h6["kernel_ms"],
        "plain_ms": cuda_ms(lambda: layout_probe_plain(x, head), reps=20),
        # Bound: x read once and the (512, 128) output written once; three
        # TF32 passes of 2 x 512 x 128 x 8.
        "bound": bound(x.numel() * 4 + 4 * p6.S * 128, {"tf32": 3 * 2 * p6.S * 128 * 8}),
        "library_ms": h6["library_ms"], "library_device_ms": h6["library_kernel_ms"],
        "variants": {n: e["ms"] for n, e in r6["probes"].items()},
        "kernel_variants": {n: e["kernel_ms"] for n, e in r6["probes"].items()},
        "transpose_library_device_ms": r6["probes"]["transpose_f32"]["library_kernel_ms"]}]

    r8, n8 = counted(lambda: p8.run(dev), "GATHER_PROBE_LAUNCHES")
    for case, forms in r8["cases"].items():
        for form, e in forms.items():
            if e is None:
                log("  P8 %s %-7s n/a (the staged row does not fit a cluster's shared memory)"
                    % (case, form))
                continue
            log("  P8 %s %-7s %-4s err %.1e %9.4f ms"
                % (case, form, "OK" if e["err"] == 0 else "FAIL", e["err"], e["ms"]))
            if e["err"] != 0:
                failures.append("P8 %s %s differs from its plain version" % (case, form))
    # B's forms and torch.gather timed in turns by the profiler's kernel
    # durations and by events.
    b8 = p8.b_turns(dev)
    for name in b8["ms"]:
        log("  P8 B %-13s device %.4f ms (turns %s), events %.4f ms (%s)"
            % (name, b8["kernel_ms"][name],
               ", ".join("%.4f" % v for v in b8["kernel_turns"][name]), b8["ms"][name], card))
    xb, ib, axis = p8.inputs(dev)["B"]
    k8 = b8["kernel_ms"]
    entries.append({
        "name": "gather_probe (P8)", "route": "cuda",
        "source": "depth_correction_tpu_torch/csrc/gather_probe.cu",
        "replaces": "scripts/exp_pallas_gather2.py:35", "launches": n8,
        "max_abs_err": max(e["err"] for f in r8["cases"].values() for e in f.values() if e),
        "ms": b8["ms"]["global"], "kernel_ms": k8["global"],
        "plain_ms": b8["ms"]["torch_gather"],
        # Bound (case B): x, the indices and the output moved once.
        "bound": bound(xb.numel() * 4 + ib.numel() * 8, {"fp32": 0}),
        # The plain version is one PyTorch call (torch.gather).
        "library_ms": b8["ms"]["torch_gather"], "library_device_ms": k8["torch_gather"],
        "cluster_kernel_ms": k8["cluster"], "sorted_kernel_ms": k8["global_sorted"],
        "variants": {"%s_%s" % (c, f): e["ms"] for c, fs in r8["cases"].items()
                     for f, e in fs.items() if e}})
    # P7's two stages (the TPU script's draws, stage 1 first).
    d7 = p7.inputs(dev)
    r7, n7 = counted(lambda: p7.run(dev, data=d7), "GATHER_SUM_LAUNCHES")
    n7_moments = _kernels.GATHER_LAUNCHES
    pr, mo = r7["probe"], r7["moments"]
    log("  P7a gather-sum %-4s err vs plain %.1e, vs float64 %.3e %9.4f ms (plain %.4f ms)"
        % ("OK" if pr["err"] == 0 else "FAIL", pr["err"], pr["rel64"], pr["ms"],
           pr["plain_ms"]))
    log("  P7 stage 2 (%d launches) rel err vs plain float32 %.3e, float64 %.3e %9.4f ms "
        "(device %.4f ms, plain %.4f ms)" % (n7_moments, mo["err32"], mo["err64"], mo["ms"],
                                             mo["kernel_ms"], mo["plain_ms"]))
    if pr["err"] != 0:
        failures.append("P7a is not bit-equal to its plain version")
    if n7_moments <= 0 or not (mo["err32"] <= PROBE_REL_BAR and mo["err64"] <= PROBE_REL_BAR):
        failures.append("P7 at stage 2 misses %.0e: %s" % (PROBE_REL_BAR, mo))
    # One PyTorch call computing P7a's function (a yardstick only).
    lib7 = p7.probe_library(dev, d7)
    log("  P7a embedding_bag (sum) %.4f ms, device %.4f ms; rel err vs plain %.3e (%s)"
        % (lib7["ms"], lib7["kernel_ms"], lib7["rel"], card))
    if not lib7["rel"] <= 1e-6:
        failures.append("embedding_bag misses 1e-6 against P7a's plain version: %.3e"
                        % lib7["rel"])
    log("  P7a device %.4f ms against embedding_bag's %.4f ms: %s (%s)"
        % (pr["kernel_ms"], lib7["kernel_ms"],
           "at or below it" if pr["kernel_ms"] <= lib7["kernel_ms"] else
           "SLOWER, %.2fx" % (pr["kernel_ms"] / lib7["kernel_ms"]), card))
    stage2 = p7_timing("probe's stage 2", *d7["moments"], card)
    m7, t7, k7 = p7.PROBE_M, p7.PROBE_T, p7.PROBE_K
    entries.append({
        "name": "gather_sum (P7a)", "route": "cuda",
        "source": "depth_correction_tpu_torch/csrc/gather_sum.cu",
        "replaces": "scripts/exp_pallas_gather.py:45", "launches": n7,
        "max_abs_err": pr["err"], "ms": pr["ms"], "plain_ms": pr["plain_ms"],
        # Bound: the table, the indices and the (3, T) output moved once;
        # one add per gathered value.
        "bound": bound(3 * m7 * 4 + t7 * k7 * 4 + 3 * t7 * 4, {"fp32": 3 * t7 * k7}),
        "kernel_ms": pr["kernel_ms"],
        "library_ms": lib7["ms"], "library_device_ms": lib7["kernel_ms"],
        "variants": {"stage2_moments": mo["ms"]}})
    if failures:
        raise RuntimeError("probe bars missed: " + "; ".join(failures))
    return entries, stage2


def phase_capped(card: str, seq):
    """The bench's capped row on the slice's scene (phase 3's loaded scans,
    ``seq``): prep, 8 Adam steps through train(), capped32_ms, and the loss
    at w=0 against the float64 plain path on the same graph."""
    import math

    import torch

    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.scripts import bench_config as config
    from depth_correction_tpu_torch.train import make_loss_fn, prepare_sequences

    cfg = config(DEVICE, STEPS, uncapped=False)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    data = prepare_sequences([seq], cfg)
    prep_s = time.perf_counter() - t0
    if data.cellwin != (None,):
        raise RuntimeError("the capped row must run the gather moments")
    nn = data.neighbors[0]
    kept = (nn >= 0).sum(1)[data.masks[0]]
    launches = {"grid": _kernels.GRID_LAUNCHES, "gather": _kernels.GATHER_LAUNCHES}
    log("capped prep: %.3f s (%s); %d rows, K %d, neighbours per row %d-%d after mutual "
        "trimming; launches X2 %d, P7 %d"
        % (prep_s, ", ".join("%s %.3f" % kv for kv in data.prep_seconds.items()),
           int(data.masks[0].sum()), nn.shape[1], int(kept.min()), int(kept.max()),
           launches["grid"], launches["gather"]))
    if launches["grid"] <= 0 or launches["gather"] <= 0 or int(kept.max()) > 32:
        raise RuntimeError("the capped prep did not run as the bench's: %s" % launches)
    _kernels.reset_launch_counts()
    _, history = train_logged(cfg, train_data=data)
    x45 = check_transposes("capped", cfg, data, STEPS)
    losses = [h["train_loss"] for h in history]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError("non-finite capped loss: %s" % losses)
    step_ms = statistics.median(h["step_ms"] for h in history[1:])
    data64 = data.to(dtype=torch.float64)
    ref = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=torch.float64, device=DEVICE)
    with torch.no_grad():
        ref_loss = float(make_loss_fn(cfg, plain=True)(ref, data64))
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    log("capped32_ms %.3f (median of steps 1..%d: %s); loss at w=0 %.9e vs float64 plain "
        "%.9e (rel %.3e) (%s)" % (step_ms, STEPS - 1,
                                  ", ".join("%.3f" % h["step_ms"] for h in history),
                                  losses[0], ref_loss, loss_rel, card))
    if not loss_rel <= LOSS_REL_BAR:
        raise RuntimeError("capped loss at w=0 misses the 1e-5 bar: %.3e" % loss_rel)
    res = {"ms": step_ms, "loss_rel": loss_rel, "prep_s": prep_s, "launches": x45,
           "cfg": cfg, "data": data}
    res["profile"] = profile_steps(cfg, data, card)
    check_no_index_backward(res["profile"], "capped")
    return res


def check_shadow_filter(scan, cfg, card: str) -> dict:
    """The shadow filter on one scan of the default config. X3's counts
    (which size k_dir) and top-k over the unit view directions, called as
    local_feature_cloud calls them, held against their plain twins; the
    mask from those tables must drop some points and keep others, and
    local_feature_cloud must keep just as many. The direction search's
    launches are local_feature_cloud's with the filter on less those with
    it off. Raises on a missed bar."""
    import torch

    from depth_correction_tpu_torch import preproc
    from depth_correction_tpu_torch.cloud import Cloud
    from depth_correction_tpu_torch.ops import _kernels, filters, knn

    cloud = Cloud.from_structured_array(scan, dtype=cfg.torch_dtype(),
                                        device=cfg.torch_device())
    r_dir = filters.ball_angle_to_distance(cfg.shadow_neighborhood_angle)
    _kernels.reset_launch_counts()
    k_dir = knn.suggest_k_max(cloud.dirs, r=r_dir, valid_points=cloud.valid)
    _, dir_nn = knn.radius_neighbors(cloud.dirs, r=r_dir, k=k_dir, valid_points=cloud.valid)
    launches = _kernels.KNN_LAUNCHES
    _, plain_nn = knn.radius_neighbors(cloud.dirs, r=r_dir, k=k_dir, valid_points=cloud.valid,
                                       plain=True)
    if not torch.equal(dir_nn, plain_nn):
        raise RuntimeError("X3's direction table differs from its plain twin's")
    res = check_knn("shadow directions", cloud.dirs, cloud.valid, r_dir, k_dir, card,
                    every_row=True)
    shadow_ok = filters.filter_shadow_mask(cloud, dir_nn, (dir_nn >= 0).to(cloud.depth.dtype),
                                           cfg.shadow_angle_bounds)
    n, kept = int(cloud.valid.sum()), int(shadow_ok.sum())

    off = cfg.copy()
    off.shadow_angle_bounds = []
    _kernels.reset_launch_counts()
    fc = preproc.local_feature_cloud(scan, cfg)
    on_launches = _kernels.KNN_LAUNCHES
    _kernels.reset_launch_counts()
    preproc.local_feature_cloud(scan, off)
    dir_launches = on_launches - _kernels.KNN_LAUNCHES
    fc_kept = int(fc.valid.sum())
    log("shadow filter (one scan): r_dir %g, k_dir %d, %d points, %d dropped, %d kept "
        "(local_feature_cloud keeps %d); X3 launches on the directions %d (direct calls %d)"
        % (r_dir, k_dir, n, n - kept, kept, fc_kept, dir_launches, launches))
    if not (launches > 0 and dir_launches == launches):
        raise RuntimeError("X3 did not run on the view directions as local_feature_cloud "
                           "runs it: %d direct, %d in local_feature_cloud"
                           % (launches, dir_launches))
    if not 0 < kept < n:
        raise RuntimeError("the shadow mask dropped %d of %d points: none or all" % (n - kept, n))
    if fc_kept != kept:
        raise RuntimeError("local_feature_cloud kept %d points, the checked mask %d"
                           % (fc_kept, kept))
    res.update(k=k_dir, dropped=n - kept, launches=launches)
    return res


def check_vp_dispersion(data, cfg) -> dict:
    """The vp_dispersion bound on the default config's global cloud, rebuilt
    from the prepared batch as prepare_sequences builds it: P7's launches
    in global_cloud_mask (the bound on less the bound off), vp_dispersion
    against the float64 plain moments of the same viewpoints, neighbours and
    weights, equal masks, and the rows kept equal to those prep kept.
    Raises on a missed bar."""
    import torch

    from depth_correction_tpu_torch import preproc
    from depth_correction_tpu_torch.ops import _kernels, features, filters
    from depth_correction_tpu_torch.train import _use_cellwin

    gcloud = preproc.global_cloud(data.batches[0])
    est_cfg = cfg
    if _use_cellwin(cfg, True):
        est_cfg = cfg.copy()
        est_cfg.nn_max_neighbors = None
        est_cfg.nn_symmetrize = False
    nn, w = preproc.establish_neighborhoods(gcloud, est_cfg)
    feat = preproc.compute_neighborhood_features(gcloud, nn, w, cfg)
    off = cfg.copy()
    off.vp_dispersion_bounds = []
    _kernels.reset_launch_counts()
    gmask = filters.global_cloud_mask(feat, nn, w, cfg, mask=feat.mask)
    launches = _kernels.GATHER_LAUNCHES
    _kernels.reset_launch_counts()
    gmask_off = filters.global_cloud_mask(feat, nn, w, off, mask=feat.mask)
    launches -= _kernels.GATHER_LAUNCHES

    vd = features.vp_dispersion(feat, nn, w)
    _, comps, _ = features.gather_moments_plain(feat.vps.double(), nn, w.double())
    vd64 = comps[0] + comps[1] + comps[2]
    rows = feat.valid
    err = float((vd.double() - vd64)[rows].abs().max())
    rel = err / max(float(vd64[rows].abs().max()), 1e-30)
    lo, hi = cfg.vp_dispersion_bounds[:2]
    mask32 = gmask_off & filters.within_bounds(vd, lo, hi)
    mask64 = gmask_off & filters.within_bounds(vd64, lo, hi)
    flips = int((mask32 != mask64).sum())
    prep_rows = data.query_rows[0][data.masks[0]]
    same_rows = bool(torch.equal(torch.nonzero(gmask).reshape(-1), prep_rows))
    dropped = int((gmask_off & ~gmask).sum())
    log("vp_dispersion (global cloud, %d points, K %d): P7 launches for the bound %d; vs "
        "float64 plain moments max abs %.3e (%.3e of max |value|); masks of [%g, %g] differ "
        "in %d rows; the bound drops %d of %d rows, keeps %d; rows equal prep's %s"
        % (int(rows.sum()), nn.shape[1], launches, err, rel, lo, hi, flips, dropped,
           int(gmask_off.sum()), int(gmask.sum()), same_rows))
    if launches <= 0:
        raise RuntimeError("P7 did not run for the vp_dispersion bound")
    if not rel <= PROBE_REL_BAR:
        raise RuntimeError("vp_dispersion misses the %.0e relative bar: %.3e"
                           % (PROBE_REL_BAR, rel))
    if flips or not torch.equal(gmask, mask32):
        raise RuntimeError("the vp_dispersion mask differs from the float64 plain one in %d "
                           "rows" % flips)
    if not (dropped > 0 and int(gmask.sum()) > 0):
        raise RuntimeError("the vp_dispersion bound dropped %d rows and kept %d: none or all"
                           % (dropped, int(gmask.sum())))
    if not same_rows:
        raise RuntimeError("the checked mask's rows differ from those prep kept")
    return {"err": err, "launches": launches}


def check_global_knn(data, cfg, card: str) -> dict:
    """X3 at the default config's global establishment: the global cloud
    rebuilt from the prepared batch, r = nn_r, K sized by X3's own counts
    (rounded up to 8, as suggest_k_max rounds). Prep routes this cloud to
    the grid search (X2), its padded size being at least
    GRID_NN_MIN_POINTS; here X3 runs on it directly and is held against its
    twin (check_knn)."""
    from depth_correction_tpu_torch import preproc
    from depth_correction_tpu_torch.ops import knn
    from depth_correction_tpu_torch.ops.grid_hash import GRID_NN_MIN_POINTS

    gcloud = preproc.global_cloud(data.batches[0])
    points, valid = gcloud.get_points(), gcloud.valid
    counts = knn.neighbor_counts(points, r=float(cfg.nn_r), valid_points=valid)
    k = max(8, -(-int(counts.max()) // 8) * 8)
    log("default global cloud: %d points (%d valid; prep routes it to %s), K %d from X3's "
        "counts" % (points.shape[0], int(valid.sum()),
                    "X2" if points.shape[0] >= GRID_NN_MIN_POINTS else "X3", k))
    return check_knn("default global cloud", points, valid, float(cfg.nn_r), k, card)


def write_asl_sequence(root: str, scene: str, name: str, noise: float = 0.005) -> int:
    """The synthetic scene's scans as ASL-laser files (the reference
    loader's layout, datasets/asl_laser.py): csv_local/Hokuyo_<i>.csv with
    the sensor-frame points, each coordinate with ``noise`` m of seeded
    Gaussian noise (exact planes would leave the smallest eigenvalues to
    rounding), and csv_global/pose_scanner_leica.csv. Returns the number of
    points written."""
    import numpy as np

    from depth_correction_tpu_torch.datasets.asl_laser import write_poses
    from depth_correction_tpu_torch.datasets.synthetic import OpenBoxDataset

    ds = OpenBoxDataset(name=scene)
    seq = os.path.join(root, name)
    os.makedirs(os.path.join(seq, "csv_local"))
    os.makedirs(os.path.join(seq, "csv_global"))
    total = 0
    rng = np.random.default_rng(0)
    for i in ds.ids:
        cloud = ds.local_cloud(i)
        xyz = np.c_[cloud["x"], cloud["y"], cloud["z"]] + noise * rng.standard_normal(
            (len(cloud), 3))
        pts = np.c_[np.full(len(cloud), float(i)), xyz, np.ones(len(cloud))]
        np.savetxt(os.path.join(seq, "csv_local", "Hokuyo_%d.csv" % i), pts, fmt="%.9f",
                   delimiter=", ", header="timestamp, x, y, z, intensity", comments="")
        total += len(cloud)
    write_poses(ds.ids, [ds.cloud_pose(i) for i in ds.ids],
                os.path.join(seq, "csv_global", "pose_scanner_leica.csv"))
    return total


def default_pose_pass(root: str, cfg, card: str) -> dict:
    """End to end with pose inputs on the default config's ASL-laser files:
    the poses perturbed (a few cm and mrad a scan) and written as a poses
    CSV, train() with train_poses_path, pose_correction = sequence and the
    same sequence and poses for validation (which trains deltas of its
    own), then eval_loss on the perturbed sequence with test_pose_deltas =
    best.train_pose_deltas. The files must exist and the eval loss must be
    finite and no higher than the first step's training loss."""
    import math

    import numpy as np

    from depth_correction_tpu_torch.datasets import asl_laser
    from depth_correction_tpu_torch.datasets.synthetic import euler_matrix
    from depth_correction_tpu_torch.eval import eval_loss
    from depth_correction_tpu_torch.train import TrainCallbacks, train

    class First(TrainCallbacks):
        def train_loss(self, it, model, pose_deltas, loss):
            if it == 0:
                self.loss = float(loss.detach())

    seq = os.path.join(asl_laser.data_dir, "open_box", "csv_global", "pose_scanner_leica.csv")
    ids, poses = asl_laser.read_poses(seq)
    rng = np.random.default_rng(10)
    perturbed = []
    for pose in poses:
        T = euler_matrix(*(0.002 * rng.standard_normal(3)))
        T[:3, 3] = 0.02 * rng.standard_normal(3)
        perturbed.append(np.asarray(pose) @ T)
    csv = os.path.join(root, "perturbed_poses.csv")
    asl_laser.write_poses(ids, perturbed, csv)
    pcfg = cfg.copy()
    pcfg.log_dir = os.path.join(root, "pose_log")
    pcfg.train_poses_path = pcfg.val_poses_path = [csv]
    pcfg.val_names = list(cfg.train_names)
    pcfg.pose_correction = "sequence"
    t0 = time.perf_counter()
    first_loss = First(pcfg)
    best = train(pcfg, callbacks=first_loss)
    train_s = time.perf_counter() - t0
    with open(os.path.join(pcfg.log_dir, "train_history.csv")) as f:
        f.readline()
        history = [list(map(float, line.split())) for line in f]
    if best is None or not best.train_pose_deltas:
        raise RuntimeError("the pose pass saved no best model and deltas")
    files = [best.model_state_dict, best.train_pose_deltas,
             os.path.join(pcfg.log_dir, "best.yaml"), os.path.join(pcfg.log_dir, "train_history.csv")]
    best.test_names = list(cfg.train_names)
    best.test_poses_path = [csv]
    best.test_pose_deltas = best.train_pose_deltas
    best.loss_eval_csv = os.path.join(pcfg.log_dir, "loss_eval_pose.csv")
    t0 = time.perf_counter()
    value = eval_loss(best)
    eval_s = time.perf_counter() - t0
    files.append(best.loss_eval_csv)
    missing = [f for f in files if not os.path.exists(f)]
    first = first_loss.loss
    log("default pose pass: train() %.1f s, %d steps, train losses %s, val %s; best %s; "
        "eval_loss %.9e (first step %.9e) in %.1f s (%s)"
        % (train_s, len(history), ", ".join("%.6e" % h[1] for h in history),
           ", ".join("%.6e" % h[2] for h in history), os.path.basename(best.train_pose_deltas),
           value, first, eval_s, card))
    if missing:
        raise RuntimeError("the pose pass did not write %s" % missing)
    if not (math.isfinite(value) and value <= first):
        raise RuntimeError("the pose pass's eval loss %.9e is not finite or above the first "
                           "step's %.9e" % (value, first))
    return {"eval_loss": value, "first_loss": first, "train_s": train_s, "eval_s": eval_s}


def phase_default(card: str):
    """A default Config() on the open box written as ASL-laser files, with
    the shadow filter: prep and train() on the card; X3 and P7 must have
    launched in prep; X3 on the view directions (check_shadow_filter) and P7
    on the viewpoints (check_vp_dispersion) held against their plain twins
    at this config's shapes; the loss at w=0 against the float64 plain
    path."""
    import math
    import shutil
    import tempfile

    import torch

    from depth_correction_tpu_torch import Config
    from depth_correction_tpu_torch.datasets import asl_laser, create_dataset
    from depth_correction_tpu_torch.models import load_model
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.train import make_loss_fn, prepare_sequences

    root = tempfile.mkdtemp(prefix="dc_asl_")
    try:
        t0 = time.perf_counter()
        n_raw = write_asl_sequence(os.path.join(root, "asl_laser"), DEFAULT_SCENE, "open_box")
        # The loader reads DEPTH_CORRECTION_DATA when it is imported.
        asl_laser.data_dir = os.path.join(root, "asl_laser")
        log("default config: %s written as ASL-laser CSV files, %d points (%.1f s)"
            % (DEFAULT_SCENE, n_raw, time.perf_counter() - t0))
        cfg = Config()
        cfg.log_dir = os.path.join(root, "log")
        cfg.train_names = ["asl_laser/open_box"]
        cfg.n_opt_iters = STEPS
        cfg.float_type = "float32"
        cfg.shadow_angle_bounds = [0.1745, 2.967]  # 10 to 170 degrees
        ds = create_dataset(cfg.train_names[0], cfg)
        reset_all_launch_counts()
        t0 = time.perf_counter()
        data = prepare_sequences([ds], cfg)
        prep_s = time.perf_counter() - t0
        launches = {"knn": _kernels.KNN_LAUNCHES, "grid": _kernels.GRID_LAUNCHES,
                    "gather": _kernels.GATHER_LAUNCHES}
        rows = int(data.masks[0].sum())
        log("default prep: %.3f s (%s); %d points, %d rows kept by the masks (vp_dispersion "
            ">= 0.36 among them); launches X3 %d, X2 %d, P7 %d; cellwin graph %s"
            % (prep_s, ", ".join("%s %.3f" % kv for kv in data.prep_seconds.items()),
               int(data.batches[0].cloud.valid.sum()), rows, launches["knn"],
               launches["grid"], launches["gather"],
               "built" if data.cellwin[0] is not None
               else "not built (%s)" % (data.cellwin_notes[0] or "not tried")))
        if launches["knn"] <= 0 or launches["gather"] <= 0:
            raise RuntimeError("X3 / P7 were not launched in the default prep: %s" % launches)
        shadow = check_shadow_filter(next(iter(ds))[0], cfg, card)
        vp = check_vp_dispersion(data, cfg)
        glob = check_global_knn(data, cfg, card)
        if rows <= 0:
            raise RuntimeError("the default masks kept no row")
        reset_all_launch_counts()
        model, history = train_logged(cfg, train_data=data)
        launches.update(check_transposes("default", cfg, data, STEPS))
        losses = [h["train_loss"] for h in history]
        if not all(math.isfinite(v) for v in losses):
            raise RuntimeError("non-finite default-config loss: %s" % losses)
        ref = load_model(cfg=cfg, dtype=torch.float64)
        with torch.no_grad():
            ref_loss = float(make_loss_fn(cfg, plain=True)(ref, data.to(dtype=torch.float64)))
        loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
        step_ms = statistics.median(h["step_ms"] for h in history[1:])
        log("default config: best %s in %d steps; loss at w=0 %.9e vs float64 plain %.9e (rel "
            "%.3e); median step %.3f ms (%s)" % (model, STEPS, losses[0], ref_loss, loss_rel,
                                                 step_ms, card))
        if not loss_rel <= LOSS_REL_BAR:
            raise RuntimeError("default-config loss at w=0 misses the 1e-5 bar: %.3e"
                               % loss_rel)
        pose = default_pose_pass(root, cfg, card)
        # Phase 12d runs here, while this phase's files exist.
        log("[phase 12d] nn_scale on the default config's data (%d Adam steps)"
            % NN_SCALE_STEPS)
        nn_scale = phase_nn_scale(card, cfg, ds, launches["gather"])
        return {"loss_rel": loss_rel, "step_ms": step_ms, "prep_s": prep_s, "rows": rows,
                "launches": launches, "shadow": shadow, "vp": vp, "global": glob,
                "pose": pose, "nn_scale": nn_scale}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phase 11's seeded pose deltas: translations and axis-angle rotations of a
# few mm and mrad on scans 1-5 (scan 0 stays, as pose mode freezes it).
POSE_DELTA_M, POSE_DELTA_RAD = 0.003, 0.002


def phase_pose(card: str, data, cfg):
    """Pose correction at full width on phase 3's prepared slice: pose mode,
    nonzero deltas on scans 1-5, 8 Adam steps of train.fit. The loss at the
    seeded deltas against the float64 plain path (bar 1e-5), the deltas'
    gradient against float64 (printed), scan 0's delta exactly 0 after the
    steps, K1 and K2 launched once a step each, pose_step_ms and the
    step's device-busy share."""
    import numpy as np
    import torch

    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.train import fit, make_loss_fn, make_optimizer

    cfg = cfg.copy()
    cfg.pose_correction = "pose"
    n_scans = data.batches[0].num_scans
    rng = np.random.default_rng(11)
    seed = np.c_[POSE_DELTA_M * rng.standard_normal((n_scans, 3)),
                 POSE_DELTA_RAD * rng.standard_normal((n_scans, 3))]
    seed[0] = 0.0

    def leaves(dtype):
        return (torch.tensor(seed, dtype=dtype, device=DEVICE, requires_grad=True),)

    # The loss and the deltas' gradient at the seeded deltas and w = 0:
    # kernels (float32) against the float64 plain path on the same graph.
    d32, d64 = leaves(cfg.torch_dtype()), leaves(torch.float64)
    model = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=cfg.torch_dtype(), device=DEVICE)
    ref = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=torch.float64, device=DEVICE)
    loss32 = make_loss_fn(cfg)(model, data, d32)
    loss32.backward()
    loss64 = make_loss_fn(cfg, plain=True)(ref, data.to(dtype=torch.float64), d64)
    loss64.backward()
    g32, g64 = d32[0].grad.double(), d64[0].grad
    loss_rel = abs(float(loss32.detach()) - float(loss64.detach())) / abs(float(loss64.detach()))
    grad_rel = float((g32 - g64).abs().max() / g64.abs().max())
    w_rel = abs(float(model.w.grad[0]) - float(ref.w.grad[0])) / abs(float(ref.w.grad[0]))
    log("pose: loss at the seeded deltas %.9e vs float64 plain %.9e (rel %.3e); deltas' "
        "gradient rel err %.3e (max |g| %.3e), w's %.3e (%s)"
        % (float(loss32.detach()), float(loss64.detach()), loss_rel, grad_rel,
           float(g64.abs().max()), w_rel, card))
    if not loss_rel <= LOSS_REL_BAR:
        raise RuntimeError("pose loss at the seeded deltas misses the 1e-5 bar: %.3e" % loss_rel)

    # The main path: train.fit in pose mode; counts from this run only.
    deltas = leaves(cfg.torch_dtype())
    reset_all_launch_counts()
    _, history = fit(cfg, data, pose_deltas=deltas)
    launches = {"fwd": cw.FWD_LAUNCHES, "bwd": cw.BWD_LAUNCHES}
    check_transposes("pose (exception rows)", cfg, data, STEPS)
    final = deltas[0].detach().cpu().numpy()
    log("pose: %d steps, K1 %d and K2 %d launches; losses %s; scan 0's delta %s, scans 1-5 "
        "moved by up to %.3e" % (len(history), launches["fwd"], launches["bwd"],
                                 ", ".join("%.9e" % h[1] for h in history), final[0].tolist(),
                                 float(np.abs(final - seed).max())))
    if launches != {"fwd": STEPS, "bwd": STEPS}:
        raise RuntimeError("K1 / K2 were not launched once a step: %s" % launches)
    if final[0].any():
        raise RuntimeError("scan 0's pose delta moved: %s" % final[0])
    if not np.abs(final[1:] - seed[1:]).max() > 0:
        raise RuntimeError("the pose deltas did not move")
    if not all(np.isfinite(h[1]) for h in history):
        raise RuntimeError("non-finite pose loss: %s" % history)
    step_ms = statistics.median(h[3] for h in history[1:])

    def step():
        opt.zero_grad()
        make(model, data, deltas).backward()
        deltas[0].grad[0] = 0.0
        opt.step()

    make = make_loss_fn(cfg)
    opt = make_optimizer(cfg, [{"params": [model.w]}, {"params": list(deltas)}])
    profile = profile_calls(step, card, "step")
    log("pose_step_ms %.3f (median of steps 1..%d: %s) (%s)"
        % (step_ms, STEPS - 1, ", ".join("%.3f" % h[3] for h in history), card))
    return {"step_ms": step_ms, "loss_rel": loss_rel, "grad_rel": grad_rel, "w_grad_rel": w_rel,
            "launches": launches, "profile": profile}


# Phase 12: the loss offset, ICP, L-BFGS, nn_scale, resume and the prep
# cache at full width.
LBFGS_STEPS = 4
NN_SCALE_STEPS = 4
# nn_scale's features (mean, eigenvalues, weights) on the card against the
# float64 plain path, relative to each output's largest magnitude.
NN_SCALE_REL_BAR = 1e-5
RESUME_STEPS = 4


def tensors_equal(a, b) -> bool:
    """Whether two prepared structures (dataclasses, tuples, dicts,
    tensors, numbers) hold the same values, bit for bit, in the same
    dtypes."""
    import dataclasses

    import torch

    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a, b)))
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            tensors_equal(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a) if f.name != "prep_seconds")
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(tensors_equal(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def w0_rel(cfg, data, loss32: float) -> tuple:
    """(rel, f64 loss): the loss at the config's model (w = 0) on the
    float64 plain path over the same graph against ``loss32``."""
    import torch

    from depth_correction_tpu_torch.models import load_model
    from depth_correction_tpu_torch.train import make_loss_fn

    ref = load_model(cfg=cfg, dtype=torch.float64)
    with torch.no_grad():
        loss64 = float(make_loss_fn(cfg, plain=True)(ref, data.to(dtype=torch.float64)))
    return abs(loss32 - loss64) / abs(loss64), loss64


def fit_counted(cfg, data, label: str):
    """train.fit with the launch counts zeroed just before and read just
    after: (history, {K1, K2, X2, X3, P7, X4, X5 launches})."""
    import math

    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.train import fit

    reset_all_launch_counts()
    _, history = fit(cfg, data)
    launches = {"fwd": cw.FWD_LAUNCHES, "bwd": cw.BWD_LAUNCHES, "grid": _kernels.GRID_LAUNCHES,
                "knn": _kernels.KNN_LAUNCHES, "gather": _kernels.GATHER_LAUNCHES,
                **transpose_launches()}
    if not all(math.isfinite(h[1]) for h in history):
        raise RuntimeError("%s: non-finite loss %s" % (label, history))
    return history, launches


class LoadedSequence(list):
    """A dataset's (scan, pose) pairs, loaded once: phase 12's paths take it
    where they take a dataset (iterated, and named by ``str``), so the
    bench scene's scans (16-19 s to generate on the card's host) are made
    once for all of them."""

    def __init__(self, ds, name: str):
        super().__init__((scan, pose) for scan, pose in ds)
        self.name = name

    def __str__(self):
        return self.name


def load_sequence(cfg):
    """The config's training sequence as a :class:`LoadedSequence`, timed."""
    from depth_correction_tpu_torch.datasets import create_dataset

    t0 = time.perf_counter()
    seq = LoadedSequence(create_dataset(cfg.train_names[0], cfg), cfg.train_names[0])
    log("%s: %d scans loaded in %.3f s" % (seq, len(seq), time.perf_counter() - t0))
    return seq


def prep_counted(cfg, seq, label: str):
    """prepare_sequences of ``seq`` with the launch counts zeroed just
    before and read just after: (data, seconds, {X2, X3, P7 launches})."""
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.train import prepare_sequences

    reset_all_launch_counts()
    t0 = time.perf_counter()
    data = prepare_sequences([seq], cfg)
    seconds = time.perf_counter() - t0
    launches = {"grid": _kernels.GRID_LAUNCHES, "knn": _kernels.KNN_LAUNCHES,
                "gather": _kernels.GATHER_LAUNCHES}
    log("%s prep: %.3f s (%s); launches X2 %d, X3 %d, P7 %d"
        % (label, seconds, ", ".join("%s %.3f" % kv for kv in data.prep_seconds.items()),
           launches["grid"], launches["knn"], launches["gather"]))
    return data, seconds, launches


def adam_step_fn(cfg, data):
    """One Adam step of the config's loss on ``data`` (the profiled step)."""
    from depth_correction_tpu_torch.models import load_model
    from depth_correction_tpu_torch.train import make_loss_fn, make_optimizer

    model = load_model(cfg=cfg)
    loss_fn = make_loss_fn(cfg)
    opt = make_optimizer(cfg, [model.w])

    def step():
        opt.zero_grad()
        loss_fn(model, data).backward()
        opt.step()

    return step


def phase_offset_cache(card: str, seq):
    """12a and 12f: the loss offset on the bench slice (prep keeps the
    per-scan neighbours; 8 Adam steps of train.fit on K1, K2 and the
    offset's gather moments, P7 and X4; the loss at w = 0 against the float64 plain
    path), its prep written to the prep cache, then prepared again: a hit,
    equal bit for bit."""
    import shutil
    import tempfile

    from depth_correction_tpu_torch.train import prepare_sequences

    cfg = bench_config()
    cfg.loss_offset = True
    root = tempfile.mkdtemp(prefix="dc_prep_cache_")
    try:
        cfg.prep_cache_dir = os.path.join(root, "cache")
        data, build_s, _ = prep_counted(cfg, seq, "offset (prep cache: build)")
        if data.cellwin[0] is None or data.off_neighbors[0] is None:
            raise RuntimeError("the offset slice has no cell-window graph or no offset graph")
        history, launches = fit_counted(cfg, data, "the offset slice's fit()")
        loss_rel, loss64 = w0_rel(cfg, data, history[0][1])
        step_ms = statistics.median(h[3] for h in history[1:])
        log("offset: %d rows, offset graph (%d, %d); losses %s; K1 %d, K2 %d launches; loss at "
            "w=0 %.9e vs float64 plain %.9e (rel %.3e); offset_step_ms %.3f (%s)"
            % (int((data.cellwin[0].row_map >= 0).sum()), *data.off_neighbors[0].shape,
               ", ".join("%.9e" % h[1] for h in history), launches["fwd"], launches["bwd"],
               history[0][1], loss64, loss_rel, step_ms, card))
        if launches["fwd"] != STEPS or launches["bwd"] != STEPS:
            raise RuntimeError("K1 / K2 were not launched once a step: %s" % launches)
        check_transposes("offset", cfg, data, STEPS, launches)
        if not loss_rel <= LOSS_REL_BAR:
            raise RuntimeError("offset loss at w=0 misses the 1e-5 bar: %.3e" % loss_rel)
        profile = profile_calls(adam_step_fn(cfg, data), card, "step")
        check_no_index_backward(profile, "offset")

        # 12f: the same prep again, from the cache.
        t0 = time.perf_counter()
        again = prepare_sequences([seq], cfg.copy())
        load_s = time.perf_counter() - t0
        hit = "cache_load" in again.prep_seconds
        equal = tensors_equal(again, data)
        log("prep cache: build %.3f s, load %.3f s (of it cache_load %.3f; the fingerprint "
            "hashes the scans); hit %s, equal bit for bit %s (%s)"
            % (build_s, load_s, again.prep_seconds.get("cache_load", 0.0), hit, equal, card))
        if not (hit and equal):
            raise RuntimeError("the prep cache missed or gave other tensors")
        return {"step_ms": step_ms, "loss_rel": loss_rel, "launches": launches,
                "profile": profile, "build_s": build_s, "load_s": load_s,
                "cache_load_s": again.prep_seconds["cache_load"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_icp(card: str, seq):
    """12b: ICP training on the bench slice (prep through X3, X2 and P7;
    8 Adam steps; the loss at w = 0 against float64), then eval_icp on the
    same sequence: each X3 k = 1 call (no radius) held against its plain
    twin and timed, the correspondences against float64 plain, the loss
    against float64 plain."""
    import contextlib

    import torch

    from depth_correction_tpu_torch.eval import eval_icp
    from depth_correction_tpu_torch.loss import icp_loss
    from depth_correction_tpu_torch.models import load_model
    from depth_correction_tpu_torch.ops import _kernels, knn

    cfg = bench_config()
    cfg.loss = "icp_loss"
    cfg.loss_kwargs = {"icp_point_to_plane": True, "icp_inlier_ratio": 0.5}
    data, prep_s, prep_launches = prep_counted(cfg, seq, "icp")
    if min(prep_launches.values()) <= 0:
        raise RuntimeError("the ICP prep did not launch X2, X3 and P7: %s" % prep_launches)
    history, launches = fit_counted(cfg, data, "the ICP slice's fit()")
    loss_rel, loss64 = w0_rel(cfg, data, history[0][1])
    step_ms = statistics.median(h[3] for h in history[1:])
    log("icp: %d pairs, %d inliers; losses %s; loss at w=0 %.9e vs float64 %.9e (rel %.3e); "
        "icp_step_ms %.3f; prep %.3f s (%s)"
        % (data.icp_idx[0].shape[0], int(data.icp_w[0].sum()),
           ", ".join("%.9e" % h[1] for h in history), history[0][1], loss64, loss_rel, step_ms,
           prep_s, card))
    if not loss_rel <= LOSS_REL_BAR:
        raise RuntimeError("ICP loss at w=0 misses the 1e-5 bar: %.3e" % loss_rel)
    if not history[-1][1] < history[0][1]:
        raise RuntimeError("the ICP loss did not fall: %s" % history)

    # eval_icp: the main path, with X3's k = 1 calls recorded.
    nearest = knn.nearest_neighbors
    calls = []

    def recording(points, query=None, k=1, r=None, valid_points=None, valid_query=None,
                  plain=False):
        before = _kernels.KNN_LAUNCHES
        out = nearest(points, query, k, r, valid_points, valid_query, plain)
        if k == 1 and r is None:
            calls.append({"points": points, "query": query, "valid": valid_points,
                          "out": out, "launches": _kernels.KNN_LAUNCHES - before})
        return out

    @contextlib.contextmanager
    def patched(fn):
        knn.nearest_neighbors = fn
        try:
            yield
        finally:
            knn.nearest_neighbors = nearest

    ecfg = cfg.copy()
    ecfg.test_names = list(cfg.train_names)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    with patched(recording):
        value, (seqs, poses) = eval_icp(ecfg, [seq], return_data=True)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    n_pairs = sum(len(s) - 1 for s in seqs)
    if len(calls) != n_pairs or any(c["launches"] != 1 for c in calls):
        raise RuntimeError("eval_icp's %d pairs made %d k = 1 calls, launches %s"
                           % (n_pairs, len(calls), [c["launches"] for c in calls]))

    # The eval loss against float64 plain: the same feature clouds, the
    # model, poses and 1-NN in float64 (its correspondences recorded).
    model64 = load_model(cfg=ecfg, dtype=torch.float64)
    seqs64 = [[c.to(dtype=torch.float64) for c in s] for s in seqs]
    poses64 = [p.double() for p in poses]
    idx64 = []

    def plain64(*a, **kw):
        out = nearest(*a, **dict(kw, plain=True))
        idx64.append(out[1])
        return out

    with patched(plain64), torch.no_grad():
        value64, _ = icp_loss(seqs64, poses=poses64, model=model64, icp_point_to_plane=True,
                              icp_inlier_ratio=0.5)
    eval_rel = abs(value - float(value64)) / abs(float(value64))

    # Each call against the plain twin on the same float32 inputs and
    # against float64 plain; X3's time per pair and its bound.
    ties = differ64 = n_queries = 0
    ms, plain_ms = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for c, i64 in zip(calls, idx64):
        dist, idx = c["out"]
        start.record()
        pdist, pidx = nearest(c["points"], c["query"], 1, None, c["valid"], plain=True)
        end.record()
        end.synchronize()
        plain_ms.append(start.elapsed_time(end))
        if not bit_equal(dist, pdist):
            raise RuntimeError("X3 k = 1: distances differ from the plain twin's")
        diff = (idx != pidx)[:, 0]
        if diff.any():
            q = c["query"][diff]
            a, b = c["points"][idx[diff, 0].long()], c["points"][pidx[diff, 0].long()]
            da, db = q - a, q - b
            d2a = da[:, 0] * da[:, 0] + da[:, 1] * da[:, 1] + da[:, 2] * da[:, 2]
            d2b = db[:, 0] * db[:, 0] + db[:, 1] * db[:, 1] + db[:, 2] * db[:, 2]
            if not bit_equal(d2a, d2b):
                raise RuntimeError("X3 k = 1: an index differs from the twin's off a tie")
            ties += int(diff.sum())
        differ64 += int((i64 != idx).sum())
        n_queries += idx.shape[0]
        args = (c["points"], c["query"], 1, None, c["valid"])
        ms.append(cuda_ms(lambda: nearest(*args), reps=3, warmup=1))
    device_ms = kernel_ms(lambda: nearest(*args), DEVICE, 3)
    n, q = calls[-1]["points"].shape[0], calls[-1]["query"].shape[0]
    nv = int(calls[-1]["valid"].sum())
    x3_bound = bound(n * 13 + q * 12 + q * 8, {"fp32": PAIR_OPS * q * nv})
    res = {"pairs": n_pairs, "n_points": n, "n_queries": q, "valid_points": nv,
           "ms": statistics.mean(ms), "ms_pairs": ms, "plain_ms": statistics.mean(plain_ms),
           "kernel_ms": device_ms, "bound_ms": x3_bound[0], "bound_by": x3_bound[1],
           "ties": ties, "differ_f64_share": differ64 / n_queries}
    log("eval_icp: loss %.9e vs float64 plain %.9e (rel %.3e); icp_eval_ms %.1f; X3 k = 1: %d "
        "calls, one launch each, distances bit-equal to the twin, %d index ties; %.3e of the "
        "correspondences differ from float64 plain; %.4f ms a pair (%s; the last pair's "
        "device time %.4f; plain %.4f), bound %.4f ms (%s, all %d x %d pairs) (%s)"
        % (value, float(value64), eval_rel, eval_ms, len(calls), ties, res["differ_f64_share"],
           res["ms"], ", ".join("%.4f" % v for v in ms), res["kernel_ms"], res["plain_ms"],
           res["bound_ms"], res["bound_by"], q, nv, card))
    if not eval_rel <= LOSS_REL_BAR:
        raise RuntimeError("the eval_icp loss misses the 1e-5 bar: %.3e" % eval_rel)
    return {"step_ms": step_ms, "loss_rel": loss_rel, "prep_s": prep_s,
            "prep_launches": prep_launches, "launches": launches, "eval_ms": eval_ms,
            "eval_loss": value, "eval_rel": eval_rel, "x3": res, "x3_launches": len(calls)}


def phase_lbfgs(card: str, data):
    """12c: L-BFGS with the zoom line search on phase 3's uncapped slice:
    the loss must fall; K1 and K2 launch once for each loss evaluation."""
    cfg = bench_config()
    cfg.optimizer = "lbfgs"
    cfg.n_opt_iters = LBFGS_STEPS
    history, launches = fit_counted(cfg, data, "the L-BFGS slice's fit()")
    evals = launches["fwd"] / LBFGS_STEPS
    step_ms = statistics.median(h[3] for h in history[1:])
    log("lbfgs: losses %s; K1 %d, K2 %d launches in %d steps (%.2f loss evaluations a step); "
        "lbfgs_step_ms %.3f (%s)"
        % (", ".join("%.9e" % h[1] for h in history), launches["fwd"], launches["bwd"],
           LBFGS_STEPS, evals, step_ms, card))
    if launches["fwd"] != launches["bwd"] or launches["fwd"] < 2 * LBFGS_STEPS:
        raise RuntimeError("L-BFGS did not evaluate K1 / K2 at its trial points: %s" % launches)
    check_transposes("lbfgs (exception rows)", cfg, data, launches["fwd"], launches)
    if not history[-1][1] < history[0][1]:
        raise RuntimeError("the L-BFGS loss did not fall: %s" % history)
    return {"step_ms": step_ms, "evals_per_step": evals, "launches": launches,
            "losses": [h[1] for h in history]}


def check_scaled_features(data, cfg) -> dict:
    """nn_scale's features on the card against the float64 plain path:
    neighborhood_features with ``scale`` (P7 for the mean, then P7 under
    the re-weighted weights) on the prepared global cloud and graph, its
    mean, eigenvalues and re-weighted weights each within
    NN_SCALE_REL_BAR of max |float64 value| over the graph's rows. Raises
    on a missed bar or when P7 did not launch twice."""
    import torch

    from depth_correction_tpu_torch import preproc
    from depth_correction_tpu_torch.ops import _kernels, features

    pts = preproc.global_cloud(data.batches[0]).get_points()
    nn, w, qr = data.neighbors[0], data.weights[0], data.query_rows[0]
    rows = qr >= 0
    _kernels.reset_launch_counts()
    with torch.no_grad():
        got = features.neighborhood_features(pts, nn, w, scale=cfg.nn_scale,
                                             compute_normals=False, query_rows=qr)
    launches = _kernels.GATHER_LAUNCHES
    with torch.no_grad():
        ref = features.neighborhood_features(pts.double(), nn, w.double(), scale=cfg.nn_scale,
                                             compute_normals=False, plain=True, query_rows=qr)
    rel = {}
    for key in ("mean", "eigvals", "weights"):
        g, r = got[key][rows].double(), ref[key][rows]
        rel[key] = float((g - r).abs().max() / r.abs().max())
    log("nn_scale features (%d rows, K %d) vs float64 plain, max abs error over max |value|: "
        "%s; P7 launches %d" % (int(rows.sum()), nn.shape[1],
                                ", ".join("%s %.3e" % kv for kv in rel.items()), launches))
    if launches != 2:
        raise RuntimeError("nn_scale's features launched P7 %d times, not 2" % launches)
    if not all(v <= NN_SCALE_REL_BAR for v in rel.values()):
        raise RuntimeError("nn_scale's features miss the %.0e bar: %s" % (NN_SCALE_REL_BAR, rel))
    return rel


def phase_nn_scale(card: str, cfg, ds, base_p7: int):
    """12d: nn_scale on phase 10's default-config data: prep (one P7 launch
    more than the same prep without nn_scale, ``base_p7``: the mean before
    the re-weighting), the scaled features against float64 plain, 4 Adam
    steps; the loss at w = 0 against the float64 plain path."""
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.train import prepare_sequences

    cfg = cfg.copy()
    cfg.nn_scale = cfg.nn_r
    cfg.n_opt_iters = NN_SCALE_STEPS
    reset_all_launch_counts()
    t0 = time.perf_counter()
    data = prepare_sequences([ds], cfg)
    prep_s = time.perf_counter() - t0
    p7, x2, x3 = _kernels.GATHER_LAUNCHES, _kernels.GRID_LAUNCHES, _kernels.KNN_LAUNCHES
    history, launches = fit_counted(cfg, data, "the nn_scale fit()")
    loss_rel, loss64 = w0_rel(cfg, data, history[0][1])
    log("nn_scale %g: prep %.3f s, P7 %d launches in prep (X2 %d, X3 %d); losses %s; loss at "
        "w=0 %.9e vs float64 plain %.9e (rel %.3e); step %.3f ms (%s)"
        % (cfg.nn_scale, prep_s, p7, x2, x3, ", ".join("%.9e" % h[1] for h in history),
           history[0][1], loss64, loss_rel, statistics.median(h[3] for h in history[1:]), card))
    if p7 != base_p7 + 1:
        raise RuntimeError("nn_scale's prep launched P7 %d times, not %d (the prep without "
                           "nn_scale, and the mean before the re-weighting)" % (p7, base_p7 + 1))
    if not loss_rel <= LOSS_REL_BAR:
        raise RuntimeError("nn_scale loss at w=0 misses the 1e-5 bar: %.3e" % loss_rel)
    x45 = check_transposes("nn_scale", cfg, data, NN_SCALE_STEPS, launches)
    feats_rel = check_scaled_features(data, cfg)
    return {"loss_rel": loss_rel, "p7_prep": p7, "prep_s": prep_s, "features_rel": feats_rel,
            "step_ms": statistics.median(h[3] for h in history[1:]), "launches": x45}


def phase_resume(card: str, data):
    """12e: train() for 4 steps with checkpoint_period 2 on phase 3's slice,
    interrupted when step 2 starts and resumed, against an uninterrupted
    run: the largest difference of w and whether the saved states are
    equal bit for bit (K2's atomics need not be deterministic; the
    exception rows' X4 is)."""
    import shutil
    import tempfile

    import torch

    from depth_correction_tpu_torch.train import TrainCallbacks, train

    class Interrupt(Exception):
        pass

    class StopAt(TrainCallbacks):
        def iteration_started(self, it):
            if it == 2:
                raise Interrupt(it)

    root = tempfile.mkdtemp(prefix="dc_resume_")
    try:
        def cfg_at(name):
            cfg = bench_config()
            cfg.n_opt_iters = RESUME_STEPS
            cfg.checkpoint_period = 2
            cfg.plot_period = RESUME_STEPS
            cfg.log_dir = os.path.join(root, name)
            return cfg

        train(cfg_at("full"), train_data=data)
        try:
            train(cfg_at("cut"), callbacks=StopAt(), train_data=data)
            raise RuntimeError("the interrupted run was not interrupted")
        except Interrupt:
            pass
        train(cfg_at("cut"), train_data=data)

        def state(name):
            return torch.load(os.path.join(root, name, "train_state", str(RESUME_STEPS - 1)),
                              map_location="cpu", weights_only=True)

        full, cut = state("full"), state("cut")
        dw = max(float((a - b).abs().max()) for a, b in zip(full["tensors"], cut["tensors"]))
        equal = all(torch.equal(a, b) for a, b in zip(full["tensors"], cut["tensors"]))
        hist = [r[1] for r in full["history"]], [r[1] for r in cut["history"]]
        log("resume: %d steps, interrupted at step 2 and resumed from the checkpoint of step 1; "
            "w %s vs uninterrupted %s (max |dw| %.3e, bit-equal %s); losses %s vs %s (%s)"
            % (RESUME_STEPS, cut["tensors"][0].tolist(), full["tensors"][0].tolist(), dw, equal,
               hist[1], hist[0], card))
        if cut["it"] != RESUME_STEPS - 1 or len(cut["history"]) != RESUME_STEPS:
            raise RuntimeError("the resumed run did not finish from its checkpoint")
        rel = abs(dw) / max(float(full["tensors"][0].abs().max()), 1e-30)
        if not rel <= 1e-4:
            raise RuntimeError("the resumed run's w is %.3e off the uninterrupted one" % rel)
        return {"max_abs_dw": dw, "bit_equal": equal}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The plane phase's bars: params of the card's and the CPU's planes, and the
# margin of the RANSAC threshold within which a point may fall either side.
PLANE_PARAMS_BAR = 1e-6
TIE_M = 1e-6


def plane_support_ties(a, b, points, thresh: float) -> int:
    """Planes ``a`` and ``b`` fitted from the same float32 ``points`` (on
    the card and on the CPU): as many planes, params within
    PLANE_PARAMS_BAR, and supports equal but for points whose distance to
    the plane lies within TIE_M of the threshold. Returns how many
    points differ; raises otherwise."""
    import numpy as np

    if len(a) != len(b):
        raise RuntimeError("plane mode: %d planes on the card, %d on the CPU" % (len(a), len(b)))
    pa, pb = a.params.cpu().double().numpy(), b.params.cpu().double().numpy()
    perr = float(np.abs(pa - pb).max())
    if not perr <= PLANE_PARAMS_BAR:
        raise RuntimeError("plane mode: params differ by %.3e" % perr)
    pts = points.detach().cpu().double().numpy()
    ties = 0
    for i in range(len(a)):
        sa, sb = (set(m[m >= 0].tolist()) for m in (a.member_idx[i].cpu().numpy(),
                                                     b.member_idx[i].cpu().numpy()))
        diff = np.asarray(sorted(sa ^ sb), np.int64)
        if len(diff):
            dist = np.abs(pts[diff] @ pa[i, :3] + pa[i, 3])
            far = np.abs(dist - thresh) > TIE_M
            if far.any():
                raise RuntimeError("plane %d: %d support points differ away from the threshold "
                                   "(distances %s)" % (i, int(far.sum()), dist[far][:5]))
            ties += len(diff)
    log("planes card vs CPU: %d planes, params max abs diff %.3e, %d support points differ "
        "within %.0e m of the threshold" % (len(a), perr, ties, TIE_M))
    return ties


def phase_plane(card: str, seq):
    """13: plane mode on phase 3's loaded scans."""
    import math

    import torch

    from depth_correction_tpu_torch import segmentation as seg
    from depth_correction_tpu_torch.preproc import global_cloud

    cfg = bench_config()
    cfg.nn_type = "plane"
    data, prep_s, launches = prep_counted(cfg, seq, "plane mode")
    if any(launches.values()):
        raise RuntimeError("plane mode's prep launched a kernel: %s" % launches)
    planes = data.neighbors[0]
    gcloud = global_cloud(data.batches[0])
    kw = dict(min_support=cfg.min_valid_neighbors, max_iterations=cfg.num_ransac_iters,
              max_models=cfg.max_neighborhoods or 10, eps=2.0 * math.sqrt(3.0) * cfg.grid_res,
              seed=cfg.random_seed)
    stats = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = seg.fit_planes(gcloud, cfg.ransac_dist_thresh, stats=stats, **kw).orient(gcloud.vps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    if not (torch.equal(again.params, planes.params)
            and torch.equal(again.member_idx, planes.member_idx)):
        raise RuntimeError("plane mode: a second fit on the card differs from prep's planes")
    members = (planes.member_idx >= 0).sum(1).tolist()
    log("plane prep %.3f s (%s): %d planes of %s points; fit again on the card %.3f s: RANSAC "
        "%s ms per model, clustering %.3f s, scoring peak %.1f MiB above the %.1f MiB held"
        % (prep_s, ", ".join("%s %.3f" % kv for kv in data.prep_seconds.items()), len(planes),
           members, fit_s, ", ".join("%.1f" % (1e3 * v) for v in stats["ransac_s"]),
           stats["cluster_s"], peak_mb, base / 2**20))
    cpu = gcloud.to(device="cpu")
    t0 = time.perf_counter()
    cpu_planes = seg.fit_planes(cpu, cfg.ransac_dist_thresh, **kw).orient(cpu.vps)
    cpu_s = time.perf_counter() - t0
    log("the same fit on the CPU: %.3f s" % cpu_s)
    ties = plane_support_ties(planes, cpu_planes, gcloud.get_points(), cfg.ransac_dist_thresh)

    history, launches = fit_counted(cfg, data, "plane mode")
    if any(launches.values()):
        raise RuntimeError("plane mode's steps launched a kernel: %s" % launches)
    step_ms = statistics.median(h[3] for h in history[1:])
    rel, loss64 = w0_rel(cfg, data, history[0][1])
    log("plane mode: %d Adam steps, plane_step_ms %.3f (median of steps 1..%d), losses %s; loss "
        "at w=0 %.9e vs float64 %.9e (rel %.3e) (%s)"
        % (len(history), step_ms, len(history) - 1, ", ".join("%.6e" % h[1] for h in history),
           history[0][1], loss64, rel, card))
    if not rel <= LOSS_REL_BAR:
        raise RuntimeError("plane mode: the loss at w=0 misses the 1e-5 bar: %.3e" % rel)
    profile = profile_calls(adam_step_fn(cfg, data), card, "step")
    return {"prep_s": prep_s, "fit_s": fit_s, "ransac_ms": [1e3 * v for v in stats["ransac_s"]],
            "cluster_s": stats["cluster_s"], "peak_mb": peak_mb, "cpu_fit_s": cpu_s,
            "planes": len(planes), "members": members, "ties": ties, "step_ms": step_ms,
            "loss_rel": rel, "profile": profile}


KITTI360_DRIVE = "2013_05_28_drive_0000_sync"
KITTI360_MAX_EXC_FRAC = 0.25


def write_kitti360(root: str, seq):
    """``seq``'s scans as KITTI-360 drive 0 under ``root``: float32 [x y z
    intensity] velodyne records, cam0_to_world rows (pose @ T_cam2velo)
    and a rigid non-identity cam-to-velo calibration, at full precision.
    Returns (the written float32 records, the poses the loader must give:
    the chain's, with the first pose as the origin)."""
    import numpy as np
    from numpy.lib.recfunctions import structured_to_unstructured as s2u

    scan_dir = os.path.join(root, "data_3d_raw", KITTI360_DRIVE, "velodyne_points", "data")
    os.makedirs(scan_dir)
    os.makedirs(os.path.join(root, "data_poses", KITTI360_DRIVE))
    os.makedirs(os.path.join(root, "calibration"))
    a, b = 0.4, -1.2
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
    calib = np.eye(4)
    calib[:3, :3] = rz @ rx
    calib[:3, 3] = [0.27, -0.08, 1.73]
    fmt = lambda v: " ".join("%.17g" % x for x in v)  # noqa: E731
    with open(os.path.join(root, "calibration", "calib_cam_to_velo.txt"), "w") as f:
        f.write(fmt(calib[:3].ravel()) + "\n")
    records, rows, poses = [], [], []
    for i, (scan, pose) in enumerate(seq):
        rec = np.zeros((len(scan), 4), np.float32)
        rec[:, :3] = s2u(scan[["x", "y", "z"]])
        rec.tofile(os.path.join(scan_dir, "%010d.bin" % i))
        records.append(rec)
        rows.append("%d %s" % (i, fmt((np.asarray(pose) @ calib).ravel())))
        poses.append(np.asarray(pose, np.float64))
    with open(os.path.join(root, "data_poses", KITTI360_DRIVE, "cam0_to_world.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    inv0 = np.linalg.inv(poses[0])
    return records, [inv0 @ p for p in poses]


def phase_kitti360(card: str, seq, small):
    """14: the main path on a KITTI-360 drive made of phase 3's scans, then
    the native KD-tree on phase 5's small scan."""
    import shutil
    import tempfile

    import numpy as np

    from depth_correction_tpu_torch.datasets import create_dataset
    from depth_correction_tpu_torch.datasets import kitti360

    root = tempfile.mkdtemp(prefix="dc_kitti360_")
    try:
        t0 = time.perf_counter()
        records, poses = write_kitti360(root, seq)
        write_s = time.perf_counter() - t0
        name = "kitti360/00_start_0_end_%d_step_1" % len(records)
        raw = kitti360.Dataset(name, path=root)
        pose_err, dropped = 0.0, 0
        for (cloud, pose), rec, want in zip(raw, records, poses):
            x, y = rec[:, 0], rec[:, 1]
            keep = (x < -1.0) | (x > 1.0) | (y < -1.0) | (y > 1.0)
            dropped += int((~keep).sum())
            for c, field in enumerate("xyz"):
                if not np.array_equal(cloud[field], rec[keep, c]):
                    raise RuntimeError("kitti360: scan points differ from the written float32 "
                                       "records")
            pose_err = max(pose_err, float(np.abs(pose - want).max()))
        log("kitti360 drive written in %.3f s (%d scans, %d points, %d dropped by the ego "
            "filter); poses against the calibration chain: max abs diff %.3e"
            % (write_s, len(records), sum(len(r) for r in records), dropped, pose_err))
        if not (pose_err <= 1e-12 and dropped > 0):
            raise RuntimeError("kitti360: poses off by %.3e or no ego point dropped" % pose_err)

        cfg = bench_config()
        cfg.train_names = [name]
        cfg.dataset_kwargs = {"path": root}
        # The scans carry the scene's bias already. A second, synthetic one
        # would estimate normals on the host (the records have none).
        cfg.depth_bias_model_kwargs = {"w": [0.0], "exponent": [4.0]}
        t0 = time.perf_counter()
        drive = LoadedSequence(create_dataset(name, cfg), name)
        load_s = time.perf_counter() - t0
        default = kitti360_default_budget(cfg, drive)
        # In the first pose's frame (the loader's zero_origin) the scene is
        # tilted 0.07 rad against the cells: 7-17% of the rows are exception
        # rows by the span limit, past the 5% at which the build declines.
        cfg.cellwin_max_exc_frac = KITTI360_MAX_EXC_FRAC
        data, prep_s, prep_launches = prep_counted(cfg, drive, "kitti360")
        if min(prep_launches.values()) <= 0:
            raise RuntimeError("kitti360: X2, X3 or P7 was not launched in prep: %s"
                               % prep_launches)
        if data.cellwin[0] is None:
            raise RuntimeError("kitti360: the cellwin build declined (%s)" % data.cellwin_notes)
        history, launches = fit_counted(cfg, data, "kitti360")
        if launches["fwd"] <= 0 or launches["bwd"] <= 0:
            raise RuntimeError("kitti360: K1 or K2 was not launched: %s" % launches)
        check_transposes("kitti360", cfg, data, STEPS, launches)
        step_ms = statistics.median(h[3] for h in history[1:])
        rel, loss64 = w0_rel(cfg, data, history[0][1])
        g = data.cellwin[0]
        log("kitti360 (exception rows up to %.0f%%): load %.3f s, prep %.3f s (launches X2 %d, "
            "X3 %d, P7 %d; cellwin %d rows, %d exception rows), %d Adam steps (K1 %d, K2 %d), "
            "kitti360_step_ms %.3f; loss at w=0 %.9e vs float64 %.9e (rel %.3e) (%s)"
            % (100 * KITTI360_MAX_EXC_FRAC, load_s, prep_s, prep_launches["grid"],
               prep_launches["knn"], prep_launches["gather"], int((g.row_map >= 0).sum()),
               g.n_exc, len(history), launches["fwd"], launches["bwd"], step_ms, history[0][1],
               loss64, rel, card))
        if not rel <= LOSS_REL_BAR:
            raise RuntimeError("kitti360: the loss at w=0 misses the 1e-5 bar: %.3e" % rel)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    native = check_native(*small["native_inputs"], card)
    return {"prep_s": prep_s, "step_ms": step_ms, "loss_rel": rel, "write_s": write_s,
            "load_s": load_s, "prep_launches": prep_launches, "launches": launches,
            "points": sum(len(r) for r in records), "default": default, "native": native}


def kitti360_default_budget(cfg, drive) -> dict:
    """The drive at the default exception-row budget (``cfg`` as given):
    prep, then 8 Adam steps on whichever path the build leaves. A declined
    build must leave the gather path (P7 forward, X4 backward, no K1 or
    K2); a build that holds, K1 and K2 (and X4 for its exception rows).
    The loss at w=0 within 1e-5 of float64 either way."""
    data, prep_s, prep_launches = prep_counted(cfg, drive, "kitti360 (default budget)")
    built = data.cellwin[0] is not None
    history, launches = fit_counted(cfg, data, "kitti360 (default budget)")
    if built and not (launches["fwd"] > 0 and launches["bwd"] > 0):
        raise RuntimeError("kitti360 (default budget): built, but K1 or K2 was not launched: %s"
                           % launches)
    if not built and (launches["fwd"] or launches["bwd"]):
        raise RuntimeError("kitti360 (default budget): declined, but the steps did not take "
                           "the gather path: %s" % launches)
    check_transposes("kitti360 (default budget)", cfg, data, STEPS, launches)
    step_ms = statistics.median(h[3] for h in history[1:])
    rel, loss64 = w0_rel(cfg, data, history[0][1])
    log("kitti360 (default exception-row budget): the cellwin build %s; prep %.3f s, %d Adam "
        "steps on the %s path (K1 %d, K2 %d, P7 %d, X4 %d), step %.3f ms; loss at w=0 %.9e vs "
        "float64 %.9e (rel %.3e)"
        % ("holds" if built else "declined (%s)" % (data.cellwin_notes,), prep_s, len(history),
           "cell-window" if built else "gather", launches["fwd"], launches["bwd"],
           launches["gather"], launches["x4"], step_ms, history[0][1], loss64, rel))
    if not rel <= LOSS_REL_BAR:
        raise RuntimeError("kitti360 (default budget): the loss at w=0 misses the 1e-5 bar: %.3e"
                           % rel)
    return {"built": built, "notes": str(data.cellwin_notes), "prep_s": prep_s,
            "step_ms": step_ms, "loss_rel": rel, "launches": launches}


def check_native(points, keep, r: float, card: str) -> dict:
    """nn_backend = native (the port's build of csrc/dc_native.cpp) on the
    small scan: its within-r sets against X3's on the same float32 points;
    pairs may differ only within TIE_M of r (the KD-tree tests
    float64 distances, X3 float32 ones)."""
    import numpy as np

    from depth_correction_tpu_torch.config import Config
    from depth_correction_tpu_torch.ops.knn import radius_neighbors
    from depth_correction_tpu_torch.preproc import _host_neighbors
    from depth_correction_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.load()
    load_s, build_s = time.perf_counter() - t0, native.BUILD_SECONDS
    cfg = Config()
    cfg.device = DEVICE
    cfg.nn_backend, cfg.nn_r, cfg.nn_k = "native", r, 0
    t0 = time.perf_counter()
    idx_n, _ = _host_neighbors(points, keep, cfg)
    query_s = time.perf_counter() - t0
    k = idx_n.shape[1]
    _, idx_x = radius_neighbors(points, points, r=r, k=k, valid_points=keep, valid_query=keep)
    a, b = idx_n.cpu().numpy(), idx_x.long().cpu().numpy()
    pts = points.detach().cpu().double().numpy()
    ties = 0
    for i in np.flatnonzero(keep.cpu().numpy()):
        sa, sb = set(a[i][a[i] >= 0].tolist()), set(b[i][b[i] >= 0].tolist())
        if sa != sb:
            diff = np.asarray(sorted(sa ^ sb))
            d = np.linalg.norm(pts[diff] - pts[i], axis=1)
            if (np.abs(d - r) > TIE_M).any():
                raise RuntimeError("native: row %d's set differs from X3's away from r" % i)
            ties += len(diff)
    log("native KD-tree: build %.3f s (load %.3f s), query %.3f s on %d points (K %d); sets "
        "equal X3's but %d pairs within %.0e m of r (%s)"
        % (build_s, load_s, query_s, int(keep.sum()), k, ties, TIE_M, card))
    return {"build_s": build_s, "load_s": load_s, "query_s": query_s, "k": k, "ties": ties}


ROOM_QUADS = 41  # quads per side of each face of the room: 6 * 2 * 41^2 = 20,172 triangles
RENDER_POSES = 8
RENDER_CPU_RAYS = 512  # rays per pose cast again on the CPU
RAY_REL_BAR = 1e-5


def write_room_obj(path: str, half: float = 5.0, height: float = 4.0, n: int = None):
    """A box room (floor z = 0), each of its six sides an n x n grid of
    quads split into two triangles, as an OBJ file; returns the count of
    triangles."""
    import numpy as np

    n = n or ROOM_QUADS
    ex, ey, ez = np.eye(3)
    sides = [((-half, -half, 0), 2 * half * ex, 2 * half * ey),
             ((-half, -half, height), 2 * half * ex, 2 * half * ey),
             ((-half, -half, 0), 2 * half * ey, height * ez),
             ((half, -half, 0), 2 * half * ey, height * ez),
             ((-half, -half, 0), 2 * half * ex, height * ez),
             ((-half, half, 0), 2 * half * ex, height * ez)]
    g = np.linspace(0.0, 1.0, n + 1)
    verts, faces = [], []
    for origin, du, dv in sides:
        base = sum(len(v) for v in verts)
        verts.append((np.asarray(origin) + g[:, None, None] * du + g[None, :, None] * dv)
                     .reshape(-1, 3))
        i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        a = base + i * (n + 1) + j
        c = a + n + 1
        faces.append(np.stack([a, c, c + 1], -1).reshape(-1, 3))
        faces.append(np.stack([a, c + 1, a + 1], -1).reshape(-1, 3))
    verts, faces = np.concatenate(verts), np.concatenate(faces)
    with open(path, "w") as f:
        f.write("".join("v %.9g %.9g %.9g\n" % tuple(v) for v in verts))
        f.write("".join("f %d %d %d\n" % tuple(t + 1) for t in faces))
    return len(faces)


def phase_render(card: str):
    """15: RenderedMeshDataset on a generated room at 1,024 x 64 beams."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from numpy.lib.recfunctions import structured_to_unstructured as s2u

    from depth_correction_tpu_torch.datasets.rendered_mesh import RenderedMeshDataset
    from depth_correction_tpu_torch.ops.raycast import raycast_mesh

    root = tempfile.mkdtemp(prefix="dc_render_")
    try:
        path = os.path.join(root, "room.obj")
        n_faces = write_room_obj(path)
        ds = RenderedMeshDataset(path, n_poses=RENDER_POSES, h_beams=1024, v_beams=64,
                                 device=DEVICE)
        verts, faces = ds.mesh_tensors()
        t0 = time.perf_counter()
        clouds = [ds.local_cloud(i) for i in ds.ids]
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        rays = 1024 * 64
        hits = [len(c) for c in clouds]
        for c, i in zip(clouds, ds.ids):
            pose = ds.cloud_pose(i)
            world = s2u(c[["x", "y", "z"]]) @ pose[:3, :3].T + pose[:3, 3]
            if not (np.abs(world[:, :2]).max() <= 5.0 + 1e-3
                    and world[:, 2].min() >= -1e-3 and world[:, 2].max() <= 4.0 + 1e-3):
                raise RuntimeError("render: a point of pose %d lies outside the room" % i)
        if min(hits) < 0.9 * rays:
            raise RuntimeError("render: too few hits %s of %d rays" % (hits, rays))
        o, d = ds.rays(0)
        raycast_ms = cuda_ms(lambda: raycast_mesh(o, d, verts, faces, t_max=ds.max_range),
                             reps=2, warmup=1)

        def render_pose():
            ds._cache.pop(0, None)
            ds.local_cloud(0)

        profile = profile_calls(render_pose, card, "pose", n=1)
        # The CPU twin on a stride of each pose's rays (a ray's result does
        # not depend on the rays cast beside it).
        stride = rays // RENDER_CPU_RAYS
        cpu_mesh = verts.cpu(), faces.cpu()
        worst, ties, t_cpu = 0.0, 0, 0.0
        for i in ds.ids:
            o, d = (x[::stride] for x in ds.rays(i))
            tc, trc = (x.cpu() for x in raycast_mesh(o, d, verts, faces, t_max=ds.max_range))
            t1 = time.perf_counter()
            t_ref, tri_ref = raycast_mesh(o.cpu(), d.cpu(), *cpu_mesh, t_max=ds.max_range)
            t_cpu += time.perf_counter() - t1
            if not torch.equal(torch.isinf(tc), torch.isinf(t_ref)):
                raise RuntimeError("render: hits differ between the card and the CPU")
            fin = torch.isfinite(t_ref)
            rel = ((tc[fin].double() - t_ref[fin].double()).abs() / t_ref[fin].double()).max()
            worst = max(worst, float(rel))
            ties += int((trc != tri_ref).sum())
        log("render: %d triangles, %d poses x %d rays in %.3f s (hits per pose %s); raycast_ms "
            "%.3f per pose (device, pose 0), device busy %.1f%% of a pose's "
            "render; %d rays a pose on the CPU (%.3f s): t max rel %.3e, %d near-ties on another "
            "triangle (%s)"
            % (n_faces, RENDER_POSES, rays, render_s, hits, raycast_ms,
               100.0 * profile["busy_ms"] / profile["wall_ms"], RENDER_CPU_RAYS, t_cpu, worst,
               ties, card))
        if not worst <= RAY_REL_BAR:
            raise RuntimeError("render: t differs by %.3e relative between the card and the CPU"
                               % worst)
        if ties > RENDER_POSES * RENDER_CPU_RAYS // 100:
            raise RuntimeError("render: %d rays hit another triangle on the CPU" % ties)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"faces": n_faces, "render_s": render_s, "raycast_ms": raycast_ms,
            "profile": profile, "t_rel": worst, "ties": ties, "cpu_s": t_cpu,
            "hits": hits}


# Phases 16-17: SLAM evaluation and the analysis modules.
SLAM_ITERS = 8
SLAM_INLIER_RATIO = 0.8  # slam_odometry's and slam_mapper's default
# Odometry noise of the prior (variances: rx ry rz in rad^2, tx ty tz in m^2):
# about 2 mrad and 5 mm a scan.
SLAM_ODOM_COV = [4e-6] * 3 + [2.5e-5] * 3
SLAM_POSE_M_BAR = 1e-4  # m, float32 on the card against float64 plain
SLAM_POSE_RAD_BAR = 1e-5  # rad
LANDSCAPE_WEIGHTS = 21
JOINT_STEPS = 4
GT_MAP_DENSITY_MULT = 0.25  # the ground-truth map at a quarter of the scene's density


def pose_differences(a, b) -> tuple:
    """(largest translation difference in m, largest rotation angle in rad)
    between two (S, 4, 4) trajectories, in float64. The angle is the norm
    of the relative rotation's axis-angle (by its quaternion): arccos of the
    trace, the metric's angle, reads a float32 rotation's departure from
    orthonormality (~1e-7) as ~5e-4 rad."""
    import torch

    from depth_correction_tpu_torch.ops.se3 import delta_transform, matrix_to_xyz_axis_angle

    d = delta_transform(torch.as_tensor(a, dtype=torch.float64),
                        torch.as_tensor(b, dtype=torch.float64))
    return (float(d[:, :3, 3].norm(dim=1).max()),
            float(matrix_to_xyz_axis_angle(d)[:, 3:].norm(dim=1).max()))


def mean_errors(gt, est) -> tuple:
    """(mean translation error m, mean rotation error rad) of ``est``."""
    import torch

    from depth_correction_tpu_torch.metrics import localization_errors

    a, t, _, _ = localization_errors(torch.as_tensor(gt, dtype=torch.float64),
                                     torch.as_tensor(est, dtype=torch.float64))
    return float(t.mean()), float(a.mean())


def x3_k1_entry(points, query, valid, card: str, held: bool = False) -> dict:
    """X3 at k = 1 with no radius on one call's inputs (its nearest search):
    events and the profiler's kernel time, the plain twin's events, and the
    tiles each warp read (the kernel's tally) over all (warp, tile) pairs,
    against the all-pairs bound (every query against every valid point)
    and the bytes bound (points, queries and results once). With ``held``,
    the distances and indices are held bit for bit to the plain twin's."""
    import math

    import torch

    from depth_correction_tpu_torch.ops import _kernels, knn

    def call():
        return knn.nearest_neighbors(points, query, 1, None, valid)

    n, q = points.shape[0], query.shape[0]
    nv = int(valid.sum())
    b = bound(n * 13 + q * 12 + q * 8, {"fp32": PAIR_OPS * q * nv})
    tally = torch.zeros(((q + 31) // 32,), dtype=torch.int32, device=points.device)
    before = _kernels.KNN_NEAREST_LAUNCHES
    _kernels.launch_knn_brute(query.contiguous(), None, points.contiguous(), valid, math.inf, 1,
                              tally=tally)
    if _kernels.KNN_NEAREST_LAUNCHES != before + 1:
        raise RuntimeError("X3 k = 1 did not take its nearest search")
    n_tiles = -(-n // 128)
    out = {"points": n, "queries": q, "valid_points": nv, "ms": cuda_ms(call, reps=5, warmup=1),
           "kernel_ms": kernel_ms(call, DEVICE, 3), "bound_ms": b[0], "bound_by": b[1],
           "bytes_bound_ms": (n * 13 + q * 12 + q * 8) / HBM_BYTES_PER_S * 1e3,
           "tiles_per_warp": float(tally.double().mean()),
           "pair_share": float(tally.double().sum()) / (tally.numel() * n_tiles),
           "plain_ms": cuda_ms(lambda: knn.nearest_neighbors(points, query, 1, None, valid,
                                                             plain=True), reps=1, warmup=0)}
    if held:
        dist, nidx = call()
        pdist, pidx = knn.nearest_neighbors(points, query, 1, None, valid, plain=True)
        if not (torch.equal(nidx, pidx) and bit_equal(dist, pdist)):
            raise RuntimeError("X3's nearest search differs from the plain twin")
    return out


def street_map_entry(card: str) -> dict:
    """X3 k = 1 at a street-sized map: box_seq50's scan 24 (~115k queries)
    against its scans 0-23 merged at 0.1 m voxels (the first point of a
    voxel kept, ~446k rows: slam_mapper's map before it fills), in the
    world frame at ground truth, from the benchmark's street."""
    import numpy as np
    import torch

    from benchmark.street import street
    from depth_correction_tpu_torch.ops.filters import grid_first_mask

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "configs",
                           "box_seq50.json")) as f:
        scene = json.load(f)["scene"]
    scans = street(scene, 2 ** 32 + 977, DEVICE, ids=range(25))

    def world(scan):
        xyz, T = scan
        p = np.stack([xyz["x"], xyz["y"], xyz["z"]], 1) @ T[:3, :3].T + T[:3, 3]
        return torch.as_tensor(p, dtype=torch.float32, device=DEVICE)

    pts = torch.cat([world(x) for x in scans[:24]])
    ones = torch.ones(len(pts), dtype=torch.bool, device=DEVICE)
    keep, bad = grid_first_mask(pts, 0.1, ones)
    pts = pts[keep].contiguous()
    return x3_k1_entry(pts, world(scans[24]), ones[:len(pts)], card, held=True)


# X6's float operations an inlier: r (3 subtractions, 3 products, 2 sums)
# and J's cross product (6 products, 3 subtractions) in float32; the 21 + 6
# products and sums of H and g and the sum of |r| in float64.
X6_F32_OPS, X6_F64_OPS = 17, 2 * 27 + 1


def x6_entry(src, tgt, T0, card: str) -> dict:
    """X6 on one registration's first step: X3's (d2, idx) of the source
    placed by the prior in the target, then the step against its plain
    twin on the same float32 inputs and in float64 (the threshold and the
    inliers bit-equal to both; T within 2e-6 of the float64 twin, as the
    card test asks), its events and profiler time, the float32 twin's, and
    the bound: each row's d2, idx, validity and placed point and each
    inlier's target point and normal once."""
    import torch

    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.ops.icp import icp_update, icp_update_plain
    from depth_correction_tpu_torch.ops.knn import knn_d2
    from depth_correction_tpu_torch.ops.reduce import masked_quantile
    from depth_correction_tpu_torch.ops.se3 import transform_points

    T = torch_tensor(T0, src.depth)
    pts = transform_points(T, src.get_points())
    tgt_pts = tgt.get_points()
    d2, idx = knn_d2(tgt_pts, pts, k=1, valid_points=tgt.valid)
    x = {"T": T, "d2": d2[:, 0].contiguous(), "idx": idx[:, 0].contiguous(), "src_pts": pts,
         "src_valid": src.valid, "tgt_pts": tgt_pts, "tgt_normals": tgt.normals}
    x64 = {k: (v.double() if v.is_floating_point() else v) for k, v in x.items()}
    stats = torch.empty(_kernels.ICP_STATS, dtype=torch.float64, device=pts.device)
    before = _kernels.ICP_SOLVE_LAUNCHES
    T6, err6 = icp_update(*x.values(), SLAM_INLIER_RATIO, stats=stats)
    launches = _kernels.ICP_SOLVE_LAUNCHES - before
    T32, _ = icp_update_plain(*x.values(), SLAM_INLIER_RATIO)
    T64, _ = icp_update_plain(*x64.values(), SLAM_INLIER_RATIO)
    stats = stats.cpu()
    ok = (x["idx"] >= 0) & x["src_valid"]
    thr = {}
    for name, d2_ in (("f32", x["d2"]), ("f64", x64["d2"])):
        d = torch.sqrt(d2_)
        t = masked_quantile(d, ok, SLAM_INLIER_RATIO)
        thr[name] = (float(t), int((ok & (d <= t)).sum()))
    gap64 = float((T6.double() - T64).abs().max())
    gap32 = float((T6.double() - T32.double()).abs().max())
    inliers = int(stats[28])
    res = {"rows": int(pts.shape[0]), "targets": int(tgt_pts.shape[0]), "ok_rows": int(stats[29]),
           "inliers": inliers, "thr": float(stats[30]), "thr_f32_twin": thr["f32"][0],
           "inliers_f32_twin": thr["f32"][1], "thr_f64_twin": thr["f64"][0],
           "inliers_f64_twin": thr["f64"][1], "T_gap_f64_twin": gap64, "T_gap_f32_twin": gap32,
           "err": float(err6), "launches_one_step": launches}
    # float32: the kernel's threshold is the float32 twin's bit for bit;
    # the float64 twin's rounds the float32 value of the same order
    # statistics, so its inliers are the same rows.
    if not (res["thr"] == res["thr_f32_twin"] and inliers == res["inliers_f32_twin"]
            and inliers == res["inliers_f64_twin"] and int(stats[29]) == int(ok.sum())
            and launches == 1):
        raise RuntimeError("X6 differs from its twins' gate: %s" % res)
    if not gap64 <= 2e-6:
        raise RuntimeError("X6's T is %.3e from the float64 twin's (2e-6 asked)" % gap64)

    def call():
        return icp_update(*x.values(), SLAM_INLIER_RATIO)

    b = bound(pts.shape[0] * (4 + 4 + 1 + 12) + inliers * 24,
              {"fp32": X6_F32_OPS * inliers, "fp64": X6_F64_OPS * inliers})
    res.update(ms=cuda_ms(call, reps=20), kernel_ms=kernel_ms(call, DEVICE, 10),
               plain_ms=cuda_ms(lambda: icp_update_plain(*x.values(), SLAM_INLIER_RATIO),
                                reps=20),
               bound_ms=b[0], bound_by=b[1])
    log("slam: X6 on the mapper's last registration (%d rows, %d targets): %d inliers at "
        "threshold %.9g (both twins' inliers equal); T %.3e from the float64 twin, %.3e from "
        "the float32 twin; %.4f ms (kernel %.4f), plain %.4f ms, bound %.5f ms (%s) (%s)"
        % (res["rows"], res["targets"], inliers, res["thr"], gap64, gap32, res["ms"],
           res["kernel_ms"], res["plain_ms"], res["bound_ms"], res["bound_by"], card))
    return res


def first_iteration_differ(pairs, plain_pairs) -> float:
    """Share of the float32 run's first-iteration 1-NN correspondences (X3)
    whose target point lies more than 1 mm from the float64 plain run's:
    another point of the map (points, not indices: the two mappers' maps
    may hold the same voxels in other rows; the same point moves by the
    runs' pose difference, ~1e-5 m), over the registrations' (source,
    target, prior) of each."""
    from depth_correction_tpu_torch.ops import knn
    from depth_correction_tpu_torch.ops.se3 import transform_points

    differ = total = 0
    for (src, tgt, T0), (src64, tgt64, T064) in zip(pairs, plain_pairs):
        q = transform_points(torch_tensor(T0, src.depth), src.get_points())
        q64 = transform_points(torch_tensor(T064, src64.depth), src64.get_points())
        _, i32 = knn.nearest_neighbors(tgt.get_points(), q, 1, None, tgt.valid)
        _, i64 = knn.nearest_neighbors(tgt64.get_points(), q64, 1, None, tgt64.valid, plain=True)
        p32 = tgt.get_points()[i32[:, 0].long()].double()
        p64 = tgt64.get_points()[i64[:, 0].long()]
        differ += int(((p32 - p64).norm(dim=1) > 1e-3).sum())
        total += i32.shape[0]
    return differ / max(total, 1)


def torch_tensor(T, like):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(T), dtype=like.dtype, device=like.device)


def run_slam(fn, clouds, odom, label: str, plain: bool = False) -> dict:
    """``fn`` (slam_odometry or slam_mapper) over the clouds with the launch
    counts zeroed just before and read just after, each registration's
    (source, target, prior) recorded: (poses, ms a registered scan, X3
    launches, the registrations)."""
    import torch

    from depth_correction_tpu_torch import slam_eval
    from depth_correction_tpu_torch.ops import _kernels

    regs = []
    align = slam_eval.icp_align

    def recording(source, target, T0=None, **kw):
        regs.append((source, target, T0))
        return align(source, target, T0=T0, **kw)

    slam_eval.icp_align = recording
    try:
        reset_all_launch_counts()
        t0 = time.perf_counter()
        est = fn(clouds, odom, n_iters=SLAM_ITERS, plain=plain)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (len(clouds) - 1)
    finally:
        slam_eval.icp_align = align
    launches = {"knn": _kernels.KNN_LAUNCHES, "icp": _kernels.ICP_SOLVE_LAUNCHES,
                "grid": _kernels.GRID_LAUNCHES, "gather": _kernels.GATHER_LAUNCHES}
    return {"est": est, "ms": ms, "launches": launches, "regs": regs}


def phase_slam(card: str, seq, cfg, model):
    """16: SLAM evaluation on phase 3's scans, corrected by its model."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from depth_correction_tpu_torch import datasets
    from depth_correction_tpu_torch.eval import eval_slam_all
    from depth_correction_tpu_torch.slam_eval import (icp_align, perturb_odometry,
                                                      run_external_slam, slam_clouds,
                                                      slam_mapper, slam_odometry)

    reset_all_launch_counts()
    t0 = time.perf_counter()
    clouds, gt = slam_clouds(seq, cfg, model)
    torch.cuda.synchronize()
    log("slam: %d corrected feature clouds (%s valid points; model %s) in %.3f s; launches "
        "X2 %d, X3 %d, P7 %d" % (len(clouds), ", ".join(str(int(c.valid.sum())) for c in clouds),
                                 model, time.perf_counter() - t0, _kernels_count("GRID_LAUNCHES"),
                                 _kernels_count("KNN_LAUNCHES"), _kernels_count("GATHER_LAUNCHES")))
    odom = perturb_odometry(gt, SLAM_ODOM_COV, seed=cfg.random_seed)
    prior_t, prior_r = mean_errors(gt, odom)
    log("slam: the prior's drift: mean translation error %.6f m, rotation %.6f rad"
        % (prior_t, prior_r))

    runs, profiles = {}, {}
    for name, fn in (("odometry", slam_odometry), ("mapper", slam_mapper)):
        run = runs[name] = run_slam(fn, clouds, odom, "slam_%s" % name)
        want = SLAM_ITERS * (len(clouds) - 1)
        if run["launches"] != {"knn": want, "icp": want, "grid": 0, "gather": 0}:
            raise RuntimeError("slam_%s launched %s, not X3 and X6 %d times each alone"
                               % (name, run["launches"], want))
        src, tgt, T0 = run["regs"][-1]
        profiles[name] = profile_calls(
            lambda: icp_align(src, tgt, T0=T0, n_iters=SLAM_ITERS), card, "scan")
        t_err, r_err = mean_errors(gt, run["est"])
        log("slam_%s_ms_per_scan %.3f (%d registrations, X3 %d launches); mean translation "
            "error %.6f m, rotation %.6f rad (%s)" % (name, run["ms"], len(run["regs"]),
                                                      run["launches"]["knn"], t_err, r_err, card))
    src, tgt, T0 = runs["mapper"]["regs"][-1]
    from depth_correction_tpu_torch.ops.se3 import transform_points

    last = x3_k1_entry(tgt.get_points(), transform_points(torch_tensor(T0, src.depth),
                                                          src.get_points()), tgt.valid, card,
                       held=True)
    street = street_map_entry(card)
    for label, e in (("the mapper's last registration", last), ("a street-sized map", street)):
        log("slam: X3 k = 1 at %s: map of %d points, %d queries; %.4f ms (kernel %.4f; plain "
            "%.1f), all-pairs bound %.4f ms (%s), bytes bound %.4f ms; "
            "%.2f tiles a warp, pair share %.5f (%s)"
            % (label, e["points"], e["queries"], e["ms"], e["kernel_ms"], e["plain_ms"],
               e["bound_ms"], e["bound_by"], e["bytes_bound_ms"],
               e["tiles_per_warp"], e["pair_share"], card))
    x6 = x6_entry(src, tgt, T0, card)

    # float64 on the plain path: the same clouds and priors.
    clouds64 = [c.to(dtype=torch.float64) for c in clouds]
    diffs = {}
    for name, fn in (("odometry", slam_odometry), ("mapper", slam_mapper)):
        t1 = time.perf_counter()
        ref = run_slam(fn, clouds64, odom, "slam_%s float64" % name, plain=True)
        if ref["launches"]["knn"] or ref["launches"]["icp"]:
            raise RuntimeError("the float64 plain run launched X3 or X6")
        dm, dr = pose_differences(runs[name]["est"], ref["est"])
        share = first_iteration_differ(runs[name]["regs"], ref["regs"])
        diffs[name] = {"m": dm, "rad": dr, "first_iter_differ": share,
                       "seconds": time.perf_counter() - t1}
        log("slam_%s against float64 plain: largest pose difference %.3e m, %.3e rad; %.3e of "
            "first-iteration correspondences differ (%.1f s)" % (name, dm, dr, share,
                                                                 diffs[name]["seconds"]))
        if not (dm <= SLAM_POSE_M_BAR and dr <= SLAM_POSE_RAD_BAR):
            raise RuntimeError("slam_%s misses the float64 bars (1e-4 m, 1e-5 rad): %.3e m, "
                               "%.3e rad" % (name, dm, dr))
    mapper_t = mean_errors(gt, runs["mapper"]["est"])[0]
    if not mapper_t < prior_t:
        raise RuntimeError("the mapper's drift %.6f m is not below the prior's %.6f m"
                           % (mapper_t, prior_t))

    # End to end: eval_slam_all on the sequence (the loaded scans stand in
    # for create_dataset of the same name), then the external route.
    root = tempfile.mkdtemp(prefix="dc_slam_")
    create = datasets.create_dataset
    try:
        ecfg = cfg.copy()
        ecfg.log_dir = root
        ecfg.train_names, ecfg.val_names, ecfg.test_names = [], [], [str(seq)]
        ecfg.eval_slams = ["icp_mapper", "icp_odometry"]
        ecfg.model_kwargs = {"w": model.w.detach().cpu().tolist(),
                             "exponent": model.exponent.detach().cpu().tolist()}
        datasets.create_dataset = (lambda name, c, *a, **kw: seq if name == str(seq)
                                   else create(name, c, *a, **kw))
        reset_all_launch_counts()
        t1 = time.perf_counter()
        results = eval_slam_all(ecfg)
        e2e_s = time.perf_counter() - t1
        rows = {}
        for slam in ecfg.eval_slams:
            with open(os.path.join(root, "slam_eval_%s_test.csv" % slam)) as f:
                rows[slam] = [line.split() for line in f]
            if len(rows[slam]) != 1 or len(rows[slam][0]) != 5:
                raise RuntimeError("slam_eval_%s_test.csv: %s" % (slam, rows[slam]))
        log("eval_slam_all: %.3f s; %s (%s)" % (e2e_s, "; ".join(
            " ".join(r[0]) for r in rows.values()), card))

        ecfg.slam = "norlab_icp_mapper"
        ecfg.slam_command = "%s %s {input_dir} {poses_csv} --drift 0" % (
            sys.executable, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                         "stub_slam_mapper.py"))
        t1 = time.perf_counter()
        ext = run_external_slam(ecfg, str(seq), clouds, odom)
        ext_s = time.perf_counter() - t1
        if ext.shape != (len(clouds), 4, 4) or not np.allclose(ext, odom, atol=1e-6):
            raise RuntimeError("the external route read back %s" % (ext.shape,))
        log("external route (scripts/stub_slam_mapper.py, no drift): %d poses read back, "
            "%.3f s" % (len(ext), ext_s))
    finally:
        datasets.create_dataset = create
        shutil.rmtree(root, ignore_errors=True)
    return {"odometry_ms": runs["odometry"]["ms"], "mapper_ms": runs["mapper"]["ms"],
            "launches": sum(r["launches"]["knn"] for r in runs.values()),
            "x6_launches": sum(r["launches"]["icp"] for r in runs.values()),
            "profiles": profiles, "last": last, "street": street, "x6": x6, "diffs": diffs,
            "prior_t": prior_t,
            "mapper_t": mapper_t, "odometry_t": mean_errors(gt, runs["odometry"]["est"])[0],
            "e2e_s": e2e_s}


def _kernels_count(attr: str) -> int:
    from depth_correction_tpu_torch.ops import _kernels

    return getattr(_kernels, attr)


def phase_analysis(card: str, data, cfg):
    """17: the loss landscape and joint learning on phase 3's slice."""
    import numpy as np
    import torch

    from depth_correction_tpu_torch.experiments import (joint_learning, synthetic_gt_map,
                                                        synthetic_gt_positions)
    from depth_correction_tpu_torch.loss_landscape import sweep_weight
    from depth_correction_tpu_torch.metrics import mapping_accuracy
    from depth_correction_tpu_torch.models import load_model
    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.preproc import global_cloud

    weights = np.linspace(-0.005, 0.005, LANDSCAPE_WEIGHTS)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    _, losses = sweep_weight(cfg, data, weights)
    landscape_ms = (time.perf_counter() - t0) * 1e3 / LANDSCAPE_WEIGHTS
    launches = {"fwd": cw.FWD_LAUNCHES, "bwd": cw.BWD_LAUNCHES}
    if launches != {"fwd": LANDSCAPE_WEIGHTS, "bwd": 0}:
        raise RuntimeError("sweep_weight launched K1 %d and K2 %d times"
                           % (launches["fwd"], launches["bwd"]))
    t1 = time.perf_counter()
    _, losses64 = sweep_weight(cfg, data.to(dtype=torch.float64), weights, plain=True)
    plain_s = time.perf_counter() - t1
    rels = [abs(losses[i] - losses64[i]) / abs(losses64[i])
            for i in (0, LANDSCAPE_WEIGHTS // 2, LANDSCAPE_WEIGHTS - 1)]
    log("landscape: %d weights in [%g, %g], K1 %d launches, K2 %d; argmin w = %g (float64 "
        "plain: %g, %.1f s); loss rel err at the first, middle and last weight %s; "
        "landscape_ms_per_weight %.3f (%s)"
        % (LANDSCAPE_WEIGHTS, weights[0], weights[-1], launches["fwd"], launches["bwd"],
           weights[np.argmin(losses)], weights[np.argmin(losses64)], plain_s,
           ", ".join("%.3e" % r for r in rels), landscape_ms, card))
    if not max(rels) <= LOSS_REL_BAR:
        raise RuntimeError("the landscape misses the 1e-5 bar: %s" % rels)
    if np.argmin(losses) != np.argmin(losses64):
        raise RuntimeError("the landscape's argmin differs from float64's")

    # Joint learning: sequence deltas, a synthetic ground-truth map and
    # positions (the open box's poses do not depend on its density, so the
    # positions come from a sparse copy of the scene).
    name = cfg.train_names[0]
    jcfg = cfg.copy()
    jcfg.pose_correction = "sequence"
    jcfg.n_opt_iters = JOINT_STEPS
    t1 = time.perf_counter()
    gt_map = synthetic_gt_map(name, jcfg, density_mult=GT_MAP_DENSITY_MULT)
    sparse = name.rsplit("density_", 1)[0] + "density_10"
    gt_xyz = synthetic_gt_positions(sparse, jcfg)
    gt_s = time.perf_counter() - t1
    batch = data.batches[0]
    if not np.allclose(gt_xyz, batch.poses[:, :3, 3].double().cpu().numpy(), atol=1e-5):
        raise RuntimeError("the sparse scene's positions differ from the slice's poses")
    # The first probe's map accuracy on float64 plain: the same global cloud.
    with torch.no_grad():
        g = global_cloud(batch, model=load_model(cfg=jcfg))
        pts = g.get_points()
        gt_t = torch.as_tensor(gt_map, dtype=pts.dtype, device=pts.device)
        acc64 = float(mapping_accuracy(pts.double(), gt_t.double(), 0.8, valid_cloud=g.valid,
                                       plain=True))
        x3 = x3_k1_entry(gt_t, pts, torch.ones(len(gt_t), dtype=torch.bool,
                                               device=pts.device), card)
    reset_all_launch_counts()
    t1 = time.perf_counter()
    hist = joint_learning(jcfg, gt_map=gt_map, gt_positions=gt_xyz, metrics_every=2, data=data)
    torch.cuda.synchronize()
    joint_ms = (time.perf_counter() - t1) * 1e3 / JOINT_STEPS
    launches = {"fwd": cw.FWD_LAUNCHES, "bwd": cw.BWD_LAUNCHES}
    acc_rel = abs(hist.map_accuracy[0] - acc64) / abs(acc64)
    log("joint: %d steps, K1 %d and K2 %d launches; rows %s; the first probe's map accuracy "
        "%.9e vs float64 plain %.9e (rel %.3e); joint_step_ms %.3f (wall a step, probes "
        "included); gt map %d points (%.1f s to make); X3 in mapping_accuracy %.4f ms (kernel "
        "%.4f), all-pairs bound %.4f ms (%s; %d queries) (%s)"
        % (JOINT_STEPS, launches["fwd"], launches["bwd"],
           list(zip(hist.iters, hist.train_loss, hist.pose_l2, hist.map_accuracy)),
           hist.map_accuracy[0], acc64, acc_rel, joint_ms, len(gt_map), gt_s, x3["ms"],
           x3["kernel_ms"], x3["bound_ms"], x3["bound_by"], x3["queries"], card))
    if launches != {"fwd": JOINT_STEPS, "bwd": JOINT_STEPS}:
        raise RuntimeError("joint_learning: K1 / K2 not once a step: %s" % launches)
    if hist.iters != [0, 2, 3] or not np.isfinite(hist.map_accuracy).all():
        raise RuntimeError("joint_learning's history: %s" % hist)
    if not acc_rel <= LOSS_REL_BAR:
        raise RuntimeError("map accuracy misses the 1e-5 bar: %.3e" % acc_rel)
    return {"landscape_ms": landscape_ms, "landscape_rel": max(rels), "joint_ms": joint_ms,
            "map_acc_rel": acc_rel, "gt_map_points": len(gt_map), "x3_map": x3}


# ---------------------------------------------------------------------------
# Phase 18: multi-GPU (depth_correction_tpu_torch/parallel)

REHEARSAL_RANKS = 4
DIST_REL_BAR = 1e-6  # a one-rank group against phase 3's ungrouped run
MULTI_REL_BAR = 1e-5  # ranks on several cards (sums in another order)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def max_rel_diff(a, b) -> float:
    """Largest |a - b| over the largest |b|, 0.0 for equal sequences."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def sharded_step_fn(cfg, data):
    """One Adam step of the sharded loss on the rank's ``data``, the
    gradient all-reduced (what train.fit does under a mesh)."""
    from depth_correction_tpu_torch.models import load_model
    from depth_correction_tpu_torch.parallel import make_sharded_loss_fn
    from depth_correction_tpu_torch.parallel.collectives import all_reduce_grads
    from depth_correction_tpu_torch.train import make_optimizer

    model = load_model(cfg=cfg)
    loss_fn = make_sharded_loss_fn(cfg, data.mesh)
    opt = make_optimizer(cfg, [model.w])

    def step():
        opt.zero_grad()
        loss_fn(model, data).backward()
        all_reduce_grads([model.w], data.mesh)
        opt.step()

    return step


def dist_train(cfg, seq, n: int, rank: int, port: int, log_dir: str, card: str = None,
               single=None):
    """train() over a group of ``n`` NCCL ranks at tcp://127.0.0.1:<port>
    through the dist_* options (prep under the mesh), every rank with
    ``log_dir`` (rank 0 writes there); with ``card``, then three profiled
    sharded steps on the rank's data, and the sharded step timed in turns
    with the ungrouped step on ``single`` (the same slice prepared without
    a group); destroys the group.

    :return: (losses, w each step starts from, the median step_ms of steps
        1.. from rank 0's train_history.csv (None on other ranks),
        launches, the rank's resident bytes, the rank's table sizes,
        {"profile", "turns": (ungrouped ms, sharded ms)} or None, the
        rank's peak device bytes over train(), prep under the mesh
        included).
    """
    import torch
    import torch.distributed as dist

    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.parallel import resident_bytes
    from depth_correction_tpu_torch.train import TrainCallbacks, train

    cfg.dist_coordinator = "127.0.0.1:%d" % port
    cfg.dist_num_processes, cfg.dist_process_id = n, rank
    cfg.log_dir = log_dir

    class Record(TrainCallbacks):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.w, self.losses, self.bytes, self.sizes, self.data = {}, {}, None, None, None

        def train_inputs(self, it, data):
            self.data = data
            g = data.cellwin[0]
            self.bytes = resident_bytes(data)
            self.sizes = {"points_a_scan": data.batches[0].cloud.depth.shape[1],
                          "row_tiles": g.f_start.shape[0] if g is not None else 0,
                          "point_tiles": g.b_start.shape[0] if g is not None else 0,
                          "ranks": data.mesh.size}

        def train_loss(self, it, model, pose_deltas, loss):
            self.w[it] = float(model.w.detach()[0])
            self.losses[it] = float(loss.detach())

    reset_all_launch_counts()
    rec = Record(cfg)
    extra = step_ms = None
    try:
        torch.cuda.reset_peak_memory_stats()
        if train(cfg, callbacks=rec, train_datasets=[seq]) is None:
            raise RuntimeError("rank %d: train() saved no best model" % rank)
        peak = torch.cuda.max_memory_allocated()
        if rank == 0:
            with open(os.path.join(log_dir, "train_history.csv")) as f:
                f.readline()
                rows = [line.split() for line in f]
            step_ms = statistics.median(float(r[3]) for r in rows[1:])
        launches = {"fwd": cw.FWD_LAUNCHES, "bwd": cw.BWD_LAUNCHES,
                    "grid": _kernels.GRID_LAUNCHES, **transpose_launches()}
        check_transposes("rank %d of %d" % (rank, n), cfg, rec.data, len(rec.losses), launches)
        if card is not None:
            log("the sharded step on the rank's tables, profiled:")
            sharded = sharded_step_fn(cfg, rec.data)
            extra = {"profile": profile_calls(sharded, card, "step")}
            log("the ungrouped step and the sharded step, in turns (CUDA events, 10 steps):")
            extra["turns"] = in_turns(adam_step_fn(cfg, single), sharded, reps=10)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return ([rec.losses[i] for i in sorted(rec.losses)], [rec.w[i] for i in sorted(rec.w)],
            step_ms, launches, rec.bytes, rec.sizes, extra, peak)


def rehearse_x2(g, r: float, k: int, size: int):
    """X2 on each of ``size`` ranks' query slices of the global cloud
    (``parallel.collectives.query_slice``, as grid_radius_neighbors_sharded
    splits them), joined, against one launch over every query."""
    from types import SimpleNamespace

    import torch

    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.ops.grid_hash import grid_radius_neighbors
    from depth_correction_tpu_torch.parallel.collectives import query_slice

    pts, valid = g.get_points().contiguous(), g.valid
    d1, i1 = grid_radius_neighbors(pts, r=r, k=k, valid_points=valid, valid_query=valid)
    before = _kernels.GRID_LAUNCHES
    parts = []
    for rank in range(size):
        lo, hi, _ = query_slice(pts.shape[0], SimpleNamespace(rank=rank, size=size))
        parts.append(grid_radius_neighbors(pts, pts[lo:hi].contiguous(), r=r, k=k,
                                           valid_points=valid, valid_query=valid[lo:hi]))
    launches = _kernels.GRID_LAUNCHES - before
    d4, i4 = torch.cat([x[0] for x in parts]), torch.cat([x[1] for x in parts])
    idx_equal = bool((d4.shape == d1.shape) and (i4 == i1).all())
    d_diff = float((d4 - d1).abs().nan_to_num(0.0).max()) if d4.numel() else 0.0
    return {"launches": launches, "idx_equal": idx_equal,
            "d_equal": bool(idx_equal and ((d4 == d1) | (d4.isinf() & d1.isinf())).all()),
            "d_max_abs_diff": d_diff, "queries": int(pts.shape[0]), "k": k}


def phase_multi_gpu(card: str, res: dict, seq):
    """18: (a) phase 3's slice trained through train() over a one-rank
    NCCL group (the dist_* options; prep under the mesh), held to phase
    3's run; (b) the sharded step's per-rank launches for 4 ranks rehearsed
    in one process on phase 3's graph (K1 on each rank's row tiles with
    the padding tiles, K2 on each rank's point tiles against the joined
    cotangent table, X2 on each rank's query slice), held to the single
    launches bit for bit; (c) with two cards or more, one NCCL rank a card
    through the same route, held to phase 3 within 1e-5."""
    import torch

    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.ops.features import _cotangent_table
    from depth_correction_tpu_torch.ops.knn import suggest_k_max
    from depth_correction_tpu_torch.parallel import resident_bytes
    from depth_correction_tpu_torch.parallel.cellwin_shard import rehearse
    from depth_correction_tpu_torch.preproc import global_cloud

    import shutil
    import tempfile

    out = {}
    # (a) One rank of NCCL at the slice's full width.
    log_dir = tempfile.mkdtemp(prefix="dc_dist1_")
    try:
        losses, ws, step_ms, launches, nbytes, sizes, extra, peak = dist_train(
            bench_config(), seq, 1, 0, free_port(), log_dir, card, res["data"])
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    profile, turns = extra["profile"], extra["turns"]
    loss_rel, w_rel = max_rel_diff(losses, res["losses"]), max_rel_diff(ws, res["w"])
    log("18(a) one-rank NCCL group, %d Adam steps: losses %s (%s)" % (
        len(losses), ", ".join("%.9e" % v for v in losses), card))
    log("18(a) w: %s (%s)" % (", ".join("%.6e" % v for v in ws), card))
    log("18(a) against phase 3: losses %s (largest rel diff %.3e), w %s (%.3e); bar %.0e (%s)"
        % ("bit-equal" if losses == res["losses"] else "differ", loss_rel,
           "bit-equal" if ws == res["w"] else "differ", w_rel, DIST_REL_BAR, card))
    per_step = (launches["fwd"] / len(losses), launches["bwd"] / len(losses))
    log("18(a) launches: K1 %d, K2 %d (%.0f and %.0f a step), X2 %d in prep; dist1_step_ms "
        "%.3f beside train_step_ms %.3f (%s)" % (launches["fwd"], launches["bwd"],
                                                 per_step[0], per_step[1], launches["grid"],
                                                 step_ms, res["step_ms"], card))
    log("18(a) profiled step: %.3f ms wall, %.3f ms device busy, %.0f kernels, against phase "
        "3's %.3f / %.3f / %.0f (%s)" % (profile["wall_ms"], profile["busy_ms"],
                                         profile["kernels_per_call"], res["profile"]["wall_ms"],
                                         res["profile"]["busy_ms"],
                                         res["profile"]["kernels_per_call"], card))
    log("18(a) in turns: the ungrouped step %.3f ms, the one-rank sharded step %.3f ms (%s)"
        % (turns[0], turns[1], card))
    log("18(a) the rank holds %s: %d points a scan, %d row tiles, %d point tiles; resident "
        "bytes: points %d, rows %d, whole on every rank %d (%s)"
        % ("1/%d" % sizes["ranks"], sizes["points_a_scan"], sizes["row_tiles"],
           sizes["point_tiles"], nbytes["points"], nbytes["rows"], nbytes["whole"], card))
    whole = resident_bytes(res["data"])
    log("18(a) prep holds the whole tables on every rank before the split: points %d, rows %d "
        "bytes (phase 3's tables); the rank's peak device bytes over train(), prep included: "
        "%d (%s)" % (whole["points"], whole["rows"], peak, card))
    if per_step != (1.0, 1.0) or launches["grid"] <= 0:
        raise RuntimeError("18(a): K1, K2 not once a step or X2 not in prep: %s" % launches)
    if loss_rel > DIST_REL_BAR or w_rel > DIST_REL_BAR:
        raise RuntimeError("18(a) misses phase 3: loss %.3e, w %.3e" % (loss_rel, w_rel))
    out.update(dist1_step_ms=step_ms, dist1_profile=profile, dist1_turns_ms=turns,
               dist1_loss_rel=loss_rel,
               dist1_w_rel=w_rel,
               dist1_bit_equal=losses == res["losses"] and ws == res["w"],
               dist1_resident_bytes=nbytes, dist1_sizes=sizes, dist1_prep_whole_bytes=whole,
               dist1_peak_bytes=peak)

    # (b) Four ranks' launches in one process.
    g, ps = res["graph"], res["ps"]
    with torch.no_grad():
        raw = cw.cellwin_fwd(ps, g.q_est, g.est_sorted, g.f_start, g.f_len, g.f_ctr, g.r2)
        gen = torch.Generator().manual_seed(18)
        gr = torch.randn((10, raw.shape[1]), generator=gen).to(ps.device)
        gr = torch.where((g.row_map >= 0)[None], gr, torch.zeros_like(gr))
        table = _cotangent_table(raw[0:3], raw[9], (gr[0:3], tuple(gr[3:9]))).contiguous()
        grad = cw.cellwin_bwd(ps, g.q_est, g.est_sorted, table, g.b_start, g.b_len, g.b_ctr,
                              g.r2)
        f0, b0 = cw.FWD_LAUNCHES, cw.BWD_LAUNCHES
        raw4, grad4 = rehearse(ps, g, REHEARSAL_RANKS, gr)
        shard_launches = (cw.FWD_LAUNCHES - f0, cw.BWD_LAUNCHES - b0)
    t1, t2 = g.f_start.shape[0], g.b_start.shape[0]
    pad_tiles = (-t1 % REHEARSAL_RANKS, -t2 % REHEARSAL_RANKS)
    moments_diff = float((raw4 - raw).abs().max())
    grad_diff = float((grad4 - grad).abs().max())
    log("18(b) %d ranks in one process on phase 3's graph (%d row tiles + %d padding, %d point "
        "tiles + %d padding; K1 %d and K2 %d launches): moments %s (max |diff| %.3e), "
        "gradient %s (max |diff| %.3e) (%s)"
        % (REHEARSAL_RANKS, t1, pad_tiles[0], t2, pad_tiles[1], shard_launches[0],
           shard_launches[1], "bit-equal" if torch.equal(raw4, raw) else "DIFFER", moments_diff,
           "bit-equal" if torch.equal(grad4, grad) else "DIFFER", grad_diff, card))
    gcloud = global_cloud(res["data"].batches[0])
    r = float(res["cfg"].nn_r)
    k = suggest_k_max(gcloud.get_points(), r=r, valid_points=gcloud.valid)
    x2 = rehearse_x2(gcloud, r, k, REHEARSAL_RANKS)
    log("18(b) X2 on %d query slices of the global cloud (%d queries, k %d, %d launches): "
        "index tables %s, distances %s (max |diff| %.3e) (%s)"
        % (REHEARSAL_RANKS, x2["queries"], k, x2["launches"],
           "equal" if x2["idx_equal"] else "DIFFER", "bit-equal" if x2["d_equal"] else "DIFFER",
           x2["d_max_abs_diff"], card))
    if not (torch.equal(raw4, raw) and torch.equal(grad4, grad) and x2["idx_equal"]
            and x2["d_equal"]):
        raise RuntimeError("18(b): the shards differ from the single launches")
    if shard_launches != (REHEARSAL_RANKS, REHEARSAL_RANKS):
        raise RuntimeError("18(b): the shards launched K1, K2 %s times" % (shard_launches,))
    out.update(rehearsal_ranks=REHEARSAL_RANKS, rehearsal_moments_diff=moments_diff,
               rehearsal_grad_diff=grad_diff, rehearsal_x2_equal=x2["idx_equal"] and x2["d_equal"],
               rehearsal_pad_tiles=pad_tiles)

    # (c) One rank a card.
    n = torch.cuda.device_count()
    if n < 2:
        log("18(c) one card seen (%s): no group of several cards was run, and no scaling is "
            "claimed" % card)
        out["cards"] = n
        return out
    out.update(multi_gpu(card, res, n))
    return out


def multi_gpu(card: str, res: dict, n: int) -> dict:
    """18(c): ``n`` NCCL ranks, one a card, each a process running
    ``chip_smoke.py --dist-rank``: rank 0's losses against phase 3's,
    every rank's losses and w the same bits."""
    import tempfile

    from depth_correction_tpu_torch.parallel.dryrun import start, wait_all

    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # The ranks share one log_dir, as ranks on one host do; rank 0 writes.
        procs = [start([sys.executable, os.path.abspath(__file__), "--dist-rank", str(rank),
                        str(n), str(port), tmp]) for rank in range(n)]
        wait_all(procs, timeout=900)
        reports = []
        for rank in range(n):
            with open(os.path.join(tmp, "rank%d.json" % rank)) as f:
                reports.append(json.load(f))
    got, ranks = reports[0], reports[1:]
    rel = max_rel_diff(got["losses"], res["losses"])
    same = all(r["losses"] == got["losses"] and r["w"] == got["w"] for r in ranks)
    log("18(c) %d NCCL ranks, one a card: losses %s (largest rel diff to phase 3 %.3e, bar "
        "%.0e); every rank's losses and w the same bits: %s; dist%d_step_ms %.3f beside "
        "train_step_ms %.3f; %.1f s (%s)"
        % (n, ", ".join("%.9e" % v for v in got["losses"]), rel, MULTI_REL_BAR, same, n,
           got["step_ms"], res["step_ms"], time.perf_counter() - t0, card))
    for r, d in enumerate([got] + ranks):
        log("18(c) rank %d holds 1/%d: %d points a scan, %d row tiles, %d point tiles; "
            "resident bytes: points %d, rows %d, whole %d; peak device bytes over train() %d "
            "(%s)" % (r, n, d["sizes"]["points_a_scan"], d["sizes"]["row_tiles"],
                      d["sizes"]["point_tiles"], d["bytes"]["points"], d["bytes"]["rows"],
                      d["bytes"]["whole"], d["peak"], card))
    if rel > MULTI_REL_BAR or not same:
        raise RuntimeError("18(c) misses phase 3 by %.3e, or the ranks differ (%s)"
                           % (rel, same))
    return {"cards": n, "distn_step_ms": got["step_ms"], "distn_loss_rel": rel,
            "distn_resident_bytes": got["bytes"]}


def dist_rank_main(rank: int, n: int, port: int, out_dir: str) -> int:
    """One rank of 18(c): phase 3's slice through train() on card ``rank``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    cfg = bench_config()
    seq = load_sequence(cfg)
    losses, ws, step_ms, launches, nbytes, sizes, _, peak = dist_train(
        cfg, seq, n, rank, port, os.path.join(out_dir, "log"))
    if launches["fwd"] != len(losses) or launches["bwd"] != len(losses):
        raise RuntimeError("rank %d: K1 / K2 launches %s" % (rank, launches))
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump({"losses": losses, "w": ws, "bytes": nbytes, "sizes": sizes,
                   "step_ms": step_ms, "peak": peak}, f)
    return 0


# ---------------------------------------------------------------------------
# Phase 19: the studies on the card (depth_correction_tpu_torch/studies)

SCALE_TIMED_STEPS = 10  # train_at_scale's default --steps
W_INJECTED = -0.002  # the scale scene's injected bias weight
# Neighbouring densities of the 32x32x6 box tried, largest first, when the
# cell-window build declines at the study's density 300.
SCALE_FALLBACK_DENSITIES = (250, 200, 150, 100)
KNN_SIZES = (131072, 524288, 1048576)
# The joint-learning studies' stand-in box in 19(c), smaller than their
# default (20 x 20 x 5 m at density 100: ~25 s each, most of it making the
# scene and its ground-truth map on the host).
STUDY_SCENE = "open_box/n_4_size_10_10_5_height_1_density_50"


def scale_run(card: str, scans, backend: str, density: float = 300.0) -> dict:
    """19(a) for one moments engine: train_at_scale's prep and steps with
    every launch count zeroed before the prep and read after the steps,
    the f32 kernels' loss at w = 0 against the float64 plain path on the
    same graph, one profiled step and the peak device bytes."""
    import torch

    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.ops import cellwin as cw
    from depth_correction_tpu_torch.studies import train_at_scale as tas
    from depth_correction_tpu_torch.train import make_loss_fn

    cfg = tas.scale_config(density=density, backend=backend, device=DEVICE)
    base_bytes = torch.cuda.memory_allocated()
    reset_all_launch_counts()
    data, prep_s = tas.prepare(cfg, scans)
    c, eng = tas.counts(data), tas.engine(data)
    tas.report_prep(c, eng, prep_s, dict(data.prep_seconds))
    run = tas.run_steps(cfg, data, SCALE_TIMED_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {"fwd": cw.FWD_LAUNCHES, "bwd": cw.BWD_LAUNCHES, "grid": _kernels.GRID_LAUNCHES,
                "gather": _kernels.GATHER_LAUNCHES, "knn": _kernels.KNN_LAUNCHES}
    tas.report_run(c, run, torch.device(DEVICE))
    steps = tas.WARMUP_STEPS + SCALE_TIMED_STEPS
    if launches["grid"] <= 0 or launches["gather"] <= 0:
        raise RuntimeError("train_at_scale's prep did not launch X2 and P7: %s" % launches)
    want = steps if eng["engine"] == "cellwin" else 0
    if launches["fwd"] != want or launches["bwd"] != want:
        raise RuntimeError("train_at_scale (%s, engine %s): K1 %d, K2 %d launches for %d steps"
                           % (backend, eng["engine"], launches["fwd"], launches["bwd"], steps))
    launches.update(check_transposes("train_at_scale (%s)" % backend, cfg, data, steps))
    with torch.no_grad():
        ref = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=torch.float64, device=DEVICE)
        loss64 = float(make_loss_fn(cfg, plain=True)(ref, data.to(dtype=torch.float64)))
    loss_rel = abs(run["losses"][0] - loss64) / abs(loss64)
    w_rel = abs(run["w"] - W_INJECTED) / abs(W_INJECTED)
    step_ms = statistics.median(run["step_ms"])
    log("scale %s (engine %s): %d global points, %d query rows, K %d; scale_step_ms median "
        "%.3f, spread %.3f-%.3f over %d steps; loss at w=0 %.9e vs float64 plain %.9e "
        "(scale_loss_rel_err_w0 %.3e); w after %d steps %.6e (rel err to %g: %.3e); "
        "launches K1 %d, K2 %d, X2 %d, P7 %d, X3 %d; peak device bytes %d (%d allocated "
        "before the prep) (%s)"
        % (backend, eng["engine"], c["global"], c["query"], c["k"], step_ms,
           min(run["step_ms"]), max(run["step_ms"]), SCALE_TIMED_STEPS, run["losses"][0], loss64,
           loss_rel, steps, run["w"], W_INJECTED, w_rel, launches["fwd"], launches["bwd"],
           launches["grid"], launches["gather"], launches["knn"], peak, base_bytes, card))
    if not loss_rel <= LOSS_REL_BAR:
        raise RuntimeError("train_at_scale (%s): loss at w=0 misses the 1e-5 bar: %.3e"
                           % (backend, loss_rel))
    profile = profile_calls(adam_step_fn(cfg, data), card, "step", n=1)
    if eng["engine"] != "cellwin":
        check_no_index_backward(profile, "train_at_scale (%s)" % backend)
    return {"counts": c, "engine": eng, "prep_s": prep_s, "prep_seconds": dict(data.prep_seconds),
            "step_ms": step_ms, "step_ms_all": run["step_ms"], "loss_rel": loss_rel,
            "w": run["w"], "w_rel": w_rel, "launches": launches, "peak_bytes": peak,
            "base_bytes": base_bytes, "profile": profile, "data": data, "cfg": cfg}


def scale_kernels(card: str, run: dict) -> dict:
    """K1 and K2 on the scale graph against their plain twins (float32 and
    float64), timed there."""
    import torch

    from depth_correction_tpu_torch.scripts.exp_cellwin_knockout import points_at_w0

    graph = run["data"].cellwin[0]
    ps = points_at_w0(run["data"], graph, DEVICE)
    with torch.no_grad():
        k = compare_kernels(ps, graph, seed=19, label="scale", card=card)
    members = int((run["data"].neighbors[0] >= 0).sum())
    kept_f, kept_b = k["kept"]["fwd"], k["kept"]["bwd"]
    k["fwd_bound"] = cellwin_fwd_bound(graph, kept_f[0], members, kept_f[2])
    k["bwd_bound"] = cellwin_bwd_bound(graph, kept_b[0], members, kept_b[2])
    log("scale graph: %d rows -> %d row tiles x %d, %d point tiles, %d exception rows, %d "
        "member pairs; K1 bound %.4f ms (%s), K2 bound %.4f ms (%s) (%s)"
        % (int((graph.row_map >= 0).sum()), graph.f_start.shape[0],
           graph.q_est.shape[1] // graph.f_start.shape[0], graph.b_start.shape[0], graph.n_exc,
           members, k["fwd_bound"][0], k["fwd_bound"][1], k["bwd_bound"][0], k["bwd_bound"][1],
           card))
    return k


def scale_declined(card: str) -> dict:
    """When the study's cell-window build declines: the largest
    neighbouring density of the same box whose build the builder accepts,
    its main path (K1, K2 once a step) and its K1 / K2 against their
    plain twins."""
    from depth_correction_tpu_torch.studies import train_at_scale as tas

    for density in SCALE_FALLBACK_DENSITIES:
        cfg = tas.scale_config(density=density, backend="cellwin", device=DEVICE)
        scans = tas.load_scans(cfg)
        run = scale_run(card, scans, "cellwin", density)
        if run["engine"]["engine"] == "cellwin":
            log("scale: the cell-window build accepts density %g (%d global points)"
                % (density, run["counts"]["global"]))
            run["density"] = density
            run["kernels"] = scale_kernels(card, run)
            return run
    raise RuntimeError("the cell-window build declines at every density in %s"
                       % (SCALE_FALLBACK_DENSITIES,))


def phase_scale(card: str) -> dict:
    """19(a): train_at_scale at its defaults (open_box 32_32_6 at density
    300, 10 timed steps), the scans loaded once, on both engines."""
    from depth_correction_tpu_torch.studies import train_at_scale as tas

    t0 = time.perf_counter()
    scans = tas.load_scans(tas.scale_config(device=DEVICE))
    load_s = time.perf_counter() - t0
    log("scale scene %s: %d scans, %d raw points, loaded in %.3f s"
        % (tas.scale_config(device=DEVICE).train_names[0], len(scans),
           sum(len(s) for s, _ in scans), load_s))
    out = {"load_s": load_s}
    for backend in ("gather", "cellwin"):
        log("[19a] train_at_scale, DC_MOMENTS_BACKEND=%s" % backend)
        out[backend] = scale_run(card, scans, backend)
    del scans
    cw_run = out["cellwin"]
    if cw_run["engine"]["engine"] == "cellwin":
        out["kernels"] = scale_kernels(card, cw_run)
        out["kernels_graph"] = "density 300 (the study's default)"
    else:
        log("scale: the cell-window build declined at density 300 (%s; exception rows %s); "
            "the run fell back to gather, as the JAX package does"
            % (cw_run["engine"]["note"], cw_run["engine"]["exc_share"]))
        alt = scale_declined(card)
        out["declined"] = alt
        out["kernels"] = alt["kernels"]
        out["kernels_graph"] = "density %g" % alt["density"]
        alt.pop("data")
    # Phase 20 takes the gather engine's prepared graph.
    out["gather_graph"] = (out["gather"].pop("cfg"), out["gather"].pop("data"))
    out["cellwin"].pop("data")
    return out


def phase_bench_knn(card: str) -> dict:
    """19(b): bench_knn at 131,072, 524,288 and 1,048,576 points: X2 and X3
    (each launch counted), cKDTree; set equality at the smallest size."""
    from depth_correction_tpu_torch.ops import _kernels
    from depth_correction_tpu_torch.studies import bench_knn

    reset_all_launch_counts()
    rows = bench_knn.main(["--sizes", ",".join(str(n) for n in KNN_SIZES),
                           "--device", DEVICE])
    launches = {"grid": _kernels.GRID_LAUNCHES, "knn": _kernels.KNN_LAUNCHES}
    for r in rows:
        log("bench_knn N=%d: X2 %.3f ms, X3 %.3f ms, cKDTree %.1f ms, mean ball %.2f, largest %d%s "
            "(%s)" % (r["n"], r["grid_ms"], r["scan_ms"], r["scipy_ms"], r["ball_mean"],
                      r["ball_max"], "" if "sets_equal" not in r else
                      "; X2 = X3 sets %s; against scipy: %d rows differ (radius ties only: %s)"
                      % (r["sets_equal"], r["scipy"]["rows"], r["scipy"]["ties_only"]), card))
    log("bench_knn launches: X2 %d, X3 %d" % (launches["grid"], launches["knn"]))
    first = rows[0]
    if first["n"] != KNN_SIZES[0] or not first.get("sets_equal"):
        raise RuntimeError("bench_knn: X2's sets differ from X3's at %d points" % first["n"])
    if not first["scipy"]["ties_only"]:
        raise RuntimeError("bench_knn: X2 differs from scipy's balls beyond radius ties")
    if launches["grid"] <= 0 or launches["knn"] <= 0:
        raise RuntimeError("bench_knn did not launch X2 and X3: %s" % launches)
    return {"rows": rows, "launches": launches}


def write_kitti360_dynamic(root: str, seq) -> None:
    """Two of ``seq``'s scans as a KITTI-360 drive (:func:`write_kitti360`)
    and one dynamic-object window over them: 200 of the first scan's
    points in the loader's map frame, so the filter drops some."""
    import numpy as np
    from numpy.lib.recfunctions import unstructured_to_structured as u2s

    from depth_correction_tpu_torch.utils.ply import write_ply_points

    _, poses = write_kitti360(root, seq[:2])  # the loader's poses: the first is the origin
    scan = seq[0][0]
    local = np.stack([scan["x"], scan["y"], scan["z"]], 1)[::max(len(scan) // 200, 1)][:200]
    world = local @ poses[0][:3, :3].T + poses[0][:3, 3]
    base = os.path.join(root, "data_3d_semantics", "train", KITTI360_DRIVE, "dynamic")
    os.makedirs(base)
    write_ply_points(os.path.join(base, "%010d_%010d.ply" % (0, 2)),
                     u2s(world.astype(np.float32), names=["x", "y", "z"]))


def phase_studies(card: str, seq) -> dict:
    """19(c): every other study's main() once on the card, at its smallest
    documented setting (iterations cut where a study takes them, the
    joint-learning studies on :data:`STUDY_SCENE`): the device it ran on,
    its seconds and its result line."""
    import contextlib
    import importlib
    import io
    import shutil
    import tempfile

    import torch

    from depth_correction_tpu_torch.datasets import kitti360

    root = tempfile.mkdtemp(prefix="dc_studies_")
    out = lambda name: os.path.join(root, name)  # noqa: E731
    runs = [
        ("weights_search", []),
        ("bias_estimation", ["--out", out("bias")]),
        ("paths_alignment", []),
        ("map_bias_removal", ["--out", out("map")]),
        ("depth_denoising", ["--out", out("denoise")]),
        ("depth_denoising", ["--out", out("denoise_ext"), "--denoiser-command",
                             "%s %s --input {input_npz} --output {output_npz}"
                             % (sys.executable, os.path.join(os.path.dirname(
                                 os.path.abspath(__file__)), "scripts", "stub_denoiser.py"))]),
        ("mapping_accuracy", []),
        ("reconstruction_eval", ["--out", out("recon")]),
        ("localization_accuracy", ["--out", out("loc")]),
        ("model_learning", ["--iters", "10", "--scene", STUDY_SCENE, "--out", out("ml")]),
        ("model_poses_learning", ["--iters", "10", "--scene", STUDY_SCENE, "--out", out("mpl")]),
        ("model_poses_learning_icp", ["--iters", "10", "--scene", STUDY_SCENE,
                                      "--out", out("mpli")]),
        ("optimization_pair_of_scans", ["--iters", "20", "--out", out("pair")]),
        ("train_demo", ["--iters", "20", "--log-dir", out("demo")]),
        ("create_dataset_npz", ["--source", "ground_plane/4", "--out", out("npz")]),
        ("generate_scans_wo_dynamic_objects_kitti360", ["kitti360/00", "--out-dir",
                                                        out("k360_filtered")]),
        ("optimization", ["--iters", "10"]),
        ("optimization_icp", ["--iters", "10"]),
    ]
    saved_dir = kitti360.data_dir
    results = {}
    try:
        write_kitti360_dynamic(out("kitti360"), seq)
        kitti360.data_dir = out("kitti360")
        for name, argv in runs:
            mod = importlib.import_module("depth_correction_tpu_torch.studies." + name)
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(argv + ["--device", DEVICE])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            lines = [ln for ln in buf.getvalue().splitlines()
                     if ln.strip() and not ln.startswith(("plot", "dashboard"))]
            key = lines[-1] if lines else ""
            label = name if name not in results else name + " (external denoiser)"
            log("[19c] %s: device %s, %.1f s: %s (%s)"
                % (label, torch.cuda.get_device_name(0), seconds, key.strip()[:200], card))
            results[label] = {"seconds": seconds, "result": key.strip()}
    finally:
        kitti360.data_dir = saved_dir
        shutil.rmtree(root, ignore_errors=True)
    filtered = results["generate_scans_wo_dynamic_objects_kitti360"]["result"]
    if "Load them with" not in filtered:
        raise RuntimeError("generate_scans_wo_dynamic_objects_kitti360: %s" % filtered)
    return results


TRANSPOSE_REPS = 20
# X4's float operations a pair: x_j - mu (3), S (x_j - mu) + h (9 fmas),
# times w added to the sum (3 fmas); X5's: D = 3 adds a pair.
X4_PAIR_OPS, X5_PAIR_OPS = 27, 3


def transpose_bounds(tg, mq: int) -> dict:
    """X4's and X5's bounds over the transpose ``tg`` of an (mq, K) table,
    each input read once and each output written once, in each design's
    layout. The redesigns (``x4``, ``x5``) read the cell order and its run
    starts; X4 also the tiles' starts and row lists, each pair's 2-byte
    local index and weight, a hub tile's pairs' int32 indices, the (mq, 12)
    row table and the (M, 3) points, and writes (M, 3); X5 each pair's
    int32 index and 3 cotangent floats, and writes (M, 3)."""
    m, p = tg.num_points, int(tg.pair.shape[0])
    t = tg.tiles
    start = tg.start.long()
    hub = (t.row_start[1:] - t.row_start[:-1]) > t.budget
    tile_pairs = start[t.tile_start[1:].long()] - start[t.tile_start[:-1].long()]
    hub_pairs = int(tile_pairs[hub].sum())
    order_runs = m * 4 + (m + 1) * 4
    tiles = (t.num_tiles + 1) * 8 + int(t.rows.shape[0]) * 4
    x4_fixed = mq * 48 + m * 24
    ops4, ops5 = {"fp32": X4_PAIR_OPS * p}, {"fp32": X5_PAIR_OPS * p}
    return {"pairs": p, "hub_pairs": hub_pairs,
            "x4": bound(order_runs + tiles + p * 6 + hub_pairs * 4 + x4_fixed, ops4),
            "x5": bound(order_runs + p * 16 + m * 12, ops5)}


def step_gradients(cfg, data) -> dict:
    """The step's gradient on ``data``'s gather graph at w = 0. In w
    (make_loss_fn): float32 kernels against the float64 plain path. In the
    global points (the features' loss over the masked rows, X4's output):
    the float32 step through X4 against the same float32 step whose X4 is
    replaced by its plain version in float64 (the kernel inside the step),
    and against the float64 plain path (printed: the float32 eigenvalue
    backward upstream of X4 sets that difference). Each relative to the
    largest reference magnitude."""
    import torch

    from depth_correction_tpu_torch import preproc
    from depth_correction_tpu_torch.loss import create_loss
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.ops import features
    from depth_correction_tpu_torch.train import FeatureRows, make_loss_fn

    mask = data.masks[0]

    def grads(d, plain):
        model = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=d.weights[0].dtype,
                                 device=DEVICE)
        make_loss_fn(cfg, plain=plain)(model, d).backward()
        with torch.no_grad():
            pts = preproc.global_cloud(d.batches[0], model=model).get_points()
        p = pts.detach().clone().requires_grad_()
        f = features.neighborhood_features(p, d.neighbors[0], d.weights[0],
                                           compute_normals=False, plain=plain,
                                           tg=d.transposes[0])
        value, _ = create_loss(cfg)([FeatureRows(eigvals=f["eigvals"], trace=f["trace"],
                                                 valid=mask)], mask=[mask])
        value.backward()
        return float(model.w.grad[0]), p.grad.double()

    w32, p32 = grads(data, False)
    w64, p64 = grads(data.to(dtype=torch.float64), True)
    x4 = features.transpose_moments
    features.transpose_moments = lambda p, tg, t: features.transpose_moments_plain(
        p.double(), tg.to(dtype=torch.float64), t.double()).to(p.dtype)
    try:
        _, p_twin = grads(data, False)
    finally:
        features.transpose_moments = x4
    return {"w_rel": abs(w32 - w64) / abs(w64), "w_grad": w64,
            "points_rel": float((p32 - p_twin).abs().max() / p_twin.abs().max()),
            "points_rel_f64": float((p32 - p64).abs().max() / p64.abs().max()),
            "points_max": float(p64.abs().max())}



def transpose_kernels(card: str, cfg, data, label: str) -> dict:
    """X4 and X5 on ``data``'s gather graph and its prep-built transpose, at
    w = 0: each against its plain version in float64 (GRAD_REL_BAR of max
    |output|) and launched twice, bit-equal; timed by CUDA events and by
    the profiler's kernel durations beside the plain version (float32) and,
    for X5, ``index_add_`` (one PyTorch call computing its function), with
    P7's two-pass form beside its single pass; the tiles' pairs a row in
    cell order and, for the same graph built in point order
    (``features.index_order``), in point order; the step's gradient against
    the float64 plain path."""
    import torch

    from depth_correction_tpu_torch import preproc
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.ops import features

    nn, w, tg = data.neighbors[0], data.weights[0], data.transposes[0]
    if tg is None or data.cellwin[0] is not None:
        raise RuntimeError("%s: no gather graph with a transpose" % label)
    model = ScaledPolynomial(w=[0.0], exponent=[4.0], dtype=torch.float32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(20)
    with torch.no_grad():
        pts = preproc.global_cloud(data.batches[0], model=model).get_points().contiguous()
        mean, comps, w_sum = features.gather_moments(pts, nn, w, centred=True)
        table = features._cotangent_rows(
            mean, w_sum, (torch.randn(mean.shape, generator=gen, device=DEVICE),
                          torch.randn(comps.shape, generator=gen, device=DEVICE)))
        g = torch.randn(tuple(nn.shape) + (3,), generator=gen, device=DEVICE)
        x4 = features.transpose_moments(pts, tg, table)
        x4_again = features.transpose_moments(pts, tg, table)
        x4_ref = features.transpose_moments_plain(pts.double(), tg.to(dtype=torch.float64),
                                                  table.double())
        x5 = features.transpose_gather(g, tg)
        x5_again = features.transpose_gather(g, tg)
        x5_ref = features.transpose_gather_plain(g.double(), tg)
        flat = nn.reshape(-1)
        real = (flat >= 0) & (flat < tg.num_points)
        idx, g_real = flat[real], g.reshape(-1, 3)[real]

        def library():
            return torch.zeros((tg.num_points, 3), device=DEVICE).index_add_(0, idx, g_real)

        lib_out = library()
        torch.cuda.synchronize()
        res = {"graph": {"rows": nn.shape[0], "k": nn.shape[1], "points": tg.num_points},
               **transpose_bounds(tg, nn.shape[0])}
        for key, got, again, ref in (("x4", x4, x4_again, x4_ref), ("x5", x5, x5_again, x5_ref)):
            res[key + "_err"] = float((got.double() - ref).abs().max())
            res[key + "_rel"] = res[key + "_err"] / float(ref.abs().max())
            res[key + "_repeat_equal"] = bool(torch.equal(got, again))
        res["library_rel"] = float((lib_out.double() - x5_ref).abs().max()
                                   / x5_ref.abs().max())
        timed = {"x4": lambda: features.transpose_moments(pts, tg, table),
                 "x5": lambda: features.transpose_gather(g, tg), "library": library,
                 "p7_centred": lambda: features.gather_moments(pts, nn, w, centred=True),
                 "p7": lambda: features.gather_moments(pts, nn, w)}
        for key, fn in timed.items():
            res[key + "_ms"] = cuda_ms(fn, TRANSPOSE_REPS)
            res[key + "_kernel_ms"] = kernel_ms(fn, DEVICE, TRANSPOSE_REPS)
        res["x4_plain_ms"] = cuda_ms(lambda: features.transpose_moments_plain(pts, tg, table), 3,
                                     warmup=1)
        res["x5_plain_ms"] = cuda_ms(lambda: features.transpose_gather_plain(g, tg), 3, warmup=1)
        flat_tg = features.transpose_in_order(nn, tg.num_points, w, features.index_order)
        res["pairs_per_row"] = {"point": flat_tg.pairs_per_row(), "cell": tg.pairs_per_row()}
        del flat_tg
    res["max_in_degree"] = int(tg.in_degree().max())
    res["prep_transpose_s"] = data.prep_seconds.get("transpose")
    res["step"] = step_gradients(cfg, data)
    log("[20] %s graph: %d rows x K %d over %d points, %d transpose pairs (largest in-degree %d); "
        "%d tiles of at most %d targets, largest within the %d-row budget %d rows, %d pairs in "
        "hub tiles; prep's transposes %.4f s (%s)"
        % (label, nn.shape[0], nn.shape[1], tg.num_points, res["pairs"], res["max_in_degree"],
           tg.tiles.num_tiles, features.TILE_TARGETS, tg.tiles.budget, tg.tiles.rows_max,
           res["hub_pairs"], res["prep_transpose_s"], card))
    log("[20] %s pairs a row of the tiles: point order %.3f, cell order (Morton, the build's) "
        "%.3f (%s)" % (label, res["pairs_per_row"]["point"], res["pairs_per_row"]["cell"], card))
    for key, name in (("x4", "X4 transpose_moments"), ("x5", "X5 transpose_gather")):
        b = res[key]
        log("[20] %s %s: %.4f ms (events), %.4f ms (device); bound %.4f ms (%s); plain %.3f "
            "ms; max abs err %.3e (%.3e of max |output|); two launches bit-equal %s (%s)"
            % (label, name, res[key + "_ms"], res[key + "_kernel_ms"], b[0], b[1],
               res[key + "_plain_ms"], res[key + "_err"], res[key + "_rel"],
               res[key + "_repeat_equal"], card))
    log("[20] %s index_add_ (X5's function): %.4f ms (events), %.4f ms (device); %.3e of max "
        "|output| (%s)" % (label, res["library_ms"], res["library_kernel_ms"], res["library_rel"],
                           card))
    log("[20] %s P7's two-pass form (the gather steps' forward) %.4f ms (events), %.4f ms "
        "(device); its single pass %.4f, %.4f (%s)"
        % (label, res["p7_centred_ms"], res["p7_centred_kernel_ms"], res["p7_ms"],
           res["p7_kernel_ms"], card))
    st = res["step"]
    log("[20] %s step gradient: w %.3e of the float64 plain path's (%.6e); in the points, X4 "
        "against its float64 plain version inside the float32 step %.3e of max |grad|, the "
        "float32 step against the float64 plain path %.3e (max |grad| %.3e) (%s)"
        % (label, st["w_rel"], st["w_grad"], st["points_rel"], st["points_rel_f64"],
           st["points_max"], card))
    for key in ("x4", "x5"):
        if not (res[key + "_rel"] <= GRAD_REL_BAR and res[key + "_repeat_equal"]):
            raise RuntimeError("%s: %s misses its bar or differs between launches: %s"
                               % (label, key, res))
    if not (st["points_rel"] <= GRAD_REL_BAR and st["w_rel"] <= GRAD_REL_BAR):
        raise RuntimeError("%s: the step's gradient misses the %.0e bar: %s"
                           % (label, GRAD_REL_BAR, st))
    return res


def transpose_entry(tr: dict, key: str, launches: dict) -> dict:
    """The kernels line's entry of X4 or X5: phase 20's numbers on the capped
    graph (top level) and the scale graph (``scale``); ``launches`` from the capped row's 8 steps (X4) or phase 12d's
    nn_scale run (X5), each main path's in ``launches_by_phase``."""
    names = {"x4": ("transpose_moments (X4)", "depth_correction_tpu/ops/features.py:604",
                    "capped"),
             "x5": ("transpose_gather (X5)", "depth_correction_tpu/ops/features.py:423",
                    "nn_scale")}
    name, replaces, main_path = names[key]
    c = tr["capped"]

    def numbers(r):
        return {"ms": r[key + "_ms"], "kernel_ms": r[key + "_kernel_ms"],
                "plain_ms": r[key + "_plain_ms"], "max_abs_err": r[key + "_err"],
                "bound_ms": r[key][0], "bound_by": r[key][1],
                "library_ms": r["library_ms"] if key == "x5" else None,
                "library_kernel_ms": r["library_kernel_ms"] if key == "x5" else None,
                "pairs": r["pairs"], "graph": r["graph"], "pairs_per_row": r["pairs_per_row"]}

    return dict({"name": name, "route": "cuda",
                 "source": "depth_correction_tpu_torch/csrc/transpose_gather.cu",
                 "replaces": replaces, "launches": launches[main_path],
                 "bound": c[key]}, **{k: v for k, v in numbers(c).items()
                                      if k not in ("bound_ms", "bound_by")},
                scale=numbers(tr["scale"]), launches_by_phase=launches,
                step_grad_rel={lbl: r["step"] for lbl, r in tr.items()})


def exception_locality(card: str, data) -> dict:
    """The pairs a row of a cell-window graph's exception-row transpose
    (phase 3's) in the cell order of the establishment positions, which
    prep builds, and over the padded cell-sorted layout's own order."""
    from depth_correction_tpu_torch.ops import features

    cw = data.cellwin[0]
    tg = cw.exc_tg
    layout = features.transpose_in_order(cw.exc_nn, tg.num_points, cw.exc_w,
                                         features.index_order)
    out = {"rows": int(cw.n_exc), "pairs": int(tg.pair.shape[0]),
           "layout": layout.pairs_per_row(), "cell": tg.pairs_per_row()}
    log("[20] exception rows (phase 3's graph): %d rows, %d transpose pairs; pairs a row of the "
        "tiles %.3f in the cell-sorted layout's order, %.3f in the cell order prep builds (%s)"
        % (out["rows"], out["pairs"], out["layout"], out["cell"], card))
    return out


def phase_transpose(card: str, graphs: dict) -> dict:
    """20: X4 and X5 on the capped row's graph (phase 9) and the scale run's
    gather graph (phase 19(a)): :func:`transpose_kernels` on each."""
    return {label: transpose_kernels(card, cfg, data, label)
            for label, (cfg, data) in graphs.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import depth_correction_tpu_torch  # noqa: F401  (fails outside the repo)

    card = card_line()
    log(card)
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))
    t0 = time.perf_counter()
    log("[phase 1] build")
    phase_build()
    log("[phase 2] kernels vs plain (synthetic graph)")
    phase_kernels()
    log("[phase 3] slice (bench configuration, %d Adam steps)" % STEPS)
    res = phase_slice(card)
    log("median step: %.3f ms over steps 1..%d; prep %.1f s; device busy %.3f ms/step; total "
        "%.1f s (%s)" % (res["step_ms"], STEPS - 1, res["prep_s"], res["profile"]["busy_ms"],
                         time.perf_counter() - t0, card))
    log("[phase 4] node (bench node scan, slab engine)")
    node = phase_node(card)
    log("[phase 5] node small scan (brute engine) and P7")
    small = phase_small(card)
    log("node_ms %.3f, node_e2e_ms %.3f, node_points %d; small scan (brute): node_ms %.3f, "
        "node_e2e_ms %.3f, node_points %d; total %.1f s (%s)"
        % (node["ms"], node["e2e_ms"], node["points"], small["ms"], small["e2e_ms"],
           small["points"], time.perf_counter() - t0, card))
    log("[phase 6] probes P1-P5 (depth_correction_tpu_torch/scripts)")
    probes, (pairs, members) = phase_probes(card, res["graph"], res["ps"],
                                            res["kernels"]["kept"]["fwd"])
    log("[phase 7] grid: X2 on the slice's clouds, the node's grid engine")
    grid = phase_grid(card, res["data"], res["cfg"], node["scan"])
    gnode = grid["node"]
    log("grid node: node_ms %.3f, node_e2e_ms %.3f, node_points %d; total %.1f s (%s)"
        % (gnode["ms"], gnode["e2e_ms"], gnode["points"], time.perf_counter() - t0, card))
    log("[phase 8] probes P6, P8, P7a and P7 (depth_correction_tpu_torch/scripts)")
    probes_p8, p7_probe = phase_probes_p6_p8(card)
    probes += probes_p8
    log("[phase 9] capped row (bench_config(uncapped=False), %d Adam steps)" % STEPS)
    capped = phase_capped(card, res["seq"])
    log("[phase 10] default Config() on ASL-laser files, shadow filter on")
    default = phase_default(card)
    log("[phase 11] pose correction (phase 3's slice, pose mode, %d Adam steps)" % STEPS)
    pose = phase_pose(card, res["data"], res["cfg"])
    log("[phase 12a, 12f] loss offset on the slice (%d Adam steps), then the prep cache" % STEPS)
    seq = res.pop("seq")
    offset = phase_offset_cache(card, seq)
    log("[phase 12b] ICP training on the slice (%d Adam steps) and eval_icp" % STEPS)
    icp = phase_icp(card, seq)
    log("[phase 12c] L-BFGS with the zoom line search on the slice (%d steps)" % LBFGS_STEPS)
    lbfgs = phase_lbfgs(card, res["data"])
    log("[phase 12e] resume (%d steps, checkpoint_period 2)" % RESUME_STEPS)
    resume = phase_resume(card, res["data"])
    seconds = {}
    t1 = time.perf_counter()
    log("[phase 13] plane neighbourhoods on phase 3's scans (%d Adam steps)" % STEPS)
    plane = phase_plane(card, seq)
    seconds["13"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("[phase 14] a KITTI-360 drive of phase 3's scans (%d Adam steps), the native KD-tree"
        % STEPS)
    k360 = phase_kitti360(card, seq, small)
    seconds["14"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("[phase 15] a rendered room mesh (%d poses, 1,024 x 64 beams)" % RENDER_POSES)
    render = phase_render(card)
    seconds["15"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("[phase 16] SLAM on phase 3's corrected scans (%d ICP iterations a scan)" % SLAM_ITERS)
    slam = phase_slam(card, seq, res["cfg"], res["model"])
    seconds["16"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("[phase 17] the loss landscape (%d weights) and joint learning (%d steps) on phase 3's "
        "slice" % (LANDSCAPE_WEIGHTS, JOINT_STEPS))
    analysis = phase_analysis(card, res["data"], res["cfg"])
    seconds["17"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("[phase 18] multi-GPU: a one-rank NCCL group, %d ranks rehearsed in one process"
        % REHEARSAL_RANKS)
    multi = phase_multi_gpu(card, res, seq)
    seconds["18"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("[phase 19a] the studies: train_at_scale at its defaults (%d timed steps), both engines"
        % SCALE_TIMED_STEPS)
    scale = phase_scale(card)
    seconds["19a"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("[phase 19b] the studies: bench_knn at %s points" % ", ".join(str(n) for n in KNN_SIZES))
    knn = phase_bench_knn(card)
    seconds["19b"], t1 = time.perf_counter() - t1, time.perf_counter()
    log("[phase 19c] the studies: every other study's main() once")
    studies = phase_studies(card, seq)
    seconds["19c"], t1 = time.perf_counter() - t1, time.perf_counter()
    del seq
    log("[phase 20] X4 and X5 on the capped row's graph and the scale run's gather graph")
    tr = phase_transpose(card, {"capped": (capped.pop("cfg"), capped.pop("data")),
                                "scale": scale.pop("gather_graph")})
    exc_locality = exception_locality(card, res["data"])
    seconds["20"] = time.perf_counter() - t1
    log("phases 13-20: %s s" % ", ".join("%s %.1f" % kv for kv in seconds.items()))
    log("build + all phases: %.1f s (%s)" % (time.perf_counter() - t0, card))
    from depth_correction_tpu_torch import scripts

    log("kernel_ms: %d extra calls for profiles taken again; %d timings queued behind a spin "
        "kernel after %d empty profiles" % (scripts.RETAKEN_CALLS, scripts.QUEUED_TIMINGS,
                                            scripts.PROFILE_ATTEMPTS))
    k = res["kernels"]
    g = res["graph"]
    shadow = default["shadow"]
    kept_f, kept_b = k["kept"]["fwd"], k["kept"]["bwd"]
    kernels = [
        {"name": "cellwin_fwd (K1)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/cellwin.cu",
         "replaces": "depth_correction_tpu/ops/cellwin.py:700",
         "launches": res["launches"]["fwd"], "max_abs_err": k["fwd_err"],
         "ms": k["fwd_ms"], "kernel_ms": k["fwd_kernel_ms"], "plain_ms": k["fwd_plain_ms"],
         "bound": cellwin_fwd_bound(g, kept_f[0], members, kept_f[2]),
         "bound_all_pairs_ms": cellwin_fwd_bound(g, pairs, members)[0],
         "pairs_kept": kept_f[0], "library_ms": None},
        {"name": "cellwin_bwd (K2)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/cellwin.cu",
         "replaces": "depth_correction_tpu/ops/cellwin.py:837",
         "launches": res["launches"]["bwd"], "max_abs_err": k["bwd_err"],
         "ms": k["bwd_ms"], "kernel_ms": k["bwd_kernel_ms"], "plain_ms": k["bwd_plain_ms"],
         "bound": cellwin_bwd_bound(g, kept_b[0], members, kept_b[2]),
         "bound_all_pairs_ms": cellwin_bwd_bound(g, kept_b[1], members)[0],
         "pairs_kept": kept_b[0], "library_ms": None},
        {"name": "slab_window (X1)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/slabwin.cu",
         "replaces": "depth_correction_tpu/ops/slabwin.py:53",
         "launches": node["launches"]["slab"], "max_abs_err": node["x1_err"],
         "ms": node["x1_ms"], "plain_ms": node["x1_plain_ms"],
         "bound": node["x1_bound"], "bound_all_pairs_ms": node["x1_bound_all_pairs"][0],
         "pairs_kept": node["x1_kept"][0], "box_tests": node["x1_kept"][2],
         "kept_share": node["x1_kept"][0] / node["x1_kept"][1], "library_ms": None},
        # Top-level times at the probe's shapes, from phase 8; each shape's
        # own in "shapes".
        {"name": "gather_moments (P7)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/gather_moments.cu",
         "replaces": "scripts/exp_pallas_gather.py:83",
         "launches": small["launches"]["gather"], "max_abs_err": small["p7_err"],
         "ms": p7_probe["ms"], "kernel_ms": p7_probe["kernel_ms"],
         "plain_ms": small["p7_plain_ms"], "bound": small["p7_bound"], "library_ms": None,
         "shapes": {"probe": p7_shape(p7_probe), "small_scan": p7_shape(small["p7_node"]),
                    "global_cloud": p7_shape(grid["p7_global"])},
         # P7's launches in prep: the slice's and the default config's.
         "launches_prep_slice": res["launches"]["gather_prep"],
         # The two-pass form on the gather steps' graphs (phase 20).
         "centred": {lbl: {k: r[k] for k in ("p7_centred_ms", "p7_centred_kernel_ms", "p7_ms",
                                             "p7_kernel_ms")} for lbl, r in tr.items()},
         "launches_default": default["launches"]["gather"],
         "vp_dispersion_err": default["vp"]["err"]},
        {"name": "grid_query (X2)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/grid_query.cu",
         "replaces": "depth_correction_tpu/ops/grid_hash.py:108",
         "launches": res["launches"]["grid"], "max_abs_err": grid["global"]["err"],
         "ms": grid["global"]["ms"], "plain_ms": grid["global"]["plain_ms"],
         "bound": grid["global"]["bound"], "library_ms": None,
         "variants": dict({"global_counts": grid["global"]["counts_ms"],
                           "scan": grid["scan"]["ms"], "scan_counts": grid["scan"]["counts_ms"]},
                          **{"node_k%d" % kk: e["ms"] for kk, e in grid["node_x2"].items()})},
        {"name": "knn_brute (X3)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/knn_brute.cu",
         "replaces": "depth_correction_tpu/ops/knn.py:51",
         "launches": small["launches"]["knn"], "max_abs_err": small["x3"]["err"],
         "ms": small["x3"]["ms"], "plain_ms": small["x3"]["plain_ms"], "bound": small["x3"]["bound"],
         "bound_all_pairs_ms": small["x3"]["bound_all_pairs"][0], "library_ms": None,
         "launches_default": default["launches"]["knn"],
         "launches_icp_eval": icp["x3_launches"], "launches_slam": slam["launches"],
         "slam_mapper_last": slam["last"], "slam_street_map": slam["street"],
         "mapping_accuracy": analysis["x3_map"],
         "inputs": {"small_scan": x3_summary(small["x3"]),
                    "shadow_dirs": dict(x3_summary(shadow), dropped=shadow["dropped"]),
                    "default_global": x3_summary(default["global"]),
                    "icp_pairs": icp["x3"]}},
        # Phase 16: the mapper's last registration's first step.
        {"name": "icp_solve (X6)", "route": "cuda",
         "source": "depth_correction_tpu_torch/csrc/icp_solve.cu",
         "replaces": "depth_correction_tpu/slam_eval.py:48",
         "launches": slam["x6_launches"], "max_abs_err": slam["x6"]["T_gap_f64_twin"],
         "ms": slam["x6"]["ms"], "kernel_ms": slam["x6"]["kernel_ms"],
         "plain_ms": slam["x6"]["plain_ms"],
         "bound": (slam["x6"]["bound_ms"], slam["x6"]["bound_by"]), "library_ms": None,
         "inputs": {k: v for k, v in slam["x6"].items()
                    if k not in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by")}},
    ] + [transpose_entry(tr, key, {"capped": capped["launches"][key],
                                   "default": default["launches"][key],
                                   "offset": offset["launches"][key],
                                   "nn_scale": default["nn_scale"]["launches"][key],
                                   "kitti360_default": k360["default"]["launches"][key],
                                   "scale_gather": scale["gather"]["launches"][key],
                                   "scale_cellwin": scale["cellwin"]["launches"][key]})
         for key in ("x4", "x5")] + probes
    # Phase 14's launches (prep for X2, X3 and P7; the 8 steps for K1, K2).
    k360_launches = {"cellwin_fwd (K1)": k360["launches"]["fwd"],
                     "cellwin_bwd (K2)": k360["launches"]["bwd"],
                     "grid_query (X2)": k360["prep_launches"]["grid"],
                     "knn_brute (X3)": k360["prep_launches"]["knn"],
                     "gather_moments (P7)": k360["prep_launches"]["gather"]}
    for en in kernels:
        if en["name"] in k360_launches:
            en["launches_kitti360"] = k360_launches[en["name"]]
    # Phase 19: the scale run's launches (prep and 13 steps) on each engine,
    # K1 / K2 on the scale graph, X2 / X3 in bench_knn.
    scale_keys = {"cellwin_fwd (K1)": "fwd", "cellwin_bwd (K2)": "bwd", "grid_query (X2)": "grid",
                  "gather_moments (P7)": "gather", "knn_brute (X3)": "knn"}
    sk = scale["kernels"]
    for en in kernels:
        key = scale_keys.get(en["name"])
        if key:
            en["launches_scale"] = {b: scale[b]["launches"][key] for b in ("gather", "cellwin")}
        if key in ("fwd", "bwd"):
            en["scale"] = {"graph": scale["kernels_graph"], "ms": sk[key + "_ms"],
                           "kernel_ms": sk[key + "_kernel_ms"],
                           "plain_ms": sk[key + "_plain_ms"], "max_abs_err": sk[key + "_err"],
                           "bound_ms": sk[key + "_bound"][0], "bound_by": sk[key + "_bound"][1]}
        if key in ("grid", "knn"):
            en["launches_bench_knn"] = knn["launches"][key]
            en["bench_knn_ms"] = {str(r["n"]): r["grid_ms" if key == "grid" else "scan_ms"]
                                  for r in knn["rows"]}
    for en in kernels:
        en["bound_ms"], en["bound_by"] = en.pop("bound")
        log("%-26s %10.4f ms, bound %.4f ms (%s), %d launches" % (
            en["name"], en["ms"], en["bound_ms"], en["bound_by"], en["launches"]))
    # The end-to-end numbers under bench.py's keys (bench.py:745-778).
    print(json.dumps({"bench": {
        "train_step_ms": res["step_ms"], "loss_rel_err_w0": res["loss_rel"],
        "w_rel_err_6steps": res["w_rel"], "capped32_ms": capped["ms"],
        "capped32_loss_rel_err_w0": capped["loss_rel"], "node_ms": node["ms"],
        "node_e2e_ms": node["e2e_ms"], "node_points": node["points"],
        "small_node_ms": small["ms"], "small_node_e2e_ms": small["e2e_ms"],
        "grid_node_ms": gnode["ms"], "prep_s": res["prep_s"],
        "local_features_s": res["data"].prep_seconds.get("local_features"),
        "default_loss_rel_err_w0": default["loss_rel"], "pose_step_ms": pose["step_ms"],
        "pose_loss_rel_err": pose["loss_rel"], "pose_grad_rel_err": pose["grad_rel"],
        "step_busy_ms": res["profile"]["busy_ms"], "step_wall_ms": res["profile"]["wall_ms"],
        "capped_busy_ms": capped["profile"]["busy_ms"],
        "capped_wall_ms": capped["profile"]["wall_ms"],
        "pose_busy_ms": pose["profile"]["busy_ms"], "pose_wall_ms": pose["profile"]["wall_ms"],
        "default_pose_eval_loss": default["pose"]["eval_loss"],
        "offset_step_ms": offset["step_ms"], "offset_loss_rel_err_w0": offset["loss_rel"],
        "offset_busy_ms": offset["profile"]["busy_ms"],
        "offset_wall_ms": offset["profile"]["wall_ms"],
        "icp_step_ms": icp["step_ms"], "icp_loss_rel_err_w0": icp["loss_rel"],
        "icp_prep_s": icp["prep_s"], "icp_eval_ms": icp["eval_ms"],
        "icp_eval_loss_rel_err": icp["eval_rel"], "lbfgs_step_ms": lbfgs["step_ms"],
        "lbfgs_evals_per_step": lbfgs["evals_per_step"],
        "nn_scale_loss_rel_err_w0": default["nn_scale"]["loss_rel"],
        "nn_scale_features_rel_err": max(default["nn_scale"]["features_rel"].values()),
        "resume_max_abs_dw": resume["max_abs_dw"], "resume_bit_equal": resume["bit_equal"],
        "prep_cache_build_s": offset["build_s"], "prep_cache_load_s": offset["load_s"],
        "plane_step_ms": plane["step_ms"], "plane_prep_s": plane["prep_s"],
        "plane_ransac_ms": plane["ransac_ms"], "plane_cluster_s": plane["cluster_s"],
        "plane_score_peak_mb": plane["peak_mb"], "plane_loss_rel_err_w0": plane["loss_rel"],
        "plane_support_ties": plane["ties"], "plane_busy_ms": plane["profile"]["busy_ms"],
        "plane_wall_ms": plane["profile"]["wall_ms"], "kitti360_step_ms": k360["step_ms"],
        "kitti360_prep_s": k360["prep_s"], "kitti360_loss_rel_err_w0": k360["loss_rel"],
        "kitti360_default_built": k360["default"]["built"],
        "kitti360_default_step_ms": k360["default"]["step_ms"],
        "kitti360_default_prep_s": k360["default"]["prep_s"],
        "kitti360_default_loss_rel_err_w0": k360["default"]["loss_rel"],
        "kitti360_default_step_launches": k360["default"]["launches"],
        "native_build_s": k360["native"]["build_s"], "native_query_s": k360["native"]["query_s"],
        "native_ties": k360["native"]["ties"], "raycast_ms": render["raycast_ms"],
        "render_s": render["render_s"], "render_busy_ms": render["profile"]["busy_ms"],
        "render_wall_ms": render["profile"]["wall_ms"], "raycast_t_rel_err": render["t_rel"],
        "raycast_near_ties": render["ties"],
        "slam_odometry_ms_per_scan": slam["odometry_ms"],
        "slam_mapper_ms_per_scan": slam["mapper_ms"],
        "slam_odometry_busy_ms": slam["profiles"]["odometry"]["busy_ms"],
        "slam_odometry_wall_ms": slam["profiles"]["odometry"]["wall_ms"],
        "slam_mapper_busy_ms": slam["profiles"]["mapper"]["busy_ms"],
        "slam_mapper_wall_ms": slam["profiles"]["mapper"]["wall_ms"],
        "slam_pose_err_m": max(d["m"] for d in slam["diffs"].values()),
        "slam_pose_err_rad": max(d["rad"] for d in slam["diffs"].values()),
        "slam_prior_t_err_m": slam["prior_t"], "slam_mapper_t_err_m": slam["mapper_t"],
        "slam_odometry_t_err_m": slam["odometry_t"], "eval_slam_all_s": slam["e2e_s"],
        "landscape_ms_per_weight": analysis["landscape_ms"],
        "landscape_loss_rel_err": analysis["landscape_rel"], "joint_step_ms": analysis["joint_ms"],
        "joint_map_acc_rel_err": analysis["map_acc_rel"],
        "joint_gt_map_points": analysis["gt_map_points"],
        "dist1_step_ms": multi["dist1_step_ms"],
        "dist1_busy_ms": multi["dist1_profile"]["busy_ms"],
        "dist1_turns_single_ms": multi["dist1_turns_ms"][0],
        "dist1_turns_sharded_ms": multi["dist1_turns_ms"][1],
        "dist1_profiled_wall_ms": multi["dist1_profile"]["wall_ms"],
        "dist1_loss_rel_diff": multi["dist1_loss_rel"],
        "dist1_w_rel_diff": multi["dist1_w_rel"], "dist1_bit_equal": multi["dist1_bit_equal"],
        "dist1_resident_bytes": multi["dist1_resident_bytes"],
        "dist1_prep_whole_bytes": multi["dist1_prep_whole_bytes"],
        "dist1_peak_bytes": multi["dist1_peak_bytes"],
        "rehearsal_ranks": multi["rehearsal_ranks"],
        "rehearsal_moments_max_abs_diff": multi["rehearsal_moments_diff"],
        "rehearsal_grad_max_abs_diff": multi["rehearsal_grad_diff"],
        "rehearsal_x2_equal": multi["rehearsal_x2_equal"], "cards": multi["cards"],
        "scale_load_s": scale["load_s"], "scale_points": scale["gather"]["counts"]["global"],
        "scale_kernels_graph": scale["kernels_graph"],
        **{"scale_%s_%s" % (k, b): v for b in ("gather", "cellwin") for k, v in (
            ("query_rows", scale[b]["counts"]["query"]), ("k", scale[b]["counts"]["k"]),
            ("engine", scale[b]["engine"]["engine"]), ("exc_share", scale[b]["engine"]["exc_share"]),
            ("step_ms", scale[b]["step_ms"]), ("step_ms_min", min(scale[b]["step_ms_all"])),
            ("step_ms_max", max(scale[b]["step_ms_all"])), ("prep_s", scale[b]["prep_s"]),
            ("loss_rel_err_w0", scale[b]["loss_rel"]), ("w", scale[b]["w"]),
            ("w_rel_err", scale[b]["w_rel"]), ("peak_bytes", scale[b]["peak_bytes"]),
            ("busy_ms", scale[b]["profile"]["busy_ms"]),
            ("wall_ms", scale[b]["profile"]["wall_ms"]),
            ("kernels_per_step", scale[b]["profile"]["kernels_per_call"]))},
        "bench_knn": {str(r["n"]): {k: r[k] for k in ("grid_ms", "scan_ms", "scipy_ms",
                                                       "ball_mean", "ball_max")}
                      for r in knn["rows"]},
        "bench_knn_sets_equal": knn["rows"][0]["sets_equal"],
        "studies_s": {name: r["seconds"] for name, r in studies.items()},
        **{"transpose_%s_%s" % (lbl, k): r["step"][v] for lbl, r in tr.items()
           for k, v in (("points_grad_rel_err", "points_rel"), ("w_grad_rel_err", "w_rel"),
                        ("points_grad_rel_err_f64", "points_rel_f64"))},
        "transpose_exception_pairs_per_row": exc_locality,
        "offset_busy_share": offset["profile"]["busy_ms"] / offset["profile"]["wall_ms"],
        "capped_busy_share": capped["profile"]["busy_ms"] / capped["profile"]["wall_ms"],
        "phase_s": seconds,
        "kernel_ms_retaken_calls": scripts.RETAKEN_CALLS,
        "kernel_ms_queued_timings": scripts.QUEUED_TIMINGS, "card": card}}), flush=True)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                                sys.argv[5]))
    sys.exit(main())
