"""Probe scripts of the port, each the counterpart of the JAX package's
script of the same name under ``scripts/``, and ``exp_grid_prep_diff``,
which compares grid and scipy establishment of the bench slice (run them
as ``python -m depth_correction_tpu_torch.scripts.<name>``), and what they
share: the bench's training configuration and slice, device timing and
the error measures they report.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

__all__ = ["PROFILE_ATTEMPTS", "PROFILE_PAD_S", "QUEUED_TIMINGS", "QUEUE_ATTEMPTS",
           "RETAKEN_CALLS", "bench_config", "device_ms", "in_turns", "kernel_ms", "queued_ms",
           "rel_max", "rel_rows", "require_card", "slice_clouds"]

# Calls of a timed function that kernel_ms made for profiles it took again
# (each a call more than its caller asked for); a caller that counts the
# launches of the timed function adds these.
RETAKEN_CALLS = 0
# Profiles a kernel_ms call takes before it times the calls by queued_ms.
PROFILE_ATTEMPTS = 5
# Seconds kernel_ms waits inside its first profile before the calls and
# after them (three times as long at each profile taken again).
PROFILE_PAD_S = 0.05
# kernel_ms calls that every profile failed, timed by queued_ms instead.
QUEUED_TIMINGS = 0
# Readings queued_ms takes before it raises.
QUEUE_ATTEMPTS = 3
_SPIN_CYCLES_PER_MS = None

# bench.py's uncapped training scene.
SCENE = "open_box/n_6_size_20_20_5_height_1_density_400"


def bench_config(device: str = "cuda", steps: int = 8, uncapped: bool = True):
    """bench.py:bench_config(uncapped): the training slice's configuration
    (the r = 0.25 graph of :data:`SCENE`, established by the grid search,
    normalised min-eigenvalue loss, Adam); uncapped, the within-r graph
    and the cell-window kernels; capped (bench.py:143-147), K = 32 with
    mutual trimming and the gather moments."""
    from ..config import Config

    cfg = Config()
    cfg.nn_backend = "grid"
    cfg.device = device
    cfg.float_type = "float32"
    cfg.dataset = "open_box"
    cfg.train_names = [SCENE]
    cfg.min_depth, cfg.max_depth = 1.0, 25.0
    cfg.grid_res = 0.1
    cfg.nn_r, cfg.nn_k = 0.25, 0
    cfg.min_valid_neighbors = 5
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = [[0, 1, 0, 0.25], [1, 2, 0.25, 1.0]]
    cfg.loss = "min_eigval_loss"
    cfg.loss_kwargs = {"sqrt": False, "normalization": True}
    cfg.depth_bias_model_kwargs = {"w": [-0.002], "exponent": [4.0]}
    cfg.model_kwargs = {"w": [0.0], "exponent": [4.0]}
    cfg.lr = 2e-4
    cfg.nn_max_neighbors = None if uncapped else 32
    cfg.moments_backend = "auto" if uncapped else "gather"
    cfg.n_opt_iters = steps
    cfg.plot_period = 1
    return cfg


def slice_clouds(device):
    """The bench slice's global cloud and first scan as prep builds them
    (filtered feature clouds, ground-truth poses): ((points, valid) of the
    global cloud, (points, valid) of scan 0), float32 on ``device``."""
    from ..datasets import create_dataset
    from ..preproc import global_cloud, local_feature_cloud, pad_size, sequence_batch

    cfg = bench_config(str(device))
    ds = create_dataset(cfg.train_names[0], cfg)
    scans = [(scan, pose) for scan, pose in ds]
    pad = max(pad_size(len(s)) for s, _ in scans)
    clouds = [local_feature_cloud(s, cfg, pad_to=pad) for s, _ in scans]
    batch = sequence_batch(clouds, np.stack([np.asarray(p) for _, p in scans]))
    g = global_cloud(batch)
    scan0 = batch.cloud.map(lambda x: x[0])
    return ((g.get_points().contiguous(), g.valid),
            (scan0.to_points().contiguous(), scan0.valid), float(cfg.nn_r))


def require_card() -> torch.device:
    """The CUDA device the probes measure on; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes time kernels on a CUDA card; none is available")
    return torch.device("cuda")


def device_ms(fn, device, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn`` on the CUDA ``device`` after
    ``warmup`` calls, by CUDA events around ``reps`` calls."""
    if torch.device(device).type != "cuda":
        raise ValueError("device_ms times CUDA devices, got %s" % device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, device, reps: int, warmup: int = 2) -> float:
    """Mean device time per call of ``fn``'s kernels on the CUDA ``device``:
    the kernels' own durations under torch.profiler over ``reps`` calls,
    after ``warmup`` calls. Unlike :func:`device_ms` it leaves out the gaps
    between kernels, so a kernel that ends before the host has issued the
    next call reads its own time, not the host's issue rate.

    The profiler drops every record that its clock places outside the
    profile's window (kineto's "Out-of-range" records). On an H100 its
    device timestamps have stood tens of milliseconds off the host's, and
    late in a long process 19 of a profile's 20 launches were dropped, or
    all of them, which left the profile empty (twice a whole smoke run
    failed so). So the host waits :data:`PROFILE_PAD_S` inside the profile
    before the first call and again after the last. A profile in which a
    kernel's recorded launches are not a multiple of ``reps`` (a launch
    dropped), or that recorded no kernel, is taken again with waits three
    times as long, up to :data:`PROFILE_ATTEMPTS` profiles in all. Each
    kernel counts as its mean recorded duration times its launches per
    call (its recorded launches over ``reps``, at least one), from the
    last profile that recorded any kernel. If none did, the calls are
    timed by :func:`queued_ms` instead, which also leaves out the host's
    gaps, and the call is counted in :data:`QUEUED_TIMINGS`. The calls of
    each profile taken again, and those of the queued timing, are added to
    :data:`RETAKEN_CALLS`.
    """
    global RETAKEN_CALLS, QUEUED_TIMINGS
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if torch.device(device).type != "cuda":
        raise ValueError("kernel_ms times CUDA devices, got %s" % device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    reading = None
    for attempt in range(PROFILE_ATTEMPTS):
        pad = PROFILE_PAD_S * 3 ** attempt
        if attempt:
            RETAKEN_CALLS += reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count > 0]
        if events:
            reading = sum(e.self_device_time_total / e.count * max(1, round(e.count / reps))
                          for e in events) / 1e3
            if all(e.count % reps == 0 for e in events):
                return reading
        if attempt + 1 < PROFILE_ATTEMPTS:
            print("kernel_ms: a profile of %d calls, %.2f s before and after them, recorded %s; "
                  "taking it again" % (reps, pad, ", ".join(
                      "%d launches of %s" % (e.count, e.key[:48]) for e in events)
                      or "no kernel"), file=sys.stderr)
    if reading is not None:
        print("kernel_ms: %d profiles of %d calls dropped launches; the last one's per-launch "
              "means stand" % (PROFILE_ATTEMPTS, reps), file=sys.stderr)
        return reading
    print("kernel_ms: %d profiles of %d calls recorded no kernel; timing the calls queued "
          "behind a spin kernel instead" % (PROFILE_ATTEMPTS, reps), file=sys.stderr)
    QUEUED_TIMINGS += 1
    ms, calls = _queued(fn, reps)
    RETAKEN_CALLS += calls
    return ms


def _spin_cycles_per_ms() -> float:
    """The card's clock cycles a millisecond of ``torch.cuda._sleep``,
    measured once by CUDA events around a spin of 2^24 cycles."""
    global _SPIN_CYCLES_PER_MS
    if _SPIN_CYCLES_PER_MS is None:
        cycles = 1 << 24
        torch.cuda._sleep(1 << 10)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS = cycles / start.elapsed_time(end)
    return _SPIN_CYCLES_PER_MS


def _queued(fn, reps: int) -> tuple:
    """(mean device ms per call, calls made): :func:`queued_ms` after no
    warm call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    spin_ms = 2 * (time.perf_counter() - t0) * 1e3 + 1.0
    calls = reps
    for _ in range(QUEUE_ATTEMPTS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms()))
        start.record()
        for _ in range(reps):
            fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        calls += reps
        if covered:
            return start.elapsed_time(end) / reps, calls
        spin_ms *= 4
    raise RuntimeError("queued_ms: the host had not issued %d calls before a spin of %.1f ms "
                       "ended, %d times" % (reps, spin_ms / 4, QUEUE_ATTEMPTS))


def queued_ms(fn, device, reps: int, warmup: int = 2) -> float:
    """Mean device ms per call of ``fn`` on the CUDA ``device`` with the
    host ahead of the card: CUDA events around ``reps`` calls that the host
    issued while a spin kernel (``torch.cuda._sleep``) still held the
    stream, so the host's issue rate leaves no gap between the calls'
    kernels and only the card's own launch gaps remain, unlike
    :func:`device_ms`. The spin lasts twice the host's time for ``reps``
    calls, plus 1 ms. If the card had already reached the start event when
    the host had issued the last call, the reading is taken again with a
    spin four times as long, up to :data:`QUEUE_ATTEMPTS` in all, and then
    it raises (a ``fn`` that waits for the card cannot be queued)."""
    if torch.device(device).type != "cuda":
        raise ValueError("queued_ms times CUDA devices, got %s" % device)
    for _ in range(warmup):
        fn()
    return _queued(fn, reps)[0]


def in_turns(first, second, device, reps: int = 50, timer=None) -> tuple:
    """(first ms, second ms, the four readings): ``timer``'s means over
    ``reps`` calls each (:func:`device_ms`, CUDA events, by default; or
    :func:`kernel_ms`), timed first, second, second, first; each the mean
    of its two."""
    timer = device_ms if timer is None else timer
    a1 = timer(first, device, reps)
    b1 = timer(second, device, reps)
    b2 = timer(second, device, reps)
    a2 = timer(first, device, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2, (a1, b1, b2, a2)


def rel_max(got, ref) -> float:
    """max |got - ref| / max |ref| over the whole output (the measure of
    scripts/exp_mosaic_dot_probe.py:105)."""
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def rel_rows(got, ref) -> float:
    """The largest over output rows of max |got - ref| / max |ref| within
    the row (absolute on a row whose reference is all zero)."""
    ref = ref.double()
    d = (got.double() - ref).abs().amax(-1)
    s = ref.abs().amax(-1)
    return float(torch.where(s > 0, d / torch.where(s > 0, s, 1.0), d).max())
