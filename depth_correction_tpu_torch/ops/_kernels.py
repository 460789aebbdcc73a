"""Build and bind the package's CUDA kernels (``csrc/*.cu``).

Route: one ``nvcc`` call compiles every source, in parallel threads
(``--threads 0``), into one shared library with a plain C interface, which
``ctypes`` loads; no PyTorch headers are compiled, so a build takes
seconds. The library is built at first use into
``depth_correction_tpu_torch/_build/`` under a name keyed by a hash of all
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import: the CPU tests import every module.

The launchers validate device, dtype, shape and contiguity before passing
pointers, launch on the current stream, and raise when the C entry returns
a CUDA error. Launch counts of K1/K2 are kept by their callers in
``ops/cellwin.py``; X1-X6, P2-P7, P7a and the probes P1 and P8 count here
(the ``*_LAUNCHES`` names of ``__all__``: :data:`SLAB_LAUNCHES`,
:data:`GRID_LAUNCHES`, :data:`TRANSPOSE_MOMENTS_LAUNCHES`,
:data:`TRANSPOSE_GATHER_LAUNCHES`, :data:`KNN_LAUNCHES`,
:data:`GATHER_LAUNCHES`, :data:`KNOCKOUT_LAUNCHES`, :data:`DOT_LAUNCHES`,
:data:`WINDOW_LAUNCHES`, :data:`LAYOUT_LAUNCHES`,
:data:`GATHER_SUM_LAUNCHES`, :data:`GATHER_PROBE_LAUNCHES`,
:data:`ICP_SOLVE_LAUNCHES`), once per accepted launch (X6 once per ICP
step, at its second launch); :data:`KNN_NEAREST_LAUNCHES` counts the X3
launches that took its nearest search (k = 1, no radius).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time

import torch

from ..utils import trace

__all__ = [
    "DOT_LAUNCHES",
    "GATHER_LAUNCHES",
    "GATHER_PACK_MIN_PAIRS",
    "GATHER_PROBE_LAUNCHES",
    "GATHER_SUM_LAUNCHES",
    "GRID_LAUNCHES",
    "ICP_SOLVE_LAUNCHES",
    "ICP_STATS",
    "KNN_LAUNCHES",
    "KNN_NEAREST_LAUNCHES",
    "KNOCKOUT_LAUNCHES",
    "LAYOUT_LAUNCHES",
    "SLAB_LAUNCHES",
    "TRANSPOSE_GATHER_LAUNCHES",
    "TRANSPOSE_MOMENTS_LAUNCHES",
    "WINDOW_LAUNCHES",
    "build",
    "knn_max_k",
    "knn_tiles_max_k",
    "launch_cellwin_bwd",
    "launch_cellwin_fwd",
    "launch_cellwin_knockout",
    "launch_gather_moments",
    "launch_gather_probe",
    "launch_gather_sum",
    "launch_grid_query",
    "launch_icp_gate",
    "launch_icp_solve",
    "launch_knn_brute",
    "launch_layout_probe",
    "launch_moment_dot",
    "launch_moment_window",
    "launch_slab_window",
    "launch_transpose_gather",
    "launch_transpose_moments",
    "load",
    "reset_launch_counts",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(os.path.join(_PKG_DIR, "csrc", name)
                for name in ("cellwin.cu", "gather_moments.cu", "slabwin.cu",
                             "cellwin_knockout.cu", "moment_dot.cu", "moment_window.cu",
                             "grid_query.cu", "layout_probe.cu", "gather_probe.cu",
                             "knn_brute.cu", "knn_warp.cu", "gather_sum.cu",
                             "transpose_gather.cu", "icp_solve.cu"))
# Headers the sources include; they key the build like the sources.
HEADERS = tuple(os.path.join(_PKG_DIR, "csrc", name)
                for name in ("cellwin_fwd.cuh", "tf32_mma.cuh", "wgmma_tf32.cuh"))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # Compile the sources in parallel threads, one per CPU.
    "--threads", "0",
    # ptxas reports each kernel's registers, shared memory and spills into
    # the build log; it does not change the binary.
    "-Xptxas", "-v",
)

# Launches of X1 (slab-window moments), X2 (the grid radius search), X3
# (the brute-force search), X4 / X5 (the gather engine's backward over a
# transpose graph), X6 (an ICP step's gate and normal equations), P7
# (gather moments), P1 (the cell-window knockout), P2 (the moment product),
# P3-P5 (the moment product with in-kernel operands), P6 (the layout
# probes), P7a (P7's gather-sum probe) and P8 (the gather probes), counted
# where each kernel is launched and nowhere else.
SLAB_LAUNCHES = 0
GRID_LAUNCHES = 0
KNN_LAUNCHES = 0
# X3's launches that took its nearest search (k = 1, no radius: the bound
# taken from the data), counted in KNN_LAUNCHES too.
KNN_NEAREST_LAUNCHES = 0
TRANSPOSE_MOMENTS_LAUNCHES = 0
TRANSPOSE_GATHER_LAUNCHES = 0
ICP_SOLVE_LAUNCHES = 0
GATHER_LAUNCHES = 0
KNOCKOUT_LAUNCHES = 0
DOT_LAUNCHES = 0
WINDOW_LAUNCHES = 0
LAYOUT_LAUNCHES = 0
GATHER_SUM_LAUNCHES = 0
GATHER_PROBE_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "libdc_kernels_%s.so" % h.hexdigest()[:16])


def build() -> dict:
    """Compile the sources if the keyed library is missing.

    :return: {"path", "seconds" (0.0 when reused), "log" (nvcc/ptxas output)}.
    """
    path = library_path()
    log_path = path[:-3] + ".log"
    if os.path.exists(path):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return {"path": path, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (exit %d): %s\n%s"
                           % (proc.returncode, " ".join(cmd), log))
    os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial file
    with open(log_path, "w") as f:
        f.write(log)
    return {"path": path, "seconds": seconds, "log": log}


def load():
    """The bound library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        lib.dc_cellwin_fwd.argtypes = [_P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _F, _P, _P]
        lib.dc_cellwin_fwd.restype = _I
        lib.dc_cellwin_bwd.argtypes = [_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _P,
                                       _P]
        lib.dc_cellwin_bwd.restype = _I
        lib.dc_slab_window.argtypes = [_P, _P, _I, _P, _P, _P, _I, _F, _P, _P]
        lib.dc_slab_window.restype = _I
        lib.dc_grid_query.argtypes = [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _F, _I, _L, _P,
                                      _P, _P, _P]
        lib.dc_grid_query.restype = _I
        for entry in (lib.dc_gather_moments, lib.dc_gather_moments_centred):
            entry.argtypes = [_P, _L, _L, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P]
            entry.restype = _I
        lib.dc_cellwin_knockout.argtypes = [_I, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I,
                                            _I, _F, _P, _P]
        lib.dc_cellwin_knockout.restype = _I
        lib.dc_moment_dot.argtypes = [_I, _P, _P, _I, _I, _I, _P, _P]
        lib.dc_moment_dot.restype = _I
        lib.dc_layout_probe.argtypes = [_I, _P, _P, _P]
        lib.dc_layout_probe.restype = _I
        lib.dc_moment_window.argtypes = [_I, _I, _P, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I, _F,
                                         _I, _P, _P]
        lib.dc_moment_window.restype = _I
        lib.dc_gather_probe.argtypes = [_I, _I, _P, _P, _I, _I, _I, _I, _P, _P]
        lib.dc_gather_probe.restype = _I
        lib.dc_gather_sum.argtypes = [_P, _I, _P, _I, _I, _P, _P]
        lib.dc_gather_sum.restype = _I
        lib.dc_knn_brute.argtypes = [_P, _P, _I, _P, _P, _I, _F, _F, _I, _I, _I, _P, _P, _P,
                                     _P, _P]
        lib.dc_knn_brute.restype = _I
        lib.dc_knn_brute_scratch.argtypes = [_I, _I, _I, _I]
        lib.dc_knn_brute_scratch.restype = _L
        lib.dc_knn_order.argtypes = [_P, _P, _I, _F, _P, _P, _P]
        lib.dc_knn_order.restype = _I
        lib.dc_knn_order_scratch.argtypes = [_I]
        lib.dc_knn_order_scratch.restype = _L
        lib.dc_knn_warp.argtypes = [_P, _P, _I, _P, _P, _I, _F, _I, _P, _P, _P]
        lib.dc_knn_warp.restype = _I
        lib.dc_knn_brute_max_k.argtypes = [_P]
        lib.dc_knn_brute_max_k.restype = _I
        lib.dc_knn_warp_max_k.argtypes = [_P]
        lib.dc_knn_warp_max_k.restype = _I
        lib.dc_transpose_moments.argtypes = [_P, _I, _I] + [_P] * 9 + [_I, _I, _I, _P, _P]
        lib.dc_transpose_moments.restype = _I
        lib.dc_transpose_gather.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P]
        lib.dc_transpose_gather.restype = _I
        lib.dc_icp_scratch.argtypes = [_I]
        lib.dc_icp_scratch.restype = _L
        lib.dc_icp_gate.argtypes = [_P, _P, _P, _I, _P, _P, _P]
        lib.dc_icp_gate.restype = _I
        lib.dc_icp_solve.argtypes = [_P, _P, _P, _P, _P, _I, _P, _P, _F, _P, _P, _P, _P, _P,
                                     _P]
        lib.dc_icp_solve.restype = _I
        lib.dc_cuda_error_string.argtypes = [_I]
        lib.dc_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError("%s must be a tensor" % name)
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s has dtype %s, the kernel takes %s" % (name, t.dtype, dtype))
    if tuple(t.shape[:len(shape)]) != tuple(shape) or t.dim() != len(shape):
        raise ValueError("%s has shape %s, expected %s" % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _check_launch(lib, err: int, name: str):
    if err != 0:
        msg = lib.dc_cuda_error_string(err).decode()
        raise RuntimeError("%s launch failed: CUDA error %d (%s)" % (name, err, msg))


def _block_size(cap: int, name: str):
    if not 1 <= cap <= 1024:
        raise ValueError("%s=%d: one thread per slot needs 1..1024" % (name, cap))


def _launch_fwd(name, lead, pts_sorted, q_est, est_sorted, f_start, f_len, f_ctr,
                r2: float) -> torch.Tensor:
    """K1 on CUDA float32 tensors through ``dc_<name>`` (K1 itself, or a
    knockout mode of P1 with ``lead`` = (mode,)) -> (10, mq_pad)."""
    device = pts_sorted.device
    if device.type != "cuda":
        raise ValueError("the cellwin kernels take CUDA tensors, got %s" % device)
    m_pad = pts_sorted.shape[0]
    mq_pad = q_est.shape[1]
    t1, ns = f_start.shape
    _check(pts_sorted, "pts_sorted", torch.float32, (m_pad, 3), device)
    _check(est_sorted, "est_sorted", torch.float32, (est_sorted.shape[0], m_pad), device)
    _check(q_est, "q_est", torch.float32, (q_est.shape[0], mq_pad), device)
    _check(f_start, "f_start", torch.int32, (t1, ns), device)
    _check(f_len, "f_len", torch.int32, (t1, ns), device)
    _check(f_ctr, "f_ctr", torch.float32, (t1, 3), device)
    if est_sorted.shape[0] < 3 or q_est.shape[0] < 3 or t1 == 0 or mq_pad % t1:
        raise ValueError("%s: inconsistent tables (est %s, q_est %s, %d tiles)"
                         % (name, tuple(est_sorted.shape), tuple(q_est.shape), t1))
    row_cap = mq_pad // t1
    _block_size(row_cap, "row_cap")
    out = torch.empty((10, mq_pad), dtype=torch.float32, device=device)
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "dc_" + name)(
            *lead, pts_sorted.data_ptr(), est_sorted.data_ptr(), m_pad,
            q_est.data_ptr(), mq_pad, f_start.data_ptr(), f_len.data_ptr(),
            f_ctr.data_ptr(), t1, ns, row_cap, float(r2), out.data_ptr(), stream)
    # A table past the shared-memory limit (csrc/cellwin_fwd.cuh allow_smem)
    # fails here with CUDA's invalid-argument error.
    _check_launch(lib, err, "%s (%d tiles, %d mini-spans a tile)" % (name, t1, ns))
    return out


def launch_cellwin_fwd(pts_sorted, q_est, est_sorted, f_start, f_len, f_ctr,
                       r2: float) -> torch.Tensor:
    """K1 on CUDA float32 tensors -> raw (10, mq_pad) moments."""
    with trace.span("k1.cellwin_fwd"):
        return _launch_fwd("cellwin_fwd", (), pts_sorted, q_est, est_sorted, f_start, f_len,
                           f_ctr, r2)


def launch_cellwin_knockout(mode_id: int, pts_sorted, q_est, est_sorted, f_start, f_len,
                            f_ctr, r2: float) -> torch.Tensor:
    """P1, K1 with knockout ``mode_id`` (the index into
    ``ops.cellwin_knockout.MODES``), on K1's CUDA float32 inputs ->
    (10, mq_pad)."""
    global KNOCKOUT_LAUNCHES
    out = _launch_fwd("cellwin_knockout", (int(mode_id),), pts_sorted, q_est, est_sorted,
                      f_start, f_len, f_ctr, r2)
    KNOCKOUT_LAUNCHES += 1
    return out


def launch_cellwin_bwd(pts_sorted, q_est, est_sorted, table9, b_start, b_len,
                       b_ctr, r2: float) -> torch.Tensor:
    """K2 on CUDA float32 tensors -> (m_pad, 3) gradient wrt pts_sorted."""
    with trace.span("k2.cellwin_bwd"):
        device = pts_sorted.device
        if device.type != "cuda":
            raise ValueError("the cellwin kernels take CUDA tensors, got %s" % device)
        m_pad = pts_sorted.shape[0]
        mq_pad = q_est.shape[1]
        t2, ns = b_start.shape
        _check(pts_sorted, "pts_sorted", torch.float32, (m_pad, 3), device)
        _check(est_sorted, "est_sorted", torch.float32, (est_sorted.shape[0], m_pad), device)
        _check(q_est, "q_est", torch.float32, (q_est.shape[0], mq_pad), device)
        _check(table9, "table9", torch.float32, (9, mq_pad), device)
        _check(b_start, "b_start", torch.int32, (t2, ns), device)
        _check(b_len, "b_len", torch.int32, (t2, ns), device)
        _check(b_ctr, "b_ctr", torch.float32, (t2, 3), device)
        if est_sorted.shape[0] < 3 or q_est.shape[0] < 3 or t2 == 0 or m_pad % t2:
            raise ValueError("cellwin_bwd: inconsistent tables (est %s, q_est %s, %d tiles)"
                             % (tuple(est_sorted.shape), tuple(q_est.shape), t2))
        pt_cap = m_pad // t2
        _block_size(pt_cap, "pt_cap")
        out = torch.empty((m_pad, 3), dtype=torch.float32, device=device)
        lib = load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.dc_cellwin_bwd(
                pts_sorted.data_ptr(), est_sorted.data_ptr(), m_pad,
                q_est.data_ptr(), table9.data_ptr(), mq_pad, b_start.data_ptr(),
                b_len.data_ptr(), b_ctr.data_ptr(), t2, ns, pt_cap, float(r2),
                out.data_ptr(), stream)
        # A table past the shared-memory limit (csrc/cellwin_fwd.cuh allow_smem)
        # fails here with CUDA's invalid-argument error.
        _check_launch(lib, err, "cellwin_bwd (%d tiles, %d mini-spans a tile)" % (t2, ns))
        return out


def launch_slab_window(pts_T, valid, lo, width, ctr, r2: float) -> torch.Tensor:
    """X1 on CUDA tensors -> (10, n) moments of every sorted slot.

    :param pts_T: (3, n) float32 sorted positions, n a multiple of 128.
    :param valid: (n,) bool.
    :param lo, width: (n / 128, 3) int32 span starts and lengths.
    :param ctr: (n / 128, 3) float32 tile centres.
    """
    global SLAB_LAUNCHES
    with trace.span("x1.slab"):
        device = pts_T.device
        if device.type != "cuda":
            raise ValueError("the slab-window kernel takes CUDA tensors, got %s" % device)
        n = pts_T.shape[-1]
        if n % 128:
            raise ValueError("slab_window: %d slots is not a multiple of 128" % n)
        t = n // 128
        _check(pts_T, "pts_T", torch.float32, (3, n), device)
        _check(valid, "valid", torch.bool, (n,), device)
        _check(lo, "lo", torch.int32, (t, 3), device)
        _check(width, "width", torch.int32, (t, 3), device)
        _check(ctr, "ctr", torch.float32, (t, 3), device)
        if pts_T.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("slab_window is forward only: pts_T requires grad")
        out = torch.empty((10, n), dtype=torch.float32, device=device)
        lib = load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.dc_slab_window(pts_T.data_ptr(), valid.data_ptr(), n, lo.data_ptr(),
                                     width.data_ptr(), ctr.data_ptr(), t, float(r2),
                                     out.data_ptr(), stream)
        _check_launch(lib, err, "slab_window")
    SLAB_LAUNCHES += 1
    return out


# P7 packs the points into (N, 4) rows first when a launch has at least
# this many index slots (Mq * K): one 32-byte sector a neighbour instead of
# up to three, for one more launch, which a host-bound node scan would pay
# without a gain.
GATHER_PACK_MIN_PAIRS = 1 << 22


def launch_gather_moments(points, neighbors, weights, centred: bool = False):
    """P7 on CUDA tensors -> (mean (3, Mq), comps (6, Mq), w_sum (Mq,)).

    :param points: (N, 3) or (3, N) float32 (a (3, 3) table is read as
        (N, 3)); any strides. Packed into (N, 4) rows first when Mq * K is
        at least :data:`GATHER_PACK_MIN_PAIRS`.
    :param neighbors: (Mq, K) int32, -1 padded.
    :param weights: (Mq, K) float32.
    :param centred: the two-pass form (``dc_gather_moments_centred``: the
        covariance summed about the mean, as the plain version sums it).
    """
    global GATHER_LAUNCHES
    name = "gather_moments_centred" if centred else "gather_moments"
    with trace.span("p7.moments"):
        device = points.device
        if device.type != "cuda":
            raise ValueError("the gather-moments kernel takes CUDA tensors, got %s" % device)
        if points.dtype != torch.float32:
            raise TypeError("points has dtype %s, the kernel takes torch.float32"
                            % points.dtype)
        if points.dim() != 2 or 3 not in points.shape:
            raise ValueError("points has shape %s, expected (N, 3) or (3, N)"
                             % (tuple(points.shape),))
        if points.shape[1] == 3:
            n_pts, sp, sc = points.shape[0], points.stride(0), points.stride(1)
        else:
            n_pts, sp, sc = points.shape[1], points.stride(1), points.stride(0)
        if points.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("gather_moments is forward only: points requires grad")
        mq, k = neighbors.shape
        _check(neighbors, "neighbors", torch.int32, (mq, k), device)
        _check(weights, "weights", torch.float32, (mq, k), device)
        mean = torch.empty((3, mq), dtype=torch.float32, device=device)
        comps = torch.empty((6, mq), dtype=torch.float32, device=device)
        wsum = torch.empty((mq,), dtype=torch.float32, device=device)
        packed = None
        if neighbors.numel() >= GATHER_PACK_MIN_PAIRS:
            packed = torch.empty((n_pts, 4), dtype=torch.float32, device=device)
        lib = load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, "dc_" + name)(points.data_ptr(), sp, sc, n_pts,
                                             neighbors.data_ptr(), weights.data_ptr(), mq, k,
                                             mean.data_ptr(), comps.data_ptr(), wsum.data_ptr(),
                                             _ptr(packed), stream)
        _check_launch(lib, err, name)
    GATHER_LAUNCHES += 1
    return mean, comps, wsum


def launch_moment_dot(prec_id: int, a, b, n_tiles: int) -> torch.Tensor:
    """P2 on CUDA float32 tensors -> (16, 128 n_tiles): columns
    [128 t, 128 t + 128) hold sum_s a[s] @ b[s] for every tile t.

    :param prec_id: index into ``ops.moment_dot.PRECISIONS``.
    :param a: (ns, 16, S) float32, S a multiple of 8.
    :param b: (ns, S, 128) float32.
    """
    global DOT_LAUNCHES
    device = a.device
    if device.type != "cuda":
        raise ValueError("the moment-product kernel takes CUDA tensors, got %s" % device)
    ns, s_len = a.shape[0], a.shape[-1]
    _check(a, "a", torch.float32, (ns, 16, s_len), device)
    _check(b, "b", torch.float32, (ns, s_len, 128), device)
    if s_len % 8 or n_tiles <= 0:
        raise ValueError("moment_dot: S = %d must be a multiple of 8 and n_tiles = %d > 0"
                         % (s_len, n_tiles))
    if (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError("moment_dot: a and b must start on 16-byte boundaries")
    out = torch.empty((16, 128 * n_tiles), dtype=torch.float32, device=device)
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dc_moment_dot(int(prec_id), a.data_ptr(), b.data_ptr(), ns, s_len,
                                int(n_tiles), out.data_ptr(), stream)
    _check_launch(lib, err, "moment_dot")
    DOT_LAUNCHES += 1
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_window(name, prec_id: int, flags: int, win, q, r2: float, n_tiles: int,
                   ns: int, s_len: int, lens, starts=None, leads=None, ctr=None, entry=None):
    """One launch of ``dc_<name>`` (P3-P5), or of the C function ``entry``
    with its signature (a variant built by
    ``scripts/exp_window_variants.py``); arguments as
    :func:`launch_moment_window`."""

    from .moment_window import FLAG_BITS

    device = win.device
    if device.type != "cuda":
        raise ValueError("the moment-window kernel takes CUDA tensors, got %s" % device)
    if s_len % 8 or n_tiles <= 0 or ns <= 0:
        raise ValueError("moment_window: S = %d must be a multiple of 8, n_tiles = %d and "
                         "ns = %d positive" % (s_len, n_tiles, ns))
    need = {name: bool(flags & bit) for name, bit in FLAG_BITS.items()}
    staged = need["staged"]
    if staged:
        _check(win, "win", torch.float32, (8, win.shape[1]), device)
    else:
        _check(win, "win", torch.float32, (ns, 8, s_len), device)
    q_cols = 128 * n_tiles if need["per_tile_q"] else 128
    _check(q, "q", torch.float32, (8, q_cols), device)
    tables = {"len_table": lens, "staged": starts, "lead": leads}
    for switch, tab in tables.items():
        if need[switch] != isinstance(tab, torch.Tensor):
            raise ValueError("moment_window: switch %s %s a table" % (
                switch, "needs" if need[switch] else "takes no"))
        if need[switch]:
            _check(tab, switch, torch.int32, (n_tiles, ns), device)
    if need["shift"] != (ctr is not None):
        raise ValueError("moment_window: ctr goes with the shift switch")
    if ctr is not None:
        _check(ctr, "ctr", torch.float32, (n_tiles, 3), device)
    # The kernel clamps every span to the table's columns: no host check of
    # the starts (it would synchronise with the card on every launch).
    out = torch.empty((16, 128 * n_tiles), dtype=torch.float32, device=device)
    len_const = 0 if need["len_table"] else int(lens)
    lib = load()
    entry = entry or getattr(lib, "dc_" + name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(
            int(prec_id), int(flags), win.data_ptr(), win.shape[-1], q.data_ptr(), q_cols,
            _ptr(starts), _ptr(leads), lens.data_ptr() if need["len_table"] else None,
            len_const, _ptr(ctr), ns, s_len, float(r2), int(n_tiles), out.data_ptr(), stream)
    _check_launch(lib, err, name)
    return out


def launch_moment_window(prec_id: int, flags: int, win, q, r2: float, n_tiles: int,
                         ns: int, s_len: int, lens, starts=None, leads=None,
                         ctr=None) -> torch.Tensor:
    """P3-P5 on CUDA float32 tensors -> (16, 128 n_tiles).

    :param flags: the switches of ``ops.moment_window`` (bit values of
        ``FLAG_BITS``); the tensors each switch needs must be given.
    :param win: (ns, 8, S) windows, or the (8, ncols) table with starts.
    :param q: (8, 128), or (8, 128 n_tiles) for per-tile q.
    :param lens: an int (every span), or an (n_tiles, ns) int32 table.
    :param starts, leads: (n_tiles, ns) int32; ctr: (n_tiles, 3) float32.
    """
    global WINDOW_LAUNCHES
    out = _launch_window("moment_window", prec_id, flags, win, q, r2, n_tiles, ns, s_len,
                         lens, starts=starts, leads=leads, ctr=ctr)
    WINDOW_LAUNCHES += 1
    return out


def launch_grid_query(q_pts, q_valid, pts_sorted_T, ids_sorted, order, mins, dims, cell, r2,
                      k: int, cap=None, own_points: bool = False):
    """X2 on CUDA tensors: k = 0 -> counts (Q,) int32; k > 0 -> (d (Q, k)
    float32, idx (Q, k) int32), -1 / inf padded.

    :param q_pts: (Q, 3) float32 queries (any strides; copied contiguous).
    :param q_valid: (Q,) bool.
    :param pts_sorted_T: (3, N) float32 positions sorted by cell id.
    :param ids_sorted: (N,) int32 sorted cell ids; order: (N,) int32.
    :param mins, dims, cell: the grid's origin (3,), dims (3,) and cell
        side, as tensors on the card or host numbers (no host read).
    :param r2: float or 0-d tensor (read once on the host).
    :param cap: cut each column's run at ``cap`` slots; None reads it whole.
    :param own_points: the queries are the grid's own points, q_pts[order]
        the columns of pts_sorted_T; the warps then take them in the grid's
        slot order, so that neighbouring warps read the same runs (each
        result still lands in its query's row).
    """
    global GRID_LAUNCHES
    if own_points and q_pts.shape[0] != pts_sorted_T.shape[-1]:
        raise ValueError("grid_query: own_points with %d queries and %d points"
                         % (q_pts.shape[0], pts_sorted_T.shape[-1]))
    with trace.span("x2.grid"):
        device = pts_sorted_T.device
        if device.type != "cuda":
            raise ValueError("the grid query kernel takes CUDA tensors, got %s" % device)
        n = pts_sorted_T.shape[-1]
        nq = q_pts.shape[0]
        q_pts = q_pts.contiguous()
        _check(q_pts, "q_pts", torch.float32, (nq, 3), device)
        _check(q_valid, "q_valid", torch.bool, (nq,), device)
        _check(pts_sorted_T, "pts_sorted_T", torch.float32, (3, n), device)
        _check(ids_sorted, "ids_sorted", torch.int32, (n,), device)
        _check(order, "order", torch.int32, (n,), device)
        if n >= 1 << 28:
            raise ValueError("grid_query: %d points, the kernel takes fewer than 2^28" % n)
        if pts_sorted_T.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("grid_query is forward only: pts_sorted_T requires grad")
        k = int(k)
        if k < 0:
            raise ValueError("grid_query: k = %d" % k)
        mins = torch.as_tensor(mins, dtype=torch.float32, device=device).reshape(3).contiguous()
        dims = torch.as_tensor(dims, device=device).to(torch.int32).reshape(3).contiguous()
        cell = torch.as_tensor(cell, dtype=torch.float32, device=device).reshape(1).contiguous()
        if k == 0:
            idx = torch.empty((nq,), dtype=torch.int32, device=device)
            d = None
        else:
            idx = torch.empty((nq, k), dtype=torch.int32, device=device)
            d = torch.empty((nq, k), dtype=torch.float32, device=device)
        lib = load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.dc_grid_query(
                q_pts.data_ptr(), q_valid.data_ptr(), nq, pts_sorted_T.data_ptr(),
                ids_sorted.data_ptr(), order.data_ptr(), n, mins.data_ptr(), dims.data_ptr(),
                cell.data_ptr(), float(r2), k, -1 if cap is None else int(cap), idx.data_ptr(),
                _ptr(d), order.data_ptr() if own_points else None, stream)
        _check_launch(lib, err, "grid_query")
    GRID_LAUNCHES += 1
    return idx if k == 0 else (d, idx)


def launch_layout_probe(probe: int, x, out_shape) -> torch.Tensor:
    """P6 probe ``probe`` (the index into ``ops.layout_probe.PROBES``) on a
    CUDA float32 x (8, 512) -> ``out_shape`` float32."""
    global LAYOUT_LAUNCHES
    device = x.device
    if device.type != "cuda":
        raise ValueError("the layout probe kernels take CUDA tensors, got %s" % device)
    _check(x, "x", torch.float32, (8, 512), device)
    out = torch.empty(tuple(out_shape), dtype=torch.float32, device=device)
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dc_layout_probe(int(probe), x.data_ptr(), out.data_ptr(), stream)
    _check_launch(lib, err, "layout_probe")
    LAYOUT_LAUNCHES += 1
    return out


def launch_gather_probe(staged: bool, axis: int, x, idx) -> torch.Tensor:
    """P8 on CUDA tensors: x (rows, cols) float32, idx (i_rows, i_cols)
    int32 in range -> take_along_axis(x, idx, axis) (i_rows, i_cols)
    float32, from device memory or (``staged``) from shared memory: one
    block's, or a cluster's of 8 blocks where an axis-1 row does not fit
    one block."""
    global GATHER_PROBE_LAUNCHES
    device = x.device
    if device.type != "cuda":
        raise ValueError("the gather probe kernels take CUDA tensors, got %s" % device)
    x_rows, x_cols = x.shape
    i_rows, i_cols = idx.shape
    _check(x, "x", torch.float32, (x_rows, x_cols), device)
    _check(idx, "idx", torch.int32, (i_rows, i_cols), device)
    out = torch.empty((i_rows, i_cols), dtype=torch.float32, device=device)
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dc_gather_probe(int(bool(staged)), int(axis), x.data_ptr(), idx.data_ptr(),
                                  x_rows, x_cols, i_rows, i_cols, out.data_ptr(), stream)
    _check_launch(lib, err, "gather_probe")
    GATHER_PROBE_LAUNCHES += 1
    return out


def _max_k(entry: str, device) -> int:
    device = torch.cuda.current_device() if device is None else device
    if (entry, device) not in _KNN_MAX_K:
        lib = load()
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = getattr(lib, entry)(ctypes.byref(out))
        _check_launch(lib, err, entry)
        _KNN_MAX_K[(entry, device)] = out.value
    return _KNN_MAX_K[(entry, device)]


_KNN_MAX_K = {}


def knn_tiles_max_k(device=None) -> int:
    """The largest k of X3's tiled body (``csrc/knn_brute.cu``), whose lists
    for one warp of 32 queries fit the shared memory per block of
    ``device`` (the current card by default): about 839 on an H100."""
    return _max_k("dc_knn_brute_max_k", device)


def knn_max_k(device=None) -> int:
    """The largest k X3 takes on ``device`` (the current card by default):
    that of the warp-per-query body (``csrc/knn_warp.cu``), which serves
    every k above :func:`knn_tiles_max_k`; about 13,680 on an H100."""
    return _max_k("dc_knn_warp_max_k", device)


def _knn_cell_order(pts, active, side: float) -> torch.Tensor:
    """(N,) int32: the rows of ``pts`` (N, 3) float32 by the Morton key of
    their cell (side max(``side``, extent / 128) over the active rows'
    box), active rows first (``active`` None: every row), equal keys in
    index order: X3's order. No path calls it: it exists for the test that
    holds the host model (scripts/knn_cull.py:cell_order), whose kept
    shares chip_smoke.py charges, to the card's order."""
    n = pts.shape[0]
    lib = load()
    scratch = torch.empty((lib.dc_knn_order_scratch(n),), dtype=torch.uint8, device=pts.device)
    order = torch.empty((n,), dtype=torch.int32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        err = lib.dc_knn_order(pts.contiguous().data_ptr(), _ptr(active), n, float(side),
                               scratch.data_ptr(), order.data_ptr(), stream)
    _check_launch(lib, err, "knn_order")
    return order


def _on_device(device):
    """``torch.cuda.device(device)``, or no scope when ``device`` is already
    current: with the raw stream handle it keeps X3's host cost per call
    (its launches are what a small search waits on) to the launches."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _same_rows(a, b) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride())


def _knn_inputs(q_pts, q_valid, pts, p_valid, k: int):
    """X3's inputs checked and made contiguous, and its outputs allocated:
    (q_pts, pts, k, idx, d2), d2 None for the counts (k = 0)."""
    device = pts.device
    if device.type != "cuda":
        raise ValueError("the brute-force search kernel takes CUDA tensors, got %s" % device)
    n, nq = pts.shape[0], q_pts.shape[0]
    q_pts, pts = q_pts.contiguous(), pts.contiguous()
    _check(q_pts, "q_pts", torch.float32, (nq, 3), device)
    _check(pts, "pts", torch.float32, (n, 3), device)
    _check(p_valid, "p_valid", torch.bool, (n,), device)
    if q_valid is not None:
        _check(q_valid, "q_valid", torch.bool, (nq,), device)
    if n >= 1 << 31 or nq >= 1 << 31:
        raise ValueError("knn_brute: %d points, %d queries; the kernel takes fewer than 2^31"
                         % (n, nq))
    if (pts.requires_grad or q_pts.requires_grad) and torch.is_grad_enabled():
        raise RuntimeError("knn_brute is forward only: its points require grad")
    k = int(k)
    if k < 0:
        raise ValueError("knn_brute: k = %d" % k)
    if k == 0:
        return q_pts, pts, k, torch.empty((nq,), dtype=torch.int32, device=device), None
    return (q_pts, pts, k, torch.empty((nq, k), dtype=torch.int32, device=device),
            torch.empty((nq, k), dtype=torch.float32, device=device))


def launch_knn_brute(q_pts, q_valid, pts, p_valid, r2: float, k: int, tally=None):
    """X3 on CUDA tensors: k = 0 -> counts (Q,) int32 of the valid points
    within r2 (every query counts); k > 0 -> (d2 (Q, k) float32, idx (Q, k)
    int32), the k nearest valid points within r2 by (d2, index), inf / -1
    padded, and all padding for a query that ``q_valid`` marks invalid.

    With a finite r2 the points and the queries are ordered by cell (side
    at least sqrt(r2)) first and each warp of queries reads only the tiles
    and chunks of points within r2 of its queries; at k = 1 with no radius
    (the nearest search, counted in :data:`KNN_NEAREST_LAUNCHES`) both are
    ordered on the points' grid and each warp reads the tiles around its
    place in the point order, then those its queries' nearest distances so
    far reach. The outputs do not depend on the order. A k above
    :func:`knn_tiles_max_k` takes the warp-per-query body of
    ``csrc/knn_warp.cu`` (every query against every point), one above
    :func:`knn_max_k` raises.

    :param q_pts: (Q, 3) float32 queries (any strides; copied contiguous).
    :param q_valid: (Q,) bool, or None (every query is valid).
    :param pts: (N, 3) float32 points (any strides; copied contiguous).
    :param p_valid: (N,) bool.
    :param r2: the squared radius as a float (``inf``: no radius).
    :param tally: None, or for the nearest search alone a ((Q + 31) // 32,)
        int32 CUDA tensor that takes the tiles of 128 points each warp of 32
        queries (in the search's order) read; for tests and measurement, no
        path passes one.
    """
    global KNN_LAUNCHES, KNN_NEAREST_LAUNCHES
    with trace.span("x3.knn"):
        same = _same_rows(q_pts, pts)
        q_pts, pts, k, idx, d2 = _knn_inputs(q_pts, q_valid, pts, p_valid, k)
        device = pts.device
        n, nq = pts.shape[0], q_pts.shape[0]
        if k > knn_tiles_max_k(device.index):
            # Past the tiled body's shared memory: X3's warp-per-query body.
            k_max = knn_max_k(device.index)
            if k > k_max:
                raise ValueError("knn_brute: k = %d does not fit: the lists of one warp hold "
                                 "at most k = %d in the card's shared memory per block"
                                 % (k, k_max))
            out = _knn_warp_body(q_pts, q_valid, pts, p_valid, r2, k, idx, d2)
            KNN_LAUNCHES += 1
            return out
        q_active = q_valid if k else None  # the counts count every query
        nearest = k == 1 and r2 == math.inf and n > 0 and nq > 0
        if tally is not None:
            if not nearest:
                raise ValueError("knn_brute: a tally is taken by the nearest search alone "
                                 "(k = 1, no radius, points and queries)")
            _check(tally, "tally", torch.int32, ((nq + 31) // 32,), device)
        # 0: no cull; 1: by the radius; 2: the nearest search.
        cull = 2 if nearest else int(math.isfinite(r2) and n > 0 and nq > 0)
        # One cell order serves points and queries when they are the same rows
        # and every row queries (counts, or a top-k without q_valid) or the
        # active queries are the valid points: the main paths' radius calls.
        share = cull == 1 and same and (q_active is None or _same_rows(q_active, p_valid))
        lib = load()
        scratch = torch.empty((lib.dc_knn_brute_scratch(nq, n, cull, int(share)),),
                              dtype=torch.uint8, device=device)
        with _on_device(device):
            # The current stream's raw handle, read without building a Stream
            # object as torch.cuda.current_stream does: a small search waits on
            # the host's cost per call.
            err = lib.dc_knn_brute(q_pts.data_ptr(), _ptr(q_active), nq, pts.data_ptr(),
                                   p_valid.data_ptr(), n, float(r2),
                                   math.sqrt(r2) if cull == 1 and r2 > 0 else 1.0, cull,
                                   int(share), k, scratch.data_ptr(), idx.data_ptr(), _ptr(d2),
                                   _ptr(tally), torch._C._cuda_getCurrentRawStream(device.index))
        _check_launch(lib, err, "knn_brute (k %d)" % k)
        KNN_LAUNCHES += 1
        KNN_NEAREST_LAUNCHES += int(nearest)
        return idx if k == 0 else (d2, idx)


def _knn_warp_body(q_pts, q_valid, pts, p_valid, r2: float, k: int, idx, d2):
    """One launch of ``csrc/knn_warp.cu`` on inputs checked by
    :func:`_knn_inputs` (``q_valid`` ignored for the counts)."""
    device = pts.device
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dc_knn_warp(q_pts.data_ptr(), _ptr(q_valid if k else None), q_pts.shape[0],
                              pts.data_ptr(), p_valid.data_ptr(), pts.shape[0], float(r2), k,
                              idx.data_ptr(), _ptr(d2), stream)
    _check_launch(lib, err, "knn_warp (k %d)" % k)
    return idx if k == 0 else (d2, idx)


def launch_gather_sum(pts_T, idx) -> torch.Tensor:
    """P7a on CUDA tensors: pts_T (3, M) float32, idx (T, K) int32 in
    [0, M) -> (3, T) float32, out[c, t] = sum over k = 0..K-1, in that order,
    of pts_T[c, idx[t, k]], gathered from the table where it lies (L2), any
    M. The indices are not checked: one outside [0, M) is undefined input."""
    global GATHER_SUM_LAUNCHES
    device = pts_T.device
    if device.type != "cuda":
        raise ValueError("the gather-sum probe kernel takes CUDA tensors, got %s" % device)
    m = pts_T.shape[-1]
    t, k = idx.shape
    _check(pts_T, "pts_T", torch.float32, (3, m), device)
    _check(idx, "idx", torch.int32, (t, k), device)
    out = torch.empty((3, t), dtype=torch.float32, device=device)
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dc_gather_sum(pts_T.data_ptr(), m, idx.data_ptr(), t, k, out.data_ptr(),
                                stream)
    _check_launch(lib, err, "gather_sum (M %d)" % m)
    GATHER_SUM_LAUNCHES += 1
    return out


def _check_tiles(tg, device) -> int:
    """A transpose graph (``ops.features.TransposeGraph``): its cell-order
    CSR (int32 ``start`` (M + 1,), ``pair`` (P,)) and tiles -> M. A graph
    without tiles raises."""
    if tg.tiles is None:
        raise ValueError("X4 and X5 walk a transpose's tiles, and this one has none: build it "
                         "with ops.features.build_transpose_graph")
    t = tg.tiles
    m = tg.start.shape[0] - 1
    p, nt = tg.pair.shape[0], t.num_tiles
    _check(tg.start, "start", torch.int32, (m + 1,), device)
    _check(tg.pair, "pair", torch.int32, (p,), device)
    _check(tg.order, "order", torch.int32, (m,), device)
    _check(t.local, "local", torch.int16, (p,), device)
    _check(t.tile_start, "tile_start", torch.int32, (nt + 1,), device)
    _check(t.row_start, "row_start", torch.int32, (nt + 1,), device)
    _check(t.rows, "rows", torch.int32, (t.rows.shape[0],), device)
    if not 0 <= t.rows_max <= t.budget:
        raise ValueError("tiles: rows_max %d outside 0..budget %d" % (t.rows_max, t.budget))
    return m


def launch_transpose_moments(points, tg, table) -> torch.Tensor:
    """X4 on CUDA float32 tensors: the gradient of the neighbourhood moments
    in the points, gathered tile by tile through a transpose graph's cell
    order -> (M, 3).

    :param points: (M, 3) positions the forward read.
    :param tg: ``ops.features.TransposeGraph`` with its tiles and float32
        weights; pair = i * tg.k + slot.
    :param table: (rows, 12) per-row S (6), mean (3), mean cotangent over
        the weight sum (3), on a 16-byte boundary.
    """
    global TRANSPOSE_MOMENTS_LAUNCHES
    with trace.span("x4.transpose_moments"):
        device = points.device
        m = _check_tiles(tg, device)
        if device.type != "cuda":
            raise ValueError("the transpose kernels take CUDA tensors, got %s" % device)
        t = tg.tiles
        _check(points, "points", torch.float32, (m, 3), device)
        _check(tg.w, "w", torch.float32, (tg.pair.shape[0],), device)
        _check(table, "table", torch.float32, (table.shape[0], 12), device)
        if table.data_ptr() % 16:
            raise ValueError("transpose_moments: the table must start on a 16-byte boundary")
        grad = torch.empty((m, 3), dtype=torch.float32, device=device)
        lib = load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.dc_transpose_moments(
                points.data_ptr(), m, t.num_tiles, tg.order.data_ptr(), tg.start.data_ptr(),
                _ptr(tg.pair), _ptr(tg.w), _ptr(t.local), t.tile_start.data_ptr(),
                t.row_start.data_ptr(), _ptr(t.rows), table.data_ptr(), int(tg.k),
                int(t.budget), int(t.rows_max), grad.data_ptr(), stream)
        _check_launch(lib, err, "transpose_moments (M %d, P %d, %d tiles)"
                      % (m, tg.pair.shape[0], t.num_tiles))
    TRANSPOSE_MOMENTS_LAUNCHES += 1
    return grad


def launch_transpose_gather(g, tg) -> torch.Tensor:
    """X5 on CUDA float32 tensors: ``g`` (slots, D), D 1 or 3, the cotangent
    of a neighbour gather by slot ``i * K + k``, summed over each target's
    run in the cell order of ``tg`` (``ops.features.TransposeGraph`` with
    its tiles) -> (M, D)."""
    global TRANSPOSE_GATHER_LAUNCHES
    with trace.span("x5.transpose_gather"):
        device = g.device
        m = _check_tiles(tg, device)
        if device.type != "cuda":
            raise ValueError("the transpose kernels take CUDA tensors, got %s" % device)
        if g.dim() != 2 or g.shape[1] not in (1, 3):
            raise ValueError("g has shape %s, expected (slots, 1) or (slots, 3)"
                             % (tuple(g.shape),))
        _check(g, "g", torch.float32, tuple(g.shape), device)
        out = torch.empty((m, g.shape[1]), dtype=torch.float32, device=device)
        lib = load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.dc_transpose_gather(_ptr(g), g.shape[1], m, tg.order.data_ptr(),
                                          tg.start.data_ptr(), _ptr(tg.pair), out.data_ptr(),
                                          stream)
        _check_launch(lib, err, "transpose_gather (M %d, P %d, D %d)"
                      % (m, tg.pair.shape[0], g.shape[1]))
    TRANSPOSE_GATHER_LAUNCHES += 1
    return out


ICP_STATS = 40  # the length of launch_icp_solve's stats


def launch_icp_gate(d2, idx, src_valid):
    """X6's first launch on CUDA tensors: each source row's sort key (its
    squared distance where its nearest target exists and it is valid, +inf
    else), each block's count of those rows into a fresh scratch, which
    :func:`launch_icp_solve` takes after the caller has sorted the keys.
    Reads nothing back.

    :param d2, idx: (N,) float32 and int32, the search's squared distance
        and index of each source row's nearest target (-1 at ``inf``: none).
    :param src_valid: (N,) bool.
    :return: (key (N,) float32, scratch (uint8)).
    """
    with trace.span("x6.icp_gate"):
        device = d2.device
        if device.type != "cuda":
            raise ValueError("the ICP step kernel takes CUDA tensors, got %s" % device)
        n = d2.numel()
        _check(d2, "d2", torch.float32, (n,), device)
        _check(idx, "idx", torch.int32, (n,), device)
        _check(src_valid, "src_valid", torch.bool, (n,), device)
        if n >= 1 << 31:
            raise ValueError("icp_gate: %d source rows; the kernel takes fewer than 2^31" % n)
        lib = load()
        scratch = torch.empty((lib.dc_icp_scratch(n),), dtype=torch.uint8, device=device)
        key = torch.empty((n,), dtype=torch.float32, device=device)
        with _on_device(device):
            stream = torch._C._cuda_getCurrentRawStream(device.index)
            err = lib.dc_icp_gate(d2.data_ptr(), idx.data_ptr(), src_valid.data_ptr(), n,
                                  key.data_ptr(), scratch.data_ptr(), stream)
        _check_launch(lib, err, "icp_gate (N %d)" % n)
    return key, scratch


def launch_icp_solve(sorted_key, scratch, T, d2, idx, src_pts, src_valid, tgt_pts,
                     tgt_normals, inlier_ratio: float, stats=None):
    """X6's second launch on CUDA float32 tensors, after
    :func:`launch_icp_gate` on the same rows and the sort of its keys: one
    point-to-plane ICP step's threshold, normal equations, solve and
    update, as ``ops/icp.py``'s ``icp_update_plain`` computes them, with
    nothing read back to the host.

    :param sorted_key: (N,) float32, the gate's keys sorted ascending.
    :param scratch: the gate's scratch.
    :param T: (4, 4) the transform that placed ``src_pts``.
    :param d2, idx, src_valid: the gate's inputs.
    :param src_pts: (N, 3) the placed source points.
    :param tgt_pts, tgt_normals: (M, 3) the target's points and normals;
        each index of ``idx`` that is not negative must lie in [0, M).
    :param stats: None, or a (``ICP_STATS``,) float64 tensor the kernel
        fills: H's upper triangle row by row (21, without the 1e-9), g (6),
        sum |r|, the inliers, the ok rows, the threshold, dx (6).
    :return: (delta @ T (4, 4) float32, the inliers' mean |r| () float32).
    """
    global ICP_SOLVE_LAUNCHES
    with trace.span("x6.icp_solve"):
        device = src_pts.device
        if device.type != "cuda":
            raise ValueError("the ICP step kernel takes CUDA tensors, got %s" % device)
        n, m = src_pts.shape[0], tgt_pts.shape[0]
        T, src_pts = T.contiguous(), src_pts.contiguous()
        tgt_pts, tgt_normals = tgt_pts.contiguous(), tgt_normals.contiguous()
        _check(sorted_key, "sorted_key", torch.float32, (n,), device)
        _check(T, "T", torch.float32, (4, 4), device)
        _check(d2, "d2", torch.float32, (n,), device)
        _check(idx, "idx", torch.int32, (n,), device)
        _check(src_pts, "src_pts", torch.float32, (n, 3), device)
        _check(src_valid, "src_valid", torch.bool, (n,), device)
        _check(tgt_pts, "tgt_pts", torch.float32, (m, 3), device)
        _check(tgt_normals, "tgt_normals", torch.float32, (m, 3), device)
        if stats is not None:
            _check(stats, "stats", torch.float64, (ICP_STATS,), device)
        if n >= 1 << 31 or m >= 1 << 31:
            raise ValueError("icp_solve: %d source and %d target rows; the kernel takes fewer "
                             "than 2^31" % (n, m))
        if any(t.requires_grad for t in (T, src_pts, tgt_pts, tgt_normals)) and \
                torch.is_grad_enabled():
            raise RuntimeError("icp_solve is forward only: its inputs require grad")
        lib = load()
        _check(scratch, "scratch", torch.uint8, (lib.dc_icp_scratch(n),), device)
        T_out = torch.empty((4, 4), dtype=torch.float32, device=device)
        err_out = torch.empty((), dtype=torch.float32, device=device)
        with _on_device(device):
            stream = torch._C._cuda_getCurrentRawStream(device.index)
            err = lib.dc_icp_solve(sorted_key.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                                   src_valid.data_ptr(), src_pts.data_ptr(), n,
                                   tgt_pts.data_ptr(), tgt_normals.data_ptr(),
                                   float(inlier_ratio), T.data_ptr(), scratch.data_ptr(),
                                   T_out.data_ptr(), err_out.data_ptr(),
                                   None if stats is None else stats.data_ptr(), stream)
        _check_launch(lib, err, "icp_solve (N %d, M %d)" % (n, m))
    ICP_SOLVE_LAUNCHES += 1
    return T_out, err_out


def reset_launch_counts() -> None:
    """Zero every launch count kept here (the ``*_LAUNCHES`` names of
    ``__all__``)."""
    for name in __all__:
        if name.endswith("_LAUNCHES"):
            globals()[name] = 0
