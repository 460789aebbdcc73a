"""Knockouts of the moment-window kernel P3-P5 (csrc/moment_window.cu) on
one CUDA card, each timed in turns against the kernel it varies (base,
variant, variant, base) by the profiler's kernel durations, to find what
holds its body. At P5's J_all (NS 15, every switch) and P3's tf32x3 (NS 5, no
switch), the probes' own draws.

Each variant is a copy of a committed source with a few lines replaced,
compiled by ``nvcc`` beside the package's build (``_build/variants/``)
and called through ctypes with the launcher's own checks; the package's
kernels are not touched. The outputs of a knockout are wrong; only the
times count.

The knockouts: without its pair test (membership a fixed pattern of the
column), without its wgmma passes (an integer sink keeps the tests and
splits alive), without its barrier a chunk, without its staging of the
next chunk (features, splits and stores, with the raw loads they use),
without the proxy fence after the staging, without the raw loads (columns
made up from their index).

    python -m depth_correction_tpu_torch.scripts.exp_window_variants
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from . import in_turns, kernel_ms, require_card

STEPS = 20

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
KNOCKOUTS = {
    "no_test": ("moment_window.cu", [
        ('  asm("set.le.f32.f32 %0, %1, %2;" : "=f"(m) : "f"(d2_rn(e.x - qx, e.y - qy, e.z - qz)),\n'
         '      "f"(r2));\n',
         "  m = ((__float_as_uint(e.x) ^ __float_as_uint(qx)) & 0x800000u) ? 1.f : r2 * 0.f;\n")]),
    "no_wgmma": ("moment_window.cu", [
        ("    if (kFull || (ks >= ks0 && ks < ks1)) issue_step<P>(d, fr[ks], desc0, ks, ks != ks0);",
         "    if (kFull || (ks >= ks0 && ks < ks1))\n"
         "      d[ks] = __uint_as_float(__float_as_uint(d[ks]) ^ fr[ks][0] ^ fr[ks][1] ^ fr[ks][2] ^\n"
         "                              fr[ks][3]);")]),
    "no_barrier": ("moment_window.cu", [
        ("      __syncthreads();  // chunk c staged; every product of chunk c - 1 done\n", "")]),
    "no_staging": ("moment_window.cu", [
        ("        store_stage<P>(smem + ((c + 1) % kStages) * Stage<P>::kFloats, raw, cx, cy, cz, tid);\n"
         "        fence_proxy_async();\n", "")]),
    "no_fence": ("moment_window.cu", [
        ("        store_stage<P>(smem + ((c + 1) % kStages) * Stage<P>::kFloats, raw, cx, cy, cz, tid);\n"
         "        fence_proxy_async();\n",
         "        store_stage<P>(smem + ((c + 1) % kStages) * Stage<P>::kFloats, raw, cx, cy, cz, tid);\n")]),
    "no_loads": ("moment_window.cu", [
        ("    for (int i = 0; i < 3; ++i) r.x[i] = __ldg(src + i * rs);",
         "    for (int i = 0; i < 3; ++i) r.x[i] = (k + i) * 1e-3f + rs * 1e-9f;"),
        ("      for (int i = 0; i < 3; ++i) r.e[i] = __ldg(src + (3 + i) * rs);",
         "      for (int i = 0; i < 3; ++i) r.e[i] = (k - i) * 1e-3f;")]),
}
# name -> (probe, variant): the shapes each knockout is timed at.
CASES = {"J_all": ("exp_mosaic_dot_probe4", "J_all"), "tf32x3": ("exp_mosaic_dot_probe2", "tf32x3")}


def _replace(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError("variant: %r is not in the source" % old)
        src = src.replace(old, new, 1)
    return src


def sources() -> dict:
    """{variant name: (CUDA source, C entry to rename to dc_variant)}."""
    out = {}
    for name, (fname, pairs) in KNOCKOUTS.items():
        src = open(os.path.join(_SRC, fname)).read()
        out[name] = (_replace(src, pairs), "dc_" + fname[:-3])
    return out


def build() -> dict:
    """Compile every variant in parallel; {name: ctypes entry dc_variant}."""
    from ..ops import _kernels

    out_dir = os.path.join(_kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    flags = [_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", _SRC, "-Xptxas", "-v"]
    procs = {}
    for name, (src, entry) in sources().items():
        path = os.path.join(out_dir, "window_" + name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(flags + ["-D%s=dc_variant" % entry, "-o",
                                                path[:-3] + ".so", path],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on variant %s:\n%s" % (name, log))
        fn = ctypes.CDLL(os.path.join(out_dir, "window_" + name + ".so")).dc_variant
        fn.argtypes = _kernels.load().dc_moment_window.argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def _case(device, name: str):
    """(win, q, prec, keyword arguments of moment_window) of a case."""
    import importlib

    probe, variant = CASES[name]
    mod = importlib.import_module("depth_correction_tpu_torch.scripts." + probe)
    if probe == "exp_mosaic_dot_probe4":
        win, q, kw = mod.inputs(device, (variant,))[variant]
        return win, q, mod.PREC, kw
    win, q, ln = mod.inputs(device)
    return win, q, variant, dict(n_tiles=mod.T1, ns=mod.NS, s_len=mod.S, lens=ln)


def _call(entry, win, q, prec: str, kw: dict):
    """One launch of the C function ``entry`` with moment_window's
    arguments."""
    from ..ops import _kernels
    from ..ops.moment_dot import PRECISIONS
    from ..ops.moment_window import window_flags
    from .exp_mosaic_dot_probe2 import R2

    flags = window_flags(kw["lens"], kw.get("starts"), kw.get("leads"), kw.get("ctr"),
                         kw.get("per_tile_q", False), kw.get("epilogue", False))
    return _kernels._launch_window(
        "variant", PRECISIONS.index(prec), flags, win, q, R2, kw["n_tiles"], kw["ns"],
        kw["s_len"], kw["lens"], starts=kw.get("starts"), leads=kw.get("leads"),
        ctr=kw.get("ctr"), entry=entry)


def run(device, reps: int = STEPS) -> dict:
    """Every knockout against its base in turns.

    :return: {case: {variant: (base ms, variant ms, equal to the base)}},
        device times by the profiler.
    """
    from ..ops.moment_window import moment_window
    from .exp_mosaic_dot_probe2 import R2

    entries = build()
    res = {}
    for case in CASES:
        win, q, prec, kw = _case(device, case)

        def base():
            return moment_window(win, q, R2, prec=prec, **kw)

        rows = res.setdefault(case, {})
        for name, entry in entries.items():
            def variant(entry=entry):
                return _call(entry, win, q, prec, kw)

            same = bool(torch.equal(variant(), base()))
            rows[name] = in_turns(base, variant, device, reps, timer=kernel_ms)[:2] + (same,)
    return res


def main() -> int:
    device = require_card()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    for case, rows in run(device).items():
        for name, (base, ms, same) in rows.items():
            print("%-7s %-22s %.4f ms device (base %.4f); output equal to the base: %s"
                  % (case, name, ms, base, same))
    return 0


if __name__ == "__main__":
    sys.exit(main())
