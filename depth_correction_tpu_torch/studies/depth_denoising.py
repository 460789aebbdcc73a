"""Depth-denoising comparison harness.

Port of the JAX package's scripts/depth_denoising.py (reference:
scripts/depth_denoising:18-91, scripts/compare_to_ddd): project scans into
range images, denoise the depth channel, and compare the map-consistency
loss of

- the raw scans,
- a range-image median denoiser (the in-framework stand-in for the external
  DeepDepthDenoising baseline, which needs its own trained weights), or an
  external denoiser command, and
- the learned depth-correction model,

on the merged multi-view cloud. Appends ``depth_denoising.csv`` rows
``"<dataset> <loss_raw> <loss_median> <loss_corrected>"``.

Usage: python -m depth_correction_tpu_torch.studies.depth_denoising
           [--dataset NAME] [--out DIR] [--denoiser-command CMD] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from . import add_device_arg


def median_denoise_range_image(img: torch.Tensor, hit: torch.Tensor, size: int = 3):
    """Median filter over hit pixels (edge-preserving range smoothing)."""
    pad = size // 2
    big = torch.full((), float("inf"), dtype=img.dtype, device=img.device)
    stack = []
    for dy in range(-pad, pad + 1):
        for dx in range(-pad, pad + 1):
            v = torch.roll(img, (dy, dx), (0, 1))
            m = torch.roll(hit, (dy, dx), (0, 1))
            stack.append(torch.where(m, v, big))
    vals = torch.stack(stack)  # (size*size, H, W)
    # Masked median: sort (inf sinks misses to the end), take the middle of
    # the valid prefix.
    svals = torch.sort(vals, dim=0).values
    count = torch.isfinite(vals).sum(0)
    mid = torch.clamp((count - 1) // 2, min=0)
    med = torch.gather(svals, 0, mid[None]).squeeze(0)
    return torch.where(hit & (count > 0), med, img)


def external_denoise_range_image(img: torch.Tensor, hit: torch.Tensor, command: str,
                                 workdir: str, scan_id: int = 0):
    """Run an external denoiser over one range image through a subprocess
    contract (the hookup the reference's compare_to_ddd study needs for the
    DeepDepthDenoising net; reference scripts/compare_to_ddd:1-165).

    Contract (``command`` is a format template):

    - ``{input_npz}``: written here: ``depth`` (H, W) float32 range image
      (invalid pixels hold +inf) and ``hit`` (H, W) bool mask,
    - ``{output_npz}``: the denoiser must write ``depth`` (H, W) float32,
      denoised ranges for hit pixels (misses are ignored).

    ``scripts/stub_denoiser.py`` documents the contract end to end.
    """
    import shlex
    import subprocess

    os.makedirs(workdir, exist_ok=True)
    in_npz = os.path.join(workdir, "range_%04d_in.npz" % scan_id)
    out_npz = os.path.join(workdir, "range_%04d_out.npz" % scan_id)
    np.savez(in_npz, depth=img.cpu().numpy().astype(np.float32), hit=hit.cpu().numpy())
    cmd = command.format(input_npz=in_npz, output_npz=out_npz)
    subprocess.run(shlex.split(cmd), check=True)
    if not os.path.exists(out_npz):
        raise RuntimeError("external denoiser wrote no output: %s" % out_npz)
    with np.load(out_npz) as z:
        den = np.asarray(z["depth"], np.float32)
    if den.shape != tuple(img.shape):
        raise RuntimeError("denoiser output shape %s != input %s" % (den.shape, tuple(img.shape)))
    return torch.where(hit, torch.as_tensor(den, dtype=img.dtype, device=img.device), img)


def scan_variants(scan, cfg, model, denoiser_command=None, workdir=".", scan_id: int = 0):
    """(raw, denoised) structured scans, the range image in the config's
    float type on its device. The denoised variant uses the external command
    when given, else the in-framework median stand-in."""
    from numpy.lib.recfunctions import structured_to_unstructured as s2u
    from numpy.lib.recfunctions import unstructured_to_structured as u2s

    from ..ops.range_image import project_range_image, unproject_range_image

    dtype, device = cfg.torch_dtype(), cfg.torch_device()
    pts = torch.as_tensor(s2u(scan[["x", "y", "z"]], dtype=np.float64), dtype=dtype,
                          device=device)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    img, hit = project_range_image(pts, valid)
    if denoiser_command:
        den = external_denoise_range_image(img, hit, denoiser_command, workdir, scan_id)
    else:
        den = median_denoise_range_image(img, hit)
    pts_den, ok = unproject_range_image(den, hit)
    den_scan = u2s(pts_den[ok].cpu().numpy().astype(np.float64), names=["x", "y", "z"])
    return scan, den_scan


def consistency_loss(seqs, cfg, model=None) -> float:
    from ..train import make_loss_fn, prepare_sequences

    data = prepare_sequences(seqs, cfg)
    with torch.no_grad():
        return float(make_loss_fn(cfg)(model, data))


def make_cfg(dataset: str, model_w: float = -0.002, device: str = "cuda"):
    """The JAX script's settings (depth_denoising.py:156-170)."""
    from ..config import Config

    cfg = Config()
    cfg.device = device
    cfg.float_type = "float32"
    cfg.min_depth, cfg.max_depth, cfg.grid_res = 0.5, 25.0, 0.2
    cfg.nn_r, cfg.nn_k = 0.4, 0
    cfg.nn_max_neighbors = 32
    cfg.min_valid_neighbors = 3
    cfg.vp_dispersion_bounds = []
    cfg.eigenvalue_ratio_bounds = []
    cfg.loss = "min_eigval_loss"
    cfg.loss_kwargs = {"sqrt": False, "normalization": False}
    if dataset.startswith("open_box"):
        # Synthetic: inject the bias the correction model removes.
        cfg.depth_bias_model_kwargs = {"w": [model_w], "exponent": [4.0]}
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="open_box/n_4_size_12_12_4_height_1_density_60")
    p.add_argument("--out", default="gen/depth_denoising")
    p.add_argument("--model-w", type=float, default=-0.002)
    p.add_argument("--denoiser-command", default=None,
                   help="external denoiser template with {input_npz} and {output_npz} (see "
                        "external_denoise_range_image); replaces the median stand-in")
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..datasets import create_dataset
    from ..models import ScaledPolynomial
    from ..utils.io import append

    cfg = make_cfg(args.dataset, args.model_w, args.device)
    ds = create_dataset(args.dataset, cfg)
    model = ScaledPolynomial(w=[args.model_w], exponent=[4.0], dtype=cfg.torch_dtype(),
                             device=cfg.torch_device())

    # Build the scan sets.
    raw, den = [], []
    for i, (scan, pose) in enumerate(ds):
        r_scan, d_scan = scan_variants(scan, cfg, model, denoiser_command=args.denoiser_command,
                                       workdir=os.path.join(args.out, "denoiser_io"),
                                       scan_id=i)
        raw.append((r_scan, pose))
        den.append((d_scan, pose))

    loss_raw = consistency_loss([raw], cfg, model=None)
    loss_med = consistency_loss([den], cfg, model=None)
    loss_corr = consistency_loss([raw], cfg, model=model)
    kind = "external-denoised" if args.denoiser_command else "median-denoised"
    print("map-consistency loss: raw %.6g, %s %.6g, corrected %.6g (%s)"
          % (loss_raw, kind, loss_med, loss_corr, args.dataset))
    os.makedirs(args.out, exist_ok=True)
    append(os.path.join(args.out, "depth_denoising.csv"),
           "%s %.9g %.9g %.9g\n" % (args.dataset, loss_raw, loss_med, loss_corr))
    return loss_raw, loss_med, loss_corr


if __name__ == "__main__":
    main(sys.argv[1:])
