"""SLAM-drift traffic: the program's ``slam_eval.slam_odometry`` over a
sequence's corrected feature clouds, pass after pass, closed loop. Set-up
makes the scans, their feature clouds through ``slam_eval.slam_clouds``
(corrected by ``model_kwargs``), and the odometry priors: the ground truth
with each increment perturbed from the seed (``prior_std``: rotation rad,
translation m, a standard deviation each).

Traffic parameters: ``n_iters`` (ICP iterations a scan), ``inlier_ratio``,
``model_kwargs``, ``prior_std`` [rot, trans].

``slam_scan_ms`` is the window's wall time over the scans registered in it
(a pass registers every scan but the first). Every pass starts from the
same priors, so each pass's poses are compared with the reference's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import roofline

__all__ = ["calibrate", "judge", "setup", "window"]

EXPECT = {"knn": ["knn_tiles_kernel"]}


def counters() -> dict:
    from depth_correction_tpu_torch.ops import _kernels

    return {"knn": _kernels.KNN_LAUNCHES}


def make_config(cell, device: str):
    from depth_correction_tpu_torch.config import Config

    cfg = Config()
    cfg.from_dict(cell.config["settings"], strict=True)
    cfg.device = device
    return cfg


def _priors(poses: np.ndarray, std, seed: int) -> np.ndarray:
    """The ground truth with each increment perturbed: a rotation about a
    random axis and a random translation, Gaussian of ``std``."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
    out = [poses[0]]
    for i in range(1, len(poses)):
        inc = np.linalg.inv(poses[i - 1]) @ poses[i]
        aa = float(std[0]) * rng.normal(size=3)
        t = aa_norm = float(np.linalg.norm(aa))
        K = np.array([[0, -aa[2], aa[1]], [aa[2], 0, -aa[0]], [-aa[1], aa[0], 0]])
        R = np.eye(3) if t == 0 else (np.eye(3) + np.sin(t) / t * K
                                      + (1 - np.cos(t)) / (aa_norm ** 2) * K @ K)
        N = np.eye(4)
        N[:3, :3] = R
        N[:3, 3] = float(std[1]) * rng.normal(size=3)
        out.append(out[-1] @ inc @ N)
    return np.stack(out)


def setup(cell, seed: int, device: str) -> dict:
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.slam_eval import slam_clouds, slam_odometry

    from ..scene import open_box

    if device == "cuda":
        from depth_correction_tpu_torch.ops import _kernels

        _kernels.load()
    cfg = make_config(cell, device)
    t = cell.traffic
    scans = open_box(cell.config["scene"], seed, device)
    mk = t["model_kwargs"]
    model = ScaledPolynomial(w=mk["w"], exponent=mk["exponent"], dtype=cfg.torch_dtype(),
                             device=cfg.torch_device())
    clouds, poses = slam_clouds(scans, cfg, model)
    priors = _priors(poses, t["prior_std"], seed)
    state = {"cfg": cfg, "scans": scans, "clouds": clouds, "priors": priors, "poses": poses,
             "cell": cell, "device": device}
    state["passes"] = [slam_odometry(clouds, priors, n_iters=int(t["n_iters"]),
                                     inlier_ratio=float(t["inlier_ratio"]))]  # the warm-up
    return state


def window(state, seconds: float, capture=None) -> dict:
    from depth_correction_tpu_torch.slam_eval import slam_odometry

    t = state["cell"].traffic
    clouds, priors = state["clouds"], state["priors"]

    def one():
        return slam_odometry(clouds, priors, n_iters=int(t["n_iters"]),
                             inlier_ratio=float(t["inlier_ratio"]))

    out = {}
    if capture is not None:
        out["profile"] = capture(one, counters, EXPECT, len(clouds) - 1)
    passes, times = [], []
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        passes.append(one())
        times.append(time.perf_counter() - t1)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    state["passes"].extend(passes)
    scans = len(passes) * (len(clouds) - 1)
    out.update(attempted=scans, window_s=window_s, items=scans, pass_s=times,
               end_to_end={"slam_scan_ms": window_s * 1e3 / scans})
    return out


def _pose_gaps(est: np.ndarray, ref: np.ndarray) -> tuple:
    """(largest translation difference m, largest rotation difference rad)."""
    dt = np.abs(est[:, :3, 3] - ref[:, :3, 3]).max()
    rot = []
    for a, b in zip(est, ref):
        R = a[:3, :3].T @ b[:3, :3]
        # The angle from the rotation's antisymmetric part: exact for small
        # angles, where arccos of the trace is not.
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
        rot.append(float(np.arcsin(min(np.linalg.norm(v), 1.0))))
    return float(dt), float(max(rot))


def _normal_gap(normals, refs) -> float:
    """The mean normal difference (largest component) over the rows the
    reference's ratio mask keeps (planar neighbourhoods) and whose
    neighbourhood rounding does not decide. A mean: the largest swings by
    the rounding of the local masks, which moves a point's correction and
    so its neighbours' normals (PERF.md)."""
    total, count = 0.0, 0
    for got, r in zip(normals, refs):
        got = got[:r["points"].shape[0]]
        want = r["normals"].cpu()
        m = (r["mask"] & ~r["ambiguous"]).cpu()
        total += float((got[m] - want[m]).abs().amax(1).sum())
        count += int(m.sum())
    return total / max(count, 1)


def _turned(refs, seed: int, rows: int) -> list:
    """The reference's normals with ``rows`` compared rows a cloud, drawn
    from the seed, turned by 90 degrees (crossed with the axis of their
    smallest component): a fault in a few rows' normals."""
    gen = torch.Generator().manual_seed(int(seed) & 0x7FFFFFFF)
    out = []
    for r in refs:
        n = r["normals"].double().cpu().clone()
        m = torch.nonzero((r["mask"] & ~r["ambiguous"]).cpu()).reshape(-1)
        pick = m[torch.randperm(m.numel(), generator=gen)[:rows]]
        axis = torch.nn.functional.one_hot(n[pick].abs().argmin(1), 3).double()
        n[pick] = torch.nn.functional.normalize(torch.cross(n[pick], axis, dim=1), dim=1)
        out.append(n)
    return out


def _reference(state, precision: str = "float64"):
    from ..reference import slam_ref

    t = state["cell"].traffic
    mk = t["model_kwargs"]
    s = state["cell"].config["settings"]
    refs = [slam_ref.feature_cloud(np.stack([a[k] for k in "xyz"], 1), s, mk["w"],
                                   mk["exponent"], state["device"], precision)
            for a, _ in state["scans"]]
    est = slam_ref.odometry(refs, state["priors"], int(t["n_iters"]), float(t["inlier_ratio"]),
                            precision)
    return refs, est


def judge(state, keep_reference: bool = False) -> dict:
    """Free the program's state, run the reference, and compare."""
    normals = [c.normals.double().cpu() for c in state.pop("clouds")]
    if state["device"] == "cuda":
        torch.cuda.empty_cache()
    refs, est = _reference(state)
    numbers = {"trans_err": 0.0, "rot_err": 0.0, "normal_mean": _normal_gap(normals, refs)}
    lim = state["cell"].limits
    failed = 0
    for p in state["passes"]:
        dt, dr = _pose_gaps(p, est)
        numbers["trans_err"] = max(numbers["trans_err"], dt)
        numbers["rot_err"] = max(numbers["rot_err"], dr)
        failed += int(dt > lim["trans_err"] or dr > lim["rot_err"])
    points = float(np.mean([r["points"].shape[0] for r in refs]))
    out = {"numbers": numbers, "errors": [], "failed": failed * (len(refs) - 1),
           "work": {"points": points},
           "item_work": roofline.icp_registration(int(points), int(state["cell"].traffic["n_iters"]))}
    if keep_reference:
        out["reference"] = (refs, est)
    return out


def calibrate(cell, seed: int, device: str, seconds: float, with_control: bool) -> dict:
    """One seed's readings: the program's numbers; with ``with_control``
    the control's (the reference in float32 with TF32 products in the
    program's place) and the fault's of a few rows' normals turned (4 rows
    a cloud, and 1), with the count of compared rows."""
    state = setup(cell, seed, device)
    win = window(state, seconds)
    verdict = judge(state, keep_reference=True)
    out = {"program": verdict["numbers"], "slam_scan_ms": win["end_to_end"]["slam_scan_ms"],
           "scans": win["items"]}
    if with_control:
        refs, est = verdict["reference"]
        crefs, cest = _reference(state, "tf32")
        dt, dr = _pose_gaps(cest, est)
        worst = _normal_gap([c["normals"].double().cpu() for c in crefs], refs)
        out["control"] = {"trans_err": dt, "rot_err": dr, "normal_mean": worst}
        out["few_rows"] = {"normal_mean": _normal_gap(_turned(refs, seed, 4), refs),
                           "one_row": _normal_gap(_turned(refs, seed, 1), refs),
                           "rows": sum(int((r["mask"] & ~r["ambiguous"]).sum()) for r in refs)}
    return out
