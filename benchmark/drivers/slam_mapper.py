"""Scan-to-map SLAM traffic: the program's ``slam_eval.slam_mapper`` (its
default SLAM, the role of upstream's ``norlab_icp_mapper``) over a
sequence's corrected feature clouds, whole passes back to back, closed
loop. Set-up is ``drivers/slam.py``'s: the scans, their feature clouds
through ``slam_eval.slam_clouds`` (corrected by ``model_kwargs``) and the
perturbed odometry priors; then one warm-up pass.

The scene is the configuration's ``scene``: the open box of
``scene.open_box``, or with ``"kind": "street"`` the street of
``street.street``.

Traffic parameters: ``slam``'s (``n_iters``, ``inlier_ratio``,
``model_kwargs``, ``prior_std``), ``map_voxel`` (m) and ``map_capacity``
(voxels).

``slam_scan_ms`` is the window's wall time over the scans registered in it
(a pass registers every scan but the first). Every pass starts from the
same priors with an empty map, so each pass's poses and final map are
compared with those of the reference's mapper
(``reference/slam_mapper_ref.py``) over the same corrected clouds, the
program's, taken in float64: ``trans_err``, ``rot_err`` (largest over
scans and passes) and ``map_share`` (the voxel keys in exactly one of the
program's and the reference's final maps, over the reference's count).
The clouds are set-up's product, and ``normal_mean`` holds them to the
reference's own feature clouds of the raw scans, as ``slam``'s judge does.
The mapper's comparison takes the program's clouds because the timed path
is the mapper: a sparse scan has bare three-point neighbourhoods, whose
ratio mask the sign of a rounding error decides (a plane through three
points has a smallest eigenvalue of 0), and each such row corrected by one
side alone moves a point by up to centimetres, and the poses with it.
"""
from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from .. import roofline
from . import slam

__all__ = ["calibrate", "judge", "setup", "window"]

EXPECT = slam.EXPECT
counters = slam.counters


def _run(state):
    """One pass: (poses, the final map's points)."""
    from depth_correction_tpu_torch.slam_eval import slam_mapper

    t = state["cell"].traffic
    est, (pts, _) = slam_mapper(state["clouds"], state["priors"], n_iters=int(t["n_iters"]),
                                inlier_ratio=float(t["inlier_ratio"]),
                                map_voxel=float(t["map_voxel"]),
                                map_capacity=int(t["map_capacity"]), return_map=True)
    return est, pts


def setup(cell, seed: int, device: str) -> dict:
    from depth_correction_tpu_torch.models import ScaledPolynomial
    from depth_correction_tpu_torch.slam_eval import slam_clouds, slam_mapper

    from ..scene import open_box
    from ..street import street

    if "return_map" not in inspect.signature(slam_mapper).parameters:
        raise RuntimeError("the program's slam_mapper cannot return its map (no return_map)")
    if device == "cuda":
        from depth_correction_tpu_torch.ops import _kernels

        _kernels.load()
    cfg = slam.make_config(cell, device)
    t = cell.traffic
    scene = cell.config["scene"]
    scans = (street if scene.get("kind") == "street" else open_box)(scene, seed, device)
    mk = t["model_kwargs"]
    model = ScaledPolynomial(w=mk["w"], exponent=mk["exponent"], dtype=cfg.torch_dtype(),
                             device=cfg.torch_device())
    clouds, poses = slam_clouds(scans, cfg, model)
    priors = slam._priors(poses, t["prior_std"], seed)
    state = {"cfg": cfg, "scans": scans, "clouds": clouds, "priors": priors, "poses": poses,
             "cell": cell, "device": device}
    est, pts = _run(state)  # the warm-up
    state["passes"], state["maps"] = [est], [pts]
    return state


def window(state, seconds: float, capture=None) -> dict:
    clouds = state["clouds"]

    def one():
        return _run(state)

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
    state["passes"].extend(p for p, _ in passes)
    state["maps"].extend(m for _, m in passes)
    scans = len(passes) * (len(clouds) - 1)
    out.update(attempted=scans, window_s=window_s, items=scans, pass_s=times,
               end_to_end={"slam_scan_ms": window_s * 1e3 / scans})
    return out


def voxel_set(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """A map's distinct voxel keys floor(p / voxel) (float64, a true
    division), each packed into one int64 (21 bits an axis), on the
    host."""
    from ..reference.slam_mapper_ref import voxel_keys

    keys = voxel_keys(points, voxel) + (1 << 20)
    if keys.numel() and not bool(((keys >= 0) & (keys < 1 << 21)).all()):
        raise ValueError("a map voxel lies beyond 2^20 voxels of the origin")
    return torch.unique((keys[:, 0] << 42) | (keys[:, 1] << 21) | keys[:, 2]).cpu()


def map_share(keys: torch.Tensor, ref_keys: torch.Tensor) -> float:
    """The voxel keys in exactly one of two sets of distinct keys, over
    the second's count."""
    _, counts = torch.unique(torch.cat([keys, ref_keys]), return_counts=True)
    return float((counts == 1).sum()) / max(int(ref_keys.shape[0]), 1)


def _inputs(clouds) -> list:
    """The program's corrected clouds as the reference's mapper takes them:
    each valid row's point and normal in the sensor's frame, float64."""
    return [{"points": c.get_points()[c.valid].to(torch.float64),
             "normals": c.normals[c.valid].to(torch.float64)} for c in clouds]


def _features(state, precision: str = "float64") -> list:
    """The reference's own feature clouds of the raw scans."""
    from ..reference import slam_ref

    mk = state["cell"].traffic["model_kwargs"]
    s = state["cell"].config["settings"]
    return [slam_ref.feature_cloud(np.stack([a[k] for k in "xyz"], 1), s, mk["w"],
                                   mk["exponent"], state["device"], precision)
            for a, _ in state["scans"]]


def _mapper(state, precision: str = "float64", **fault) -> dict:
    """The reference's mapper over the program's clouds."""
    from ..reference import slam_mapper_ref

    t = state["cell"].traffic
    return slam_mapper_ref.mapper(state["inputs"], state["priors"], int(t["n_iters"]),
                                  float(t["inlier_ratio"]), float(t["map_voxel"]),
                                  fault.get("map_capacity", int(t["map_capacity"])), precision,
                                  fault.get("keep", "first"))


def item_work(work, iters: int) -> roofline.Work:
    """A registration's needed work, the mean over ``work`` ((queries, map
    rows) each): ``iters`` nearest searches of the scan's points in the map
    and the per-point ICP work of ``roofline.icp_registration``, then the
    merge: the map's and the scan's points and normals read (24 bytes a
    row), the next map written."""
    total = roofline.Work(0, 0)
    for k, (q, m) in enumerate(work):
        nxt = work[k + 1][1] if k + 1 < len(work) else m + q
        total = total + roofline.Work(
            iters * (roofline.nearest_search(q, m)[0] + q * 36) + (m + q) * 24 + nxt * 24,
            iters * q * 90)
    return roofline.Work(total[0] / len(work), total[1] / len(work))


def judge(state, keep_reference: bool = False) -> dict:
    """Free the program's state, run the reference, and compare."""
    voxel = float(state["cell"].traffic["map_voxel"])
    keys = [voxel_set(m, voxel) for m in state.pop("maps")]
    clouds = state.pop("clouds")
    normals = [c.normals.double().cpu() for c in clouds]
    state["inputs"] = _inputs(clouds)
    del clouds
    if state["device"] == "cuda":
        torch.cuda.empty_cache()
    refs = _features(state)
    ref = _mapper(state)
    ref_keys = voxel_set(ref["points"], voxel)
    numbers = {"trans_err": 0.0, "rot_err": 0.0, "normal_mean": slam._normal_gap(normals, refs),
               "map_share": max(map_share(k, ref_keys) for k in keys)}
    lim = state["cell"].limits
    failed = 0
    for p in state["passes"]:
        dt, dr = slam._pose_gaps(p, ref["poses"])
        numbers["trans_err"] = max(numbers["trans_err"], dt)
        numbers["rot_err"] = max(numbers["rot_err"], dr)
        failed += int(dt > lim["trans_err"] or dr > lim["rot_err"])
    iters = int(state["cell"].traffic["n_iters"])
    out = {"numbers": numbers, "errors": [], "failed": failed * (len(refs) - 1),
           "work": {"registrations": ref["work"], "evicted": sum(ref["evicted"]),
                    "points": float(np.mean([q for q, _ in ref["work"]])),
                    "map_rows": float(np.mean([m for _, m in ref["work"]]))},
           "item_work": item_work(ref["work"], iters)}
    if keep_reference:
        out["reference"] = (refs, ref, ref_keys)
    return out


def _gaps(poses, keys, ref, ref_keys) -> dict:
    dt, dr = slam._pose_gaps(poses, ref["poses"])
    return {"trans_err": dt, "rot_err": dr, "map_share": map_share(keys, ref_keys)}


def calibrate(cell, seed: int, device: str, seconds: float, with_control: bool) -> dict:
    """One seed's readings: the program's numbers, the final map's size and
    evictions, and the drift (largest pose gaps to the ground truth) of the
    priors, the program and the reference; with ``with_control`` the
    control's (the reference in float32 with TF32 products in the
    program's place, its mapper over the program's clouds) and each
    fault's, the reference's mapper in float64 with one part broken:
    ``odometry`` (each scan registered on the previous scan, not the map),
    ``no_evict`` (the map never evicts), ``last_wins`` (the last row of a
    voxel wins its merge)."""
    from ..reference import slam_ref

    state = setup(cell, seed, device)
    win = window(state, seconds)
    verdict = judge(state, keep_reference=True)
    refs, ref, ref_keys = verdict["reference"]
    w = verdict["work"]
    gt = state["poses"]
    out = {"program": verdict["numbers"], "slam_scan_ms": win["end_to_end"]["slam_scan_ms"],
           "scans": win["items"], "points": w["points"], "map_rows": w["map_rows"],
           "final_map": int(ref_keys.shape[0]), "evicted": w["evicted"],
           "largest_map": max(m for _, m in w["registrations"]),
           "drift": {k: slam._pose_gaps(p, gt) for k, p in (
               ("prior", state["priors"]), ("program", state["passes"][0]),
               ("reference", ref["poses"]))}}
    if with_control:
        t = cell.traffic
        voxel = float(t["map_voxel"])
        control = _mapper(state, "tf32")
        out["control"] = dict(_gaps(control["poses"], voxel_set(control["points"], voxel), ref,
                                    ref_keys),
                              normal_mean=slam._normal_gap(
                                  [c["normals"].double().cpu() for c in _features(state, "tf32")],
                                  refs))
        odo = slam_ref.odometry(state["inputs"], state["priors"], int(t["n_iters"]),
                                float(t["inlier_ratio"]))
        dt, dr = slam._pose_gaps(odo, ref["poses"])
        out["odometry"] = {"trans_err": dt, "rot_err": dr}
        for name, fault in (("no_evict", {"map_capacity": None}), ("last_wins", {"keep": "last"})):
            f = _mapper(state, **fault)
            out[name] = _gaps(f["poses"], voxel_set(f["points"], voxel), ref, ref_keys)
    return out
