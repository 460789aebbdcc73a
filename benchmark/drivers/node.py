"""Online-corrector traffic: raw scans fed back to back through the
program's ``node.DepthCorrector.process`` (a numpy structured scan in, a
numpy structured scan out), closed loop with one client: batch correction
of a recorded sequence, or a robot's stream with no idle time between
scans.

Traffic parameters: ``pool`` (distinct raw scans made from the seed in
set-up, from viewpoints spread around the scene's circle), ``density``
(raw points a square metre), ``nn_backend`` (the node's engine),
``model_kwargs`` (the model the node applies), ``sample`` (the outputs of
the window kept, drawn from the seed, and compared with the reference).

``node_scan_ms`` is the window's wall time over the scans corrected in it.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import roofline

__all__ = ["calibrate", "judge", "setup", "window"]

EXPECT = {"slab": ["slab_window_kernel"]}


def counters() -> dict:
    from depth_correction_tpu_torch.ops import _kernels

    return {"slab": _kernels.SLAB_LAUNCHES}


def make_config(cell, device: str):
    from depth_correction_tpu_torch.config import Config

    cfg = Config()
    cfg.from_dict(cell.config["settings"], strict=True)
    cfg.device = device
    cfg.nn_backend = cell.traffic["nn_backend"]
    cfg.model_kwargs = dict(cell.traffic["model_kwargs"])
    return cfg


def setup(cell, seed: int, device: str) -> dict:
    from depth_correction_tpu_torch.node import DepthCorrector

    from ..scene import open_box

    if device == "cuda":
        from depth_correction_tpu_torch.ops import _kernels

        _kernels.load()
    cfg = make_config(cell, device)
    t = cell.traffic
    scene = dict(cell.config["scene"], n=int(t["pool"]), density=float(t["density"]))
    pool = [scan for scan, _ in open_box(scene, seed, device, thin=False)]
    corrector = DepthCorrector(cfg)
    for scan in pool:  # the warm-up: every scan's shapes
        corrector.process(scan)
    return {"cfg": cfg, "pool": pool, "corrector": corrector, "cell": cell, "device": device,
            "seed": seed}


def window(state, seconds: float, capture=None) -> dict:
    pool, corrector = state["pool"], state["corrector"]
    out = {}
    if capture is not None:
        def fn():
            for scan in pool:
                corrector.process(scan)

        out["profile"] = capture(fn, counters, EXPECT, len(pool))
    k = int(state["cell"].traffic["sample"])
    rng = random.Random(state["seed"])
    sample, times = [], []
    i = 0
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        res = corrector.process(pool[i % len(pool)])
        times.append(time.perf_counter() - t1)
        # Reservoir sampling: every scan of the window equally likely kept.
        if len(sample) < k:
            sample.append((i % len(pool), res))
        else:
            j = rng.randrange(i + 1)
            if j < k:
                sample[j] = (i % len(pool), res)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    state["sample"] = sample
    failed = sum(1 for _, r in sample if r is None)
    out.update(attempted=i, failed=failed, window_s=window_s, items=i, item_s=times,
               end_to_end={"node_scan_ms": window_s * 1e3 / i})
    return out


def _xyz(arr) -> np.ndarray:
    return np.stack([np.asarray(arr[c], np.float64) for c in ("x", "y", "z")], 1)


# Raw points the row alignment looks ahead of its place in the raw scan.
LOOKAHEAD = 8192


def _raw_index(out_pts: np.ndarray, raw: np.ndarray, kept_ref: np.ndarray) -> np.ndarray:
    """Each output row's index in the raw scan. Rows stay in the raw order
    and on their rays, so a row is the raw point with its direction: the
    reference's kept rows where the counts and directions agree, else a
    walk along the raw scan that looks up to ``LOOKAHEAD`` points ahead. A
    row whose direction no raw point has (an answer moved off its ray)
    takes, in order, the reference's kept points between its matched
    neighbours where they are as many as such rows; else -1."""
    def dirs(x):
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-20)

    od = dirs(out_pts)
    if len(out_pts) == len(kept_ref):
        if np.all(np.abs(od - dirs(raw[kept_ref])).max(1) < 1e-5):
            return kept_ref
    rd = dirs(raw)
    idx = np.full(len(od), -1, np.int64)
    r = 0
    for j in range(len(od)):
        for span in (16, LOOKAHEAD):
            hit = np.flatnonzero(np.abs(rd[r:r + span] - od[j]).max(1) < 1e-5)
            if len(hit):
                idx[j] = r + hit[0]
                r = idx[j] + 1
                break
    j = 0
    while j < len(idx):
        if idx[j] >= 0:
            j += 1
            continue
        k = j
        while k < len(idx) and idx[k] < 0:
            k += 1
        lo = idx[j - 1] if j else -1
        hi = idx[k] if k < len(idx) else len(raw)
        cands = kept_ref[(kept_ref > lo) & (kept_ref < hi)]
        if len(cands) == k - j:
            idx[j:k] = cands
        j = k
    return idx


def _near(a: np.ndarray, b: np.ndarray, r: float) -> np.ndarray:
    """Rows of ``a`` within ``r`` of any point of ``b``."""
    out = np.zeros(len(a), bool)
    for p in b:
        out |= ((a - p) ** 2).sum(1) <= r * r
    return out


# A kept row counts as answered differently where its corrected point lies
# farther than POINT_TOL (m) from the reference's or, masked on both sides,
# its normal farther than NORMAL_TOL (largest component); a float32 program
# stays within a fifth of either (PERF.md).
POINT_TOL = 2e-5
NORMAL_TOL = 5e-5


def compare(out, raw: np.ndarray, ref: dict, r: float) -> dict:
    """One output's numbers against the reference's answer. Rows whose
    neighbourhood rounding decides (a neighbour at r to rounding, or within
    r of a point that one side kept and the other not) are left out of the
    row errors. ``mismatch_share``: the rows kept by one side only, and the
    rows whose mask differs or whose answer differs (POINT_TOL, NORMAL_TOL),
    over the reference's kept rows; ``point_err``: the largest corrected-
    point error (m) where the masks agree; ``normal_err``: the largest
    normal difference where both mask; ``excluded``: the share left out."""
    kept_ref = ref["kept"].cpu().numpy()
    pts = _xyz(out)
    idx = _raw_index(pts, raw, kept_ref)
    both, i_out, i_ref = np.intersect1d(idx, kept_ref, return_indices=True)
    n_ref = max(len(kept_ref), 1)
    one_side = len(idx) + len(kept_ref) - 2 * len(both)
    diff = np.setxor1d(idx[idx >= 0], kept_ref)
    sure = ~ref["ambiguous"].cpu().numpy()[i_ref]
    if len(diff):
        sure &= ~_near(raw[both], raw[diff], r * 1.001)
    i_out, i_ref = i_out[sure], i_ref[sure]
    m_out = np.asarray(out["mask"], bool)[i_out]
    m_ref = ref["mask"].cpu().numpy()[i_ref]
    same = m_out == m_ref
    p_err = np.abs(pts[i_out] - ref["points"].cpu().numpy()[i_ref]).max(1)
    nrm = np.stack([np.asarray(out[c], np.float64) for c in
                    ("normal_x", "normal_y", "normal_z")], 1)[i_out]
    n_err = np.abs(nrm - ref["normals"].cpu().numpy()[i_ref]).max(1)
    masked = m_out & m_ref
    wrong = ~same | (p_err > POINT_TOL) | (masked & (n_err > NORMAL_TOL))
    return {"mismatch_share": (one_side + int(wrong.sum())) / n_ref,
            "point_err": float(p_err[same].max()) if same.any() else 0.0,
            "normal_err": float(n_err[masked].max()) if masked.any() else 0.0,
            "excluded": 1.0 - len(i_ref) / n_ref}


def _reference(state, precision: str = "float64") -> dict:
    from ..reference import node_ref

    mk = state["cell"].traffic["model_kwargs"]
    used = sorted({i for i, _ in state["sample"]})
    return {i: node_ref.correct(_xyz(state["pool"][i]), state["cell"].config["settings"],
                                mk["w"], mk["exponent"], state["device"], precision)
            for i in used}


def judge(state, keep_reference: bool = False) -> dict:
    """Free the program's state, run the reference on the sampled scans,
    and compare."""
    del state["corrector"]
    if state["device"] == "cuda":
        torch.cuda.empty_cache()
    refs = _reference(state)
    r = float(state["cell"].config["settings"]["nn_r"])
    numbers = {"mismatch_share": 0.0, "point_err": 0.0, "normal_err": 0.0}
    errors, failed, excluded = [], 0, 0.0
    lim = state["cell"].limits
    for i, res in state["sample"]:
        if res is None:
            errors.append("a scan of the window returned nothing")
            failed += 1
            continue
        got = compare(res, _xyz(state["pool"][i]), refs[i], r)
        excluded = max(excluded, got.pop("excluded"))
        failed += int(any(got[k] > lim[k] for k in got))
        numbers = {k: max(numbers[k], got[k]) for k in numbers}
    pool = state["pool"]
    work = {"raw": float(np.mean([len(p) for p in pool])),
            "kept": float(np.mean([int(r["kept"].numel()) for r in refs.values()])),
            "pairs": float(np.mean([r["pairs"] for r in refs.values()]))}
    out = {"numbers": numbers, "errors": errors, "failed": failed, "work": work,
           "item_work": roofline.node_scan(work["raw"], work["kept"], work["pairs"]),
           "excluded": excluded}
    if keep_reference:
        out["reference"] = refs
    return out


def calibrate(cell, seed: int, device: str, seconds: float, with_control: bool) -> dict:
    """One seed's readings: the program's numbers over a short window's
    sample; with ``with_control`` the control's (the reference in float32
    with TF32 products put in the program's place) over the same scans."""
    state = setup(cell, seed, device)
    win = window(state, seconds)
    verdict = judge(state, keep_reference=True)
    out = {"program": verdict["numbers"], "errors": verdict["errors"],
           "node_scan_ms": win["end_to_end"]["node_scan_ms"], "work": verdict["work"],
           "excluded": verdict["excluded"],
           "scans": win["items"]}
    if with_control:
        ctrl = _reference(state, "tf32")
        numbers = {}
        for i, ref in verdict["reference"].items():
            c = ctrl[i]
            row = {"x": c["points"][:, 0].cpu().numpy(), "y": c["points"][:, 1].cpu().numpy(),
                   "z": c["points"][:, 2].cpu().numpy(), "mask": c["mask"].cpu().numpy(),
                   "normal_x": c["normals"][:, 0].cpu().numpy(),
                   "normal_y": c["normals"][:, 1].cpu().numpy(),
                   "normal_z": c["normals"][:, 2].cpu().numpy()}
            got = compare(row, _xyz(state["pool"][i]), ref,
                          float(cell.config["settings"]["nn_r"]))
            got.pop("excluded")
            numbers = {k: max(numbers.get(k, 0.0), v) for k, v in got.items()}
        out["control"] = numbers
    return out
