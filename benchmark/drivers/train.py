"""Training traffic: training runs back to back, closed loop, each through
the program's ``train.fit`` from the configuration's starting weights with
a fresh optimizer, on the ``TrainData`` that ``train.prepare_sequences``
made once in set-up from the scene (no prep cache: prep is what a user
pays once a training run, and it shows in ``setup_s``).

Traffic parameters: ``steps_per_run`` (``Config.n_opt_iters``),
``plot_period`` (a line printed every so many steps), ``compare_steps``
(the steps of each run compared with the reference).

``train_step_ms`` is the window's wall time over the Adam steps completed
in it; ``fit`` ends every step in a sync. Set-up makes one run through the
same call as the window (the warm-up), and the first ``compare_steps``
steps of that run and of every run of the window are compared with the
plain reference: each step's loss, the first gradient as the optimizer
gets it, and the weights' change after the compared steps, besides prep's
graph and loss rows.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

from .. import roofline

__all__ = ["judge", "setup", "window"]

# Launch counters of the program and the kernels they count, for the
# profiler's retake rule.
EXPECT = {"cellwin_fwd": ["cellwin_fwd_kernel"], "cellwin_bwd": ["cellwin_bwd_kernel"],
          "gather": ["gather_moments_kernel"], "transpose": ["transpose_moments_kernel"]}


def counters() -> dict:
    from depth_correction_tpu_torch.ops import _kernels, cellwin

    return {"cellwin_fwd": cellwin.FWD_LAUNCHES, "cellwin_bwd": cellwin.BWD_LAUNCHES,
            "gather": _kernels.GATHER_LAUNCHES,
            "transpose": _kernels.TRANSPOSE_MOMENTS_LAUNCHES}


def make_config(cell, device: str):
    from depth_correction_tpu_torch.config import Config

    cfg = Config()
    cfg.from_dict(cell.config["settings"], strict=True)
    cfg.device = device
    cfg.n_opt_iters = int(cell.traffic["steps_per_run"])
    cfg.plot_period = int(cell.traffic["plot_period"])
    cfg.log_dir = os.path.join(tempfile.gettempdir(), "benchmark_log")
    return cfg


def _recorder(cfg, k: int):
    from depth_correction_tpu_torch.train import TrainCallbacks

    class Recorder(TrainCallbacks):
        """Keeps, without a sync, the first gradient (as the optimizer gets
        it: after the step's masking, before its update) and the weights
        at the start and after ``k`` steps."""

        def __init__(self):
            super().__init__(cfg)
            self.grad0 = None
            self.w = {}

        def train_loss(self, it, model, pose_deltas, loss):
            if it == 0:
                self.grad0 = model.w.grad.detach().clone()

        def on_step(self, it, model, row, state):
            if it in (0, k):
                self.w[it] = state["model"]["w"]
            return False

    return Recorder()


def _run(state) -> dict:
    """One training run through ``train.fit``: its history and what the
    comparison reads."""
    from depth_correction_tpu_torch.train import fit

    rec = _recorder(state["cfg"], state["k"])
    _, history = fit(state["cfg"], state["data"], callbacks=rec, on_step=rec.on_step)
    return {"losses": [row[1] for row in history[:state["k"]]], "steps": len(history),
            "grad0": rec.grad0, "w0": rec.w.get(0), "wk": rec.w.get(state["k"])}


def setup(cell, seed: int, device: str) -> dict:
    from depth_correction_tpu_torch.train import prepare_sequences

    from ..scene import open_box

    if device == "cuda":
        from depth_correction_tpu_torch.ops import _kernels

        _kernels.load()
    cfg = make_config(cell, device)
    scans = open_box(cell.config["scene"], seed, device)
    data = prepare_sequences([scans], cfg)
    state = {"cfg": cfg, "data": data, "scans": scans, "cell": cell, "device": device,
             "k": int(cell.traffic["compare_steps"]), "prep_seconds": dict(data.prep_seconds),
             "engine": "cellwin" if data.cellwin[0] is not None else "gather"}
    state["runs"] = [_run(state)]  # the warm-up: every shape of the window
    return state


def window(state, seconds: float, capture=None) -> dict:
    out = {}
    if capture is not None:
        held = {}

        def fn():
            held["run"] = _run(state)

        out["profile"] = capture(fn, counters, EXPECT, int(state["cfg"].n_opt_iters))
    runs, steps = [], 0
    times = []
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        run = _run(state)
        times.append(time.perf_counter() - t1)
        runs.append(run)
        steps += run["steps"]
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    print("window: %d runs of %d steps; a run %.4f / %.4f / %.4f s (min / median / max)"
          % (len(times), state["cfg"].n_opt_iters, min(times), sorted(times)[len(times) // 2],
             max(times)), file=sys.stderr)
    state["runs"].extend(runs)
    out.update(attempted=steps, window_s=window_s, items=steps, run_s=times,
               end_to_end={"train_step_ms": window_s * 1e3 / steps})
    return out


def _graph_keys(data, total: int):
    """The program's frozen graph as sorted pair keys row * total + col, and
    its loss rows (global point indices)."""
    nn, rows, valid = data.neighbors[0], data.query_rows[0], data.masks[0]
    ok = (nn >= 0) & valid[:, None]
    r = rows.long()[:, None].expand_as(nn)[ok]
    keys = torch.sort(r * total + nn.long()[ok]).values
    return keys, torch.sort(rows.long()[valid]).values


def _sym_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """|a xor b| of two sorted tensors of distinct keys."""
    common = int(torch.isin(a, b).sum())
    return a.numel() + b.numel() - 2 * common


def _rel_norm_gap(got, ref) -> float:
    """|norm(got) - norm(ref)| over norm(ref) (one leaf: the weights)."""
    g, r = float(got.double().norm()), float(ref.double().norm())
    return abs(g - r) / max(r, 1e-300)


def _gaps(losses, grad0, change, ref: dict, k: int) -> tuple:
    """(loss gap, gradient gap, change gap) of one run against the
    reference's ``k`` steps."""
    lg = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    gg = _rel_norm_gap(grad0, ref["grad0"].cpu())
    cg = _rel_norm_gap(change, (ref["w"][k] - ref["w"][0]).cpu())
    return lg, gg, cg


def _ref_graph(prep: dict, total: int) -> tuple:
    sel = prep["gmask"][prep["rows"]]
    keys = torch.sort((prep["rows"][sel] * total + prep["cols"][sel]).cpu()).values
    return keys, torch.nonzero(prep["gmask"]).reshape(-1).cpu()


def judge(state, keep_reference: bool = False) -> dict:
    """Free the program's state, run the reference, and compare."""
    from ..reference import train_ref

    cell, device = state["cell"], state["device"]
    settings = cell.config["settings"]
    n_pad = state["data"].batches[0].cloud.depth.shape[1]
    total = n_pad * len(state["scans"])
    keys, rows = _graph_keys(state["data"], total)
    keys, rows = keys.cpu(), rows.cpu()
    runs = [{k: (v.double().cpu() if isinstance(v, torch.Tensor) else v) for k, v in r.items()}
            for r in state["runs"]]
    del state["data"]
    if device == "cuda":
        torch.cuda.empty_cache()
    prep = train_ref.prepare(state["scans"], settings, device)
    k = state["k"]
    ref = train_ref.run(prep, settings, steps=k)
    errors = []
    if prep["n_pad"] != n_pad:
        errors.append("the program's scans are padded to %d points, the reference's to %d"
                      % (n_pad, prep["n_pad"]))
    ref_keys, ref_rows = _ref_graph(prep, total)
    loss_gap = grad_gap = change_gap = 0.0
    bad_runs = 0
    lim = cell.limits
    for i, run in enumerate(runs):
        if run["grad0"] is None or run["wk"] is None or len(run["losses"]) < k:
            errors.append("a run ended before step %d" % k)
            bad_runs += int(i > 0)
            continue
        lg, gg, cg = _gaps(run["losses"], run["grad0"], run["wk"] - run["w0"], ref, k)
        loss_gap, grad_gap, change_gap = max(loss_gap, lg), max(grad_gap, gg), max(change_gap, cg)
        # runs[0] is set-up's warm-up; the window's runs count as attempted.
        bad_runs += int(i > 0 and (lg > lim["loss_gap"] or gg > lim["grad_gap"]
                                   or cg > lim["change_gap"]))
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
               "pair_gap": _sym_diff(keys, ref_keys) / max(ref_keys.numel(), 1),
               "row_gap": _sym_diff(rows, ref_rows) / max(ref_rows.numel(), 1)}
    cap = settings.get("nn_max_neighbors")
    n_rows = int(ref_rows.numel())
    work = {"points": int(prep["valid"].sum()), "rows": n_rows, "pairs": int(ref_keys.numel()),
            "slots": n_rows * int(cap) if cap else 0, "engine": state["engine"]}
    out = {"numbers": numbers, "errors": errors, "work": work,
           "item_work": roofline.train_step(work["points"], n_rows, work["pairs"], work["slots"]),
           "failed": bad_runs * int(state["cfg"].n_opt_iters), "runs": len(runs)}
    if keep_reference:
        out["reference"] = (prep, ref, ref_keys, ref_rows, total)
    return out


def _substitute(ref: dict, other: dict, ref_graph: tuple, graph: tuple, k: int) -> dict:
    """The numbers of a reference run ``other`` put in the program's place."""
    lg, gg, cg = _gaps(other["losses"], other["grad0"], other["w"][k] - other["w"][0], ref, k)
    (rk, rr), (ok, orows) = ref_graph, graph
    return {"loss_gap": lg, "grad_gap": gg, "change_gap": cg,
            "pair_gap": _sym_diff(ok, rk) / max(rk.numel(), 1),
            "row_gap": _sym_diff(orows, rr) / max(rr.numel(), 1)}


def calibrate(cell, seed: int, device: str, seconds: float, with_control: bool) -> dict:
    """One seed's readings: the program's numbers; with ``with_control``
    also the control's (the reference in float32 with TF32 products) and
    the faults' (half the loss rows left out, the mean over the rest; a
    step that leaves the weights unchanged reads change_gap 1 by its
    definition and needs no run)."""
    from ..reference import train_ref

    state = setup(cell, seed, device)
    win = window(state, seconds)
    verdict = judge(state, keep_reference=True)
    out = {"program": verdict["numbers"], "errors": verdict["errors"],
           "train_step_ms": win["end_to_end"]["train_step_ms"], "work": verdict["work"],
           "runs": verdict["runs"]}
    if with_control:
        prep, ref, ref_keys, ref_rows, total = verdict["reference"]
        settings, k = cell.config["settings"], state["k"]
        half = train_ref.run(prep, settings, steps=k, half_rows=True)
        out["half_batch"] = _substitute(ref, half, (ref_keys, ref_rows), (ref_keys, ref_rows), k)
        del half
        cprep = train_ref.prepare(state["scans"], settings, device, precision="tf32")
        ctrl = train_ref.run(cprep, settings, steps=k, precision="tf32")
        out["control"] = _substitute(ref, ctrl, (ref_keys, ref_rows), _ref_graph(cprep, total), k)
    return out
