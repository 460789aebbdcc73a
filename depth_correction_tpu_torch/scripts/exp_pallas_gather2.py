"""The dynamic-gather probes (P8) on the card.

Counterpart of scripts/exp_pallas_gather2.py, which asked which dynamic
gathers Mosaic lowers and whether a gather's index space is the whole
array or one tile. Its cases, with its shapes and default_rng(0) draws in
its order:

  A  take_along_axis along lanes, (8, 256)
  B  the same at (8, 131072): the index space is the whole row
  C  along sublanes (axis 0), (8, 256), indices in [0, 8)
  D  (8, 1024) gathered to (8, 256)
  E  a 1-D take, (2048,)

Each in two forms (ops/gather_probe.py, csrc/gather_probe.cu): ``global``
loads x[idx] from device memory, ``staged`` stages the block's row (all of
x for C) in shared memory first, where that fits one block's 227 KB; B's
512 KB row does not, so B's staged form spreads the row over a cluster of
8 blocks' shared memory. For each: ms per call and the error against the
plain version (must be 0). B's forms and torch.gather (the plain version,
one PyTorch call) are also timed in turns (:func:`b_turns`).

    python -m depth_correction_tpu_torch.scripts.exp_pallas_gather2
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.gather_probe import FORMS, gather_probe, gather_probe_plain, staged_fits
from . import device_ms, kernel_ms, require_card

STEPS = 50
B_COLS = 131072


def inputs(device) -> dict:
    """{case: (x float32, idx int32, axis)} on ``device``, drawn as the
    script draws them (default_rng(0), normal values cast to float32)."""
    rng = np.random.default_rng(0)

    def case(x_shape, hi, i_shape, axis):
        x = np.asarray(rng.normal(size=x_shape), np.float32)
        idx = np.asarray(rng.integers(0, hi, i_shape), np.int32)
        return (torch.as_tensor(x, device=device), torch.as_tensor(idx, device=device), axis)

    cases = {}
    cases["A"] = case((8, 256), 256, (8, 256), 1)
    cases["B"] = case((8, B_COLS), B_COLS, (8, B_COLS), 1)
    cases["C"] = case((8, 256), 8, (8, 256), 0)
    cases["D"] = case((8, 1024), 1024, (8, 256), 1)
    cases["E"] = case((2048,), 2048, (2048,), 1)
    return cases


def run(device, reps: int = STEPS) -> dict:
    """Time and check every case and form.

    :return: {"cases": {case: {form: {"ms", "err", "out"} or None (not
        applicable)}}} with ``err`` the largest |kernel - plain|.
    """
    res = {}
    for name, (x, idx, axis) in inputs(device).items():
        want = gather_probe_plain(x, idx, axis)
        res[name] = {}
        for form in FORMS:
            if form == "staged" and not staged_fits(x, axis):
                res[name][form] = None
                continue

            def call(x=x, idx=idx, axis=axis, form=form):
                return gather_probe(x, idx, axis, form)

            ms = device_ms(call, device, reps)
            out = call()
            res[name][form] = {"ms": ms, "err": float((out - want).abs().max()), "out": out}
    return {"cases": res}


def b_turns(device, reps: int = STEPS) -> dict:
    """Case B's forms and torch.gather timed in turns.

    B's global form, its cluster form and torch.gather (the plain version,
    one PyTorch call) are timed by the profiler's kernel durations and by
    CUDA events in the order global, cluster, torch.gather, global_sorted,
    then back again; each reading is the mean of its two. ``global_sorted``
    is the global form on B's indices sorted within each row: the same
    bytes, but neighbouring lanes read neighbouring words, so its time
    without the random 32-byte sectors says how much of B's time they take.

    :return: {"kernel_ms" / "ms": {"global", "cluster", "torch_gather",
        "global_sorted": ms}, "kernel_turns" / "turns": {name: (first,
        second)}}.
    """
    xb, ib, axis = inputs(device)["B"]
    ib_sorted = torch.sort(ib, dim=1).values.contiguous()
    calls = {"global": lambda: gather_probe(xb, ib, axis, "global"),
             "cluster": lambda: gather_probe(xb, ib, axis, "staged"),
             "torch_gather": lambda: gather_probe_plain(xb, ib, axis),
             "global_sorted": lambda: gather_probe(xb, ib_sorted, axis, "global")}
    res = {}
    for key, timer in (("kernel", kernel_ms), ("", device_ms)):
        turns = {n: [] for n in calls}
        for n in list(calls) + list(calls)[::-1]:
            turns[n].append(timer(calls[n], device, reps))
        res[(key + "_" if key else "") + "ms"] = {n: sum(t) / 2 for n, t in turns.items()}
        res[(key + "_" if key else "") + "turns"] = {n: tuple(t) for n, t in turns.items()}
    return res


def main() -> int:
    device = require_card()
    res = run(device)
    ok = True
    for name, forms in res["cases"].items():
        for form, e in forms.items():
            if e is None:
                print("%s %-7s n/a (the staged table does not fit one block's shared memory)"
                      % (name, form))
                continue
            ok &= e["err"] == 0
            print("%s %-7s %s  err %.1e  %8.4f ms/call"
                  % (name, form, "OK  " if e["err"] == 0 else "FAIL", e["err"], e["ms"]))
    turns = b_turns(device)
    for name in turns["ms"]:
        print("B %-13s device %.4f ms (turns %s), events %.4f ms"
              % (name, turns["kernel_ms"][name],
                 ", ".join("%.4f" % v for v in turns["kernel_turns"][name]), turns["ms"][name]))
    print(torch.cuda.get_device_name(device))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
