"""Helpers of the per-layer metrics' readers (``metrics/<metric>.py``):
each reads the traced run's profile, the program's counters or prep's
seconds, and returns None where it finds nothing to read."""
from __future__ import annotations

from . import roofline

__all__ = ["idle_pct", "kernel_roofline", "launches_per_item", "prep_seconds", "step_work",
           "suffix"]


def _profile(ctx):
    return ctx.get("profile")


def launches_per_item(ctx):
    """Device operations (kernels, copies, memsets) a profiled item."""
    prof = _profile(ctx)
    if prof is None or not prof.items:
        return None
    return len(prof.ops) / prof.items


def idle_pct(ctx):
    prof = _profile(ctx)
    return None if prof is None else prof.idle_pct()


def step_work(ctx, kind: str):
    """The needed work of one launch of the moments (``fwd``, ``bwd``) or of
    a whole training step (``step``) on the cell's graph, from the
    reference's counts."""
    w = (ctx.get("verdict") or {}).get("work")
    if not w:
        return None
    fn = {"fwd": roofline.moments_fwd, "bwd": roofline.moments_bwd,
          "step": roofline.train_step}[kind]
    return fn(w["points"], w["rows"], w["pairs"], w["slots"])


def kernel_roofline(ctx, names, work, engine=None):
    """Percent of the roofline of the kernels named ``names`` a profiled
    item (device time over items), against ``work``; None where the
    profile has none of them, or the cell's engine is not ``engine``."""
    prof = _profile(ctx)
    if prof is None or work is None:
        return None
    w = (ctx.get("verdict") or {}).get("work") or {}
    if engine is not None and w.get("engine") != engine:
        return None
    seconds, launches = prof.kernel(names)
    if not launches:
        return None
    return roofline.share(work, seconds / prof.items)


def prep_seconds(ctx, part: str):
    state = ctx.get("state") or {}
    secs = state.get("prep_seconds") or {}
    return secs.get(part)


def suffix(ctx) -> str:
    """The part of the read metric's name after its first dot."""
    return ctx["metric"].split(".", 1)[1]
