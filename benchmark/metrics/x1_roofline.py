"""X1 (slab_window_kernel) a scan against the within-r moments' needed
work over the kept rows of the pool's scans (the mean scan)."""
from benchmark import readers, roofline

NAMES = ["slab_window_kernel"]


def read(ctx):
    w = (ctx.get("verdict") or {}).get("work")
    if not w:
        return None
    work = roofline.moments_fwd(w["kept"], w["kept"], w["pairs"])
    return readers.kernel_roofline(ctx, NAMES, work)
