"""X3 (the knn_* kernels of the k = 1 search) a registered scan against the
nearest searches' needed bytes (no pair count: a cull may skip most
pairs)."""
from benchmark import readers, roofline

NAMES = ["knn_"]


def read(ctx):
    w = (ctx.get("verdict") or {}).get("work")
    if not w:
        return None
    iters = int(ctx["cell"].traffic["n_iters"])
    p = int(w["points"])
    return readers.kernel_roofline(ctx, NAMES, roofline.Work(
        iters * roofline.nearest_search(p, p)[0], 0))
