"""X3 (the knn_* kernels of the k = 1 search) a registered scan of the
mapper against the needed bytes of its nearest searches in the map: each
registration's ``n_iters`` searches of its points in the map as it stood
(the reference's (queries, map rows)), the mean over the pass's
registrations. No pair count: a cull may skip most pairs."""
from benchmark import readers, roofline

NAMES = ["knn_"]


def read(ctx):
    regs = ((ctx.get("verdict") or {}).get("work") or {}).get("registrations")
    if not regs:
        return None
    iters = int(ctx["cell"].traffic["n_iters"])
    need = sum(iters * roofline.nearest_search(q, m)[0] for q, m in regs) / len(regs)
    return readers.kernel_roofline(ctx, NAMES, roofline.Work(need, 0))
