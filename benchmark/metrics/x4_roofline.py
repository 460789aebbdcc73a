"""X4 (transpose_moments_kernel) a step against the K = 32 graph's
moments' VJP's needed work."""
from benchmark import readers

NAMES = ["transpose_moments_kernel"]


def read(ctx):
    return readers.kernel_roofline(ctx, NAMES, readers.step_work(ctx, "bwd"), "gather")
