"""P7 (gather_moments_kernel, both passes of the centred form) a step
against the K = 32 graph's moments' needed work."""
from benchmark import readers

NAMES = ["gather_moments_kernel"]


def read(ctx):
    return readers.kernel_roofline(ctx, NAMES, readers.step_work(ctx, "fwd"), "gather")
