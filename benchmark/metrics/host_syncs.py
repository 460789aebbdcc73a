"""host_syncs.<cell kind>: the copies between host and card an item (a
registered scan, a step, a corrected scan) over the profiled stretch of a
``--trace 1`` run, each a host sync: ``COUNTS["host_syncs"]`` of
``depth_correction_tpu_torch.utils.trace`` over its item spans. None where
the program records no such span."""

ITEM = {"slam": "slam.scan", "train": "fit.step", "node": "node.scan"}


def read(ctx):
    try:
        from depth_correction_tpu_torch.utils import trace
    except ImportError:
        return None
    item = ITEM.get(ctx["cell"].traffic["driver"])
    items = sum(1 for r in trace.records() if r[0] == item and r[2] is not None)
    return trace.COUNTS["host_syncs"] / items if items else None
