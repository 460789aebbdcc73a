"""The copies between host and card a registered scan of
``slam_eval.slam_mapper`` (a ``slam.scan`` span) over the profiled passes
of a ``--trace 1`` run, each a host sync: ``COUNTS["host_syncs"]`` of
``depth_correction_tpu_torch.utils.trace`` over the passes' scan spans (a
pass's first merge, outside them, counted too). None where the program
records no such span."""

ITEM = "slam.scan"


def read(ctx):
    try:
        from depth_correction_tpu_torch.utils import trace
    except ImportError:
        return None
    items = sum(1 for r in trace.records() if r[0] == ITEM and r[2] is not None)
    return trace.COUNTS["host_syncs"] / items if items else None
