"""The mapper's map rows a registration (the ICP target's size), the mean
over the profiled passes of a ``--trace 1`` run: ``COUNTS["map_voxels"]``
of ``depth_correction_tpu_torch.utils.trace`` over the ``slam.scan`` spans.
None where the program counts no map."""

ITEM = "slam.scan"


def read(ctx):
    try:
        from depth_correction_tpu_torch.utils import trace
    except ImportError:
        return None
    rows = trace.COUNTS.get("map_voxels")
    items = sum(1 for r in trace.records() if r[0] == ITEM and r[2] is not None)
    return rows / items if rows and items else None
