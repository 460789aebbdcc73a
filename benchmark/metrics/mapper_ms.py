"""mapper_ms.<span>: the program span's self time (its duration less its
children's, on the host's clock) an item, in ms, over the profiled stretch
of a ``--trace 1`` run, as ``span_ms`` reads the odometry cell's. The item
is a ``slam.scan`` span of ``slam_eval.slam_mapper``: a registration and
its merge into the map (``map.merge``, ``map.evict``, ``map.target``,
``icp.search``, ``copy.d2h``, ...). None where the program records no such
span."""
from benchmark import readers

ITEM = "slam.scan"


def read(ctx):
    try:
        from depth_correction_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.self_ms(trace.records(), ITEM).get(readers.suffix(ctx))
