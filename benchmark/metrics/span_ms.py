"""span_ms.<span>: the program span's self time (its duration less its
children's, on the host's clock) an item, in ms, over the profiled stretch
of a ``--trace 1`` run, from ``depth_correction_tpu_torch.utils.trace``'s
records: the profiler's session turns the program's spans on. The item is
the driver's span (``slam.scan``, ``fit.step``, ``node.scan``); a retaken
profile runs whole passes again, so the mean an item stays exact. None
where the program records no such span."""
from benchmark import readers

ITEM = {"slam": "slam.scan", "train": "fit.step", "node": "node.scan"}


def read(ctx):
    try:
        from depth_correction_tpu_torch.utils import trace
    except ImportError:
        return None
    item = ITEM.get(ctx["cell"].traffic["driver"])
    return trace.self_ms(trace.records(), item).get(readers.suffix(ctx))
