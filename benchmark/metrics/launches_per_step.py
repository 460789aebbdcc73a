"""launches_per_step.<cell kind>: device operations (kernels, memcpys,
memsets) an item (a step, a scan) of the profiled stretch: the host
dispatch the item pays for."""
from benchmark import readers


def read(ctx):
    return readers.launches_per_item(ctx)
