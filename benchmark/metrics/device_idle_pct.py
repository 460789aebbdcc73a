"""device_idle_pct.<cell kind>: 100 - the union of device activity over the
profiled stretch's wall time (a training run, a pass over the node's scan
pool, an odometry pass)."""
from benchmark import readers


def read(ctx):
    return readers.idle_pct(ctx)
