"""prep_s.<part>: the seconds of one part of prep,
TrainData.prep_seconds[<part>] (``train._tick`` syncs the card):
cellwin_build (the cell-window build, host), global_neighbors (X2 on the
card)."""
from benchmark import readers


def read(ctx):
    return readers.prep_seconds(ctx, readers.suffix(ctx))
