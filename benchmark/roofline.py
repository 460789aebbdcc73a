"""Published peaks of one NVIDIA H100 SXM and the work an operation needs.

The peaks are NVIDIA's data sheet figures for the SXM part at its 700 W
limit: 67 TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of
HBM3 bandwidth. The kernels of the measured paths run float32 FMA code, so
float32's peak is the ceiling of their operations.

The work counts what the operation needs for the cell's inputs, whatever
implements it: each input byte read once, in the form prep hands to the
step (float32 points, the neighbour table and its weights where the graph
is a table, the cotangent rows), each output byte written once, and the
floating point operations of the pairs the result needs. A within-r graph
is implied by the points and the radius, so its moments need no table; a
capped graph is a table of int32 indices and float32 weights. Nothing here
counts a kernel's own layout, its tiles, its padding or the pairs it tests
and rejects.

Operations a pair: the forward moments add the neighbour to the row's sum
(3) and its products to the six second moments (6 FMAs, 12), 15 in all;
their VJP adds to the neighbour's gradient the row's mean cotangent (3)
and the symmetric 3 x 3 cotangent times the centred neighbour (9 FMAs,
18), 21 in all.
"""
from __future__ import annotations

__all__ = ["BYTES_PER_S", "FLOPS_PER_S", "Work", "moments_bwd", "moments_fwd", "node_scan",
           "icp_registration", "nearest_search", "share", "train_step"]

FLOPS_PER_S = 67e12   # float32, non-tensor-core
BYTES_PER_S = 3.35e12  # HBM3

POINT_BYTES = 12      # a float32 point
ROW_OUT_BYTES = 40    # mean (3), six second moments, the weight sum: float32
COT_ROW_BYTES = 48    # a row's cotangent: 12 float32 (_cotangent_rows)
SLOT_BYTES = 8        # a table slot: int32 index and float32 weight
PAIR_FLOPS_FWD = 15
PAIR_FLOPS_BWD = 21
# A training step's point-wise work a point: the local fields read (view
# point 12, direction 12, depth 4, incidence angle 4, mask 1) and the world
# point written, forward; the point's gradient read and the depth's
# gradient written, backward.
STEP_POINT_BYTES = 33 + 12 + 12 + 4
# A loss row's eigen-features and cotangent: its moments read, its
# cotangent row written.
STEP_ROW_BYTES = ROW_OUT_BYTES + COT_ROW_BYTES


class Work(tuple):
    """(bytes, flops) an operation needs; ``+`` adds two."""

    def __new__(cls, nbytes: float, flops: float):
        return super().__new__(cls, (float(nbytes), float(flops)))

    def __add__(self, other):
        return Work(self[0] + other[0], self[1] + other[1])

    def seconds(self) -> float:
        """The least time at the published peaks."""
        return max(self[0] / BYTES_PER_S, self[1] / FLOPS_PER_S)


def moments_fwd(points: int, rows: int, pairs: int, slots: int = 0) -> Work:
    """A moments forward over ``pairs`` pairs of ``rows`` rows on
    ``points`` points; ``slots`` table slots where the graph is a table."""
    return Work(points * POINT_BYTES + slots * SLOT_BYTES + rows * ROW_OUT_BYTES,
                pairs * PAIR_FLOPS_FWD)


def moments_bwd(points: int, rows: int, pairs: int, slots: int = 0) -> Work:
    """The moments' VJP: the rows' cotangents and the points in, the
    points' gradient out."""
    return Work(rows * COT_ROW_BYTES + 2 * points * POINT_BYTES + slots * SLOT_BYTES,
                pairs * PAIR_FLOPS_BWD)


def train_step(points: int, rows: int, pairs: int, slots: int = 0) -> Work:
    """A whole training step: the moments and their VJP, the point-wise
    correction, transform and their backward, and the rows' eigen-features."""
    return (moments_fwd(points, rows, pairs, slots) + moments_bwd(points, rows, pairs, slots)
            + Work(points * STEP_POINT_BYTES + rows * STEP_ROW_BYTES, 0))


def node_scan(raw: int, kept: int, pairs: int) -> Work:
    """One corrected scan on the card: the raw float32 points in, the
    within-r moments of the kept rows, each kept row's corrected point,
    normal and mask (28 bytes) out."""
    return moments_fwd(kept, kept, pairs) + Work(raw * POINT_BYTES + kept * 28, 0)


def nearest_search(queries: int, points: int) -> Work:
    """A nearest-neighbour search: the queries and the points in, an index
    and a distance a query out. No pair count: a cull may skip most
    pairs."""
    return Work((queries + points) * POINT_BYTES + queries * 8, 0)


def icp_registration(points: int, iters: int) -> Work:
    """One scan's point-to-plane registration: ``iters`` times the nearest
    search of its points in the previous scan's, and per point the
    transform, the residual along the target normal and the normal
    equations' products (J^T W J and J^T W r: ~90 flops), reading the point,
    its target point and normal."""
    return Work(iters * (nearest_search(points, points)[0] + points * 36),
                iters * points * 90)


def share(work: Work, seconds: float):
    """Percent of the roofline: the least time over ``seconds``; None
    without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * work.seconds() / seconds
