"""Wall-time instrumentation (counterpart of ``depth_correction_tpu/utils/
timing.py``; reference: src/depth_correction/utils.py:54-64)."""
from __future__ import annotations

import functools
from timeit import default_timer as timer

__all__ = ["timing", "timer"]


def timing(f):
    """Decorator printing wall time of each call."""

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        t0 = timer()
        try:
            return f(*args, **kwargs)
        finally:
            print("%s %.6f s" % (f.__name__, timer() - t0))

    return wrapper
