"""A short steady stretch of a run under torch.profiler, read once.

The profiler drops records that its clock places outside a profile's
window (kineto's "Out-of-range" records), most often late in a long
process. So, as the program's ``scripts.kernel_ms`` does, the host waits
``PAD_S`` inside the profile before the stretch and after it, and a
profile in which a named kernel's recorded launches are not a positive
multiple of what the program's own launch counters counted over the
stretch is taken again, with waits three times as long, up to
``ATTEMPTS`` profiles. A stretch that no profile recorded whole gives no
profile, and nothing is read from it.
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch

__all__ = ["ATTEMPTS", "PAD_S", "Profile", "capture"]

ATTEMPTS = 5
PAD_S = 0.05


class Profile:
    """The device operations of one profiled stretch: ``ops`` a list of
    (name, start_us, end_us), ``wall_s`` the stretch's host
    time (ending in a sync), ``items`` the items (steps, scans) it ran."""

    def __init__(self, ops, wall_s: float, items: int):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.wall_s = float(wall_s)
        self.items = int(items)

    def kernel(self, names) -> tuple:
        """(device seconds, launches) of the operations whose name holds
        one of ``names``."""
        sel = [o for o in self.ops if any(n in o[0] for n in names)]
        return sum(o[2] - o[1] for o in sel) / 1e6, len(sel)

    def busy_s(self) -> float:
        """The union of the device operations' intervals, in seconds."""
        total, end = 0.0, None
        for _, s, e in self.ops:
            if end is None or s >= end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def idle_pct(self):
        if self.wall_s <= 0:
            return None
        return 100.0 * max(0.0, 1.0 - self.busy_s() / self.wall_s)

    def top_ops(self, n: int = 10) -> list:
        acc = defaultdict(float)
        for name, s, e in self.ops:
            acc[name[:120]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time between device operations, summed by what the host
        was issuing when the card went idle: the device operation that
        ended the gap."""
        acc = defaultdict(float)
        end = None
        for name, s, e in self.ops:
            if end is not None and s > end:
                acc[("before " + name)[:120]] += (s - end) / 1e6
            end = e if end is None else max(end, e)
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def _device_ops(prof) -> list:
    """(name, start_us, end_us) of every kernel, memcpy and memset the
    profile recorded; user annotations left out."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def capture(fn, counters, expect, items: int):
    """Run ``fn()`` once under the profiler and return its :class:`Profile`,
    or None if every attempt dropped launches. ``counters()`` reads the
    program's launch counters; ``expect`` maps a counter's key to the
    kernel names it counts. ``fn`` runs again at each attempt."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(ATTEMPTS):
        pad = PAD_S * 3 ** attempt
        before = counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(pad)
        after = counters()
        p = Profile(_device_ops(prof), wall, items)
        dropped = []
        for key, names in expect.items():
            want = after[key] - before[key]
            got = p.kernel(names)[1]
            if want > 0 and (got == 0 or got % want):
                dropped.append("%s %d of %d" % (key, got, want))
        if p.ops and not dropped:
            return p
        print("profile: attempt %d (%.2f s pads) recorded %s; taking it again"
              % (attempt + 1, pad, ", ".join(dropped) or "no device operation"),
              file=sys.stderr)
    return None
