"""Spans and host-sync counts of the port's hot paths.

:func:`span` marks one stretch of host work by name. Tracing is on while a
``torch.profiler`` session records, or inside :func:`recording`; there is
no other switch. Off, a span is one shared no-op context, returned after a
check of two module flags. On, it appends ``(name, start_ns, end_ns,
parent, attrs)`` to an in-memory list on ``time.perf_counter_ns`` and,
while a profiler records, opens ``torch.profiler.record_function`` under
its name, so that the span lies in the profiler's trace on the device
operations' clock. ``parent`` is the list index of the enclosing span
(None at the top), ``attrs`` the span's keywords (``scan=i``, ``it=i``).

Every copy between the host and the card on the instrumented paths goes
through :func:`to_host` or :func:`to_device`: a ``copy.d2h`` or
``copy.h2d`` span, and while tracing one count of ``COUNTS["host_syncs"]``
when the copy crosses between host and card memory (a copy from pageable
memory waits for the stream, as a read back does). While tracing, these
copies are allowed under ``torch.cuda.set_sync_debug_mode``, so that a
test can make every other synchronisation an error.

Spans (``PERF.md`` lists the metric that reads each): ``slam.scan`` ⊃
``slam.prior``, ``icp.search``, ``icp.gate``, ``icp.solve`` (SLAM; on the
card the last two hold X6's launcher spans ``x6.icp_gate``, ``x6.icp_solve``),
and in the mapper ``map.target``, ``map.merge`` (⊃ the scan's one
``copy.d2h``), ``map.evict``;
``fit.step`` ⊃ ``step.forward``, ``step.backward``, ``step.val``,
``step.optim``, ``step.after`` (training); ``prep.<part>`` (prep);
``node.scan`` ⊃ ``node.correct`` (the online corrector); one span a kernel
launcher (``x3.knn``, ``x1.slab``, ...); ``copy.h2d``, ``copy.d2h``.

Counts besides the syncs (:func:`count`, while tracing): ``map_voxels``, the
mapper's map rows a registration, summed; ``map_evicted``, the rows its
evictions dropped; ``dropped`` (below).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _profiler

__all__ = ["COUNTS", "MAX_RECORDS", "count", "idle_by_span", "records", "recording", "reset",
           "self_ms", "span", "to_device", "to_host"]

# Records past this many are counted in COUNTS["dropped"], not kept.
MAX_RECORDS = 1_000_000
COUNTS = {"host_syncs": 0, "dropped": 0, "map_voxels": 0, "map_evicted": 0}

_RECORDS: list = []  # [name, start_ns, end_ns, parent, attrs]; end_ns None while open
# The open spans' indices. One stack for the process: a backward's launches
# run on the autograd engine's thread while the caller waits inside its span.
_STACK: list = []
_RECORDING = 0  # depth of recording() blocks
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "rec", "fn")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        # A record_function lands only in a profiler's trace: skipped without one.
        self.fn = (torch.profiler.record_function(self.name).__enter__()
                   if _profiler._is_profiler_enabled else None)
        index = None
        self.rec = None
        if len(_RECORDS) < MAX_RECORDS:
            index = len(_RECORDS)
            self.rec = [self.name, time.perf_counter_ns(), None,
                        _STACK[-1] if _STACK else None, self.attrs]
            _RECORDS.append(self.rec)
        else:
            COUNTS["dropped"] += 1
        _STACK.append(index)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[2] = time.perf_counter_ns()
        _STACK.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[name]`` while tracing is on."""
    if _RECORDING or _profiler._is_profiler_enabled:
        COUNTS[name] += n


def span(name: str, **attrs):
    """A context that marks one stretch of host work as ``name`` while
    tracing is on (see the module's docstring); otherwise a shared no-op."""
    if not (_RECORDING or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans and counts inside the block, with or without a
    profiler session."""
    global _RECORDING
    _RECORDING += 1
    try:
        yield
    finally:
        _RECORDING -= 1


def records() -> list:
    """The spans recorded since the last :func:`reset`, in the order they
    opened: (name, start_ns, end_ns, parent, attrs); ``end_ns`` is None
    for a span still open."""
    return [tuple(r) for r in _RECORDS]


def reset() -> None:
    """Forget the records and zero the counts (between spans, not inside
    one)."""
    _RECORDS.clear()
    for key in COUNTS:
        COUNTS[key] = 0


@contextlib.contextmanager
def _sync_allowed(device):
    """A counted copy may synchronise under ``set_sync_debug_mode``."""
    mode = torch.cuda.get_sync_debug_mode() if device.type == "cuda" else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``: a ``copy.d2h`` span, and a host sync counted when ``t``
    is on a card."""
    if not (_RECORDING or _profiler._is_profiler_enabled):
        return t.cpu()
    with _Span("copy.d2h", {}):
        if t.device.type == "cpu":
            return t
        COUNTS["host_syncs"] += 1
        with _sync_allowed(t.device):
            return t.cpu()


def to_device(x, like: torch.Tensor = None, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype, device)``, ``dtype`` and ``device`` by
    default ``like``'s: a ``copy.h2d`` span where ``x`` is in host memory,
    and a host sync counted where it goes to a card."""
    if like is not None:
        dtype = like.dtype if dtype is None else dtype
        device = like.device if device is None else device
    if not (_RECORDING or _profiler._is_profiler_enabled) or (
            torch.is_tensor(x) and x.device.type != "cpu"):
        return torch.as_tensor(x, dtype=dtype, device=device)
    with _Span("copy.h2d", {}):
        device = torch.device("cpu" if device is None else device)
        if device.type == "cpu":
            return torch.as_tensor(x, dtype=dtype, device=device)
        COUNTS["host_syncs"] += 1
        with _sync_allowed(device):
            return torch.as_tensor(x, dtype=dtype, device=device)


def self_ms(recs, item: str) -> dict:
    """Each span name's self time (its duration less its children's) over
    the spans inside ``item`` spans (the ``item`` spans too), summed and
    divided by the number of ``item`` spans, in ms. Empty without a closed
    ``item`` span."""
    inside = {}

    def within(i):
        if i is None:
            return False
        if i not in inside:
            name, parent = recs[i][0], recs[i][3]
            inside[i] = name == item or within(parent)
        return inside[i]

    dur = [None if r[2] is None else r[2] - r[1] for r in recs]
    child = defaultdict(int)
    for r, d in zip(recs, dur):
        if r[3] is not None and d is not None:
            child[r[3]] += d
    items = sum(1 for r, d in zip(recs, dur) if r[0] == item and d is not None)
    if not items:
        return {}
    out = defaultdict(float)
    for i, (r, d) in enumerate(zip(recs, dur)):
        if d is not None and within(i):
            out[r[0]] += (d - child[i]) / 1e6 / items
    return dict(out)


def idle_by_span(events) -> dict:
    """Device-idle seconds by the program span open on the host at the time.

    ``events``: a profiler's events (``prof.events()``): the device
    operations (CUDA events, not annotations) and the spans (CPU user
    annotations: the program's, and any other ``record_function``), each with
    ``time_range.start`` / ``.end`` in us on one clock. Each gap between
    device operations is split at the spans' edges, and each piece goes to
    the innermost span open across it (the latest opened), or to ``""``
    where none is. Returns {name: seconds}, largest first.
    """
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in events:
        note = getattr(e, "is_user_annotation", False)
        if e.device_type == DeviceType.CUDA:
            if not note:
                ops.append((e.time_range.start, e.time_range.end))
        elif note:
            spans.append((e.time_range.start, e.time_range.end, e.name))
    ops.sort()
    gaps, end = [], None
    for s, e in ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    spans.sort()
    # Between two consecutive edges no span opens or closes.
    edges = sorted({x for g in gaps for x in g} | {x for s in spans for x in s[:2]})
    acc = defaultdict(float)
    gi = si = 0
    active = []
    for a, b in zip(edges, edges[1:]):
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        if gi == len(gaps):
            break
        while si < len(spans) and spans[si][0] <= a:
            active.append(spans[si])
            si += 1
        active = [s for s in active if s[1] > a]
        if b <= gaps[gi][0]:
            continue
        name = max(active, key=lambda s: (s[0], -s[1]))[2] if active else ""
        acc[name] += (b - a) / 1e6
    return dict(sorted(acc.items(), key=lambda kv: -kv[1]))
