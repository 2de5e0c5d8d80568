"""Reading the program's spans in a parsed trace (``benchmark.trace.Trace``).

The port names its layers with ``dyffusion_tpu_torch.utils.profiling.span``:
host ops (``cpu_op`` events) called ``<layer>.<what>`` on the profiler's
clock, which the trace keeps with the other host ops. A kernel belongs to a
span when its launch call starts inside the span, whichever host thread
launched it: the backward's kernels launch from autograd's thread while
the main thread sits in ``trainer.backward``. A kernel inside nested spans
belongs to each of them, and counts once however many of the names asked
for hold it. A trace without the spans (a program that opens none) reads
as nothing: every function returns None, as the kernel readings do where
no kernel launched inside the spans.
"""
from __future__ import annotations

import bisect
from typing import Callable, Iterable, List, Optional, Tuple

Intervals = List[Tuple[float, float]]


def _union(intervals) -> Intervals:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def spans(trace, names: Iterable[str]) -> Optional[Intervals]:
    """The union of every thread's spans named in ``names`` (microseconds),
    or None where the trace holds none."""
    names = set(names)
    found = [(a, b) for ops in trace.ops.values() for a, b, name in ops if name in names]
    return _union(found) if found else None


def _kernels_in(trace, names: Iterable[str]) -> Optional[List[float]]:
    """The durations (microseconds) of the kernels launched inside the spans."""
    union = spans(trace, names)
    if union is None:
        return None
    starts = [a for a, _ in union]
    out = []
    for _, _, dur, corr in trace.device:
        launch = trace.launch.get(corr)
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch[1]) - 1
        if i >= 0 and launch[1] <= union[i][1]:
            out.append(dur)
    return out


def device_seconds_in(trace, names: Iterable[str]) -> Optional[float]:
    """Device seconds of the kernels whose launch starts inside a span of
    one of ``names``."""
    durs = _kernels_in(trace, names)
    return sum(durs) * 1e-6 if durs else None


def kernels_in(trace, names: Iterable[str]) -> Optional[int]:
    """The number of those kernels."""
    durs = _kernels_in(trace, names)
    return len(durs) if durs else None


def _overlap(a: Intervals, b: Intervals) -> float:
    """The length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_seconds_in(trace, names: Iterable[str]) -> Optional[float]:
    """Seconds of the traced window in which a span of one of ``names`` is
    open on some host thread and the device runs no kernel, copy or set."""
    union = spans(trace, names)
    if union is None:
        return None
    w0, w1 = trace.window
    inside = [(max(a, w0), min(b, w1)) for a, b in union if min(b, w1) > max(a, w0)]
    return (sum(b - a for a, b in inside) - _overlap(inside, trace._intervals())) * 1e-6


def per_unit(run, mode: str, read: Callable, names: Iterable[str], scale: float = 1.0) -> Optional[float]:
    """``read(trace, names)`` x ``scale`` over the traced units of a traced
    run of ``mode``; None for another mode, an untraced run or no reading."""
    if run.mode_name != mode or run.trace is None:
        return None
    value, traced = read(run.trace, names), run.units - run.untraced_units
    return None if value is None or traced <= 0 else value * scale / traced
