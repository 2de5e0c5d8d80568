"""Reading a ``torch.profiler`` trace of the measured units: device busy
time and idle gaps over the traced window, kernel time by name, and the
device time of the kernels launched under a host op.

The trace is kineto's Chrome-trace export: ``cpu_op`` events on host
threads, ``cuda_runtime`` / ``cuda_driver`` launch calls, and ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events on the device, tied to their
launch by ``args.correlation``. The window is the ``user_annotation``
named :data:`WINDOW` around the traced units.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    """The parsed trace (times in microseconds, as the export has them)."""

    def __init__(self, events: List[dict]):
        self.window: Optional[Tuple[float, float]] = None
        self.device: List[Tuple[str, float, float, int]] = []  # (name, start, dur, correlation), kernels
        self.other_device: List[Tuple[float, float]] = []  # copies and sets
        self.launch: Dict[int, Tuple[int, float]] = {}  # correlation -> (tid, ts)
        ops: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat == "kernel":
                self.device.append((e.get("name", ""), ts, dur, int(args.get("correlation", -1))))
            elif cat in DEVICE_CATS:
                self.other_device.append((ts, dur))
            elif cat in LAUNCH_CATS:
                self.launch[int(args.get("correlation", -1))] = (e.get("tid"), ts)
            elif cat == "user_annotation" and e.get("name") == WINDOW:
                self.window = (ts, ts + dur)
            elif cat == "cpu_op":
                ops[e.get("tid")].append((ts, ts + dur, e.get("name", "")))
        self.ops = {tid: sorted(v) for tid, v in ops.items()}
        if self.window is None:
            raise ValueError(f"the trace has no '{WINDOW}' annotation")

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def _intervals(self) -> List[Tuple[float, float]]:
        """Merged device-busy intervals, clipped to the window."""
        w0, w1 = self.window
        spans = sorted((max(ts, w0), min(ts + dur, w1)) for ts, dur in
                       [(t, d) for _, t, d, _ in self.device] + self.other_device)
        merged: List[List[float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._intervals()) * 1e-6

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, _, dur, _ in self.device:
            out[name] += dur * 1e-6
        return dict(out)

    def _op_at(self, tid, ts: float) -> Optional[str]:
        """The innermost host op on thread ``tid`` open at ``ts``: of those
        that contain it, the one that began last."""
        ops = self.ops.get(tid, [])
        i = bisect.bisect_right(ops, (ts, float("inf"), ""))
        for a, b, name in reversed(ops[:i]):
            if b >= ts:
                return name
        return None

    def seconds_under(self, match) -> float:
        """Device seconds of the kernels launched inside a host op whose
        name ``match`` accepts."""
        spans = {tid: sorted((a, b) for a, b, name in ops if match(name)) for tid, ops in self.ops.items()}
        starts = {tid: [a for a, _ in v] for tid, v in spans.items()}
        total = 0.0
        for _, _, dur, corr in self.device:
            tid, ts = self.launch.get(corr, (None, 0.0))
            i = bisect.bisect_right(starts.get(tid, []), ts) - 1
            if i >= 0 and spans[tid][i][1] >= ts:
                total += dur * 1e-6
        return total

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle stretches of the window, each named by the
        innermost host op open on the busiest host thread when it began."""
        w0, w1 = self.window
        iv = self._intervals()
        edges = [w0] + [x for a, b in iv for x in (a, b)] + [w1]
        tid = max(self.ops, key=lambda t: len(self.ops[t])) if self.ops else None
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self._op_at(tid, start) or "(no host op)", length * 1e-6] for length, start in gaps[:n]]

    def device_ops(self, n: int = 10) -> List[List]:
        ks = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])
        return [[name, sec] for name, sec in ks[:n]]
