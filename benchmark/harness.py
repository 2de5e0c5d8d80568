"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, and the result line.

Everything a cell is comes from files found by name: its entry in
``BENCHMARK.json`` names a configuration (``benchmark/configs/<name>.json``)
and a traffic mix (``benchmark/traffic/<name>.json``); the mix names its
mode (``benchmark/modes/<mode>.py``, which builds the system and drives one
unit of work: a request or an optimizer step); each metric listed for the
cell is read by ``benchmark/metrics/<metric>.py``. Adding a cell, a
configuration, a mix or a metric is adding files.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from benchmark.reference.compare import verdict

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dyffusion_tpu")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entry, configuration and traffic mix, and the metrics it
    reports (end-to-end ones with ``--trace 0``, per-layer ones with 1)."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root, self.dir = root, root / "benchmark"
        bench = read_json(root / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entry
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        self.config = read_json(root / conf["file"])
        self.traffic = read_json(self.dir / "traffic" / f"{entry['traffic']}.json")
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        names = {m["name"] for m in e2e}
        layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
        self.metrics = {0: e2e, 1: layer}

    def mode(self):
        return _load(self.dir / "modes" / f"{self.traffic['mode']}.py", f"benchmark_mode_{self.traffic['mode']}")


class Run:
    """What the metric readers read: the cell, the unit times, the work a
    unit does, the set-up time, peak memory and, traced, the trace."""

    def __init__(self, cell: Cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.mode_name = cell.traffic["mode"]
        self.setup_s: Optional[float] = None
        self.unit_seconds: List[float] = []  # per unit (request or optimizer step), untraced part
        self.units = 0
        self.window_s = 0.0
        self.untraced_units = 0
        self.untraced_s = 0.0
        self.work: Dict[str, float] = {}  # per unit: flops, b1_bytes, resize_bytes, and the unit's frames or samples
        self.peak_bytes = 0
        self.trace = None


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _window(session, run: Run, seconds: float, first: int, timed: bool) -> tuple:
    """Units back to back until ``seconds`` have passed; returns (units,
    wall seconds). With ``timed``, each unit's time: the host clock around
    a unit that ends in a synchronise, else CUDA events between units."""
    import torch

    use_events = timed and not session.unit_syncs and run.device.startswith("cuda")
    events = []
    _sync(run.device)
    t0 = time.perf_counter()
    if use_events:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    n = 0
    while True:
        t = time.perf_counter()
        session.unit(first + n)
        n += 1
        if use_events:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        elif timed:
            run.unit_seconds.append(time.perf_counter() - t)
        if time.perf_counter() - t0 >= seconds:
            break
    session.finish()
    wall = time.perf_counter() - t0
    if use_events:
        run.unit_seconds += [a.elapsed_time(b) * 1e-3 for a, b in zip(events, events[1:])]
    return n, wall


def _traced(session, run: Run, seconds: float, first: int) -> int:
    """Units under ``torch.profiler`` (host ops and device activity) until
    ``seconds`` have passed and at least one unit ran; parses the trace."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.trace import WINDOW, Trace

    _sync(run.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            n = 0
            while n == 0 or time.perf_counter() - t0 < seconds:
                session.unit(first + n)
                n += 1
            session.finish()
    with tempfile.TemporaryDirectory(prefix="benchmark_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        run.trace = Trace.load(path)
    return n


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def read_metrics(run: Run, specs: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in specs:
        reader = _load(run.cell.dir / "metrics" / f"{m['name']}.py", "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(cell_name: str, seed: int, seconds: float, trace: int, device: str = "cuda",
            t_start: Optional[float] = None, root: Path = ROOT) -> dict:
    """One run of ``cell_name``; returns the result line's object. The
    process start is ``t_start`` (``time.perf_counter()`` at the top of
    the entry point)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cell_name, root)
    run = Run(cell, seed, device)
    session = cell.mode().Session(cell, run)
    run.setup_s = time.perf_counter() - t_start
    if not trace:
        run.units, run.window_s = _window(session, run, seconds, 0, timed=False)
    else:
        run.untraced_units, run.untraced_s = _window(session, run, seconds / 2, 0, timed=True)
        traced = _traced(session, run, seconds / 2, run.untraced_units)
        run.units = run.untraced_units + traced
        run.work.update(session.work())
    if device.startswith("cuda"):
        import torch

        run.peak_bytes = int(torch.cuda.max_memory_allocated())
    metrics = read_metrics(run, cell.metrics[trace])
    numbers, limits = session.check()
    del session
    gc.collect()
    correct = verdict(numbers, limits)
    result = {
        "correct": bool(correct),
        "attempted": int(run.units),
        "failed": 0 if correct else 1,
        "metrics": metrics,
        "device": _device(run),
    }
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    result["_readings"] = {k: v for k, v in numbers.items() if k not in limits}
    return result


def _device(run: Run) -> dict:
    if not run.device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": run.peak_bytes, "power_limit": _power_limit()}
    if run.trace is not None:
        out["busy_s"] = run.trace.busy_s
        out["window_s"] = run.trace.window_s
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def main(argv: List[str], t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch

    chips = Cell(a.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = execute(a.workload, a.seed, a.seconds, a.trace, "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}, which the benchmark may not load", file=sys.stderr)
        return 3
    for k, v in result.pop("_readings").items():
        print(f"reading {k} {v} (not compared)", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
