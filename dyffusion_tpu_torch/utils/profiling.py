"""Tracing and profiling: spans, wall-clock scopes, ``torch.profiler`` traces
and a device-memory report (counterpart of ``dyffusion_tpu/utils/profiling.py``).

:func:`span` names a region of the program in a ``torch.profiler`` trace. The
port opens these, named ``<layer>.<what>``:

- ``serving.request``: the body of ``predict`` (``serving.build_experiment_predict_fn``);
- ``engine.forecaster``, ``engine.interpolator``: the DYffusion engine's
  network calls (``diffusion/dyffusion.py``);
- ``backbone.norm``: every norm of the ``Unet``, ``UNetSimple`` and
  ``SimpleConvNet``; ``backbone.upsample``: ``UNetSimple``'s decoder x2
  bilinear; ``backbone.resize``: its outer resample to the working grid and back;
- ``trainer.forward``, ``trainer.backward``, ``trainer.update``: the loss, the
  backward with the gradient all-reduce, and the optimizer step of
  ``training/trainer.py::make_train_step``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()
# a host op of the trace (``cpu_op``) on the profiler's clock, which trace
# readers that keep host ops (``benchmark/trace.py``) see with the aten ops;
# about a twelfth of the cost of ``torch.profiler.record_function``'s annotation
_record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """Context manager that records the region as the host op ``name`` while
    a ``torch.profiler`` session records, nested in the spans open around
    it: the kernels it launches are those of the trace's device rows whose
    launch call falls inside it. Otherwise, and while ``torch.compile`` or
    ``torch.export`` traces (a span adds no node to a graph), it reads one
    flag and does nothing. It keeps no state: the profiler holds the events
    until its trace is exported."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _NO_SPAN
    return _record(name)


@contextlib.contextmanager
def timing_scope(name: str = "", results: Optional[dict] = None, no_op: bool = False) -> Iterator[None]:
    """Wall-clock scope: stores the elapsed seconds under ``results[name]``
    when a dict is given, else prints them. It does not synchronize a
    device: end the scope's work with a host read or
    ``torch.cuda.synchronize()`` to time device work."""
    if no_op:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results[name] = dt
        else:
            print(f"Elapsed ``{name}``: {dt:.3f}s")


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the scope with ``torch.profiler`` (CPU activity, and CUDA
    activity where a GPU is present) and write a Chrome trace,
    ``<log_dir>/trace_<pid>_<ns>.json`` (viewable in Perfetto or
    ``chrome://tracing``). Yields the profiler, whose ``key_averages()``
    can be read after the scope."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory_report() -> str:
    """One line per CUDA device: memory allocated by tensors, reserved by
    torch's caching allocator, the peak allocated, and the card's total, in
    GiB. Without a GPU, one line that says so."""
    if not torch.cuda.is_available():
        return "no CUDA device: device memory not reported"
    lines = []
    for i in range(torch.cuda.device_count()):
        gib = 2.0 ** 30
        total = torch.cuda.get_device_properties(i).total_memory / gib
        lines.append(
            f"cuda:{i} {torch.cuda.get_device_name(i)}: {torch.cuda.memory_allocated(i) / gib:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved(i) / gib:.2f} GiB reserved, peak {torch.cuda.max_memory_allocated(i) / gib:.2f}"
            f" GiB, of {total:.2f} GiB"
        )
    return "\n".join(lines)
