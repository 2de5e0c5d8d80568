"""The program's spans read from a hand-built trace: kernels attributed by
the time of their launch against every thread's spans, nested spans, idle
time inside spans, the trace's own readings unchanged by the spans, and the
span metrics' readers."""
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.metrics import _spans
from benchmark.trace import WINDOW, Trace
from benchmark.tests.tiny import REPO

MAIN, AUTOGRAD = 1, 2
SPAN_NAMES = ("serving.request", "engine.interpolator", "backbone.norm", "trainer.backward")


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": args}


def _events(with_spans: bool = True):
    """A window of 0-1000 us. The main thread serves a request (10-900) whose
    interpolator call (20-400) holds a norm (30-60) with its aten op
    (31-59), then sits in the backward (500-800) while autograd's thread
    launches a kernel; one launch (950) is outside every span, and a second
    request (990-1100) runs past the window's end. Kernels: the norm's
    40-50, the interpolator's 110-210, the backward's 610-640, the
    outsider's 960-980; with the spans, their device-side twins too."""
    ev = [
        _x("user_annotation", WINDOW, 0, 1000),
        _x("cpu_op", "aten::native_group_norm", 31, 28),
        _x("cpu_op", "aten::add", 940, 15),
        _x("cuda_runtime", "cudaLaunchKernel", 35, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 100, 2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 600, 2, tid=AUTOGRAD, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 950, 2, correlation=4),
        _x("kernel", "group_norm_kernel", 40, 10, tid=7, correlation=1),
        _x("kernel", "conv_kernel", 110, 100, tid=7, correlation=2),
        _x("kernel", "dgrad_kernel", 610, 30, tid=7, correlation=3),
        _x("kernel", "add_kernel", 960, 20, tid=7, correlation=4),
    ]
    if with_spans:
        ev += [
            _x("cpu_op", "serving.request", 10, 890),
            _x("cpu_op", "engine.interpolator", 20, 380),
            _x("cpu_op", "backbone.norm", 30, 30),
            _x("cpu_op", "trainer.backward", 500, 300),
            _x("cpu_op", "serving.request", 990, 110),
            _x("gpu_user_annotation", "engine.interpolator", 40, 170, tid=7),
        ]
    return ev


@pytest.fixture
def trace():
    return Trace(_events())


def test_kernel_of_another_thread_counts_in_the_span_it_launched_in(trace):
    assert _spans.kernels_in(trace, ["trainer.backward"]) == 1
    assert _spans.device_seconds_in(trace, ["trainer.backward"]) == pytest.approx(30e-6)


def test_nested_spans_count_a_kernel_once(trace):
    assert _spans.device_seconds_in(trace, ["engine.interpolator"]) == pytest.approx(110e-6)
    assert _spans.device_seconds_in(trace, ["backbone.norm"]) == pytest.approx(10e-6)
    both = ["engine.interpolator", "backbone.norm"]
    assert _spans.device_seconds_in(trace, both) == pytest.approx(110e-6)
    assert _spans.kernels_in(trace, both) == 2
    assert _spans.kernels_in(trace, ["serving.request"]) == 3  # not the outsider at 950


def test_idle_inside_spans(trace):
    # the first request: 890 us open, 140 us of it busy; the second: 10 us inside the window, idle
    assert _spans.idle_seconds_in(trace, ["serving.request"]) == pytest.approx(760e-6)
    assert _spans.idle_seconds_in(trace, ["backbone.norm"]) == pytest.approx(20e-6)
    assert _spans.idle_seconds_in(trace, ["trainer.backward"]) == pytest.approx(270e-6)


def test_no_spans_reads_nothing():
    plain = Trace(_events(with_spans=False))
    for read in (_spans.device_seconds_in, _spans.kernels_in, _spans.idle_seconds_in):
        assert read(plain, ["serving.request"]) is None


def test_trace_readings_unchanged_by_spans(trace):
    """Busy time, kernel time by name and the time under an aten op read the
    same with the spans in the trace. An idle gap keeps its length and the
    op that names it; one that began in no op now names the innermost span
    open there."""
    plain = Trace(_events(with_spans=False))
    assert trace.busy_s == plain.busy_s and trace.window_s == plain.window_s
    assert trace.device_ops() == plain.device_ops()
    for match in (lambda op: op == "aten::native_group_norm", lambda op: op.startswith("aten::")):
        assert trace.seconds_under(match) == plain.seconds_under(match)
    named, bare = trace.idle_gaps(), plain.idle_gaps()
    assert [g[1] for g in named] == [g[1] for g in bare]
    for (name, _), (was, _) in zip(named, bare):
        assert name == was or (was == "(no host op)" and name in SPAN_NAMES)
    assert any(name != was for (name, _), (was, _) in zip(named, bare))


METRICS = {
    "interpolator_ms.serve": ("serve", 110e-3 / 2),
    "forecaster_ms.serve": ("serve", None),  # no such span in the trace
    "norm_ms.serve": ("serve", 10e-3 / 2),
    "resample_roofline.serve": ("serve", None),
    "kernels_per_request.serve": ("serve", 3 / 2),
    "request_idle_ms.serve": ("serve", 760e-3 / 2),
    "forward_ms.train": ("train", None),
    "backward_ms.train": ("train", 30e-3 / 2),
    "update_ms.train": ("train", None),
}


def _run(mode, trace):
    return SimpleNamespace(mode_name=mode, trace=trace, units=3, untraced_units=1, work={"resize_bytes": 1e6})


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_metric_readers(name, trace):
    mode, want = METRICS[name]
    reader = harness._load(REPO / "benchmark/metrics" / f"{name}.py", "test_metric_" + name.replace(".", "_"))
    got = reader.read(_run(mode, trace))
    assert got == pytest.approx(want) if want is not None else got is None
    other = "train" if mode == "serve" else "serve"
    assert reader.read(_run(other, trace)) is None
    assert reader.read(_run(mode, Trace(_events(with_spans=False)))) is None
    assert reader.read(_run(mode, None)) is None


def test_resample_roofline_reads_the_resample_spans():
    ev = _events() + [_x("cpu_op", "backbone.resize", 95, 10), _x("cpu_op", "backbone.upsample", 598, 5, tid=AUTOGRAD)]
    reader = harness._load(REPO / "benchmark/metrics/resample_roofline.serve.py", "test_metric_resample")
    from benchmark.reference import peaks

    # 2 traced units of 1 MB over the 130 us of the two kernels launched inside the spans
    want = 100.0 * 1e6 * 2 / peaks.HBM_BYTES_PER_S / 130e-6
    assert reader.read(_run("serve", Trace(ev))) == pytest.approx(want)
