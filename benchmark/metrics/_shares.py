"""Shared arithmetic of the share metrics: achieved work over the chip's
published peak, from the untraced part of a traced run (MFU), and a
kernel's byte bound over its device time in the trace (rooflines)."""
from benchmark.reference import peaks


def mfu(run, mode):
    if run.mode_name != mode or not run.untraced_s or not run.work.get("flops"):
        return None
    return 100.0 * run.work["flops"] * run.untraced_units / run.untraced_s / peaks.BF16_FLOPS_PER_S


def roofline(run, mode, work_key, match):
    """100 x (bytes per unit x traced units / peak bandwidth) / device
    seconds of the kernels launched under the host ops ``match`` accepts;
    None where the trace holds no such kernel."""
    if run.mode_name != mode or run.trace is None or not run.work.get(work_key):
        return None
    seconds = run.trace.seconds_under(match)
    if seconds <= 0.0:
        return None
    traced = run.units - run.untraced_units
    return 100.0 * run.work[work_key] * traced / peaks.HBM_BYTES_PER_S / seconds


def idle(run, mode):
    if run.mode_name != mode or run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
