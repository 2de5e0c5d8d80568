"""resample_roofline.serve (backbone): the bytes of every bilinear resample
of a request (input + output at bf16, from the reference's shapes) over
3.35 TB/s, over the device time of the kernels launched under the
program's backbone.upsample and backbone.resize spans, in percent. The
spans name the work, not the kernel that does it."""
from benchmark.metrics import _spans
from benchmark.reference import peaks


def read(run):
    if run.mode_name != "serve" or run.trace is None or not run.work.get("resize_bytes"):
        return None
    seconds = _spans.device_seconds_in(run.trace, ["backbone.upsample", "backbone.resize"])
    if not seconds:
        return None
    traced = run.units - run.untraced_units
    return 100.0 * run.work["resize_bytes"] * traced / peaks.HBM_BYTES_PER_S / seconds
