"""resize_roofline.serve (backbone): the bytes of every bilinear resample
of a request (input + output at bf16, from the reference's shapes) over
3.35 TB/s, over the device time of the kernels launched under the
aten::upsample_bilinear2d ops, in percent."""
from benchmark.metrics import _shares


def read(run):
    return _shares.roofline(run, "serve", "resize_bytes", lambda op: op.startswith("aten::upsample_bilinear2d"))
