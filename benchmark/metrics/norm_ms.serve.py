"""norm_ms.serve (backbone): the device milliseconds of a request's kernels
launched under the program's backbone.norm spans (every GroupNorm,
channel LayerNorm and BatchNorm of both networks), over the traced
requests."""
from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, "serve", _spans.device_seconds_in, ["backbone.norm"], 1e3)
