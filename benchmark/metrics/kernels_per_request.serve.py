"""kernels_per_request.serve (serving): the kernels launched under the
program's serving.request spans, over the traced requests."""
from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, "serve", _spans.kernels_in, ["serving.request"])
