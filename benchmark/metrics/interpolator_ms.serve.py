"""interpolator_ms.serve (model step): the device milliseconds of a request's
kernels launched under the program's engine.interpolator spans (the
sampler's 2B cold pairs, the peeled last step, the refinement), over the
traced requests."""
from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, "serve", _spans.device_seconds_in, ["engine.interpolator"], 1e3)
