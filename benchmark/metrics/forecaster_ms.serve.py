"""forecaster_ms.serve (model step): the device milliseconds of a request's
kernels launched under the program's engine.forecaster spans (one a
sampler step), over the traced requests."""
from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, "serve", _spans.device_seconds_in, ["engine.forecaster"], 1e3)
