"""request_idle_ms.serve (serving): the milliseconds of a request in which
the host is inside the program's serving.request span and the device runs
no kernel, copy or set, over the traced requests."""
from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, "serve", _spans.idle_seconds_in, ["serving.request"], 1e3)
