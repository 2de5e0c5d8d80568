"""backward_ms.train (trainer): the device milliseconds of an optimizer
step's kernels launched, from any host thread, while the program is inside
its trainer.backward spans (the backward, remat's recomputation and the
gradient all-reduce), over the traced steps."""
from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, "train", _spans.device_seconds_in, ["trainer.backward"], 1e3)
