"""update_ms.train (trainer): the device milliseconds of an optimizer step's
kernels launched under the program's trainer.update spans (the gradient
norm and zero share, the gradient watch, the optimizer step), over the
traced steps."""
from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, "train", _spans.device_seconds_in, ["trainer.update"], 1e3)
