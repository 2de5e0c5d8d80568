"""forward_ms.train (trainer): the device milliseconds of an optimizer step's
kernels launched under the program's trainer.forward spans (the loss of
each micro-batch), over the traced steps."""
from benchmark.metrics import _spans


def read(run):
    return _spans.per_unit(run, "train", _spans.device_seconds_in, ["trainer.forward"], 1e3)
