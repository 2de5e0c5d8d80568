"""mfu.train (model step): the model FLOPs of a unit (counted on the
reference at the cell's shapes) x the units of the untraced part of the
traced run / its wall time / the bf16 dense peak, in percent."""
from benchmark.metrics import _shares


def read(run):
    return _shares.mfu(run, "train")
