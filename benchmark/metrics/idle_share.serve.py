"""idle_share.serve (device): 1 - the union of kernel, copy and set intervals
/ the traced window, in percent."""
from benchmark.metrics import _shares


def read(run):
    return _shares.idle(run, "serve")
