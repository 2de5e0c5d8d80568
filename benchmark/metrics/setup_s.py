"""setup_s (host clock): from the start of the entry point to the first
measured unit: imports, the kernels' build or load, the models, weights
and inputs, and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
