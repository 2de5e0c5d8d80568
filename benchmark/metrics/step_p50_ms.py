"""step_p50_ms (trainer layer): the median interval between CUDA events
recorded at optimizer-step boundaries (no synchronise per step), over the
untraced part of the traced run."""
import statistics


def read(run):
    if run.mode_name != "train" or not run.unit_seconds:
        return None
    return statistics.median(run.unit_seconds) * 1e3
