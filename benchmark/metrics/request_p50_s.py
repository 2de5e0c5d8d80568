"""request_p50_s (serving layer): the median host-clock time of a request,
each ending in a synchronise, over the untraced part of the traced run."""
import statistics


def read(run):
    if run.mode_name != "serve" or not run.unit_seconds:
        return None
    return statistics.median(run.unit_seconds)
