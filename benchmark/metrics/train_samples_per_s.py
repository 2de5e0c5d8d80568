"""train_samples_per_s (host clock): the examples of every optimizer step
in the window over the window, which ends in a synchronise and a host read
of the last loss."""


def read(run):
    if run.mode_name != "train" or not run.window_s:
        return None
    return run.work["samples"] * run.units / run.window_s
