"""frames_per_s (host clock): the frames (members x rows x horizon) of the
requests completed in the window over the window, which runs from the
first request's start to the last one's return (a synchronise)."""


def read(run):
    if run.mode_name != "serve" or not run.window_s:
        return None
    return run.work["frames"] * run.units / run.window_s
