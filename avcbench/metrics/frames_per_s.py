"""frames_per_s: every picture of the requests completed in the window,
over the window (its start to the end of its last request)."""


def read(run):
    return run.frames / run.window_s if run.frames else None
