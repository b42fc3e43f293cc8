"""untimed_ms_per_frame: each request's wall time (call to the
synchronise after its last plane) minus the sum of its stage timers,
summed over the window's requests, per picture: the entry's work outside
every stage (NAL split, DPB, the wait for the card's tail)."""


def read(run):
    return run.untimed_s * 1e3 / run.frames if run.frames else None
