"""device_idle_pct: 100 x (1 - the union of every device activity in the
traced window / the window), from torch.profiler's device events."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
