"""host_cpu_ms_per_frame: the process's CPU time (user and system, every
thread) across the window, per picture completed."""


def read(run):
    return run.cpu_s * 1e3 / run.frames if run.frames else None
