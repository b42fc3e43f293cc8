"""entropy_ms_per_frame: the program's ``entropy`` stage (its StageTimers
name, timed on the decode thread by the harness's timers) summed over the
window's requests, per picture.  Nothing to read where the path has no
such stage."""


def read(run):
    if "entropy" not in run.stage_s or not run.frames:
        return None
    return run.stage_s["entropy"] * 1e3 / run.frames
