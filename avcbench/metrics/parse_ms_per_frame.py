"""parse_ms_per_frame: the program's ``parse`` stage (its StageTimers
name, timed on the decode thread by the harness's timers) summed over the
window's requests, per picture.  Nothing to read where the path has no
such stage."""


def read(run):
    if "parse" not in run.stage_s or not run.frames:
        return None
    return run.stage_s["parse"] * 1e3 / run.frames
