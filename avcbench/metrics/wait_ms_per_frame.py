"""wait_ms_per_frame: the program's ``wait`` stage (its StageTimers name,
timed on the decode thread by the harness's timers) summed over the
window's requests, per picture: the host blocked on a card event, before
reusing a staging slot whose copy is in flight, before a staging cap
growth, and at the call's last drain.  Nothing to read where the path
has no such stage."""


def read(run):
    if "wait" not in run.stage_s or not run.frames:
        return None
    return run.stage_s["wait"] * 1e3 / run.frames
