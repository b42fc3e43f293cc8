"""pack_ms_per_frame: the program's ``pack`` stage (its StageTimers name,
timed on the decode thread by the harness's timers) summed over the
window's requests, per picture.  On the I/P/B path that is filling each
picture's wire blob: the native pack, a re-pack after a cap growth, the
motion field, the weighted-prediction tables and the step's key.  On
the batched path the pack is fused into ``entropy``, and ``pack`` holds
only a PCM batch's host rows.  Nothing to read where the path has no
such stage."""


def read(run):
    if "pack" not in run.stage_s or not run.frames:
        return None
    return run.stage_s["pack"] * 1e3 / run.frames
