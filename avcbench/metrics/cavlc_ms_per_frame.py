"""cavlc_ms_per_frame: the program's ``cavlc`` stage (its StageTimers
name: the native CAVLC entropy decode of a picture, timed on the decode
thread by the harness's timers) summed over the window's requests, per
picture.  Nothing to read where the path has no such stage, as on CABAC
streams and in a program that hands CAVLC streams to its host decoder."""


def read(run):
    if "cavlc" not in run.stage_s or not run.frames:
        return None
    return run.stage_s["cavlc"] * 1e3 / run.frames
