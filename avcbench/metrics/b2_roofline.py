"""b2_roofline: the least time the window's B2 launches
(``csrc/intra_wavefront.cu``, ``intra_rows_kernel``) could take on this
card, over their time in the trace, in %. Each launch's bound is the
larger of its bytes at the card's memory rate and its int32 operations
at its integer rate (``work.launch_bound_s``, ``peaks.PEAKS``); the
launches are the requests' own, from the configuration's ``work.json``.
Nothing to read on a card without peaks, or when the trace's launches
are not the ones the requests make."""
from avcbench.work import launch_bound_s


def read(run):
    want = run.launches.get("b2", [])
    if run.trace is None or run.peak is None or not want:
        return None
    seconds, launches = run.trace.kernel("intra_rows_kernel")
    if launches != len(want) or seconds <= 0:
        return None
    bound = sum(launch_bound_s(b, ops, run.peak) for b, ops in want)
    return 100.0 * bound / seconds
