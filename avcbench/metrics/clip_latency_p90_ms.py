"""clip_latency_p90_ms: the 90th percentile, linear between ranks, of the
latency of every request completed in the window, each from its call to
the synchronise after its last plane."""
from avcbench.timing import percentile


def read(run):
    if not run.latencies_s:
        return None
    return percentile(run.latencies_s, 90) * 1e3
