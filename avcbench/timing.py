"""Host clocks of a run: the stage timers handed to the program, the
process's start, percentiles and the host's description."""
from __future__ import annotations

import contextlib
import os
import platform
import time
from collections import defaultdict


class SpanTimers:
    """What the program's ``timers=`` argument takes (``stage`` and
    ``count``): seconds and calls per stage of one request.  When
    `profiled`, each stage is also a ``torch.profiler`` range
    ``avcbench.stage.<name>``, so that the trace can say which stage the
    host was in while the card idled."""

    def __init__(self, profiled: bool = False):
        self.t = defaultdict(float)
        self.n = defaultdict(int)
        self.counters = defaultdict(int)
        self.profiled = profiled

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.profiled:
            from torch.profiler import record_function
            rf = record_function("avcbench.stage." + name)
        else:
            rf = contextlib.nullcontext()
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.t[name] += time.perf_counter() - t0
                self.n[name] += 1

    def count(self, name: str, v: int) -> None:
        self.counters[name] += v


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), in the
    kernel's clock ticks."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of `values`, linear between the two
    nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def host_line() -> str:
    """The host's CPU model, its cores and the cores this process may
    use."""
    model = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() in ("model name", "Model", "CPU part"):
                    model += f", {value.strip()}"
                    break
    except OSError:
        pass
    return (f"host: {model}, {os.cpu_count()} cores, "
            f"{len(os.sched_getaffinity(0))} usable")
