"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer readers and the ``breakdown`` take: device busy time (the union
of every device activity), time and launches per device operation, and
the card's idle time by what the host was doing.

The window runs from the host marker ``avcbench.window.start`` to
``avcbench.window.end`` (the end of the last request); a request is
``avcbench.request``, and the program's stages, as the harness's timers
see them, are ``avcbench.stage.<name>``.  Idle time inside a request and
outside every stage is "untimed"; idle time between requests is the
harness's ("between requests").
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_START = "avcbench.window.start"
WINDOW_END = "avcbench.window.end"
REQUEST = "avcbench.request"
STAGE = "avcbench.stage."


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    op_s: dict = field(default_factory=dict)       # device op -> seconds
    launches: dict = field(default_factory=dict)   # device op -> count
    idle_s: dict = field(default_factory=dict)     # host activity -> s

    def kernel(self, fn: str):
        """(seconds, launches) of the device ops of the function `fn`
        (its name followed by its argument list, in any namespace)."""
        names = [k for k in self.op_s
                 if re.search(rf"(^|::){re.escape(fn)}[(<]", k)]
        return (sum(self.op_s[k] for k in names),
                sum(self.launches[k] for k in names))

    def breakdown(self) -> dict:
        top = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _overlap(spans, starts, a, b):
    """Nanoseconds of [a, b) that the sorted, disjoint `spans` cover."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    tot = 0
    while i < len(spans) and spans[i][0] < b:
        tot += max(0, min(b, spans[i][1]) - max(a, spans[i][0]))
        i += 1
    return tot


def summarize(events) -> TraceSummary:
    """`events`: (name, on_device, start_ns, end_ns) of every activity of
    the trace (``from_profiler`` makes them)."""
    starts = [s for n, dev, s, _ in events if not dev and n == WINDOW_START]
    ends = [s for n, dev, s, _ in events if not dev and n == WINDOW_END]
    if not starts or not ends:
        raise ValueError("the trace lacks the window's start or end")
    w0, w1 = min(starts), max(ends)
    op_s, launches, busy = defaultdict(float), defaultdict(int), []
    requests, stages = [], defaultdict(list)
    for n, dev, s, e in events:
        if dev:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                op_s[n] += (e - s) * 1e-9
                launches[n] += 1
                busy.append((s, e))
        elif n == REQUEST:
            requests.append((s, e))
        elif n.startswith(STAGE):
            stages[n[len(STAGE):]].append((s, e))
    busy = _merge(busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    merged = {k: _merge(v) for k, v in stages.items()}
    merged["in a request"] = _merge(requests)
    starts = {k: [s for s, _ in v] for k, v in merged.items()}
    idle = defaultdict(float)
    for a, b in gaps:
        left = b - a
        inside = _overlap(merged["in a request"],
                          starts["in a request"], a, b)
        for k, v in merged.items():
            if k != "in a request":
                ns = _overlap(v, starts[k], a, b)
                idle[k] += ns * 1e-9
                inside -= ns
                left -= ns
        idle["untimed"] += max(inside, 0) * 1e-9
        idle["between requests"] += max(left - max(inside, 0), 0) * 1e-9
    return TraceSummary((w1 - w0) * 1e-9,
                        sum(b - a for a, b in busy) * 1e-9,
                        dict(op_s), dict(launches),
                        {k: v for k, v in idle.items() if v > 0})


def from_profiler(prof) -> list:
    """(name, on_device, start_ns, end_ns) of every event of a finished
    ``torch.profiler.profile``.  A host range that the profiler mirrors
    on the device's timeline (a user annotation, named as its host range)
    is no device activity and is left out."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    host = {e.name() for e in evs if e.device_type() == DeviceType.CPU}
    out = []
    for e in evs:
        dev = e.device_type() != DeviceType.CPU
        if dev and (e.name() in host or getattr(
                e, "is_user_annotation", lambda: False)()):
            continue
        s = e.start_ns()
        out.append((e.name(), dev, s, s + e.duration_ns()))
    return out
