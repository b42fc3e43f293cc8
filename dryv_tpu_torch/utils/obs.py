# Copy of dryv_tpu/utils/obs.py; trace_device traces with torch.profiler.
"""Observability: per-layer tagged logging, stage timers, device profiling.

The reference's only instrumentation is a colored `log!` macro with
per-layer tags (`#[moov]`, `#[stbl]` — src/ascii.rs:100) plus a wall-clock
print and an unreported CABAC bin counter (SURVEY.md §5).  Here:
- `logger(tag)` — stdlib logging with the same per-layer-tag convention
- `StageTimers` — demux / entropy / pack / device-recon timers with
  bins/s, MB/s, frames/s counters
- `trace_device()` — context manager around a `torch.profiler` trace of
  the host and the CUDA device, written as a Chrome trace
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict


def logger(tag: str) -> logging.Logger:
    return logging.getLogger(f"dryv_tpu_torch.{tag}")


class StageTimers:
    """Accumulates wall time + work counters per pipeline stage."""

    def __init__(self):
        self.t = defaultdict(float)
        self.n = defaultdict(int)
        self.counters = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.t[name] += time.perf_counter() - t0
            self.n[name] += 1

    def count(self, name: str, v: int) -> None:
        self.counters[name] += v

    def report(self) -> dict:
        out = {}
        for k in self.t:
            out[k] = {"total_s": round(self.t[k], 4), "calls": self.n[k]}
        if "entropy" in self.t and self.counters.get("bins"):
            out["bins_per_s"] = int(self.counters["bins"] / self.t["entropy"])
        if "recon" in self.t and self.counters.get("mbs"):
            out["mbs_per_s"] = int(self.counters["mbs"] / self.t["recon"])
        if self.counters.get("frames") and sum(self.t.values()) > 0:
            out["frames_per_s"] = round(
                self.counters["frames"] / sum(self.t.values()), 2)
        return out


@contextlib.contextmanager
def trace_device(logdir: str = "temp/dryv_tpu_torch_trace"):
    """torch.profiler trace (host ops and, where CUDA is present, device
    kernels) around a decode region; yields the profiler, and on exit
    writes ``trace.json`` (Chrome trace format) into `logdir`."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
