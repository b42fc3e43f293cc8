# Copy of dryv_tpu/utils/obs.py; trace_device traces with torch.profiler.
"""Observability: per-layer tagged logging, stage timers, device profiling.

The reference's only instrumentation is a colored `log!` macro with
per-layer tags (`#[moov]`, `#[stbl]` — src/ascii.rs:100) plus a wall-clock
print and an unreported CABAC bin counter (SURVEY.md §5).  Here:
- `logger(tag)` — stdlib logging with the same per-layer-tag convention
- `StageTimers` — what the decode entries' ``timers=`` argument takes:
  seconds and calls per host stage (``STAGES``) and work counters
  (``COUNTERS``); while a ``torch.profiler`` records, each stage is also
  a range ``dryv.<stage>`` on the profiler's timeline
- `staged()` — a context manager entered and left inside a stage
- `trace_device()` — context manager around a `torch.profiler` trace of
  the host and the CUDA device, written as a Chrome trace (the CLI's
  ``--trace DIR``)
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

# the host stages of the decode entries (``device_ipb_packed`` and
# ``gop_pipeline``), each call's host lines cut into them with no stage
# inside another, so a call's wall time minus their sum is the time no
# stage names:
#   split     NAL split, parameter sets, access units (I/P/B; the batched
#             entry does these inside parse)
#   parse     slice headers, POC and reference lists
#   entropy   the C++ CABAC entropy decode (batched: fused with the pack)
#   cavlc     the C++ CAVLC entropy decode of a picture (I/P/B), in place
#             of entropy
#   redecode  a picture decoded again after a staging cap growth
#   motion    motion derivation and weighted-prediction tables
#   prep      a batched picture's deblock controls
#   pack      the wire blob (I/P/B), a PCM batch's host rows (batched)
#   pad       a batch's tail padded with its last picture
#   alloc     the call's device planes, its staging taken from and given
#             back to the keep (``wire.take``, a new one's pinned blobs),
#             and the blobs of a cap growth
#   wait      the host blocked on a card event: slot reuse, a growth's
#             drain, the call's last drain
#   hold      entering and leaving ``StepCache.hold``
#   ship      enqueueing the host-to-card copies
#   dispatch  enqueueing the step (a graph replay) and its planes' copies
#   harvest   the planes handed back (host frames: the card-to-host copy)
#   dpb       reference marking, stored motion fields, display order
#   fallback  a stream that left the path, on the decoder it went to
STAGES = ("split", "parse", "entropy", "cavlc", "redecode", "motion", "prep",
          "pack", "pad", "alloc", "wait", "hold", "ship", "dispatch",
          "harvest", "dpb", "fallback")
# frames: pictures decoded; bins: CABAC bins of their slices (the native
# entropy's bin_count); cavlc_bits: the slice-data bits of CAVLC slices
# handed to the native decode, from the end of each slice header to the
# end of its RBSP; wire_bytes: bytes of each host blob shipped to
# the card (a batch's whole blob, padded tail included); retries:
# pictures whose entropy or pack ran again after a staging cap growth;
# par_pictures: pictures first decoded by a batched native call in which
# more than one task ran at once; entropy_task_us: the summed wall time
# of the batched native calls' tasks (re-decodes too), in microseconds;
# epb_bytes: the emulation-prevention bytes (00 00 03 -> 00 00) removed
# from the slice NALs' payloads as their RBSPs were made; staging_kept:
# calls whose staging came from the keep (``wire.take``): an earlier
# call's of the same key, at the caps it grew to
COUNTERS = ("frames", "bins", "cavlc_bits", "wire_bytes", "retries",
            "par_pictures", "entropy_task_us", "epb_bytes", "staging_kept")
RANGE = "dryv."


def logger(tag: str) -> logging.Logger:
    return logging.getLogger(f"dryv_tpu_torch.{tag}")


def enable_debug_log(path: str = "debug.log") -> None:
    """File log of every parse stage (the reference's debug.log)."""
    root = logging.getLogger("dryv_tpu_torch")
    root.setLevel(logging.DEBUG)
    fh = logging.FileHandler(path, mode="w")
    fh.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
    root.addHandler(fh)


class StageTimers:
    """Seconds and calls per stage, and work counters, of the decodes it
    is handed to.  ``stage(name)`` times its body on ``perf_counter``;
    while a ``torch.profiler`` records, the body is also the range
    ``dryv.<name>``, on the clock of the profiler's device activity.
    ``count(name, v)`` adds an integer."""

    def __init__(self):
        self.t = defaultdict(float)
        self.n = defaultdict(int)
        self.counters = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        import torch

        with (torch.profiler.record_function(RANGE + name)
              if torch.autograd._profiler_enabled()
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.t[name] += time.perf_counter() - t0
                self.n[name] += 1

    def count(self, name: str, v: int) -> None:
        self.counters[name] += v

    def report(self) -> dict:
        """Each stage's seconds and calls, the counters, bins_per_s (bins
        over the entropy stage's seconds) and cavlc_bits_per_s
        (cavlc_bits over the cavlc stage's seconds) where both were
        taken, and
        entropy_parallelism (the native tasks' summed time over the
        entropy and redecode stages' wall time: the threads that worked
        at once, on average) where the tasks were timed."""
        out = {"stages": {k: {"total_s": round(v, 4), "calls": self.n[k]}
                          for k, v in self.t.items()},
               "counters": dict(self.counters)}
        if self.t.get("entropy") and self.counters.get("bins"):
            out["bins_per_s"] = int(self.counters["bins"] / self.t["entropy"])
        if self.t.get("cavlc") and self.counters.get("cavlc_bits"):
            out["cavlc_bits_per_s"] = int(self.counters["cavlc_bits"]
                                          / self.t["cavlc"])
        wall = self.t.get("entropy", 0.0) + self.t.get("redecode", 0.0)
        if wall and self.counters.get("entropy_task_us"):
            out["entropy_parallelism"] = round(
                self.counters["entropy_task_us"] / (wall * 1e6), 3)
        return out


@contextlib.contextmanager
def staged(timers, name: str, make):
    """The context manager ``make()`` made, entered and left inside stage
    `name` of `timers`, and the body of the ``with`` outside it, so that
    the stages the body opens do not nest in `name`."""
    with timers.stage(name):
        cm = make()
        value = cm.__enter__()
    try:
        yield value
    except BaseException as e:
        with timers.stage(name):
            if not cm.__exit__(type(e), e, e.__traceback__):
                raise
    else:
        with timers.stage(name):
            cm.__exit__(None, None, None)


@contextlib.contextmanager
def trace_device(logdir: str = "temp/dryv_tpu_torch_trace"):
    """torch.profiler trace (host ops and, where CUDA is present, device
    kernels) around a decode region; yields the profiler, and on exit
    writes ``trace.json`` (Chrome trace format) into `logdir`.  The
    decode's ``dryv.<stage>`` ranges land in it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
