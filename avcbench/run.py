"""One run of one cell of the benchmark of ``dryv_tpu_torch``.

    python3 -m avcbench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, which holds ``BENCHMARK.json``.  The cell
names a configuration (``avcbench/configs/<name>/config.json``: its pool
of frozen streams with their SHA-256, ``golden.json``, ``work.json``) and
a traffic mix (``avcbench/traffic/<name>.json``, read by
``traffic.Traffic``; its ``n_threads`` goes to the entry, and its
``torch_threads``, where given, sizes torch's host thread pool as a data
loader's worker does); each metric of ``BENCHMARK.json`` is read by
``avcbench/metrics/<name>.py``.  A new cell, configuration, mix or metric
is new files and new entries there, never an edit of this file.

Set-up checks the streams' hashes, deals the run's requests from the seed,
and sends each distinct request once, which builds the program's kernels
(into ``dryv_tpu_torch/build/``) and captures every graph the traffic
uses.  The window then sends requests from one client in a closed loop
for ``--seconds`` and ends when the last one has finished; a request is
timed from its call to the synchronise after its last plane.  The outputs
of the requests the seed samples, and of the last one, are copied to the
host after their timing and compared with the golden digests once the
window has closed.  ``--trace 1`` runs the same window under
``torch.profiler`` and reports the per-layer metrics instead of the
end-to-end ones.

The run prints its readings on standard error, each number compared with
its limit last, and one JSON line on standard output.  Without CUDA, or
with fewer cards than the cell asks for, it exits with 3 and prints no
result; with JAX or the JAX package loaded once the window has closed,
with 4.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

from . import check
from .entries import ENTRIES
from .peaks import PEAKS
from .timing import SpanTimers, host_line, process_age_s
from .trace import REQUEST, WINDOW_END, WINDOW_START, from_profiler, summarize
from .traffic import Traffic

# top-level module names that may not be loaded in a run (compared whole:
# the program's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "dryv_tpu")


@dataclass
class Run:
    """What a run measured, as the metric readers take it."""
    setup_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0
    attempted: int = 0
    failed: int = 0
    latencies_s: list = field(default_factory=list)
    cpu_s: float = 0.0
    stage_s: dict = field(default_factory=dict)
    untimed_s: float = 0.0
    mem_peak_bytes: int | None = None
    pool_mib: dict | None = None     # card -> MiB
    trace: object = None
    launches: dict = field(default_factory=dict)  # kernel -> [(B, ops)]
    peak: dict | None = None
    device_kind: str = "cpu"


class Record(NamedTuple):
    """One request of the window."""
    i: int
    wall: float         # call to the synchronise after its last plane
    failed: bool
    stages: dict        # StageTimers seconds
    frames: int


def log(msg: str) -> None:
    print(f"avcbench: {msg}", file=sys.stderr, flush=True)


def load_cell(root: Path, workload: str):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"avcbench: no workload {workload!r} in "
                         f"BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg_path = root / conf["file"]
    cfg = json.loads(cfg_path.read_text())
    mix = json.loads((root / "avcbench" / "traffic" /
                      f"{cell['traffic']}.json").read_text())
    return spec, cell, cfg_path.parent, cfg, mix


def metrics_of(spec: dict, cell: dict, trace: bool) -> list:
    """The cell's metrics for this kind of run: its end-to-end ones with
    --trace 0, its per-layer ones with --trace 1."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def read_metric(root: Path, name: str, run: Run):
    """The value `avcbench/metrics/<name>.py`'s ``read`` gives, or None."""
    path = root / "avcbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"avcbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def measure(folder: Path, cfg: dict, mix: dict, seed: int, seconds: float,
            trace: bool, device: str = "cuda", entry=None):
    """Set up, run the window and check its outputs; returns the Run and
    the numbers compared.  `entry` replaces the program's entry (the
    tests drive faults through it)."""
    import torch

    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run = Run()
    traffic = Traffic(mix, folder, cfg, seed)
    if (mix["loop"], mix["clients"]) != ("closed", 1):
        raise ValueError("only a closed loop of one client runs: the "
                         "program's entries share host buffers between "
                         "calls")
    if "torch_threads" in mix:      # torch's own host thread pool
        torch.set_num_threads(mix["torch_threads"])
    entry = entry or ENTRIES[mix["entry"]](mix, cfg, device)
    for req in traffic.distinct:
        entry.call(req.stream, SpanTimers())
        sync()
    if entry.fallbacks():
        raise RuntimeError("a request left the path the mix names")
    made = entry.steps.made
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()

    records, kept = [], []
    setup_s = process_age_s()
    cpu0 = time.process_time()
    t0 = end = time.perf_counter()
    cpu_end = cpu0
    if trace:
        with torch.profiler.record_function(WINDOW_START):
            pass
    i, done = 0, False
    while not done:
        req = traffic.distinct[traffic.index(i)]
        tm = SpanTimers(profiled=trace)
        ts = time.perf_counter()
        try:
            with (torch.profiler.record_function(REQUEST) if trace
                  else contextlib.nullcontext()):
                out = entry.call(req.stream, tm)
                sync()
        except Exception as e:   # a request that fails is counted
            log(f"request {i} failed: {type(e).__name__}: {e}")
            out = None
        end = time.perf_counter()
        cpu_end = time.process_time()
        done = end - t0 >= seconds
        if done and trace:
            with torch.profiler.record_function(WINDOW_END):
                pass
        records.append(Record(i, end - ts, out is None, dict(tm.t),
                              0 if out is None else len(out)))
        if out is not None and (done or traffic.sampled(i)):
            kept.append((i, [tuple(p.cpu().numpy() for p in pic)
                             for pic in out]))
        del out
        i += 1
    if trace:
        prof.__exit__(None, None, None)

    run.setup_s = setup_s
    run.window_s = end - t0
    run.cpu_s = cpu_end - cpu0
    if cuda:
        run.mem_peak_bytes = torch.cuda.max_memory_reserved()
        run.device_kind = torch.cuda.get_device_name()
        run.peak = PEAKS.get(run.device_kind)
    run.attempted = len(records)
    ok = [r for r in records if not r.failed]
    run.failed = run.attempted - len(ok)
    run.frames = sum(r.frames for r in ok)
    run.latencies_s = [r.wall for r in ok]
    for r in ok:
        for k, v in r.stages.items():
            run.stage_s[k] = run.stage_s.get(k, 0.0) + v
        run.untimed_s += r.wall - sum(r.stages.values())
        for k, v in traffic.distinct[traffic.index(r.i)].work.items():
            run.launches.setdefault(k, []).extend(v)
    if trace:
        run.pool_mib = entry.steps.pool_mib()
        run.trace = summarize(from_profiler(prof))
        del prof
    captures = entry.steps.made - made
    fallbacks = entry.fallbacks()
    log(f"window {run.window_s:.3f} s: {run.attempted} requests, "
        f"{run.failed} failed, {run.frames} pictures; graphs captured in "
        f"the window {captures}, requests off the path {fallbacks}")
    if captures or fallbacks:
        raise RuntimeError("the window captured graphs or left the path")

    wrong = compared = 0
    for i, pics in kept:
        want = traffic.distinct[traffic.index(i)].golden
        wrong += check.pictures_wrong(pics, want)
        compared += len(want)
    log(f"compared {compared} pictures of {len(kept)} requests with the "
        f"golden digests")
    kept.clear()
    numbers = {"pictures_wrong": wrong, "requests_failed": run.failed}
    return run, numbers


def report(root: Path, spec: dict, cell: dict, run: Run, numbers: dict,
           trace: bool) -> dict:
    """The result line of a run: its metrics as their readers give them,
    the device, the trace's breakdown, and the numbers compared last."""
    if run.latencies_s:
        lat = sorted(run.latencies_s)
        log(f"request latency ms: {len(lat)} requests, min "
            f"{lat[0] * 1e3:.3f}, median {lat[len(lat) // 2] * 1e3:.3f}, "
            f"max {lat[-1] * 1e3:.3f}; host CPU {run.cpu_s:.3f} s; stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in run.stage_s.items()))
    metrics = {}
    for m in metrics_of(spec, cell, trace):
        v = read_metric(root, m["name"], run)
        if v is None:
            log(f"{m['name']}: nothing to read in this run")
        else:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.device_kind,
              "count": cell["chips"], "memory_peak_bytes":
              run.mem_peak_bytes}
    result = {"correct": check.verdict(numbers), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = {k: {"value": numbers[k], "limit": lim}
                       for k, lim in check.LIMITS.items()}
    return result


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return f"card: {out}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m avcbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    spec, cell, folder, cfg, mix = load_cell(root, args.workload)

    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s), this "
            f"machine has {n}: no result")
        return 3
    log(host_line())
    log(card_line())
    run, numbers = measure(folder, cfg, mix, args.seed, args.seconds,
                           bool(args.trace))
    result = report(root, spec, cell, run, numbers, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        log(f"modules loaded that a run may not load: {', '.join(bad)}: "
            f"no result")
        return 4
    for line in check.lines(numbers):
        log(line)
    print(json.dumps(result), flush=True)
    return 0
