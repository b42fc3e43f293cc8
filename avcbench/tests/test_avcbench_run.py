"""Whole runs on the CPU with the program's plain kernels, at a size a
test can hold: two cells made from files alone (small configurations in
``tests/configs``, traffic mixes and one extra metric reader written into
a scratch checkout, entries in its BENCHMARK.json), each driven through
``run.measure`` and ``run.report`` as a run on the card is.  The faults
and the control are planted under the timed path and must turn
``correct`` false; the command without a card exits 3 and prints
nothing."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

from avcbench.control import lower_precision
from avcbench.entries import ENTRIES, Entry
from avcbench.run import load_cell, measure, report
from avcbench.traffic import Traffic

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
RENAME = {"ipb.gop10": "tiny.gop", "intra.stream128": "tiny.stream"}
MIXES = {
    "tiny_gop": {"entry": "ipb_packed", "request": "gop", "pictures": 10,
                 "loop": "closed", "clients": 1, "output": "device",
                 "n_threads": 2, "batch": 1, "check_every": 1},
    "tiny_stream": {"entry": "intra_batched", "request": "idr_stream",
                    "pictures": 32, "loop": "closed", "clients": 1,
                    "output": "device", "n_threads": 2, "batch": 16,
                    "distinct": 3, "check_every": 1},
}
# a per-layer metric a later change could add as one file
SHIP = '''"""ship_ms_per_frame: the ship stage per picture."""


def read(run):
    return run.stage_s.get("ship", 0.0) * 1e3 / run.frames
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout holding the harness, two small configurations, two
    traffic mixes and a new metric, added as files and entries."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "avcbench", r / "avcbench", ignore=
                    shutil.ignore_patterns("__pycache__", "*.264", "tests"))
    for name in ("tiny-ipb", "tiny-intra"):
        shutil.copytree(ROOT / "avcbench" / "tests" / "configs" / name,
                        r / "avcbench" / "configs" / name)
    for name, mix in MIXES.items():
        (r / "avcbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    (r / "avcbench" / "metrics" / "ship_ms_per_frame.py").write_text(SHIP)
    (r / "dryv_tpu_torch").symlink_to(ROOT / "dryv_tpu_torch")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"] = [
        {"name": n, "source": "https://example.org", "reduced": [],
         "file": f"avcbench/configs/{n}/config.json", "why": n}
        for n in ("tiny-ipb", "tiny-intra")]
    spec["workloads"] = [
        {"name": "tiny.gop", "config": "tiny-ipb", "traffic": "tiny_gop",
         "chips": 1, "why": "test"},
        {"name": "tiny.stream", "config": "tiny-intra",
         "traffic": "tiny_stream", "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [RENAME[w] for w in m["workloads"]]
    spec["per_layer"].append(
        {"name": "ship_ms_per_frame", "unit": "ms/frame", "better": "lower",
         "source": "program_span", "layer": "entry loops",
         "moves": "frames_per_s"})
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    return r


def test_mix_sizes_torch_threads(root):
    """A mix's torch_threads sizes torch's host thread pool for the run,
    and its n_threads goes to the entry."""
    import torch

    _, _, folder, cfg, mix = load_cell(root, "tiny.gop")
    mix = dict(mix, n_threads=1, torch_threads=1)
    entry = ENTRIES[mix["entry"]](mix, cfg, "cpu")
    seen = []

    def call(stream, timers):
        seen.append(torch.get_num_threads())
        return entry.call(stream, timers)

    before = torch.get_num_threads()
    try:
        run, numbers = measure(folder, cfg, mix, 2 ** 31 + 7, 0.1, False,
                               "cpu", Entry(call, entry.steps,
                                            entry.fallbacks))
    finally:
        torch.set_num_threads(before)
    assert seen and set(seen) == {1}
    assert numbers == {"pictures_wrong": 0, "requests_failed": 0}


def seed_after_set_up(root, workload):
    """A seed whose first request in the window is not the request the
    set-up sent last, so that a stale answer cannot be right."""
    _, _, folder, cfg, mix = load_cell(root, workload)
    return next(s for s in range(31, 200)
                if Traffic(mix, folder, cfg, s).index(0) == 0)


def drive(root, workload, seed, seconds, trace=False, wrap=None):
    spec, cell, folder, cfg, mix = load_cell(root, workload)
    entry = ENTRIES[mix["entry"]](mix, cfg, "cpu")
    if wrap is not None:
        entry = wrap(entry)
    run, numbers = measure(folder, cfg, mix, seed, seconds, trace, "cpu",
                           entry)
    return report(root, spec, cell, run, numbers, trace)


@pytest.mark.parametrize("workload,trace", [
    ("tiny.gop", False), ("tiny.gop", True), ("tiny.stream", False),
    ("tiny.stream", True)])
def test_cell_from_files_runs_correct(root, workload, trace):
    res = drive(root, workload, 2 ** 31 + 99, 0.1, trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "check"
    assert res["check"] == {"pictures_wrong": {"value": 0, "limit": 0},
                            "requests_failed": {"value": 0, "limit": 0}}
    m = res["metrics"]
    if not trace:
        want = {"frames_per_s", "host_cpu_ms_per_frame", "setup_s"}
        if workload == "tiny.gop":
            want.add("clip_latency_p90_ms")
        assert set(m) == want           # no device memory on the CPU
        assert all(v["value"] > 0 for v in m.values())
    else:
        assert {"parse_ms_per_frame", "entropy_ms_per_frame",
                "untimed_ms_per_frame", "dispatch_ms_per_frame",
                "ship_ms_per_frame"} <= set(m)
        assert ("motion_ms_per_frame" in m) == (workload == "tiny.gop")
        for absent in ("device_idle_pct", "b2_roofline",
                       "graph_pool_mib"):
            assert absent not in m      # nothing to read on the CPU
        b = res["breakdown"]
        assert b["device_ops"] == [] and b["idle_gaps"]
    json.dumps(res)


def stale_request(entry):
    """A step that returns its state unchanged: each call hands back the
    planes of the call before it."""
    last = []

    def call(stream, timers):
        out = entry.call(stream, timers)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return Entry(call, entry.steps, entry.fallbacks)


def stale_by_two(entry):
    """Each call hands back the planes of the call two before it, as a
    double buffer reused too early would."""
    last = []

    def call(stream, timers):
        out = entry.call(stream, timers)
        last.append(out)
        return last.pop(0) if len(last) > 2 else out
    return Entry(call, entry.steps, entry.fallbacks)


def stale_picture(entry):
    """Each picture after the first gets the planes of the one before."""
    def call(stream, timers):
        out = entry.call(stream, timers)
        return out[:1] + out[:-1]
    return Entry(call, entry.steps, entry.fallbacks)


def half_batch(entry):
    """Half of each batch of 16 left out."""
    def call(stream, timers):
        out = entry.call(stream, timers)
        return [p for i, p in enumerate(out) if i % 16 < 8]
    return Entry(call, entry.steps, entry.fallbacks)


def altered(entry):
    """One sample of one picture changed where it is produced."""
    def call(stream, timers):
        out = entry.call(stream, timers)
        y, cb, cr = out[0]
        y = y.clone()
        y[3, 5] ^= 1
        return [(y, cb, cr)] + out[1:]
    return Entry(call, entry.steps, entry.fallbacks)


def fails_after_set_up(entry):
    """Every call after the set-up's three raises."""
    calls = []

    def call(stream, timers):
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("planted")
        return entry.call(stream, timers)
    return Entry(call, entry.steps, entry.fallbacks)


@pytest.mark.parametrize("workload,fault", [
    ("tiny.stream", stale_request), ("tiny.stream", stale_by_two),
    ("tiny.stream", stale_picture),
    ("tiny.stream", half_batch), ("tiny.stream", altered),
    ("tiny.stream", lower_precision), ("tiny.gop", stale_request),
    ("tiny.gop", stale_by_two), ("tiny.gop", altered),
    ("tiny.gop", lower_precision),
], ids=lambda x: getattr(x, "__name__", str(x)))
def test_fault_turns_correct_false(root, workload, fault):
    res = drive(root, workload, seed_after_set_up(root, workload), 0.1,
                wrap=fault)
    assert res["correct"] is False
    assert res["check"]["pictures_wrong"]["value"] > 0


def test_failed_requests_turn_correct_false(root):
    res = drive(root, "tiny.stream", 5, 0.5, wrap=fails_after_set_up)
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert res["check"]["requests_failed"]["value"] >= 1


def test_no_card_no_result(tmp_path):
    """Without a card the command exits 3 and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "avcbench", "--workload",
                        "ipb.gop10", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 3 and r.stdout == ""
    assert "no result" in r.stderr


def test_one_client_only(root):
    """The program's entries share host buffers between calls (the native
    entropy's arena), so a mix of more than one client is refused."""
    _, _, folder, cfg, mix = load_cell(root, "tiny.stream")
    with pytest.raises(ValueError, match="one client"):
        measure(folder, cfg, dict(mix, clients=2), 17, 1.0, False, "cpu")
