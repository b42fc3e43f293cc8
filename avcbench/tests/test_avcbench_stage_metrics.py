"""The per-layer readers of the program's ``pack`` and ``wait`` stages:
on synthetic runs, as the harness loads them, and in traced runs of the
two small cells on the CPU (the scratch checkout of
``test_avcbench_run``), where the program's stages are what they read."""
import json

import pytest

from conftest import ROOT

from avcbench.run import Run, read_metric
from test_avcbench_run import drive, root  # noqa: F401  (a fixture)

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"pack_ms_per_frame": "pack", "wait_ms_per_frame": "wait"}


@pytest.mark.parametrize("name,stage", sorted(NEW.items()))
def test_reads_its_stage_per_picture(name, stage):
    run = Run(frames=40, stage_s={stage: 0.5, "entropy": 2.0},
              untimed_s=0.1)
    assert read_metric(ROOT, name, run) == pytest.approx(12.5)


@pytest.mark.parametrize("name", sorted(NEW))
@pytest.mark.parametrize("run", [
    Run(frames=40, stage_s={"entropy": 2.0}),      # a path without it
    Run(frames=0, stage_s={"pack": 1.0, "wait": 1.0}),
], ids=["no_stage", "no_frames"])
def test_nothing_to_read(name, run):
    assert read_metric(ROOT, name, run) is None


def test_entries():
    per = {m["name"]: m for m in SPEC["per_layer"]}
    assert per["pack_ms_per_frame"]["workloads"] == ["ipb.gop10"]
    assert per["wait_ms_per_frame"]["workloads"] == ["ipb.gop10",
                                                     "intra.stream128"]
    for name in NEW:
        m = per[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms/frame", "lower", "program_span", "frames_per_s")
    # appended after the metrics the benchmark had
    assert [m["name"] for m in SPEC["per_layer"][-2:]] == sorted(NEW)


@pytest.mark.parametrize("workload,want", [
    ("tiny.gop", {"pack_ms_per_frame", "wait_ms_per_frame"}),
    ("tiny.stream", {"wait_ms_per_frame"}),
])
def test_traced_cell_reads_them(root, workload, want):  # noqa: F811
    res = drive(root, workload, 2 ** 31 + 5, 0.1, trace=True)
    assert res["correct"] is True
    m = res["metrics"]
    assert want <= set(m) and all(m[k]["value"] >= 0 for k in want)
    assert ("pack_ms_per_frame" in m) == (workload == "tiny.gop")
