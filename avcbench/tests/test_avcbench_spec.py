"""BENCHMARK.json and the files it names: every name, unit and bound is
legal, every configuration, traffic mix and metric has its file, and the
frozen streams are the ones their configurations state."""
import json
import math
import re

import pytest

from conftest import ROOT

from avcbench.streams import Pool, sha256

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(SPEC) == KEYS
    assert SPEC["command"][:2] == ["python3", "-m"]
    assert len(SPEC["command"]) <= 32 and all(map(line, SPEC["command"]))
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_24_cells():
    cells = 24
    total = (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 180 \
        + 1200
    assert total <= 43200


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["name"] in used
        assert line(c["source"]) and c["source"].startswith("https://")
        assert line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg)
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_pool_is_frozen(conf):
    folder = (ROOT / conf["file"]).parent
    cfg = json.loads((ROOT / conf["file"]).read_text())
    golden = json.loads((folder / "golden.json").read_text())
    work = json.loads((folder / "work.json").read_text())
    for p in cfg["pool"]:
        data = (folder / p["file"]).read_bytes()
        assert sha256(data) == p["sha256"]
        pool = Pool.parse(data)
        assert len(pool.pictures) == p["pictures"] == len(golden[p["file"]])
        assert pool.sps.width_mbs * 16 >= cfg["width"]
        assert pool.sps.height_mbs * 16 >= cfg["height"]
        assert len(work[p["file"]]["b2"]) == p["pictures"]
        assert cfg["x264_options"] in data.decode("latin-1")


def test_workloads():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        mix = json.loads((ROOT / "avcbench" / "traffic" /
                          f"{w['traffic']}.json").read_text())
        assert mix["loop"] == "closed" and mix["clients"] == 1


def metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_metric_names_units_readers():
    names = [m["name"] for m in metrics()]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in metrics():
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "avcbench" / "metrics" / f"{m['name']}.py").exists()


def test_end_to_end():
    assert 1 <= len(SPEC["end_to_end"]) <= 16
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer():
    assert 1 <= len(SPEC["per_layer"]) <= 128
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_enough(cell):
    def of(group):
        return [m["name"] for m in SPEC[group]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    e2e = of("end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert of("per_layer")


def test_bounds_are_numbers():
    for m in SPEC["end_to_end"]:
        assert math.isfinite(m["bound"])
