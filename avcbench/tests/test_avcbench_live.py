"""The cells ``baseline.live16`` and ``intra.clip16`` as whole runs on
the CPU with the program's plain kernels, at a size a test can hold: the
cells' own traffic mixes with their pictures cut to the small
configurations' (``tests/configs/tiny-live``, the live recipe at 320x192,
and ``tests/configs/tiny-intra``), driven through ``run.measure`` and
``run.report`` as a run on the card is.  A fault planted in the CAVLC
path, and the control, turn ``correct`` false; a program that hands
CAVLC streams to its host decoder fails at set-up; the reader
``cavlc_ms_per_frame`` reads the ``cavlc`` stage and nothing else."""
import importlib.util
import json
import shutil

import pytest

from conftest import ROOT

from avcbench.control import lower_precision
from avcbench.entries import ENTRIES, Entry
from avcbench.run import Run, load_cell, measure, report
from avcbench.traffic import Traffic

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {"baseline.live16": ("tiny.live", "tiny-live", "live16", 8),
         "intra.clip16": ("tiny.clip", "tiny-intra", "clip16", 16)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout holding the harness, the two small configurations and
    the two cells' mixes, their pictures cut to the configurations'."""
    r = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "avcbench", r / "avcbench", ignore=
                    shutil.ignore_patterns("__pycache__", "*.264", "tests"))
    (r / "dryv_tpu_torch").symlink_to(ROOT / "dryv_tpu_torch")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"], spec["workloads"] = [], []
    for cell, (name, conf, traffic, pictures) in CELLS.items():
        shutil.copytree(ROOT / "avcbench" / "tests" / "configs" / conf,
                        r / "avcbench" / "configs" / conf)
        mix = json.loads((ROOT / "avcbench" / "traffic" /
                          f"{traffic}.json").read_text())
        mix.update(pictures=pictures, check_every=1)
        (r / "avcbench" / "traffic" / f"tiny_{traffic}.json").write_text(
            json.dumps(mix))
        spec["configs"].append(
            {"name": conf, "source": "https://example.org", "reduced": [],
             "file": f"avcbench/configs/{conf}/config.json", "why": conf})
        spec["workloads"].append(
            {"name": name, "config": conf, "traffic": f"tiny_{traffic}",
             "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELLS[w][0] for w in m["workloads"]
                              if w in CELLS]
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    return r


def drive(root, workload, seed, seconds, trace=False, wrap=None):
    spec, cell, folder, cfg, mix = load_cell(root, workload)
    entry = ENTRIES[mix["entry"]](mix, cfg, "cpu")
    if wrap is not None:
        entry = wrap(entry)
    run, numbers = measure(folder, cfg, mix, seed, seconds, trace, "cpu",
                           entry)
    return report(root, spec, cell, run, numbers, trace)


def seed_after_set_up(root, workload):
    """A seed whose first request in the window is not the request the
    set-up sent last."""
    _, _, folder, cfg, mix = load_cell(root, workload)
    return next(s for s in range(31, 200)
                if Traffic(mix, folder, cfg, s).index(0) == 0)


@pytest.mark.parametrize("workload,trace", [
    ("tiny.live", False), ("tiny.live", True), ("tiny.clip", False),
    ("tiny.clip", True)])
def test_cell_runs_correct(root, workload, trace):
    res = drive(root, workload, 2 ** 31 + 123, 0.1, trace)
    assert res["correct"] is True and res["failed"] == 0
    assert res["check"] == {"pictures_wrong": {"value": 0, "limit": 0},
                            "requests_failed": {"value": 0, "limit": 0}}
    m = res["metrics"]
    if not trace:
        assert set(m) == {"frames_per_s", "host_cpu_ms_per_frame",
                          "setup_s"}         # no device memory on the CPU
    elif workload == "tiny.live":
        assert set(m) == {"cavlc_ms_per_frame"}
        assert m["cavlc_ms_per_frame"]["value"] > 0
    else:
        assert set(m) == {"parse_ms_per_frame", "entropy_ms_per_frame"}
        assert all(m[k]["value"] > 0 for k in ("parse_ms_per_frame",
                                                "entropy_ms_per_frame"))
    json.dumps(res)


def cavlc_level(entry):
    """One luma level of every P picture's CAVLC decode one larger, as a
    fault in the native CAVLC path would leave it."""
    from dryv_tpu_torch.native import entropy

    decode = entropy.decode_picture_slices

    def faulty(slice_datas, sps, pps, *args, **kw):
        out = decode(slice_datas, sps, pps, *args, **kw)
        if not pps.entropy_coding_mode_flag and slice_datas[0][4] == 0:
            out["luma4"].reshape(-1)[0] += 1
        return out

    def call(stream, timers):
        entropy.decode_picture_slices = faulty
        try:
            return entry.call(stream, timers)
        finally:
            entropy.decode_picture_slices = decode
    return Entry(call, entry.steps, entry.fallbacks)


def stale_request(entry):
    """Each call hands back the planes of the call before it."""
    last = []

    def call(stream, timers):
        out = entry.call(stream, timers)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return Entry(call, entry.steps, entry.fallbacks)


@pytest.mark.parametrize("workload,fault", [
    ("tiny.live", cavlc_level), ("tiny.live", lower_precision),
    ("tiny.live", stale_request), ("tiny.clip", lower_precision),
    ("tiny.clip", stale_request),
], ids=lambda x: getattr(x, "__name__", str(x)))
def test_fault_turns_correct_false(root, workload, fault):
    res = drive(root, workload, seed_after_set_up(root, workload), 0.1,
                wrap=fault)
    assert res["correct"] is False
    assert res["check"]["pictures_wrong"]["value"] > 0


def test_a_program_that_hands_cavlc_to_the_host_fails_at_set_up(
        root, monkeypatch):
    """As a program before the CAVLC path did: the set-up's first
    request leaves the path, and the run stops before its window (the
    host decoder's frames are not the card planes the entry unpacks;
    were they, the set-up's count of requests off the path would stop
    it)."""
    from dryv_tpu_torch import device_ipb_packed

    # the entry counts requests off the path for the whole process: put
    # the count back afterwards, or later runs in this process fail
    decode = device_ipb_packed.decode_annexb_device_packed
    monkeypatch.setattr(decode, "host_calls", decode.host_calls)
    scope = device_ipb_packed._out_of_scope
    monkeypatch.setattr(
        device_ipb_packed, "_out_of_scope",
        lambda sps, pps, h: scope(sps, pps, h)
        or not pps.entropy_coding_mode_flag)
    before = decode.host_calls
    with pytest.raises((TypeError, RuntimeError)):
        drive(root, "tiny.live", 5, 0.1)
    assert decode.host_calls == before + 1


def test_cavlc_reader():
    spec = importlib.util.spec_from_file_location(
        "cavlc_ms_per_frame",
        ROOT / "avcbench" / "metrics" / "cavlc_ms_per_frame.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read(Run(frames=16, stage_s={"entropy": 1.0})) is None
    assert mod.read(Run(frames=0, stage_s={"cavlc": 1.0})) is None
    assert mod.read(Run(frames=16, stage_s={"cavlc": 0.048})) == \
        pytest.approx(3.0)
