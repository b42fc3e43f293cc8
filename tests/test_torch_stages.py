"""The host stages and counters of the port's two decode entries
(``device_ipb_packed.decode_annexb_device_packed`` and
``gop_pipeline.decode_annexb_gop_pipelined`` with ``pack_batch``, and
the ``wire.Staging`` both use),
on the CPU with the benchmark's tiny streams (``avcbench/tests/configs``):
a recording timer that fails on a nested stage or a count outside every
stage, each call the entries make from their own frames checked to run
inside a stage, and the counters frames, bins, wire_bytes and retries
held to what the native entropy, the pack and the step's loads saw.
Also ``utils.obs.StageTimers``: its ``dryv.<stage>`` ranges under
``torch.profiler`` and none without one, and its report."""
import contextlib
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from dryv_tpu_torch import device_ipb_packed, gop_pipeline, graphs, wire
from dryv_tpu_torch.native import entropy
from dryv_tpu_torch.utils import obs

CONFIGS = Path(__file__).resolve().parent.parent / "avcbench" / "tests" \
    / "configs"
IPB = (CONFIGS / "tiny-ipb" / "gop_s1.264").read_bytes()
INTRA = (CONFIGS / "tiny-intra" / "idr16_s3.264").read_bytes()
LIVE = (CONFIGS / "tiny-live" / "live_slices4_s4.264").read_bytes()

# the functions whose own frames the stages must cover, and what they may
# call outside every stage: the stage context managers themselves, the
# helpers that open their own stages, and the loop's enumerate
ENTRY_CODES = {"decode_annexb_device_packed", "decode_annexb_gop_pipelined",
               "pack", "pack_batch", "grow", "wait"}
ENTRY_FILES = ("device_ipb_packed.py", "gop_pipeline.py", "wire.py")
MAY_CALL_OUTSIDE = {"helper", "__enter__", "__exit__", "staged",
                    "pack_batch", "grow", "wait", "to_host", "enumerate"}


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): the retries and redecode stages pinned here are
    a first call's, which a kept staging skips."""
    wire.release()
    yield
    wire.release()


class Recorder:
    """The ``timers=`` protocol, failing on a stage opened inside another
    and on a count made outside every stage."""

    def __init__(self):
        self.t = defaultdict(float)
        self.counters = defaultdict(int)
        self.open = None
        self.names = []

    @contextlib.contextmanager
    def stage(self, name):
        assert self.open is None, f"stage {name} inside {self.open}"
        self.open = name
        self.names.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.t[name] += time.perf_counter() - t0
            self.open = None

    def count(self, name, v):
        assert self.open is not None, f"count {name} outside every stage"
        self.counters[name] += v


def traced_decode(decode, monkeypatch):
    """Run decode(tm) with a Recorder; returns it, the calls made from
    the entries' own frames while no stage was open, the bytes each
    step load took, each native entropy call's (picture key, bins) and
    the picture each pack_frame call packed."""
    tm = Recorder()
    loads, decodes, packs = [], [], []
    load = graphs.Step.load

    def counted_load(self, *xs):
        loads.append(xs[0].numel() * xs[0].element_size())
        return load(self, *xs)

    # the keyed objects are held, so that no key is reused in a call
    held = []

    def recorded(fn, key):
        def wrapper(slice_datas, *args, **kw):
            res = fn(slice_datas, *args, **kw)
            out = res[0] if isinstance(res, tuple) else res
            held.append(slice_datas)
            decodes.append((key(slice_datas), int(out["bin_count"].sum())))
            return res
        return wrapper

    def recorded_batch(fn):
        def wrapper(pics, *args, **kw):
            res = fn(pics, *args, **kw)
            for (slice_datas, _), bins in zip(pics, res[0][:, 3]):
                held.append(slice_datas)
                decodes.append((id(slice_datas), int(bins)))
            return res
        return wrapper

    pack_frame = entropy.pack_frame

    def counted_pack(*args, **kw):
        packs.append(tm.counters["frames"])
        return pack_frame(*args, **kw)

    monkeypatch.setattr(graphs.Step, "load", counted_load)
    monkeypatch.setattr(entropy, "decode_picture_slices",
                        recorded(entropy.decode_picture_slices, id))
    monkeypatch.setattr(entropy, "decode_pack_picture_islices",
                        recorded(entropy.decode_pack_picture_islices, id))
    monkeypatch.setattr(entropy, "decode_pack_batch",
                        recorded_batch(entropy.decode_pack_batch))
    monkeypatch.setattr(entropy, "pack_frame", counted_pack)
    outside = []

    def profile(frame, event, arg):
        if event == "call":
            caller, callee = frame.f_back, frame.f_code.co_name
        elif event == "c_call":
            caller, callee = frame, getattr(arg, "__name__", str(arg))
        else:
            return
        if (caller is not None and tm.open is None
                and caller.f_code.co_name in ENTRY_CODES
                and caller.f_code.co_filename.endswith(ENTRY_FILES)):
            outside.append(callee)

    sys.setprofile(profile)
    try:
        out = decode(tm)
    finally:
        sys.setprofile(None)
    return tm, out, outside, loads, decodes, packs


@pytest.fixture(scope="module")
def ipb():
    wire.release()
    with pytest.MonkeyPatch.context() as mp:
        return traced_decode(
            lambda tm: device_ipb_packed.decode_annexb_device_packed(
                IPB, n_threads=1, device_out=True, device="cpu", timers=tm),
            mp)


@pytest.fixture(scope="module")
def live():
    """A CAVLC stream (IDR then P, 4 slices a picture) on the I/P/B
    path."""
    wire.release()
    with pytest.MonkeyPatch.context() as mp:
        return traced_decode(
            lambda tm: device_ipb_packed.decode_annexb_device_packed(
                LIVE, n_threads=1, device_out=True, device="cpu", timers=tm),
            mp)


@pytest.fixture(scope="module")
def intra():
    """Two calls on the stream of 16 IDR pictures twice over (two
    batches of 16), from an emptied keep: the first grows its staging,
    the second takes it back from the keep at the caps it grew to."""
    wire.release()
    runs = []
    for _ in range(2):
        with pytest.MonkeyPatch.context() as mp:
            runs.append(traced_decode(
                lambda tm: gop_pipeline.decode_annexb_gop_pipelined(
                    INTRA * 2, gop=16, n_threads=1, device="cpu",
                    stacked_out=True, timers=tm), mp))
    return runs


def test_stage_list_is_documented():
    """``utils.obs.STAGES`` is the list its comment documents, in order,
    and ``COUNTERS`` the nine counters, each named in their comment."""
    text = Path(obs.__file__).read_text()
    assert tuple(re.findall(r"^#   (\w+) ", text, re.M)) == obs.STAGES
    assert obs.COUNTERS == ("frames", "bins", "cavlc_bits", "wire_bytes",
                            "retries", "par_pictures", "entropy_task_us",
                            "epb_bytes", "staging_kept")
    for name in obs.COUNTERS:
        assert re.search(rf"[#;] {name}:", text), name


@pytest.mark.parametrize("path,want", [
    ("ipb", {"split", "parse", "entropy", "motion", "alloc", "pack", "wait",
             "hold", "ship", "dispatch", "dpb"}),
    ("intra", {"parse", "alloc", "prep", "entropy", "redecode", "wait",
               "pad", "hold", "ship", "dispatch", "harvest"}),
    ("live", {"split", "parse", "cavlc", "motion", "alloc", "pack", "wait",
              "hold", "ship", "dispatch", "dpb"}),
])
def test_stage_names(path, want, request):
    runs = request.getfixturevalue(path)
    tm = (runs[0] if path == "intra" else runs)[0]
    assert set(tm.names) == want
    assert want <= set(obs.STAGES)


@pytest.mark.parametrize("path", ["ipb", "intra", "live"])
def test_every_call_of_the_entries_runs_inside_a_stage(path, request):
    """No stage nests in another (the Recorder fails on one), and each
    call the entries make from their own frames outside every stage is
    a stage's own context manager or a helper that opens stages."""
    runs = request.getfixturevalue(path)
    for run in (runs if path == "intra" else [runs]):
        assert set(run[2]) <= MAY_CALL_OUTSIDE, set(run[2]) - \
            MAY_CALL_OUTSIDE


def _pictures(decodes):
    """Bins per picture: entropy calls on one picture's slices (a
    redecode after a growth) are one picture."""
    out = {}
    for key, bins in decodes:
        assert out.setdefault(key, bins) == bins
    return list(out.values())


def test_ipb_counters(ipb):
    tm, frames, _, loads, decodes, packs = ipb
    assert len(frames) == 10
    pics = _pictures(decodes)
    assert tm.counters["frames"] == len(pics) == 10
    assert tm.counters["bins"] == sum(pics) > 0
    assert tm.counters["wire_bytes"] == sum(loads) > 0 and len(loads) == 10
    # a picture's pack ran again after each growth of the blobs' caps
    per_pic = defaultdict(int)
    for f in packs:
        per_pic[f] += 1
    assert tm.counters["retries"] == sum(c > 1 for c in per_pic.values())
    assert tm.counters["retries"] >= 1     # the caps start at 32/1024/256


def test_live_counters(live):
    """On CAVLC pictures ``cavlc_bits`` is the slice data handed to the
    native decode (each slice's RBSP from the end of its header) and
    ``bins`` is not counted."""
    tm, frames, _, loads, decodes, _ = live
    assert len(frames) == 8 and tm.counters["frames"] == 8
    assert tm.counters["bins"] == 0 and all(b == 0 for _, b in decodes)
    from dryv_tpu_torch.avc import split_annexb
    from dryv_tpu_torch.avc.slice_header import SliceHeader
    from dryv_tpu_torch.decoder import SyntaxDecoder

    sd = SyntaxDecoder()
    bits = 0
    for nal in sd.feed_parameter_sets(list(split_annexb(LIVE))):
        if int(nal.type) in (1, 5):
            pps = next(iter(sd.pps_map.values()))
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = SliceHeader.parse(nal.rbsp, nal, sps, pps)
            bits += len(nal.rbsp) * 8 - h.header_bit_len
    assert tm.counters["cavlc_bits"] == bits > 0
    assert tm.counters["wire_bytes"] == sum(loads) > 0 and len(loads) == 8


def test_intra_counters(intra):
    for tm, out, _, loads, decodes, _ in intra:
        assert sum(nf for *_, nf in out) == 32
        pics = _pictures(decodes)
        assert tm.counters["frames"] == len(pics) == 32
        assert tm.counters["bins"] == sum(pics) > 0
        # each batch's whole blob, its padded tail included
        assert tm.counters["wire_bytes"] == sum(loads) and len(loads) == 2
    # the first call grows its new staging and decodes pictures again
    tm, decodes = intra[0][0], intra[0][4]
    retried = len(decodes) - len(_pictures(decodes))
    assert retried >= 1 and "redecode" in tm.names
    assert 1 <= tm.counters["retries"] <= retried
    assert tm.counters["staging_kept"] == 0
    # the second takes it back from the keep, grown: each picture once
    tm, decodes = intra[1][0], intra[1][4]
    assert len(decodes) == 32 and "redecode" not in tm.names
    assert tm.counters["retries"] == 0 and tm.counters["staging_kept"] == 1
    # the rest are equal (entropy_task_us is a wall time)
    first, second = ({k: v for k, v in run[0].counters.items()
                      if k not in ("entropy_task_us", "retries",
                                   "staging_kept")} for run in intra)
    assert min(run[0].counters["entropy_task_us"] for run in intra) > 0
    assert first == second


def test_staging_started_large_enough_retries_nothing():
    from dryv_tpu_torch import wire
    from dryv_tpu_torch.kernels.geometry import BLK, round_up

    pics, sps, pps = gop_pipeline._parse_pictures(INTRA)
    n = sps.pic_width_in_mbs * sps.frame_height_in_mbs
    start = gop_pipeline.START_CAPS
    grown = wire.Staging(4, round_up(n, BLK), n, start, slots=1)
    tm = Recorder()
    first = gop_pipeline.pack_batch(grown, 0, pics[:4], sps, pps, 1,
                                    tm).clone()
    assert tm.counters["retries"] >= 1 and grown.caps != (32, 256, 64)
    big = wire.Staging(4, round_up(n, BLK), n, start, slots=1)
    big.grow(grown.caps, Recorder())
    tm2 = Recorder()
    again = gop_pipeline.pack_batch(big, 0, pics[:4], sps, pps, 1, tm2)
    assert tm2.counters["retries"] == 0 and "redecode" not in tm2.names
    assert tm2.counters["frames"] == tm.counters["frames"] == 4
    assert tm2.counters["bins"] == tm.counters["bins"]
    assert torch.equal(again, first)


def test_stage_timers_open_ranges_under_the_profiler():
    tm = obs.StageTimers()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tm.stage("entropy"):
            torch.ones(4).add_(1)
    ev = prof.events()
    ranges = [e for e in ev if e.name == "dryv.entropy"]
    assert len(ranges) == 1
    add = next(e for e in ev if e.name == "aten::add_")
    assert add.cpu_parent is not None
    assert add.cpu_parent.name == "dryv.entropy"
    assert tm.n["entropy"] == 1 and tm.t["entropy"] > 0


def test_stage_timers_open_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    tm = obs.StageTimers()
    with tm.stage("parse"):
        pass
    assert opened == [] and tm.n["parse"] == 1


def test_decode_under_the_profiler_has_a_range_per_stage():
    tm = obs.StageTimers()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gop_pipeline.decode_annexb_gop_pipelined(
            INTRA, gop=16, n_threads=1, device="cpu", stacked_out=True,
            timers=tm)
    names = defaultdict(int)
    for e in prof.events():
        if e.name.startswith(obs.RANGE):
            names[e.name[len(obs.RANGE):]] += 1
    assert dict(names) == dict(tm.n)


def test_report_has_entropy_parallelism():
    """entropy_parallelism: the native tasks' summed time over the
    entropy and redecode stages' wall time."""
    tm = obs.StageTimers()
    tm.t["entropy"], tm.t["redecode"] = 0.3, 0.1
    tm.count("entropy_task_us", 2_000_000)
    tm.count("par_pictures", 16)
    r = tm.report()
    assert r["entropy_parallelism"] == 5.0
    assert r["counters"]["par_pictures"] == 16
    tm = obs.StageTimers()
    with tm.stage("entropy"):
        pass
    assert "entropy_parallelism" not in tm.report()


def test_report_has_stages_counters_and_bins_per_s():
    tm = obs.StageTimers()
    with tm.stage("entropy"):
        time.sleep(0.01)
    tm.count("bins", 1000)
    tm.count("frames", 2)
    r = tm.report()
    assert set(r) == {"stages", "counters", "bins_per_s"}
    assert r["stages"]["entropy"]["calls"] == 1
    assert r["counters"] == {"bins": 1000, "frames": 2}
    assert 0 < r["bins_per_s"] <= 100000
    assert set(obs.StageTimers().report()) == {"stages", "counters"}


def test_report_has_cavlc_bits_per_s():
    """cavlc_bits_per_s: the CAVLC slice-data bits over the cavlc stage's
    seconds, beside bins_per_s where a decode had both."""
    tm = obs.StageTimers()
    tm.t["cavlc"], tm.t["entropy"] = 0.5, 0.25
    tm.count("cavlc_bits", 1000)
    tm.count("bins", 1000)
    r = tm.report()
    assert r["cavlc_bits_per_s"] == 2000 and r["bins_per_s"] == 4000
    tm = obs.StageTimers()
    with tm.stage("cavlc"):
        pass
    assert "cavlc_bits_per_s" not in tm.report()
