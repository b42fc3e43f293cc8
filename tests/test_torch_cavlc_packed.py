"""CAVLC streams on the port's packed I/P path
(``dryv_tpu_torch.device_ipb_packed``) on the CPU: x264 Constrained
Baseline live streams (``avcbench/tests/configs/tiny-live``: CAVLC, IDR
then P, 320x192, the 1080p pool's recipe and slice QPs; one of them in 4
slices a picture) and the CAVLC intra fixtures stay on the device path
and equal libavcodec and the port's scalar decoder; a slice whose header
ends inside a byte hands its data to the CAVLC decode from that bit; the
``cavlc`` stage and the ``cavlc_bits`` counter stand in for ``entropy``
and ``bins``; the CLI's ``--stats`` reports them.  The JAX package's
packed path hands the same streams to its host decoder."""
import json
from pathlib import Path

import numpy as np
import pytest

from dryv_tpu.avc import NalUnitType, split_annexb
from dryv_tpu.avc.nal import to_avcc_sample
from dryv_tpu.container import write_mp4
from dryv_tpu.testing.fixtures import get_fixture
from dryv_tpu.testing.oracle import decode_annexb
from dryv_tpu_torch import cli
from dryv_tpu_torch.decoder import decode_annexb_scalar
from dryv_tpu_torch.device_ipb_packed import (PackedPictureDecoder,
                                              decode_annexb_device_packed)
from dryv_tpu_torch.native import entropy
from dryv_tpu_torch.utils.obs import StageTimers
from dryv_tpu_torch import wire

LIVE = Path(__file__).resolve().parent.parent / "avcbench" / "tests" / \
    "configs" / "tiny-live"
STREAMS = sorted(p.name for p in LIVE.glob("*.264"))


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): a staging kept from an earlier test would start
    a decode at the caps that test grew to, not at the entry's start
    caps, and so change its steps' keys."""
    wire.release()
    yield
    wire.release()


def _stream(name):
    return (LIVE / name).read_bytes()


@pytest.fixture(scope="module")
def decoded():
    """Each live stream decoded once on the device path: (frames in POC
    order, the StageTimers, the slice-data bit offsets handed to the
    native decode, the change in host_calls, nlists of each
    PackedPictureDecoder call)."""
    out = {}
    for name in STREAMS:
        offsets, seen = [], []
        decode = entropy.decode_picture_slices
        forward = PackedPictureDecoder.forward

        def recorded(slice_datas, *args, **kw):
            offsets.extend(sd[1] for sd in slice_datas)
            return decode(slice_datas, *args, **kw)

        def counted(self, *args):
            seen.append(args[5])
            return forward(self, *args)

        tm = StageTimers()
        before = decode_annexb_device_packed.host_calls
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(entropy, "decode_picture_slices", recorded)
            mp.setattr(PackedPictureDecoder, "forward", counted)
            frames = decode_annexb_device_packed(_stream(name),
                                                 device="cpu", timers=tm)
        out[name] = (sorted(frames, key=lambda f: f.poc), tm, offsets,
                     decode_annexb_device_packed.host_calls - before, seen)
    return out


@pytest.fixture
def pictures(monkeypatch):
    """Counts PackedPictureDecoder calls by nlists (0 intra, 1 P, 2 B)."""
    seen = []
    forward = PackedPictureDecoder.forward

    def counted(self, *args):
        seen.append(args[5])
        return forward(self, *args)

    monkeypatch.setattr(PackedPictureDecoder, "forward", counted)
    return seen


def _planes(f):
    return [np.asarray(p, np.uint8) for p in (f.y, f.cb, f.cr)]


def test_the_streams_are_constrained_baseline():
    """profile_idc 66 with constraint_set0 and 1, CAVLC, IDR then P."""
    assert len(STREAMS) == 4
    for name in STREAMS:
        nals = list(split_annexb(_stream(name)))
        sps = next(n for n in nals if n.type == NalUnitType.SPS)
        head = sps.to_bytes()
        assert head[1] == 66 and head[2] >> 6 == 0b11, name
        assert b"cabac=0" in _stream(name) and b"bframes=0" in _stream(name)


@pytest.mark.parametrize("name", STREAMS)
def test_live_stream_stays_on_the_device_path(name, decoded):
    stream = _stream(name)
    got, _, _, host_calls, pictures = decoded[name]
    assert host_calls == 0
    assert pictures == [0] + [1] * 7        # IDR, then P pictures
    ref = decode_annexb(stream)
    scalar = sorted(decode_annexb_scalar(stream), key=lambda f: f.poc)
    assert len(got) == len(ref) == len(scalar) == 8
    for i, (f, r, s) in enumerate(zip(got, ref, scalar)):
        for pn, a, b, c in zip(("y", "cb", "cr"), _planes(f), r,
                               _planes(s)):
            np.testing.assert_array_equal(a, b, err_msg=f"{i} {pn} oracle")
            np.testing.assert_array_equal(a, c, err_msg=f"{i} {pn} scalar")


@pytest.mark.parametrize("name", ["cavlc_i4_qp10", "cavlc_i16_qp0",
                                  "cavlc_i4_qp0"])
def test_cavlc_intra_fixture_stays_on_the_device_path(name, pictures):
    stream, golden, _, _ = get_fixture(name)
    before = decode_annexb_device_packed.host_calls
    f = decode_annexb_device_packed(stream, device="cpu")[0]
    assert decode_annexb_device_packed.host_calls == before
    assert pictures == [0]
    for a, b in zip(_planes(f), golden):
        np.testing.assert_array_equal(a, b)


def test_slice_data_starts_where_a_cavlc_header_ends(decoded):
    """Each CAVLC slice hands its data to the native decode from the bit
    its header ends at, which for most slices lies inside a byte (CABAC
    data starts at the next byte, CAVLC data does not)."""
    from dryv_tpu.avc.slice_header import SliceHeader
    from dryv_tpu.decoder import SyntaxDecoder

    stream = _stream("live_slices4_s4.264")
    got, _, offsets, _, _ = decoded["live_slices4_s4.264"]
    # the header lengths as the JAX package's parser reads them
    sd = SyntaxDecoder()
    want = []
    for nal in sd.feed_parameter_sets(list(split_annexb(stream))):
        if nal.type not in (NalUnitType.IDR_SLICE,
                            NalUnitType.NON_IDR_SLICE):
            continue
        pps = next(iter(sd.pps_map.values()))
        sps = sd.sps_map[pps.seq_parameter_set_id]
        want.append(SliceHeader.parse(nal.rbsp, nal, sps,
                                      pps).header_bit_len)
    assert offsets == want and len(want) == 32
    assert sum(o % 8 != 0 for o in offsets) >= 16
    for f, r in zip(got, decode_annexb(stream)):
        for a, b in zip(_planes(f), r):
            np.testing.assert_array_equal(a, b)


def test_cavlc_stage_and_counter(decoded):
    """A CAVLC picture's native decode is timed as ``cavlc``, not
    ``entropy``; ``cavlc_bits`` counts each slice's data bits (its RBSP
    past the header) and ``bins`` stays 0."""
    stream = _stream("live_s2.264")
    tm = decoded["live_s2.264"][1]
    assert "entropy" not in tm.t and tm.n["cavlc"] == 8
    bits = sum(len(nal.rbsp) * 8 for nal in split_annexb(stream)
               if nal.type in (NalUnitType.IDR_SLICE,
                               NalUnitType.NON_IDR_SLICE))
    assert 0 < tm.counters["cavlc_bits"] < bits
    assert bits - tm.counters["cavlc_bits"] < 8 * 8 * 64    # the headers
    assert tm.counters["bins"] == 0 and tm.counters["frames"] == 8
    r = tm.report()
    assert "bins_per_s" not in r
    assert r["cavlc_bits_per_s"] == int(tm.counters["cavlc_bits"]
                                        / tm.t["cavlc"])


def test_cli_stats_report_the_cavlc_stage(tmp_path, capsys):
    stream = _stream("live_s1.264")
    nals = list(split_annexb(stream))
    sps = next(n for n in nals if n.type == NalUnitType.SPS).to_bytes()
    pps = next(n for n in nals if n.type == NalUnitType.PPS).to_bytes()
    samples = [to_avcc_sample([n]) for n in nals
               if n.type in (NalUnitType.IDR_SLICE,
                             NalUnitType.NON_IDR_SLICE)]
    path = tmp_path / "live.mp4"
    write_mp4(path, samples, sps, pps, 320, 192)
    before = decode_annexb_device_packed.host_calls
    assert cli.main([str(path), "-o", str(tmp_path / "out.yuv"),
                     "--frames", "0", "--device", "cpu", "--backend",
                     "device-ipb", "--stats"]) == 0
    assert decode_annexb_device_packed.host_calls == before
    text = capsys.readouterr().out
    stats = json.loads(text.split("stats: ", 1)[1].splitlines()[0])
    assert stats["stages"]["cavlc"]["calls"] == 8
    assert "entropy" not in stats["stages"]
    assert stats["counters"]["cavlc_bits"] > 0
    assert stats["cavlc_bits_per_s"] > 0 and "bins_per_s" not in stats


def test_port_takes_cavlc_where_the_jax_path_falls_back(monkeypatch,
                                                        decoded):
    """The JAX package's packed path hands a CAVLC stream to its host
    decoder; the port decodes it on the device path, to the same
    pictures."""
    from dryv_tpu.device_ipb_packed import \
        decode_annexb_device_packed as jax_packed
    from dryv_tpu.native import full

    handed = []
    native = full.decode_annexb_native

    def counted(stream, *args, **kw):
        handed.append(len(stream))
        return native(stream, *args, **kw)

    monkeypatch.setattr(full, "decode_annexb_native", counted)
    stream = _stream("live_s3.264")
    theirs = jax_packed(stream)
    ours, _, _, host_calls, _ = decoded["live_s3.264"]
    assert handed == [len(stream)] and host_calls == 0
    assert len(ours) == len(theirs) == 8
    for f, g in zip(ours, sorted(theirs, key=lambda f: f.poc)):
        for a, b in zip(_planes(f), _planes(g)):
            np.testing.assert_array_equal(a, b)
