"""The port's packed-wire device I/P/B decode
(``dryv_tpu_torch.device_ipb_packed``) on the CPU: the cases of
tests/test_device_ipb_packed.py, and the whole third-party corpus of
tests/test_device_ipb.py, bit-exact against the libavcodec oracle, with
the split between the device path and the native fallback."""
import os

import numpy as np
import pytest

from dryv_tpu.avc.slice_header import PredWeight, PredWeightTable
from dryv_tpu.encoder import default_sps_pps
from dryv_tpu.encoder.p_frame import SequenceEncoder
from dryv_tpu.encoder.slices import encode_sequence_annexb
from dryv_tpu.testing.oracle import decode_annexb
from dryv_tpu_torch.device_ipb_packed import (PackedPictureDecoder,
                                              decode_annexb_device_packed)

from test_device_ipb import _conformance_streams, _sources

ROOT = os.path.join(os.path.dirname(__file__), "..")


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


def _check(stream, pictures):
    before = decode_annexb_device_packed.host_calls
    ref = decode_annexb(stream)
    got = sorted(decode_annexb_device_packed(stream, device="cpu"),
                 key=lambda f: f.poc)
    assert decode_annexb_device_packed.host_calls == before
    assert len(ref) == len(got) == len(pictures)
    for i, ((ry, rcb, rcr), f) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(f.y, ry, err_msg=f"frame {i} luma")
        np.testing.assert_array_equal(f.cb, rcb, err_msg=f"frame {i} cb")
        np.testing.assert_array_equal(f.cr, rcr, err_msg=f"frame {i} cr")


@pytest.mark.parametrize("deblock", [False, True])
def test_packed_ipb_sequence(deblock, pictures):
    mb_w, mb_h = 6, 4
    frame_at = _sources(31, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=28, poc_type=0, max_refs=2)
    se = SequenceEncoder(sps, pps, 28, deblock=deblock)
    frames = [
        (se.encode_idr(*frame_at(0), poc=0), 7, True, 0, 0, 3),
        (se.encode_p(*frame_at(4), poc=8), 5, False, 1, 8, 3),
        (se.encode_b(*frame_at(2), poc=4), 6, False, 2, 4, 0),
    ]
    stream = encode_sequence_annexb(sps, pps, frames,
                                    deblock_disable=0 if deblock else 1)
    _check(stream, pictures)
    assert pictures == [0, 1, 2]


def test_packed_ipb_weighted_explicit(pictures):
    mb_w, mb_h = 5, 4
    frame_at = _sources(41, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=28, weighted_pred=1)
    se = SequenceEncoder(sps, pps, 28)
    pwt = PredWeightTable(
        luma_log2_weight_denom=5,
        chroma_log2_weight_denom=6,
        luma_l0=[PredWeight(40, -4)],
        chroma_l0=[(PredWeight(70, 5), PredWeight(60, -6))])
    frames = [
        (se.encode_idr(*frame_at(0)), 7, True, 0),
        (se.encode_p(*frame_at(1), wp_table=pwt), 5, False, 1, 0, 3, pwt),
        (se.encode_p(*frame_at(3), wp_table=pwt), 5, False, 2, 0, 3, pwt),
    ]
    _check(encode_sequence_annexb(sps, pps, frames), pictures)
    assert pictures == [0, 1, 1]


def test_packed_ipb_weighted_implicit(pictures):
    mb_w, mb_h = 5, 4
    frame_at = _sources(47, mb_w, mb_h)
    sps, pps = default_sps_pps(mb_w, mb_h, qp=28, poc_type=0, max_refs=2,
                               weighted_bipred_idc=2)
    se = SequenceEncoder(sps, pps, 28)
    frames = [
        (se.encode_idr(*frame_at(0), poc=0), 7, True, 0, 0, 3),
        (se.encode_p(*frame_at(4), poc=8), 5, False, 1, 8, 3),
        (se.encode_b(*frame_at(1), poc=2), 6, False, 2, 2, 0),
    ]
    _check(encode_sequence_annexb(sps, pps, frames), pictures)
    assert pictures == [0, 1, 2]


def test_packed_ipb_bench_fixture(pictures):
    """The 640x368 IPB bench stream (quarter-pel MC, B frames, direct
    modes, in-loop filter) against its golden."""
    g = np.load(os.path.join(ROOT, "benchdata", "bench_ipb_golden.npz"))
    stream = open(os.path.join(ROOT, "benchdata", "bench_ipb.264"),
                  "rb").read()
    frames = sorted(decode_annexb_device_packed(stream, device="cpu"),
                    key=lambda f: f.poc)
    assert len(frames) == len(pictures) == 9
    assert set(pictures) == {0, 1, 2}
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(f.y, g[f"f{i}_y"], err_msg=f"frame {i}")
        np.testing.assert_array_equal(f.cb, g[f"f{i}_b"])
        np.testing.assert_array_equal(f.cr, g[f"f{i}_r"])


# the corpus streams the device path takes; the others leave for the
# native decoder before any picture reaches the device (4:2:2, 4:4:4,
# CAVLC, constrained intra, scaling matrices, monochrome, lossless, MBAFF)
DEVICE_STREAMS = {
    "chroma_qp", "deblock_22", "defaults_qp28", "fake_interlaced",
    "intra_only", "intra_refresh", "keyint3", "nal_hrd_cbr", "no8x8",
    "no_deblock", "open_gop", "qp51", "refs8_bpyr", "scenecut",
    "slice_max_size", "slices4", "slow_qp24", "veryfast_crf", "vui_sar",
    "weightp_fade"}


@pytest.mark.parametrize(
    "path", _conformance_streams(),
    ids=[os.path.basename(p) for p in _conformance_streams()])
def test_packed_conformance_bit_exact(path, pictures):
    """Every corpus stream through the packed path: the device path where
    in scope, the native fallback elsewhere; every frame equal to
    libavcodec."""
    stream = open(path, "rb").read()
    golden = decode_annexb(stream)
    before = decode_annexb_device_packed.host_calls
    ours = decode_annexb_device_packed(stream, device="cpu")
    on_device = os.path.basename(path)[:-4] in DEVICE_STREAMS
    assert decode_annexb_device_packed.host_calls == before + (not on_device)
    assert (len(pictures) > 0) == on_device
    assert len(ours) == len(golden)
    for i, (o, g) in enumerate(zip(ours, golden)):
        for pn, op, gp in zip(("y", "cb", "cr"), (o.y, o.cb, o.cr), g):
            if gp is None:
                continue
            if op is None:
                assert (gp == 128).all(), f"frame {i} {pn}"
                continue
            np.testing.assert_array_equal(np.asarray(op), gp,
                                          err_msg=f"frame {i} plane {pn}")
