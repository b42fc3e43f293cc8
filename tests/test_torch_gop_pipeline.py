"""The port's batched GOP decode on device="cpu" (plain versions of the
kernels) against the JAX pipeline (Pallas in interpret mode) and the
libavcodec oracle: distinct frames per batch, tail padding, deblocked
and undeblocked streams, vals-stride growth and |v|>127 fixes at low QP,
PCM batches, device outputs, and where inter streams go."""
from functools import lru_cache

import numpy as np
import pytest
import torch

from dryv_tpu.testing.oracle import decode_annexb
from dryv_tpu.testing.x264 import encode_x264
from dryv_tpu_torch.gop_pipeline import decode_annexb_gop_pipelined
from dryv_tpu_torch import wire

from test_gop_pipeline import _frames


@pytest.fixture(autouse=True)
def empty_staging_keep():
    """Each test starts from an emptied staging keep and leaves none
    (``wire.release``): a staging kept from an earlier test would start
    a decode at the caps that test grew to, not at the entry's start
    caps, and so change its steps' keys."""
    wire.release()
    yield
    wire.release()


@lru_cache(maxsize=None)
def _stream(params, n=6):
    return encode_x264(_frames(n), x264_params=params)


def _assert_frames(got, ref):
    assert len(got) == len(ref)
    for f, (ry, rcb, rcr) in zip(got, ref):
        np.testing.assert_array_equal(f.y, ry)
        np.testing.assert_array_equal(f.cb, rcb)
        np.testing.assert_array_equal(f.cr, rcr)


@pytest.mark.parametrize("params", ["qp=30:keyint=1:slices=2",
                                    "qp=34:keyint=1:nf=1"])
def test_matches_jax_pipeline_and_oracle(params):
    """6 frames at gop=4: one full batch and one padded tail batch;
    slices=2 keeps x264's in-loop filter on, nf=1 turns it off."""
    from dryv_tpu.gop_pipeline import decode_annexb_gop_pipelined as jax_dec

    stream = _stream(params)
    got = decode_annexb_gop_pipelined(stream, gop=4, n_threads=1,
                                      device="cpu")
    _assert_frames(got, decode_annexb(stream))
    ref = jax_dec(stream, gop=4, n_threads=1, interpret=True)
    _assert_frames(got, [(f.y, f.cb, f.cr) for f in ref])


def _blocky_frames(n):
    """Flat 4x4 blocks of 0 or 255: few nonzero levels per MB, most of
    them beyond +/-127."""
    out = []
    for t in range(n):
        r = np.random.default_rng(t)
        y = np.kron(r.integers(0, 2, (12, 16)) * 255, np.ones((4, 4)))
        c = np.kron(r.integers(0, 2, (6, 8)) * 255, np.ones((4, 4)))
        out.append((y.astype(np.uint8), c.astype(np.uint8),
                    c[::-1].astype(np.uint8)))
    return out


@pytest.mark.parametrize("params,blocky", [
    ("qp=4:keyint=1", False), ("qp=12:keyint=1:nf=1", False),
    ("qp=8:keyint=1", True)])
def test_wire_channels(params, blocky):
    """Dense low-QP pictures outgrow the initial vals stride (W growth)
    and ship heavy MBs as overflow rows; the blocky pictures ship their
    |v|>127 levels as (index, delta) corrections."""
    stream = (encode_x264(_blocky_frames(3), x264_params=params) if blocky
              else _stream(params, n=3))
    got = decode_annexb_gop_pipelined(stream, gop=2, n_threads=1,
                                      device="cpu")
    _assert_frames(got, decode_annexb(stream))


@pytest.mark.parametrize("name", ["pcm", "dblk_mix_qp26", "mix8_qp30",
                                  "dblk_slices_qp28", "crop_qp28"])
def test_fixtures(name):
    """Fixture pictures (PCM batches among them) vs their goldens."""
    from dryv_tpu.testing.fixtures import get_fixture

    stream, golden, _, _ = get_fixture(name)
    got = decode_annexb_gop_pipelined(stream, gop=2, n_threads=1,
                                      device="cpu")
    _assert_frames(got, [golden])


def test_device_outputs():
    stream = _stream("qp=30:keyint=1:nf=1", n=3)
    ref = decode_annexb(stream)
    per_frame = decode_annexb_gop_pipelined(stream, gop=2, n_threads=1,
                                            device="cpu", device_out=True)
    assert len(per_frame) == 3
    for (y, cb, cr), (ry, rcb, rcr) in zip(per_frame, ref):
        assert isinstance(y, torch.Tensor)
        H, W = ry.shape
        np.testing.assert_array_equal(y.numpy()[:H, :W], ry)
        np.testing.assert_array_equal(cb.numpy()[:H // 2, :W // 2], rcb)
    stacked = decode_annexb_gop_pipelined(stream, gop=2, n_threads=1,
                                          device="cpu", stacked_out=True)
    assert [nf for *_, nf in stacked] == [2, 1]
    assert stacked[0][0].shape[0] == 2


def test_inter_stream_falls_back():
    """P-frame streams are outside the batched scope and the per-picture
    device path's too.  ``decode_annexb_gop_pipelined.fallback_calls``
    counts streams that left the batched scope (for
    ``pipeline.decode_annexb_fast``); ``decode_annexb_fast.host_calls``
    counts those that reached the native C++ decoder from there."""
    from dryv_tpu_torch.pipeline import decode_annexb_fast

    stream = encode_x264(_frames(4), x264_params="qp=30:keyint=2:bframes=0:"
                                                 "scenecut=0:min-keyint=2")
    before = decode_annexb_gop_pipelined.fallback_calls
    host_before = decode_annexb_fast.host_calls
    got = decode_annexb_gop_pipelined(stream, gop=4, n_threads=1,
                                      device="cpu")
    assert decode_annexb_gop_pipelined.fallback_calls == before + 1
    assert decode_annexb_fast.host_calls == host_before + 1
    _assert_frames(got, decode_annexb(stream))
    with pytest.raises(ValueError):
        decode_annexb_gop_pipelined(stream, device="cpu", stacked_out=True)
