"""The port's per-picture path (``dryv_tpu_torch.pipeline``) on the CPU,
bit-exact against ``dryv_tpu.pipeline`` and the oracle's goldens:
CAVLC, PCM, multi-slice, cropping, custom scaling matrices and the
in-loop filter; and the batched pipeline handing a CAVLC stream to it."""
import numpy as np
import pytest

from dryv_tpu.testing.fixtures import get_fixture
from dryv_tpu_torch import pipeline as tp


def _assert_frames(got, ref, golden):
    assert len(got) == len(ref) == 1
    for g, r in zip(got, ref):
        for a, b, c in zip((g.y, g.cb, g.cr), (r.y, r.cb, r.cr), golden):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("name", ["mix_qp26", "pcm", "slices_qp28",
                                  "crop_qp28", "cavlc_mix_qp26"])
def test_decode_annexb_tpu(name):
    from dryv_tpu.pipeline import decode_annexb_tpu

    stream, golden, _, _ = get_fixture(name)
    _assert_frames(tp.decode_annexb_tpu(stream, device="cpu"),
                   decode_annexb_tpu(stream), golden)


@pytest.mark.parametrize("name", ["dblk_mix_qp26", "dblk_slices_qp28",
                                  "scal_mix8_qp28", "scal_pps_qp30",
                                  "scal_dblk_qp32", "cavlc_mix8_qp30"])
def test_decode_annexb_fast(name):
    from dryv_tpu.pipeline import decode_annexb_fast

    stream, golden, _, _ = get_fixture(name)
    before = tp.decode_annexb_fast.host_calls
    got = tp.decode_annexb_fast(stream, n_threads=1, device="cpu")
    assert tp.decode_annexb_fast.host_calls == before
    _assert_frames(got, decode_annexb_fast(stream, n_threads=1), golden)


@pytest.mark.parametrize("name", ["scal_mix8_qp28", "scal_dblk_qp32"])
def test_reconstruct_frame(name):
    """Uncropped planes from the same FrameSyntax and custom LevelScale
    lists, with the in-loop filter where the stream enables it."""
    from dryv_tpu.coeffs import pack_from_native
    from dryv_tpu.kernels.deblock import deblock_precompute_intra
    from dryv_tpu.native.entropy import decode_picture_islices
    from dryv_tpu.pipeline import reconstruct_frame_jax
    from dryv_tpu_torch.gop_pipeline import _parse_pictures

    stream, golden, _, _ = get_fixture(name)
    pics, sps, pps = _parse_pictures(stream)
    slice_datas, headers = pics[0]
    out = decode_picture_islices(slice_datas, sps, pps)
    fs = pack_from_native(out, sps, pps)
    ls4, ls8 = tp._level_scales(sps, pps)
    assert not np.array_equal(ls4[0].reshape(6, 16)[:, :4],
                              ls4[0].reshape(6, 16)[:, 4:8])
    pre = jpre = None
    if "dblk" in name:
        pre = tp.deblock_pre_of(fs, out["slice_id"], headers, pps, "cpu")
        jpre = deblock_precompute_intra(
            fs.kind, fs.qp_y, out["slice_id"], tp._dbctl_of(headers).tolist(),
            fs.mb_w, fs.mb_h, pps.chroma_qp_index_offset,
            pps.second_chroma_qp_offset)
    got = tp.reconstruct_frame(fs, ls4, ls8, deblock_pre=pre, device="cpu")
    ref = reconstruct_frame_jax(fs, ls4, ls8, deblock_pre=jpre)
    for g, r, c in zip(got, ref, golden):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, c)


def test_gop_pipeline_sends_cavlc_to_the_per_picture_path():
    """A CAVLC stream leaves the batched scope for the per-picture device
    path, as in the JAX package, and never reaches the host decoder."""
    from dryv_tpu.gop_pipeline import decode_annexb_gop_pipelined as jdec
    from dryv_tpu_torch.gop_pipeline import decode_annexb_gop_pipelined

    stream, golden, _, _ = get_fixture("cavlc_dblk_qp30")
    before = decode_annexb_gop_pipelined.fallback_calls
    host_before = tp.decode_annexb_fast.host_calls
    got = decode_annexb_gop_pipelined(stream, gop=2, n_threads=1,
                                      device="cpu")
    assert decode_annexb_gop_pipelined.fallback_calls == before + 1
    assert tp.decode_annexb_fast.host_calls == host_before
    _assert_frames(got, jdec(stream, gop=2, n_threads=1, interpret=True),
                   golden)
