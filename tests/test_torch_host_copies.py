"""The port's copies of the host layers (``dryv_tpu_torch/{avc,cabac,
cavlc,native,encoder,container,...}``) give the same results as their
originals in ``dryv_tpu`` on the same bytes: the C++ entropy stage (plain
and fused with the device pack), the native full decoder, the parsed
parameter sets and slice headers, the encoder's output and the MP4
demux.  The port builds its own C++ library from its own sources."""
import enum
import importlib

import numpy as np
import pytest

from dryv_tpu.testing.fixtures import FIXTURE_SPECS, get_fixture

PKGS = ("dryv_tpu", "dryv_tpu_torch")
CASES = ["mix_qp26", "slices_qp28", "pcm", "dblk_mix_qp26",
         "dblk_slices_qp28", "cavlc_mix_qp26", "cavlc_mix8_qp30"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _plain(o):
    """Structure of parsed syntax objects, free of the package they come
    from: class names and fields, enums by value, arrays as lists."""
    if isinstance(o, enum.Enum):
        return o.value
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (list, tuple)):
        return [_plain(x) for x in o]
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if hasattr(o, "__dict__"):
        return (type(o).__name__, {k: _plain(v) for k, v in vars(o).items()})
    return o


def _pictures(pkg, stream):
    """(slice_datas, headers, sps, pps, parameter sets) per picture,
    parsed with `pkg`'s own layers, as ``pipeline._pictures`` does."""
    SliceHeader = _mod(pkg, "avc.slice_header").SliceHeader
    dec = _mod(pkg, "decoder")
    sd = dec.SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(_mod(pkg, "avc").split_annexb(stream)))
    out = []
    for pic_nals in dec.group_access_units(rest):
        datas, headers = [], []
        for nal in pic_nals:
            h0 = SliceHeader.parse(nal.rbsp, nal, next(iter(
                sd.sps_map.values())), next(iter(sd.pps_map.values())))
            pps = sd.pps_map[h0.pic_parameter_set_id]
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = SliceHeader.parse(nal.rbsp, nal, sps, pps)
            headers.append(h)
            bitoff = ((h.header_bit_len + 7) & ~7
                      if pps.entropy_coding_mode_flag else h.header_bit_len)
            datas.append((nal.rbsp, bitoff, h.first_mb_in_slice,
                          h.slice_qp_y(pps)))
        out.append((datas, headers, sps, pps, (sd.sps_map, sd.pps_map)))
    return out


def _pack(pkg, datas, sps, pps):
    """decode_pack_picture_islices of `pkg` into fresh buffers, on one
    thread (slice workers append overflow rows in the order they finish)."""
    n = sps.pic_width_in_mbs * sps.frame_height_in_mbs
    npad, W = (n + 127) // 128 * 128, 32
    bufs = [np.zeros((npad, 51), np.uint8), np.zeros((npad, W), np.int8),
            np.zeros(npad, np.int32), np.zeros((npad, 19), np.uint8),
            np.zeros(64, np.int32), np.zeros(64, np.int16),
            np.zeros(16, np.int32), np.zeros((16, 408), np.int16)]
    ctl = np.asarray([(1, 0, 0)] * len(datas), np.int32)
    out, maxnz, nexc, novf = _mod(pkg, "native.entropy") \
        .decode_pack_picture_islices(datas, sps, pps, W, ctl, *bufs,
                                     n_threads=1, reuse=False)
    return out, (maxnz, nexc, novf), bufs


def _encode(pkg, name):
    """The fixture's stream, encoded by `pkg`'s encoder (the recipe of
    ``dryv_tpu.testing.fixtures.get_fixture`` for these fixtures)."""
    _, mb_w, mb_h, qp, policy, t8, rps, crop = next(
        s for s in FIXTURE_SPECS if s[0] == name)
    enc_mod = _mod(pkg, "encoder")
    src_mod = _mod(pkg, "testing.sources" if pkg == "dryv_tpu_torch"
                   else "testing.fixtures")
    sps, pps = enc_mod.default_sps_pps(mb_w, mb_h, qp=qp, transform_8x8=t8,
                                       crop=crop, profile=66,
                                       cabac=not name.startswith("cavlc"))
    enc = _mod(pkg, "encoder.intra_encoder").IntraEncoder(
        sps, pps, qp, mb_kind_policy=src_mod.POLICIES[policy])
    src = src_mod.make_source(mb_w, mb_h)
    if rps:
        mbs = enc.encode_frame(*src, slice_bounds=list(
            range(0, mb_w * mb_h, rps * mb_w)))
    else:
        mbs = enc.encode_frame(*src)
    return enc_mod.encode_frame_annexb(sps, pps, rps, mbs,
                                       deblock_disable=0 if "dblk" in name
                                       else 1)


def _demux(pkg, stream, sps, path):
    """Annex B stream of an MP4 holding `stream`, muxed by the JAX
    package and demuxed by `pkg`'s container layer."""
    from dryv_tpu.avc import NalUnitType, split_annexb
    from dryv_tpu.avc.nal import to_avcc_sample
    from dryv_tpu.container import write_mp4

    nals = list(split_annexb(stream))
    sps_nal = next(n for n in nals if n.type == NalUnitType.SPS).to_bytes()
    pps_nal = next(n for n in nals if n.type == NalUnitType.PPS).to_bytes()
    slices = [n for n in nals if n.type in (NalUnitType.IDR_SLICE,
                                            NalUnitType.NON_IDR_SLICE)]
    if not path.exists():
        write_mp4(path, [to_avcc_sample(slices)], sps_nal, pps_nal,
                  sps.width, sps.height)
    if pkg == "dryv_tpu":
        from dryv_tpu.video import Video
        return Video.open(path).annexb_stream()
    from dryv_tpu_torch.video import TorchVideo
    return TorchVideo.open(path).annexb_stream()


@pytest.mark.parametrize("name", CASES)
def test_copies_equal_originals(name, tmp_path):
    stream, (gy, gcb, gcr), sps0, _ = get_fixture(name)
    cabac = not name.startswith("cavlc")

    # the encoder: both packages make the fixture's bytes
    assert _encode("dryv_tpu_torch", name) == _encode("dryv_tpu", name) \
        == stream

    # parameter sets and slice headers
    pics = {p: _pictures(p, stream) for p in PKGS}
    assert len(pics["dryv_tpu"]) == len(pics["dryv_tpu_torch"]) == 1
    (da, ha, spa, ppa, psa), = pics["dryv_tpu"]
    (db, hb, spb, ppb, psb), = pics["dryv_tpu_torch"]
    assert [d[1:] for d in da] == [d[1:] for d in db]
    assert _plain(ha) == _plain(hb)
    assert _plain(psa) == _plain(psb)

    # the C++ entropy stage, plain and fused with the device pack
    ea = _mod("dryv_tpu", "native.entropy").decode_picture_islices(
        da, spa, ppa)
    eb = _mod("dryv_tpu_torch", "native.entropy").decode_picture_islices(
        db, spb, ppb)
    assert ea.keys() == eb.keys()
    for k in ea:
        np.testing.assert_array_equal(ea[k], eb[k], err_msg=k)
    if cabac:
        oa, ra, ba = _pack("dryv_tpu", da, spa, ppa)
        ob, rb, bb = _pack("dryv_tpu_torch", db, spb, ppb)
        assert ra == rb
        for k in oa:
            np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
        for a, b in zip(ba, bb):
            np.testing.assert_array_equal(a, b)

    # the native full decoder
    fa = _mod("dryv_tpu", "native.full").decode_annexb_native(stream)
    fb = _mod("dryv_tpu_torch", "native.full").decode_annexb_native(stream)
    assert len(fa) == len(fb) == 1
    for a, b, g in zip((fb[0].y, fb[0].cb, fb[0].cr),
                       (fa[0].y, fa[0].cb, fa[0].cr), (gy, gcb, gcr)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, g)

    # the MP4 demux
    mp4 = tmp_path / "fixture.mp4"
    assert _demux("dryv_tpu_torch", stream, sps0, mp4) == \
        _demux("dryv_tpu", stream, sps0, mp4)


def test_port_builds_its_own_host_library():
    """The port's entropy stage loads the library built from
    ``dryv_tpu_torch/native/*.cc`` into ``dryv_tpu_torch/build/``, never
    the JAX package's ``libdryv_entropy.so``."""
    from pathlib import Path

    import dryv_tpu_torch
    from dryv_tpu_torch.native import build, entropy

    lib = Path(entropy.lib()._name).resolve()
    root = Path(dryv_tpu_torch.__file__).resolve().parent
    assert lib == build.build()
    assert lib.parent == root / "build"
    assert lib.name.startswith("libdryv_host_")
    assert all(s.parent == root / "native" for s in build.SRCS)


def test_dpb_checkpoint_copy_round_trip_mid_gop():
    """``utils.ckpt`` of the port: the mid-GOP round trip of
    tests/test_ckpt.py on ``bench_ipb.264`` through the port's own DPB,
    each snapshot the same JSON as the JAX package's at the same point,
    and the restored buffer deciding every later picture as the
    uninterrupted one does."""
    from pathlib import Path

    from dryv_tpu.utils import snapshot_dpb as jax_snapshot
    from dryv_tpu_torch.utils import restore_dpb, snapshot_dpb

    stream = (Path(__file__).resolve().parent.parent / "benchdata"
              / "bench_ipb.264").read_bytes()
    pics = {p: [(h[0], nal, sps) for (_, h, sps, _, _), nal in zip(
        _pictures(p, stream), _first_nals(p, stream))] for p in PKGS}
    dpbs = {p: _mod(p, "avc.dpb").DecodedPictureBuffer() for p in PKGS}

    def key(p):
        return (p.frame_num, p.pic_num, p.long_term_pic_num,
                p.long_term_frame_idx, p.pic_order_cnt, p.is_long_term,
                p.is_reference, p.frame_idx, tuple(p.field_ref))

    def step(dpb, h, nal, sps):
        poc = dpb.decode_poc(sps, h, nal)
        dpb.build_ref_lists(sps, h, poc)
        lists = ([key(p) for p in dpb.ref_list0],
                 [key(p) for p in dpb.ref_list1])
        dpb.mark_and_store(sps, h, nal, poc)
        return poc, lists, [key(p) for p in dpb.pictures]

    cut = 4     # after the 4th coded picture, inside the B run
    assert len(pics["dryv_tpu_torch"]) >= 6
    for i in range(cut):
        for p in PKGS:
            step(dpbs[p], *pics[p][i])
    blob = snapshot_dpb(dpbs["dryv_tpu_torch"])
    assert blob == jax_snapshot(dpbs["dryv_tpu"])
    resumed = restore_dpb(blob)
    assert snapshot_dpb(resumed) == blob
    for h, nal, sps in pics["dryv_tpu_torch"][cut:]:
        assert step(resumed, h, nal, sps) == \
            step(dpbs["dryv_tpu_torch"], h, nal, sps)


def _first_nals(pkg, stream):
    """The first NAL unit of each picture, split by `pkg`'s layers."""
    dec = _mod(pkg, "decoder")
    sd = dec.SyntaxDecoder()
    rest = sd.feed_parameter_sets(list(_mod(pkg, "avc").split_annexb(stream)))
    return [nals[0] for nals in dec.group_access_units(rest)]
