# Copy of dryv_tpu/encoder/slices.py.
"""Slice/frame assembly for the fixture encoder."""
from __future__ import annotations

from ..avc import SPS, PPS, NalUnit, NalUnitType, to_annexb
from ..avc.slice_header import SliceHeader
from ..bitio import BitWriter
from ..cabac.encoder import CabacEncoder
from ..cabac.syntax import SliceCoder


def default_sps_pps(mb_w: int, mb_h: int, *, profile: int = 66,
                    transform_8x8: bool = False, qp: int = 26,
                    chroma_qp_offset: int = 0,
                    crop=None, max_refs: int = 1,
                    poc_type: int = 2, weighted_pred: int = 0,
                    weighted_bipred_idc: int = 0,
                    cabac: bool = True,
                    lossless: bool = False) -> tuple[SPS, PPS]:
    if lossless:
        profile = 244  # High 4:4:4 Predictive hosts the bypass flag
        # (profile 100 with the flag is non-conformant: A.2.4 requires it
        # be 0 there, and libavcodec only honours bypass on 244)
    sps = SPS(
        profile_idc=profile if profile == 244
        else (100 if (transform_8x8 or profile >= 100) else profile),
        level_idc=40,
        pic_width_in_mbs_minus1=mb_w - 1,
        pic_height_in_map_units_minus1=mb_h - 1,
        pic_order_cnt_type=poc_type,
        log2_max_pic_order_cnt_lsb_minus4=4,  # lsb range 256 (poc type 0)
        max_num_ref_frames=max_refs,
        qpprime_y_zero_transform_bypass_flag=1 if lossless else 0,
    )
    if crop is not None:
        from ..avc.sps import FrameCropping
        sps.frame_cropping = FrameCropping(*crop)
    pps = PPS(
        entropy_coding_mode_flag=1 if cabac else 0,
        weighted_pred_flag=weighted_pred,
        weighted_bipred_idc=weighted_bipred_idc,
        pic_init_qp_minus26=qp - 26,
        chroma_qp_index_offset=chroma_qp_offset,
        # fixtures disable the in-loop deblocking filter per slice: the
        # reference decoder does not implement deblocking (README.md:14)
        # and bit-exact comparison requires the oracle to skip it too
        deblocking_filter_control_present_flag=1,
        transform_8x8_mode_flag=1 if transform_8x8 else 0,
        second_chroma_qp_index_offset=chroma_qp_offset if transform_8x8 else None,
    )
    return sps, pps


def encode_islice_nal(sps: SPS, pps: PPS, mbs_frame, mb_list, first_mb: int,
                      slice_id: int, *, qp_delta: int = 0, idr: bool = True,
                      frame_num: int = 0, idr_pic_id: int = 0,
                      pic_order_cnt_lsb: int = 0,
                      slice_type_code: int = 7,
                      num_ref_l0: int | None = None,
                      num_ref_l1: int | None = None,
                      deblock_disable: int = 1,
                      nal_ref_idc: int = 3,
                      pred_weight_table=None,
                      direct_spatial: int = 1,
                      mmco=None, rplm_l0=None,
                      field_pic: int = 0, bottom_field: int = 0,
                      sgmap=None) -> NalUnit:
    """Encode one slice covering `mb_list` starting at `first_mb`.

    mbs_frame: frame-wide MBState list (shared across slices for correct
    cross-slice unavailability).  slice_type_code: 7 = I, 5 = P, 6 = B.
    num_ref_l0/l1: actual list lengths (header override when they differ
    from the PPS defaults).  B slices use spatial direct."""
    from ..avc.slice_header import DeblockingFilterControl
    h = SliceHeader(
        first_mb_in_slice=first_mb,
        slice_type_code=slice_type_code,
        pic_parameter_set_id=pps.pic_parameter_set_id,
        frame_num=frame_num,
        idr_pic_id=idr_pic_id,
        pic_order_cnt_lsb=pic_order_cnt_lsb,
        slice_qp_delta=qp_delta,
        field_pic_flag=field_pic,
        bottom_field_flag=bottom_field,
        direct_spatial_mv_pred_flag=direct_spatial,
        pred_weight_table=pred_weight_table,
        deblocking=DeblockingFilterControl(disable_idc=deblock_disable),
    )
    if num_ref_l0 is not None:
        h.num_ref_idx_l0_active_minus1 = num_ref_l0 - 1
    if num_ref_l1 is not None:
        h.num_ref_idx_l1_active_minus1 = num_ref_l1 - 1
    if mmco:
        from ..avc.slice_header import DecRefPicMarking
        h.dec_ref_pic_marking = DecRefPicMarking(
            adaptive_ref_pic_marking_mode_flag=1, mmco_ops=list(mmco))
    if rplm_l0:
        h.ref_pic_list_modification_l0 = list(rplm_l0)
    w = BitWriter()
    h.write(w, sps, pps, idr, nal_ref_idc=nal_ref_idc)
    if pps.entropy_coding_mode_flag:
        w.byte_align(fill=1)  # cabac_alignment_one_bit
        init_mode = 0 if h.slice_type.is_intra else 1 + h.cabac_init_idc
        eng = CabacEncoder(h.slice_qp_y(pps), init_mode)
        coder = SliceCoder(eng, sps, pps, h, mbs_frame, slice_id)
        coder.encode_slice_data(mb_list, sgmap=sgmap)
        for b in eng.get_bits():
            w.bit(b)
        w.byte_align(fill=0)
    else:
        from ..cavlc import CavlcSliceCoder
        coder = CavlcSliceCoder(w, sps, pps, h, mbs_frame, slice_id,
                                encoding=True)
        coder.encode_slice_data(mb_list)
        w.rbsp_trailing_bits()
    rbsp = w.bytes()
    typ = NalUnitType.IDR_SLICE if idr else NalUnitType.NON_IDR_SLICE
    return NalUnit.build(nal_ref_idc, typ, rbsp)


def encode_sequence_annexb(sps: SPS, pps: PPS, frames,
                           deblock_disable: int = 1) -> bytes:
    """Assemble an IDR+P sequence.

    frames: list of (mb_list, slice_type_code, idr_flag, frame_num) or
    (..., pic_order_cnt_lsb, nal_ref_idc) 6-tuples (B support; B slices
    get one active reference per list)."""
    mb_w = sps.pic_width_in_mbs
    mb_h = sps.frame_height_in_mbs
    n = mb_w * mb_h
    nals = [
        NalUnit.build(3, NalUnitType.SPS, sps.write()),
        NalUnit.build(3, NalUnitType.PPS, pps.write()),
    ]
    nref = 0  # reference frames currently in the DPB
    for entry in frames:
        mb_list, st_code, idr, frame_num = entry[:4]
        poc_lsb = entry[4] if len(entry) > 4 else 0
        ref_idc = entry[5] if len(entry) > 5 else 3
        pwt = entry[6] if len(entry) > 6 else None
        direct_spatial = entry[7] if len(entry) > 7 else 1
        mmco = entry[8] if len(entry) > 8 else None
        rplm_l0 = entry[9] if len(entry) > 9 else None
        assert len(mb_list) == n
        mbs_frame = [None] * n
        st = st_code % 5
        nals.append(encode_islice_nal(
            sps, pps, mbs_frame, mb_list, 0, 0, idr=idr,
            frame_num=frame_num, slice_type_code=st_code,
            pic_order_cnt_lsb=poc_lsb, nal_ref_idc=ref_idc,
            num_ref_l0=(min(nref, sps.max_num_ref_frames) if st in (0, 1)
                        else None),
            num_ref_l1=min(nref, sps.max_num_ref_frames) if st == 1
            else None,
            deblock_disable=deblock_disable, pred_weight_table=pwt,
            direct_spatial=direct_spatial, mmco=mmco, rplm_l0=rplm_l0))
        if ref_idc != 0:
            nref = 1 if idr else min(nref + 1, sps.max_num_ref_frames)
    return to_annexb(nals)


def encode_frame_annexb(sps: SPS, pps: PPS, mb_rows_per_slice, mb_list,
                        **kw) -> bytes:
    """Assemble SPS+PPS+slice NALs into an Annex-B stream.

    mb_rows_per_slice: None for a single slice, else number of MB rows per
    slice (multi-slice fixture)."""
    mb_w = sps.pic_width_in_mbs
    mb_h = sps.frame_height_in_mbs
    n = mb_w * mb_h
    assert len(mb_list) == n
    nals = [
        NalUnit.build(3, NalUnitType.SPS, sps.write()),
        NalUnit.build(3, NalUnitType.PPS, pps.write()),
    ]
    mbs_frame = [None] * n
    if mb_rows_per_slice is None:
        bounds = [0, n]
    else:
        step = mb_rows_per_slice * mb_w
        bounds = list(range(0, n, step)) + [n]
    for sid in range(len(bounds) - 1):
        lo, hi = bounds[sid], bounds[sid + 1]
        nals.append(encode_islice_nal(
            sps, pps, mbs_frame, mb_list[lo:hi], lo, sid, **kw))
    return to_annexb(nals)


def encode_fmo_frame_annexb(sps, pps, mb_list, sgmap) -> bytes:
    """Assemble an FMO intra frame: one slice per slice group, each
    walking its group's MBs via the 8.2.2 map (pps.slice_groups must
    describe the same map that produced `sgmap`)."""
    n = len(mb_list)
    ngroups = int(max(sgmap)) + 1
    nals = [
        NalUnit.build(3, NalUnitType.SPS, sps.write()),
        NalUnit.build(3, NalUnitType.PPS, pps.write()),
    ]
    mbs_frame = [None] * n
    # the slice containing MB 0 must come first (first_mb_in_slice == 0
    # marks the access-unit boundary); order groups by first address
    groups = sorted(range(ngroups),
                    key=lambda g: min(a for a in range(n) if sgmap[a] == g))
    for sid, g in enumerate(groups):
        addrs = [a for a in range(n) if sgmap[a] == g]
        nals.append(encode_islice_nal(
            sps, pps, mbs_frame, [mb_list[a] for a in addrs],
            addrs[0], sid, sgmap=sgmap))
    return to_annexb(nals)


def encode_fields_annexb(sps, pps, field_entries,
                         deblock_disable: int = 1) -> bytes:
    """Assemble a PAFF sequence: each entry is one coded FIELD.

    field_entries: list of (mb_list, bottom_flag, idr, frame_num); every
    field is a standalone half-height intra picture (field_pic_flag=1).
    Requires sps.frame_mbs_only_flag == 0."""
    assert not sps.frame_mbs_only_flag
    mb_w = sps.pic_width_in_mbs
    n = mb_w * (sps.frame_height_in_mbs // 2)
    nals = [
        NalUnit.build(3, NalUnitType.SPS, sps.write()),
        NalUnit.build(3, NalUnitType.PPS, pps.write()),
    ]
    for mb_list, bottom, idr, frame_num in field_entries:
        assert len(mb_list) == n
        mbs_frame = [None] * n
        nals.append(encode_islice_nal(
            sps, pps, mbs_frame, mb_list, 0, 0, idr=idr,
            frame_num=frame_num, field_pic=1, bottom_field=bottom,
            deblock_disable=deblock_disable))
    return to_annexb(nals)
