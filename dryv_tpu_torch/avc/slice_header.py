# Copy of dryv_tpu/avc/slice_header.py.
"""Slice header (spec 7.3.3 / 7.4.3) — parse and write.

Capability parity with reference src/video/slice/header.rs: slice types,
field/MBAFF flags, POC fields, ref-idx overrides, ref-pic-list modification,
prediction weight table, dec-ref-pic marking (all 6 MMCO ops), CABAC init,
QP deltas, deblocking control, slice group change cycle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional

from ..bitio import BitReader, BitWriter
from .nal import NalUnit, NalUnitType
from .pps import PPS
from .sps import SPS


class SliceType(IntEnum):
    P = 0
    B = 1
    I = 2
    SP = 3
    SI = 4

    @classmethod
    def from_code(cls, code: int) -> "SliceType":
        return cls(code % 5)

    @property
    def is_intra(self) -> bool:
        return self in (SliceType.I, SliceType.SI)

    @property
    def is_predictive(self) -> bool:
        return self in (SliceType.P, SliceType.SP)

    @property
    def is_switching(self) -> bool:
        return self in (SliceType.SP, SliceType.SI)


@dataclass
class RefPicListModification:
    """One modification op (spec 7.3.3.1): idc 0/1 = pic_num diff, 2 = long term."""
    idc: int
    value: int


@dataclass
class PredWeight:
    weight: int
    offset: int


@dataclass
class PredWeightTable:
    luma_log2_weight_denom: int = 0
    chroma_log2_weight_denom: int = 0
    luma_l0: list = field(default_factory=list)
    chroma_l0: list = field(default_factory=list)
    luma_l1: list = field(default_factory=list)
    chroma_l1: list = field(default_factory=list)


@dataclass
class MmcoOp:
    op: int
    val1: int = 0
    val2: int = 0


@dataclass
class DecRefPicMarking:
    no_output_of_prior_pics_flag: int = 0
    long_term_reference_flag: int = 0
    adaptive_ref_pic_marking_mode_flag: int = 0
    mmco_ops: list = field(default_factory=list)


@dataclass
class DeblockingFilterControl:
    disable_idc: int = 0
    alpha_c0_offset_div2: int = 0
    beta_offset_div2: int = 0


@dataclass
class SliceHeader:
    first_mb_in_slice: int = 0
    slice_type_code: int = 7
    pic_parameter_set_id: int = 0
    colour_plane_id: int = 0
    frame_num: int = 0
    field_pic_flag: int = 0
    bottom_field_flag: int = 0
    idr_pic_id: Optional[int] = None
    pic_order_cnt_lsb: int = 0
    delta_pic_order_cnt_bottom: int = 0
    delta_pic_order_cnt: tuple = (0, 0)
    redundant_pic_cnt: int = 0
    direct_spatial_mv_pred_flag: int = 0
    num_ref_idx_l0_active_minus1: int = 0
    num_ref_idx_l1_active_minus1: int = 0
    ref_pic_list_modification_l0: Optional[list] = None
    ref_pic_list_modification_l1: Optional[list] = None
    pred_weight_table: Optional[PredWeightTable] = None
    dec_ref_pic_marking: Optional[DecRefPicMarking] = None
    cabac_init_idc: int = 0
    slice_qp_delta: int = 0
    sp_for_switch_flag: int = 0
    slice_qs_delta: int = 0
    deblocking: Optional[DeblockingFilterControl] = None
    slice_group_change_cycle: int = 0
    # bit offset just past the header (for entropy stage start)
    header_bit_len: int = 0

    @property
    def slice_type(self) -> SliceType:
        return SliceType.from_code(self.slice_type_code)

    @property
    def all_slices_same_type(self) -> bool:
        return self.slice_type_code >= 5

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, rbsp: bytes, nal: NalUnit, sps: SPS, pps: PPS) -> "SliceHeader":
        r = BitReader(rbsp)
        h = cls()
        idr = nal.type == NalUnitType.IDR_SLICE
        h.first_mb_in_slice = r.ue()
        h.slice_type_code = r.ue()
        st = h.slice_type
        h.pic_parameter_set_id = r.ue()
        if sps.separate_colour_plane_flag:
            h.colour_plane_id = r.bits(2)
        h.frame_num = r.bits(sps.log2_max_frame_num_minus4 + 4)
        if not sps.frame_mbs_only_flag:
            h.field_pic_flag = r.bit()
            if h.field_pic_flag:
                h.bottom_field_flag = r.bit()
        if idr:
            h.idr_pic_id = r.ue()
        if sps.pic_order_cnt_type == 0:
            h.pic_order_cnt_lsb = r.bits(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
            if pps.bottom_field_pic_order_in_frame_present_flag and not h.field_pic_flag:
                h.delta_pic_order_cnt_bottom = r.se()
        elif sps.pic_order_cnt_type == 1 and sps.poc_type1 and \
                not sps.poc_type1.delta_pic_order_always_zero_flag:
            d0 = r.se()
            d1 = 0
            if pps.bottom_field_pic_order_in_frame_present_flag and not h.field_pic_flag:
                d1 = r.se()
            h.delta_pic_order_cnt = (d0, d1)
        if pps.redundant_pic_cnt_present_flag:
            h.redundant_pic_cnt = r.ue()
        if st == SliceType.B:
            h.direct_spatial_mv_pred_flag = r.bit()
        h.num_ref_idx_l0_active_minus1 = pps.num_ref_idx_l0_default_active_minus1
        h.num_ref_idx_l1_active_minus1 = pps.num_ref_idx_l1_default_active_minus1
        if st in (SliceType.P, SliceType.SP, SliceType.B):
            if r.bit():  # num_ref_idx_active_override_flag
                h.num_ref_idx_l0_active_minus1 = r.ue()
                if st == SliceType.B:
                    h.num_ref_idx_l1_active_minus1 = r.ue()
        if nal.type in (NalUnitType.SLICE_EXTENSION,
                        NalUnitType.DEPTH_SLICE_EXTENSION):
            raise NotImplementedError("MVC ref_pic_list_mvc_modification")
        # ref_pic_list_modification (7.3.3.1)
        if not st.is_intra:
            h.ref_pic_list_modification_l0 = cls._parse_rplm(r)
        if st == SliceType.B:
            h.ref_pic_list_modification_l1 = cls._parse_rplm(r)
        # pred_weight_table (7.3.3.2)
        if (pps.weighted_pred_flag and st.is_predictive) or \
                (pps.weighted_bipred_idc == 1 and st == SliceType.B):
            h.pred_weight_table = cls._parse_pwt(
                r, sps, st, h.num_ref_idx_l0_active_minus1,
                h.num_ref_idx_l1_active_minus1)
        # dec_ref_pic_marking (7.3.3.3)
        if nal.ref_idc != 0:
            h.dec_ref_pic_marking = cls._parse_drpm(r, idr)
        if pps.entropy_coding_mode_flag and not st.is_intra:
            h.cabac_init_idc = r.ue()
        h.slice_qp_delta = r.se()
        if st.is_switching:
            if st == SliceType.SP:
                h.sp_for_switch_flag = r.bit()
            h.slice_qs_delta = r.se()
        if pps.deblocking_filter_control_present_flag:
            d = DeblockingFilterControl()
            d.disable_idc = r.ue()
            if d.disable_idc != 1:
                d.alpha_c0_offset_div2 = r.se()
                d.beta_offset_div2 = r.se()
            h.deblocking = d
        if pps.slice_groups is not None and pps.slice_groups.map_type in (3, 4, 5):
            pic_size_in_map_units = sps.pic_width_in_mbs * sps.pic_height_in_map_units
            rate = pps.slice_groups.change_rate_minus1 + 1
            bits = math.ceil(math.log2(pic_size_in_map_units / rate + 1))
            h.slice_group_change_cycle = r.bits(bits)
        h.header_bit_len = r.pos
        return h

    @staticmethod
    def _parse_rplm(r: BitReader):
        if not r.bit():  # ref_pic_list_modification_flag
            return None
        ops = []
        while True:
            idc = r.ue()
            if idc == 3:
                break
            ops.append(RefPicListModification(idc, r.ue()))
        return ops

    @staticmethod
    def _parse_pwt(r: BitReader, sps: SPS, st: SliceType, n0: int, n1: int):
        t = PredWeightTable()
        t.luma_log2_weight_denom = r.ue()
        if sps.chroma_array_type != 0:
            t.chroma_log2_weight_denom = r.ue()

        def read_list(n):
            luma, chroma = [], []
            for _ in range(n + 1):
                if r.bit():
                    luma.append(PredWeight(r.se(), r.se()))
                else:
                    luma.append(None)
                if sps.chroma_array_type != 0:
                    if r.bit():
                        chroma.append((PredWeight(r.se(), r.se()),
                                       PredWeight(r.se(), r.se())))
                    else:
                        chroma.append(None)
            return luma, chroma

        t.luma_l0, t.chroma_l0 = read_list(n0)
        if st == SliceType.B:
            t.luma_l1, t.chroma_l1 = read_list(n1)
        return t

    @staticmethod
    def _parse_drpm(r: BitReader, idr: bool):
        m = DecRefPicMarking()
        if idr:
            m.no_output_of_prior_pics_flag = r.bit()
            m.long_term_reference_flag = r.bit()
        else:
            m.adaptive_ref_pic_marking_mode_flag = r.bit()
            if m.adaptive_ref_pic_marking_mode_flag:
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    o = MmcoOp(op)
                    if op in (1, 3):
                        o.val1 = r.ue()  # difference_of_pic_nums_minus1
                    if op == 2:
                        o.val1 = r.ue()  # long_term_pic_num
                    if op == 3:
                        o.val2 = r.ue()  # long_term_frame_idx
                    if op == 4:
                        o.val1 = r.ue()  # max_long_term_frame_idx_plus1
                    if op == 6:
                        o.val1 = r.ue()  # long_term_frame_idx
                    m.mmco_ops.append(o)
        return m

    # ------------------------------------------------------------------
    def write(self, w: BitWriter, sps: SPS, pps: PPS, idr: bool, nal_ref_idc: int):
        """Write an (intra) slice header for fixture generation."""
        w.ue(self.first_mb_in_slice)
        w.ue(self.slice_type_code)
        w.ue(self.pic_parameter_set_id)
        w.bits(self.frame_num, sps.log2_max_frame_num_minus4 + 4)
        if not sps.frame_mbs_only_flag:
            w.bit(self.field_pic_flag)
            if self.field_pic_flag:
                w.bit(self.bottom_field_flag)
        if idr:
            w.ue(self.idr_pic_id or 0)
        if sps.pic_order_cnt_type == 0:
            w.bits(self.pic_order_cnt_lsb, sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
            if pps.bottom_field_pic_order_in_frame_present_flag and not self.field_pic_flag:
                w.se(self.delta_pic_order_cnt_bottom)
        st = self.slice_type
        assert st in (SliceType.I, SliceType.P, SliceType.B), \
            "fixture writer emits I/P/B slices"
        if st == SliceType.B:
            w.bit(self.direct_spatial_mv_pred_flag)
        if st in (SliceType.P, SliceType.B):
            override = (self.num_ref_idx_l0_active_minus1
                        != pps.num_ref_idx_l0_default_active_minus1) or \
                (st == SliceType.B and self.num_ref_idx_l1_active_minus1
                 != pps.num_ref_idx_l1_default_active_minus1)
            w.bit(1 if override else 0)  # num_ref_idx_active_override_flag
            if override:
                w.ue(self.num_ref_idx_l0_active_minus1)
                if st == SliceType.B:
                    w.ue(self.num_ref_idx_l1_active_minus1)
            for mods, cond in ((self.ref_pic_list_modification_l0, True),
                               (self.ref_pic_list_modification_l1,
                                st == SliceType.B)):
                if not cond:
                    continue
                if not mods:
                    w.bit(0)  # ref_pic_list_modification_flag
                else:
                    w.bit(1)
                    for op in mods:
                        w.ue(op.idc)
                        w.ue(op.value)
                    w.ue(3)  # end of modification ops
        if (pps.weighted_pred_flag and st == SliceType.P) or \
                (pps.weighted_bipred_idc == 1 and st == SliceType.B):
            t = self.pred_weight_table or PredWeightTable()
            w.ue(t.luma_log2_weight_denom)
            if sps.chroma_array_type != 0:
                w.ue(t.chroma_log2_weight_denom)

            def wlist(luma, chroma, n):
                for i in range(n + 1):
                    e = luma[i] if i < len(luma) else None
                    if e is None:
                        w.bit(0)
                    else:
                        w.bit(1)
                        w.se(e.weight)
                        w.se(e.offset)
                    if sps.chroma_array_type != 0:
                        ce = chroma[i] if i < len(chroma) else None
                        if ce is None:
                            w.bit(0)
                        else:
                            w.bit(1)
                            for pw in ce:
                                w.se(pw.weight)
                                w.se(pw.offset)
            wlist(t.luma_l0, t.chroma_l0, self.num_ref_idx_l0_active_minus1)
            if st == SliceType.B:
                wlist(t.luma_l1, t.chroma_l1,
                      self.num_ref_idx_l1_active_minus1)
        if nal_ref_idc != 0:
            if idr:
                w.bit(self.dec_ref_pic_marking.no_output_of_prior_pics_flag
                      if self.dec_ref_pic_marking else 0)
                w.bit(self.dec_ref_pic_marking.long_term_reference_flag
                      if self.dec_ref_pic_marking else 0)
            else:
                m = self.dec_ref_pic_marking
                if m is None or not m.adaptive_ref_pic_marking_mode_flag:
                    w.bit(0)  # adaptive_ref_pic_marking_mode_flag
                else:
                    w.bit(1)
                    for op in m.mmco_ops:
                        w.ue(op.op)
                        if op.op in (1, 2, 4, 6):
                            w.ue(op.val1)
                        elif op.op == 3:
                            w.ue(op.val1)
                            w.ue(op.val2)
                    w.ue(0)  # end of MMCO ops
        if pps.entropy_coding_mode_flag and st in (SliceType.P, SliceType.B):
            w.ue(self.cabac_init_idc)
        w.se(self.slice_qp_delta)
        if pps.deblocking_filter_control_present_flag:
            d = self.deblocking or DeblockingFilterControl()
            w.ue(d.disable_idc)
            if d.disable_idc != 1:
                w.se(d.alpha_c0_offset_div2)
                w.se(d.beta_offset_div2)

    # -- derived values ------------------------------------------------
    def slice_qp_y(self, pps: PPS) -> int:
        return 26 + pps.pic_init_qp_minus26 + self.slice_qp_delta

    def mbaff_frame_flag(self, sps: SPS) -> int:
        return int(sps.mb_adaptive_frame_field_flag and not self.field_pic_flag)
