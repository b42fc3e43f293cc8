# Copy of dryv_tpu/avc/vui.py.
"""VUI parameters (spec Annex E) — parse-only; fixtures don't emit VUI.

Capability parity with reference src/video/atom/avcc/vui.rs: aspect ratio
(incl. extended SAR), overscan, video signal type + colour description,
chroma sample loc, timing, NAL/VCL HRD, bitstream restriction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..bitio import BitReader

EXTENDED_SAR = 255


@dataclass
class HrdParameters:
    cpb_cnt_minus1: int = 0
    bit_rate_scale: int = 0
    cpb_size_scale: int = 0
    bit_rate_value_minus1: list = field(default_factory=list)
    cpb_size_value_minus1: list = field(default_factory=list)
    cbr_flag: list = field(default_factory=list)
    initial_cpb_removal_delay_length_minus1: int = 0
    cpb_removal_delay_length_minus1: int = 0
    dpb_output_delay_length_minus1: int = 0
    time_offset_length: int = 0

    @classmethod
    def parse(cls, r: BitReader) -> "HrdParameters":
        h = cls()
        h.cpb_cnt_minus1 = r.ue()
        h.bit_rate_scale = r.bits(4)
        h.cpb_size_scale = r.bits(4)
        for _ in range(h.cpb_cnt_minus1 + 1):
            h.bit_rate_value_minus1.append(r.ue())
            h.cpb_size_value_minus1.append(r.ue())
            h.cbr_flag.append(r.bit())
        h.initial_cpb_removal_delay_length_minus1 = r.bits(5)
        h.cpb_removal_delay_length_minus1 = r.bits(5)
        h.dpb_output_delay_length_minus1 = r.bits(5)
        h.time_offset_length = r.bits(5)
        return h


@dataclass
class VuiParameters:
    sar_width: int = 0
    sar_height: int = 0
    overscan_appropriate_flag: Optional[int] = None
    video_format: int = 5
    video_full_range_flag: int = 0
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    chroma_sample_loc_type_top_field: int = 0
    chroma_sample_loc_type_bottom_field: int = 0
    num_units_in_tick: Optional[int] = None
    time_scale: Optional[int] = None
    fixed_frame_rate_flag: int = 0
    nal_hrd: Optional[HrdParameters] = None
    vcl_hrd: Optional[HrdParameters] = None
    low_delay_hrd_flag: int = 0
    pic_struct_present_flag: int = 0
    bitstream_restriction: Optional[dict] = None

    @classmethod
    def parse(cls, r: BitReader) -> "VuiParameters":
        v = cls()
        if r.bit():  # aspect_ratio_info_present
            idc = r.bits(8)
            if idc == EXTENDED_SAR:
                v.sar_width = r.bits(16)
                v.sar_height = r.bits(16)
            else:
                # Table E-1 sample aspect ratios
                table = [(0, 0), (1, 1), (12, 11), (10, 11), (16, 11),
                         (40, 33), (24, 11), (20, 11), (32, 11), (80, 33),
                         (18, 11), (15, 11), (64, 33), (160, 99), (4, 3),
                         (3, 2), (2, 1)]
                v.sar_width, v.sar_height = table[idc] if idc < len(table) else (0, 0)
        if r.bit():  # overscan_info_present
            v.overscan_appropriate_flag = r.bit()
        if r.bit():  # video_signal_type_present
            v.video_format = r.bits(3)
            v.video_full_range_flag = r.bit()
            if r.bit():  # colour_description_present
                v.colour_primaries = r.bits(8)
                v.transfer_characteristics = r.bits(8)
                v.matrix_coefficients = r.bits(8)
        if r.bit():  # chroma_loc_info_present
            v.chroma_sample_loc_type_top_field = r.ue()
            v.chroma_sample_loc_type_bottom_field = r.ue()
        if r.bit():  # timing_info_present
            v.num_units_in_tick = r.bits(32)
            v.time_scale = r.bits(32)
            v.fixed_frame_rate_flag = r.bit()
        nal_hrd_present = r.bit()
        if nal_hrd_present:
            v.nal_hrd = HrdParameters.parse(r)
        vcl_hrd_present = r.bit()
        if vcl_hrd_present:
            v.vcl_hrd = HrdParameters.parse(r)
        if nal_hrd_present or vcl_hrd_present:
            v.low_delay_hrd_flag = r.bit()
        v.pic_struct_present_flag = r.bit()
        if r.bit():  # bitstream_restriction
            v.bitstream_restriction = {
                "motion_vectors_over_pic_boundaries_flag": r.bit(),
                "max_bytes_per_pic_denom": r.ue(),
                "max_bits_per_mb_denom": r.ue(),
                "log2_max_mv_length_horizontal": r.ue(),
                "log2_max_mv_length_vertical": r.ue(),
                "max_num_reorder_frames": r.ue(),
                "max_dec_frame_buffering": r.ue(),
            }
        return v
