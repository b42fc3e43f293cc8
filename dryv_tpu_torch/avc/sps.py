# Copy of dryv_tpu/avc/sps.py.
"""Sequence parameter set (spec 7.3.2.1 / 7.4.2.1) — parse and write.

Capability parity with reference src/video/atom/avcc/sps.rs (profiles,
chroma formats, scaling lists with fallback rules, POC types 0/1/2, frame
cropping) plus the write direction for fixture generation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..bitio import BitReader, BitWriter
from ..cabac.tables import (
    DEFAULT_4X4_INTER,
    DEFAULT_4X4_INTRA,
    DEFAULT_8X8_INTER,
    DEFAULT_8X8_INTRA,
)
from .vui import VuiParameters

HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)

FLAT_16 = np.full(16, 16, dtype=np.int32)
FLAT_64 = np.full(64, 16, dtype=np.int32)


def parse_scaling_list(r: BitReader, size: int):
    """spec 7.3.2.1.1.1: returns (list | None, use_default).

    The returned list is in *zig-zag* order as coded; callers de-zigzag."""
    last, next_ = 8, 8
    out = np.zeros(size, dtype=np.int32)
    use_default = False
    for j in range(size):
        if next_ != 0:
            delta = r.se()
            next_ = (last + delta + 256) % 256
            if j == 0 and next_ == 0:
                use_default = True
        val = last if next_ == 0 else next_
        out[j] = val
        last = val
    return out, use_default


def write_scaling_list(w: BitWriter, values, use_default: bool):
    if use_default:
        w.se(-8)  # makes nextScale 0 at j == 0 → use-default signal
        return
    last = 8
    for v in values:
        delta = (int(v) - last) % 256
        if delta > 127:
            delta -= 256
        w.se(delta)
        last = int(v)


@dataclass
class ScalingLists:
    """Resolved 4x4[6][16] and 8x8[6][64] weight lists, **zigzag scan
    order** (as coded; Table 7-3 defaults are specified in this order).
    Consumers de-zigzag to raster before building LevelScale tables."""
    l4x4: np.ndarray = field(default_factory=lambda: np.tile(FLAT_16, (6, 1)))
    l8x8: np.ndarray = field(default_factory=lambda: np.tile(FLAT_64, (6, 1)))


# zig-zag orders (spec 8.5.6 / 8.5.7), generated algorithmically.
def _zigzag(n: int) -> np.ndarray:
    # walk anti-diagonals, alternating direction (up-right on even diagonals)
    coords = []
    for d in range(2 * n - 1):
        rng = range(max(0, d - n + 1), min(d, n - 1) + 1)
        diag = [(i, d - i) for i in rng]  # (row, col)
        if d % 2 == 0:
            diag = diag[::-1]  # up-right: start from bottom of diagonal
        coords.extend(diag)
    return np.array([r * n + c for r, c in coords], dtype=np.int32)


ZIGZAG_4X4 = _zigzag(4)
ZIGZAG_8X8 = _zigzag(8)

# Alternate ("field") coefficient scans, spec Tables 8-9 / 8-10: applied
# to all scanned blocks of field-coded macroblocks (8.5.6).  Entries are
# raster indices in coded-scan order.
FIELDSCAN_4X4 = np.array(
    [0, 4, 1, 8, 12, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15], dtype=np.int64)
FIELDSCAN_8X8 = np.array([
    0, 8, 16, 1, 9, 24, 32, 17, 2, 25, 40, 48,
    56, 33, 10, 3, 18, 41, 49, 57, 26, 11, 4, 19,
    34, 42, 50, 58, 27, 12, 5, 20, 35, 43, 51, 59,
    28, 13, 6, 21, 36, 44, 52, 60, 29, 14, 22, 37,
    45, 53, 61, 30, 7, 15, 38, 46, 54, 62, 23, 31,
    39, 47, 55, 63], dtype=np.int64)


def dezigzag(zz_values: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros_like(zz_values)
    order = ZIGZAG_4X4 if n == 4 else ZIGZAG_8X8
    out[order] = zz_values
    return out


def zigzag(raster_values: np.ndarray, n: int) -> np.ndarray:
    order = ZIGZAG_4X4 if n == 4 else ZIGZAG_8X8
    return raster_values[order]


def resolve_scaling_lists(present4, lists4, present8, lists8,
                          fallback4, fallback8) -> ScalingLists:
    """Fallback rules A/B (spec Table 7-2; reference sps.rs:206-249).

    present*/lists*: per-index (coded?, (zigzag values | None, use_default)).
    fallback4/fallback8: the rule-A fallback heads (defaults or flat)."""
    out4 = np.zeros((6, 16), dtype=np.int32)
    out8 = np.zeros((6, 64), dtype=np.int32)
    for i in range(6):
        if not present4[i] or lists4[i] is None:
            if i == 0:
                out4[i] = fallback4[0]
            elif i == 3:
                out4[i] = fallback4[1]
            else:
                out4[i] = out4[i - 1]
        else:
            vals, use_def = lists4[i]
            if use_def:
                out4[i] = DEFAULT_4X4_INTRA if i < 3 else DEFAULT_4X4_INTER
            else:
                out4[i] = vals
    for i in range(6):
        if not present8[i] or lists8[i] is None:
            if i == 0:
                out8[i] = fallback8[0]
            elif i == 1:
                out8[i] = fallback8[1]
            else:
                out8[i] = out8[i - 2]
        else:
            vals, use_def = lists8[i]
            if use_def:
                out8[i] = DEFAULT_8X8_INTRA if i % 2 == 0 else DEFAULT_8X8_INTER
            else:
                out8[i] = vals
    return ScalingLists(out4, out8)


@dataclass
class PocType1:
    delta_pic_order_always_zero_flag: int = 0
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: list = field(default_factory=list)


@dataclass
class FrameCropping:
    left: int = 0
    right: int = 0
    top: int = 0
    bottom: int = 0


@dataclass
class SPS:
    profile_idc: int = 66
    constraint_set_flags: int = 0
    level_idc: int = 30
    seq_parameter_set_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane_flag: int = 0
    bit_depth_luma_minus8: int = 0
    bit_depth_chroma_minus8: int = 0
    qpprime_y_zero_transform_bypass_flag: int = 0
    seq_scaling_matrix_present_flag: int = 0
    seq_scaling_lists: Optional[ScalingLists] = None
    log2_max_frame_num_minus4: int = 0
    pic_order_cnt_type: int = 2
    log2_max_pic_order_cnt_lsb_minus4: int = 0
    poc_type1: Optional[PocType1] = None
    max_num_ref_frames: int = 1
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width_in_mbs_minus1: int = 0
    pic_height_in_map_units_minus1: int = 0
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 1
    frame_cropping: Optional[FrameCropping] = None
    vui: Optional[VuiParameters] = None

    # ------------------------------------------------------------------
    @property
    def chroma_array_type(self) -> int:
        return 0 if self.separate_colour_plane_flag else self.chroma_format_idc

    @property
    def pic_width_in_mbs(self) -> int:
        return self.pic_width_in_mbs_minus1 + 1

    @property
    def pic_height_in_map_units(self) -> int:
        return self.pic_height_in_map_units_minus1 + 1

    @property
    def frame_height_in_mbs(self) -> int:
        return (2 - self.frame_mbs_only_flag) * self.pic_height_in_map_units

    @property
    def width(self) -> int:
        w = self.pic_width_in_mbs * 16
        if self.frame_cropping:
            sub_w = {0: 1, 1: 2, 2: 2, 3: 1}[self.chroma_array_type]
            w -= sub_w * (self.frame_cropping.left + self.frame_cropping.right)
        return w

    @property
    def height(self) -> int:
        h = self.frame_height_in_mbs * 16
        if self.frame_cropping:
            sub_h = {0: 1, 1: 2, 2: 1, 3: 1}[self.chroma_array_type]
            h -= sub_h * (2 - self.frame_mbs_only_flag) * (
                self.frame_cropping.top + self.frame_cropping.bottom)
        return h

    @property
    def max_frame_num(self) -> int:
        return 1 << (self.log2_max_frame_num_minus4 + 4)

    @property
    def max_pic_order_cnt_lsb(self) -> int:
        return 1 << (self.log2_max_pic_order_cnt_lsb_minus4 + 4)

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, rbsp: bytes) -> "SPS":
        r = BitReader(rbsp)
        s = cls()
        s.profile_idc = r.bits(8)
        s.constraint_set_flags = r.bits(8)
        s.level_idc = r.bits(8)
        s.seq_parameter_set_id = r.ue()
        if s.profile_idc in HIGH_PROFILES:
            s.chroma_format_idc = r.ue()
            if s.chroma_format_idc == 3:
                s.separate_colour_plane_flag = r.bit()
            s.bit_depth_luma_minus8 = r.ue()
            s.bit_depth_chroma_minus8 = r.ue()
            s.qpprime_y_zero_transform_bypass_flag = r.bit()
            s.seq_scaling_matrix_present_flag = r.bit()
            if s.seq_scaling_matrix_present_flag:
                n8 = 6 if s.chroma_format_idc == 3 else 2
                present4, lists4 = [], []
                present8, lists8 = [], []
                for i in range(6):
                    p = r.bit()
                    present4.append(p)
                    lists4.append(parse_scaling_list(r, 16) if p else None)
                for i in range(n8):
                    p = r.bit()
                    present8.append(p)
                    lists8.append(parse_scaling_list(r, 64) if p else None)
                present8 += [0] * (6 - n8)
                lists8 += [None] * (6 - n8)
                s.seq_scaling_lists = resolve_scaling_lists(
                    present4, lists4, present8, lists8,
                    (DEFAULT_4X4_INTRA, DEFAULT_4X4_INTER),
                    (DEFAULT_8X8_INTRA, DEFAULT_8X8_INTER))
        s.log2_max_frame_num_minus4 = r.ue()
        s.pic_order_cnt_type = r.ue()
        if s.pic_order_cnt_type == 0:
            s.log2_max_pic_order_cnt_lsb_minus4 = r.ue()
        elif s.pic_order_cnt_type == 1:
            p = PocType1()
            p.delta_pic_order_always_zero_flag = r.bit()
            p.offset_for_non_ref_pic = r.se()
            p.offset_for_top_to_bottom_field = r.se()
            n = r.ue()
            p.offset_for_ref_frame = [r.se() for _ in range(n)]
            s.poc_type1 = p
        s.max_num_ref_frames = r.ue()
        s.gaps_in_frame_num_value_allowed_flag = r.bit()
        s.pic_width_in_mbs_minus1 = r.ue()
        s.pic_height_in_map_units_minus1 = r.ue()
        s.frame_mbs_only_flag = r.bit()
        if not s.frame_mbs_only_flag:
            s.mb_adaptive_frame_field_flag = r.bit()
        s.direct_8x8_inference_flag = r.bit()
        if r.bit():  # frame_cropping_flag
            s.frame_cropping = FrameCropping(r.ue(), r.ue(), r.ue(), r.ue())
        if r.bit():  # vui_parameters_present_flag
            s.vui = VuiParameters.parse(r)
        return s

    def write(self) -> bytes:
        w = BitWriter()
        w.bits(self.profile_idc, 8)
        w.bits(self.constraint_set_flags, 8)
        w.bits(self.level_idc, 8)
        w.ue(self.seq_parameter_set_id)
        if self.profile_idc in HIGH_PROFILES:
            w.ue(self.chroma_format_idc)
            if self.chroma_format_idc == 3:
                w.bit(self.separate_colour_plane_flag)
            w.ue(self.bit_depth_luma_minus8)
            w.ue(self.bit_depth_chroma_minus8)
            w.bit(self.qpprime_y_zero_transform_bypass_flag)
            if self.seq_scaling_matrix_present_flag and \
                    self.seq_scaling_lists is not None:
                w.bit(1)
                sl = self.seq_scaling_lists
                n8 = 6 if self.chroma_format_idc == 3 else 2
                for i in range(6):
                    w.bit(1)
                    write_scaling_list(w, sl.l4x4[i], False)
                for i in range(n8):
                    w.bit(1)
                    write_scaling_list(w, sl.l8x8[i], False)
            else:
                w.bit(0)  # seq_scaling_matrix_present_flag
        w.ue(self.log2_max_frame_num_minus4)
        w.ue(self.pic_order_cnt_type)
        if self.pic_order_cnt_type == 0:
            w.ue(self.log2_max_pic_order_cnt_lsb_minus4)
        elif self.pic_order_cnt_type == 1:
            p = self.poc_type1 or PocType1()
            w.bit(p.delta_pic_order_always_zero_flag)
            w.se(p.offset_for_non_ref_pic)
            w.se(p.offset_for_top_to_bottom_field)
            w.ue(len(p.offset_for_ref_frame))
            for v in p.offset_for_ref_frame:
                w.se(v)
        w.ue(self.max_num_ref_frames)
        w.bit(self.gaps_in_frame_num_value_allowed_flag)
        w.ue(self.pic_width_in_mbs_minus1)
        w.ue(self.pic_height_in_map_units_minus1)
        w.bit(self.frame_mbs_only_flag)
        if not self.frame_mbs_only_flag:
            w.bit(self.mb_adaptive_frame_field_flag)
        w.bit(self.direct_8x8_inference_flag)
        if self.frame_cropping:
            w.bit(1)
            w.ue(self.frame_cropping.left)
            w.ue(self.frame_cropping.right)
            w.ue(self.frame_cropping.top)
            w.ue(self.frame_cropping.bottom)
        else:
            w.bit(0)
        w.bit(0)  # vui_parameters_present_flag
        w.rbsp_trailing_bits()
        return w.bytes()
