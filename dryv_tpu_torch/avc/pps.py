# Copy of dryv_tpu/avc/pps.py.
"""Picture parameter set (spec 7.3.2.2) — parse and write.

Capability parity with reference src/video/atom/avcc/pps.rs: entropy mode
switch, slice groups (FMO, all 7 map types incl. box-out), weighted pred,
and the high-profile extra RBSP (transform_8x8_mode, pic scaling matrix,
second_chroma_qp_index_offset).
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
from .sps import (
    SPS,
    FLAT_16,
    FLAT_64,
    ScalingLists,
    parse_scaling_list,
    resolve_scaling_lists,
    write_scaling_list,
)


@dataclass
class SliceGroups:
    """FMO map description (PPS part); sgmap derivation lives in slice_map.py."""
    num_slice_groups: int = 1
    map_type: int = 0
    run_length_minus1: list = field(default_factory=list)       # type 0
    top_left: list = field(default_factory=list)                # type 2
    bottom_right: list = field(default_factory=list)            # type 2
    change_direction_flag: int = 0                              # types 3-5
    change_rate_minus1: int = 0                                 # types 3-5
    explicit_ids: list = field(default_factory=list)            # type 6


@dataclass
class PPS:
    pic_parameter_set_id: int = 0
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 1  # 1 = CABAC
    bottom_field_pic_order_in_frame_present_flag: int = 0
    slice_groups: Optional[SliceGroups] = None
    num_ref_idx_l0_default_active_minus1: int = 0
    num_ref_idx_l1_default_active_minus1: int = 0
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp_minus26: int = 0
    pic_init_qs_minus26: int = 0
    chroma_qp_index_offset: int = 0
    deblocking_filter_control_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    # extra rbsp (high profile)
    transform_8x8_mode_flag: int = 0
    pic_scaling_matrix_present_flag: int = 0
    pic_scaling_lists: Optional[ScalingLists] = None
    second_chroma_qp_index_offset: Optional[int] = None

    @property
    def second_chroma_qp_offset(self) -> int:
        return (self.second_chroma_qp_index_offset
                if self.second_chroma_qp_index_offset is not None
                else self.chroma_qp_index_offset)

    @classmethod
    def parse(cls, rbsp: bytes, sps: Optional[SPS] = None) -> "PPS":
        r = BitReader(rbsp)
        p = cls()
        p.pic_parameter_set_id = r.ue()
        p.seq_parameter_set_id = r.ue()
        p.entropy_coding_mode_flag = r.bit()
        p.bottom_field_pic_order_in_frame_present_flag = r.bit()
        num_slice_groups = r.ue() + 1
        if num_slice_groups > 1:
            sg = SliceGroups(num_slice_groups=num_slice_groups)
            sg.map_type = r.ue()
            if sg.map_type == 0:
                sg.run_length_minus1 = [r.ue() for _ in range(num_slice_groups)]
            elif sg.map_type == 2:
                for _ in range(num_slice_groups - 1):
                    sg.top_left.append(r.ue())
                    sg.bottom_right.append(r.ue())
            elif sg.map_type in (3, 4, 5):
                sg.change_direction_flag = r.bit()
                sg.change_rate_minus1 = r.ue()
            elif sg.map_type == 6:
                n = r.ue() + 1
                import math
                bits = max(1, math.ceil(math.log2(num_slice_groups)))
                sg.explicit_ids = [r.bits(bits) for _ in range(n)]
            p.slice_groups = sg
        p.num_ref_idx_l0_default_active_minus1 = r.ue()
        p.num_ref_idx_l1_default_active_minus1 = r.ue()
        p.weighted_pred_flag = r.bit()
        p.weighted_bipred_idc = r.bits(2)
        p.pic_init_qp_minus26 = r.se()
        p.pic_init_qs_minus26 = r.se()
        p.chroma_qp_index_offset = r.se()
        p.deblocking_filter_control_present_flag = r.bit()
        p.constrained_intra_pred_flag = r.bit()
        p.redundant_pic_cnt_present_flag = r.bit()
        if r.more_rbsp_data():
            p.transform_8x8_mode_flag = r.bit()
            p.pic_scaling_matrix_present_flag = r.bit()
            if p.pic_scaling_matrix_present_flag:
                chroma_fmt = sps.chroma_format_idc if sps else 1
                n8 = (6 if chroma_fmt == 3 else 2) if p.transform_8x8_mode_flag else 0
                present4, lists4, present8, lists8 = [], [], [], []
                for i in range(6):
                    pr = r.bit()
                    present4.append(pr)
                    lists4.append(parse_scaling_list(r, 16) if pr else None)
                for i in range(n8):
                    pr = r.bit()
                    present8.append(pr)
                    lists8.append(parse_scaling_list(r, 64) if pr else None)
                present8 += [0] * (6 - n8)
                lists8 += [None] * (6 - n8)
                # fallback rule B when SPS lists exist, rule A otherwise
                if sps is not None and sps.seq_scaling_lists is not None:
                    f4 = (sps.seq_scaling_lists.l4x4[0], sps.seq_scaling_lists.l4x4[3])
                    f8 = (sps.seq_scaling_lists.l8x8[0], sps.seq_scaling_lists.l8x8[1])
                else:
                    f4 = (DEFAULT_4X4_INTRA, DEFAULT_4X4_INTER)
                    f8 = (DEFAULT_8X8_INTRA, DEFAULT_8X8_INTER)
                p.pic_scaling_lists = resolve_scaling_lists(
                    present4, lists4, present8, lists8, f4, f8)
            p.second_chroma_qp_index_offset = r.se()
        return p

    def write(self) -> bytes:
        w = BitWriter()
        w.ue(self.pic_parameter_set_id)
        w.ue(self.seq_parameter_set_id)
        w.bit(self.entropy_coding_mode_flag)
        w.bit(self.bottom_field_pic_order_in_frame_present_flag)
        if self.slice_groups:
            sg = self.slice_groups
            w.ue(sg.num_slice_groups - 1)
            w.ue(sg.map_type)
            if sg.map_type == 0:
                for v in sg.run_length_minus1:
                    w.ue(v)
            elif sg.map_type == 2:
                for tl, br in zip(sg.top_left, sg.bottom_right):
                    w.ue(tl)
                    w.ue(br)
            elif sg.map_type in (3, 4, 5):
                w.bit(sg.change_direction_flag)
                w.ue(sg.change_rate_minus1)
            elif sg.map_type == 6:
                import math
                w.ue(len(sg.explicit_ids) - 1)
                bits = max(1, math.ceil(math.log2(sg.num_slice_groups)))
                for v in sg.explicit_ids:
                    w.bits(v, bits)
        else:
            w.ue(0)
        w.ue(self.num_ref_idx_l0_default_active_minus1)
        w.ue(self.num_ref_idx_l1_default_active_minus1)
        w.bit(self.weighted_pred_flag)
        w.bits(self.weighted_bipred_idc, 2)
        w.se(self.pic_init_qp_minus26)
        w.se(self.pic_init_qs_minus26)
        w.se(self.chroma_qp_index_offset)
        w.bit(self.deblocking_filter_control_present_flag)
        w.bit(self.constrained_intra_pred_flag)
        w.bit(self.redundant_pic_cnt_present_flag)
        if self.transform_8x8_mode_flag \
                or self.second_chroma_qp_index_offset is not None \
                or self.pic_scaling_matrix_present_flag:
            w.bit(self.transform_8x8_mode_flag)
            if self.pic_scaling_matrix_present_flag and \
                    self.pic_scaling_lists is not None:
                w.bit(1)
                sl = self.pic_scaling_lists
                # 4:4:4 not supported by the writer; n8 per 7.3.2.2
                n8 = 2 if self.transform_8x8_mode_flag else 0
                for i in range(6):
                    w.bit(1)
                    write_scaling_list(w, sl.l4x4[i], False)
                for i in range(n8):
                    w.bit(1)
                    write_scaling_list(w, sl.l8x8[i], False)
            else:
                w.bit(0)  # pic_scaling_matrix_present_flag
            w.se(self.second_chroma_qp_offset)
        w.rbsp_trailing_bits()
        return w.bytes()

    def resolve_active_scaling_lists(self, sps: SPS) -> ScalingLists:
        """Active weight matrices: PPS overrides SPS, flat-16 fallback
        (reference header.rs:317-332)."""
        if self.pic_scaling_lists is not None:
            return self.pic_scaling_lists
        if sps.seq_scaling_lists is not None:
            return sps.seq_scaling_lists
        return ScalingLists(np.tile(FLAT_16, (6, 1)), np.tile(FLAT_64, (6, 1)))
