# Copy of dryv_tpu/avc/dpb.py.
"""Decoded picture buffer bookkeeping (spec 8.2.1, 8.2.4, 8.2.5).

Behavioural mirror of reference src/video/slice/dpb.rs (860 LoC): picture
order count types 0/1/2, reference picture list construction for P/B with
modification, and decoded reference picture marking (IDR, all six MMCO
ops, sliding window).  Like the reference's `Picture` (dpb.rs:802-815),
entries track POC/marking metadata; pixel storage lives with the frame
pipeline (sharded HBM planes), not here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .slice_header import SliceHeader, SliceType
from .sps import SPS
from .nal import NalUnit, NalUnitType


@dataclass
class Picture:
    frame_num: int = 0
    pic_num: int = 0
    long_term_pic_num: int = 0
    long_term_frame_idx: int = -1
    pic_order_cnt: int = 0
    top_field_order_cnt: int = 0
    bottom_field_order_cnt: int = 0
    is_long_term: bool = False
    is_reference: bool = True
    frame_idx: int = 0  # decode-order index, keys the pixel store
    # PAFF: which parities have been decoded as reference fields (a frame
    # picture sets both; a field pair fills them one at a time)
    field_ref: tuple = (True, True)


class DecodedPictureBuffer:
    """POC + reference bookkeeping (reference dpb.rs:9-757)."""

    def __init__(self):
        self.pictures: list[Picture] = []
        # POC state (8.2.1)
        self.prev_pic_order_cnt_msb = 0
        self.prev_pic_order_cnt_lsb = 0
        self.prev_frame_num = 0
        self.prev_frame_num_offset = 0
        self.max_long_term_frame_idx = -1
        self.ref_list0: list[Picture] = []
        self.ref_list1: list[Picture] = []
        self._decode_count = 0

    # -- POC decoding (spec 8.2.1; reference dpb.rs:592-757) -------------
    def decode_poc(self, sps: SPS, header: SliceHeader, nal: NalUnit) -> int:
        idr = nal.type == NalUnitType.IDR_SLICE
        t = sps.pic_order_cnt_type
        if t == 0:
            return self._poc_type0(sps, header, idr)
        if t == 1:
            return self._poc_type1(sps, header, nal, idr)
        return self._poc_type2(sps, header, nal, idr)

    def _poc_type0(self, sps, h, idr):
        max_lsb = sps.max_pic_order_cnt_lsb
        if idr:
            prev_msb, prev_lsb = 0, 0
        else:
            prev_msb = self.prev_pic_order_cnt_msb
            prev_lsb = self.prev_pic_order_cnt_lsb
        lsb = h.pic_order_cnt_lsb
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        top = msb + lsb
        bottom = top + h.delta_pic_order_cnt_bottom
        self.prev_pic_order_cnt_msb = msb
        self.prev_pic_order_cnt_lsb = lsb
        self._last_top, self._last_bottom = top, bottom
        return min(top, bottom) if h.field_pic_flag == 0 else \
            (bottom if h.bottom_field_flag else top)

    def _frame_num_offset(self, sps, h, idr):
        if idr:
            return 0
        prev = self.prev_frame_num_offset
        if self.prev_frame_num > h.frame_num:
            return prev + sps.max_frame_num
        return prev

    def _poc_type1(self, sps, h, nal, idr):
        p1 = sps.poc_type1
        off = self._frame_num_offset(sps, h, idr)
        n_ref = len(p1.offset_for_ref_frame) if p1 else 0
        abs_frame_num = off + h.frame_num if n_ref else 0
        if nal.ref_idc == 0 and abs_frame_num > 0:
            abs_frame_num -= 1
        expected = 0
        if abs_frame_num > 0 and p1:
            cycle = (abs_frame_num - 1) // n_ref
            in_cycle = (abs_frame_num - 1) % n_ref
            expected_delta = sum(p1.offset_for_ref_frame)
            expected = cycle * expected_delta + \
                sum(p1.offset_for_ref_frame[:in_cycle + 1])
        if nal.ref_idc == 0 and p1:
            expected += p1.offset_for_non_ref_pic
        d0, d1 = h.delta_pic_order_cnt
        top = expected + d0
        bottom = top + (p1.offset_for_top_to_bottom_field if p1 else 0) + d1
        self.prev_frame_num = h.frame_num
        self.prev_frame_num_offset = off
        self._last_top, self._last_bottom = top, bottom
        if h.field_pic_flag:
            return bottom if h.bottom_field_flag else top
        return min(top, bottom)

    def _poc_type2(self, sps, h, nal, idr):
        off = self._frame_num_offset(sps, h, idr)
        if idr:
            poc = 0
        elif nal.ref_idc == 0:
            poc = 2 * (off + h.frame_num) - 1
        else:
            poc = 2 * (off + h.frame_num)
        self.prev_frame_num = h.frame_num
        self.prev_frame_num_offset = off
        self._last_top = self._last_bottom = poc
        return poc

    # -- picture numbers (spec 8.2.4.1; dpb.rs:48-68) --------------------
    def _assign_pic_nums(self, sps: SPS, curr_frame_num: int):
        max_fn = sps.max_frame_num
        for p in self.pictures:
            if p.is_long_term:
                p.long_term_pic_num = p.long_term_frame_idx
            else:
                if p.frame_num > curr_frame_num:
                    p.pic_num = p.frame_num - max_fn
                else:
                    p.pic_num = p.frame_num

    # -- reference list construction (spec 8.2.4; dpb.rs:38-257) ---------
    def build_ref_lists(self, sps: SPS, header: SliceHeader, poc: int):
        st = header.slice_type
        self.ref_list0 = []
        self.ref_list1 = []
        if st.is_intra:
            return
        self._assign_pic_nums(sps, header.frame_num)
        short = [p for p in self.pictures
                 if p.is_reference and not p.is_long_term]
        long = sorted((p for p in self.pictures
                       if p.is_reference and p.is_long_term),
                      key=lambda p: p.long_term_pic_num)
        if st.is_predictive:
            l0 = sorted(short, key=lambda p: -p.pic_num) + long
            self.ref_list0 = l0
        else:  # B
            before = sorted((p for p in short if p.pic_order_cnt <= poc),
                            key=lambda p: -p.pic_order_cnt)
            after = sorted((p for p in short if p.pic_order_cnt > poc),
                           key=lambda p: p.pic_order_cnt)
            l0 = before + after + long
            l1 = after + before + long
            if len(l1) > 1 and l0[:len(l1)] == l1[:len(l0)]:
                l1[0], l1[1] = l1[1], l1[0]
            self.ref_list0 = l0
            self.ref_list1 = l1
        # modification (spec 8.2.4.3)
        self.ref_list0 = self._modify_list(
            self.ref_list0, header.ref_pic_list_modification_l0, sps, header,
            header.num_ref_idx_l0_active_minus1 + 1)
        if st == SliceType.B:
            self.ref_list1 = self._modify_list(
                self.ref_list1, header.ref_pic_list_modification_l1, sps,
                header, header.num_ref_idx_l1_active_minus1 + 1)
        self.ref_list0 = self.ref_list0[:header.num_ref_idx_l0_active_minus1 + 1]
        if st == SliceType.B:
            self.ref_list1 = self.ref_list1[:header.num_ref_idx_l1_active_minus1 + 1]

    def _modify_list(self, lst, mods, sps: SPS, header: SliceHeader,
                     num_active: int):
        if not mods:
            return lst
        lst = list(lst)
        max_pic_num = sps.max_frame_num
        curr_pic_num = header.frame_num
        pred = curr_pic_num
        ref_idx = 0
        for m in mods:
            if m.idc in (0, 1):
                diff = m.value + 1
                if m.idc == 0:
                    pred = pred - diff
                    if pred < 0:
                        pred += max_pic_num
                else:
                    pred = pred + diff
                    if pred >= max_pic_num:
                        pred -= max_pic_num
                pic_num = pred
                if pic_num > curr_pic_num:
                    pic_num -= max_pic_num
                target = next((p for p in self.pictures
                               if p.is_reference and not p.is_long_term
                               and p.pic_num == pic_num), None)
            else:  # long term
                target = next((p for p in self.pictures
                               if p.is_reference and p.is_long_term
                               and p.long_term_pic_num == m.value), None)
            if target is None:
                continue
            lst.insert(ref_idx, target)
            ref_idx += 1
            # remove later duplicate
            for i in range(ref_idx, len(lst)):
                if lst[i] is target:
                    del lst[i]
                    break
        return lst

    # -- PAFF field reference lists (8.2.4.2.2/8.2.4.2.4/8.2.4.2.5) ------
    def build_field_lists(self, sps: SPS, header: SliceHeader, poc: int):
        """Reference lists for a coded FIELD: lists of (Picture, parity).

        Frames order as for frame decoding (P: FrameNumWrap descending;
        B: POC-partitioned), then each frame splits into its reference
        fields in parity-alternating order starting with the current
        field's parity (8.2.4.2.5)."""
        st = header.slice_type
        self.ref_list0 = []
        self.ref_list1 = []
        if st.is_intra:
            return [], []
        cur_par = int(header.bottom_field_flag)
        max_fn = sps.max_frame_num
        frames = [p for p in self.pictures
                  if p.is_reference and not p.is_long_term
                  and any(p.field_ref)]
        for p in frames:
            wrap = p.frame_num - max_fn if p.frame_num > header.frame_num \
                else p.frame_num
            p.pic_num = wrap  # FrameNumWrap (field PicNum derived below)
        lt = [p for p in self.pictures
              if p.is_reference and p.is_long_term and any(p.field_ref)]
        lt = sorted(lt, key=lambda p: p.long_term_frame_idx)

        def split(fl):
            out = []
            a, b = cur_par, 1 - cur_par
            ia = [p for p in fl if p.field_ref[a]]
            ib = [p for p in fl if p.field_ref[b]]
            i = j = 0
            while i < len(ia) or j < len(ib):
                if i < len(ia):
                    out.append((ia[i], a))
                    i += 1
                if j < len(ib):
                    out.append((ib[j], b))
                    j += 1
            return out

        if st.is_predictive:
            order = sorted(frames, key=lambda p: -p.pic_num)
            l0 = split(order) + split(lt)
            l1 = []
        else:
            before = sorted((p for p in frames if p.pic_order_cnt <= poc),
                            key=lambda p: -p.pic_order_cnt)
            after = sorted((p for p in frames if p.pic_order_cnt > poc),
                           key=lambda p: p.pic_order_cnt)
            l0 = split(before + after) + split(lt)
            l1 = split(after + before) + split(lt)
            if len(l1) > 1 and l0[:len(l1)] == l1[:len(l0)]:
                l1[0], l1[1] = l1[1], l1[0]
        l0 = self._modify_field_list(l0, header.ref_pic_list_modification_l0,
                                     sps, header, cur_par)
        if st == SliceType.B:
            l1 = self._modify_field_list(
                l1, header.ref_pic_list_modification_l1, sps, header,
                cur_par)
        l0 = l0[:header.num_ref_idx_l0_active_minus1 + 1]
        if st == SliceType.B:
            l1 = l1[:header.num_ref_idx_l1_active_minus1 + 1]
        return l0, l1

    def _modify_field_list(self, lst, mods, sps: SPS, header: SliceHeader,
                           cur_par: int):
        """8.2.4.3 with field picture numbers: MaxPicNum = 2*MaxFrameNum,
        CurrPicNum = 2*frame_num + 1, field PicNum = 2*FrameNumWrap +
        (1 if same parity else 0)."""
        if not mods:
            return lst
        lst = list(lst)
        max_pic_num = 2 * sps.max_frame_num
        curr_pic_num = 2 * header.frame_num + 1
        pred = curr_pic_num
        ref_idx = 0
        for m in mods:
            if m.idc in (0, 1):
                diff = m.value + 1
                if m.idc == 0:
                    pred -= diff
                    if pred < 0:
                        pred += max_pic_num
                else:
                    pred += diff
                    if pred >= max_pic_num:
                        pred -= max_pic_num
                pic_num = pred
                if pic_num > curr_pic_num:
                    pic_num -= max_pic_num
                # field PicNum -> (FrameNumWrap, parity)
                wrap, same = pic_num >> 1, pic_num & 1
                par = cur_par if same else 1 - cur_par
                target = next(
                    ((p, par) for p in self.pictures
                     if p.is_reference and not p.is_long_term
                     and p.pic_num == wrap and p.field_ref[par]), None)
            else:
                # idc == 2: long_term_pic_num selects a long-term FIELD
                # (8.2.4.3.2: LongTermPicNum = 2*LongTermFrameIdx + 1 for
                # same-parity fields, 2*LongTermFrameIdx for opposite)
                wrap, same = m.value >> 1, m.value & 1
                par = cur_par if same else 1 - cur_par
                target = next(
                    ((p, par) for p in self.pictures
                     if p.is_reference and p.is_long_term
                     and p.long_term_frame_idx == wrap
                     and p.field_ref[par]), None)
            if target is None:
                continue
            lst.insert(ref_idx, target)
            ref_idx += 1
            for i in range(ref_idx, len(lst)):
                if lst[i] == target:
                    del lst[i]
                    break
        return lst

    def store_field(self, sps: SPS, header: SliceHeader, nal: NalUnit,
                    poc: int):
        """Marking for a coded field (8.2.5 field handling).

        The second field of a complementary reference pair joins its
        sibling's Picture; a first field opens a new entry (sliding
        window runs then, counting frames)."""
        idr = nal.type == NalUnitType.IDR_SLICE
        par = int(header.bottom_field_flag)
        if nal.ref_idc == 0:
            self._decode_count += 1
            return None
        m = header.dec_ref_pic_marking
        adaptive = bool(m and m.adaptive_ref_pic_marking_mode_flag)
        if idr:
            self.pictures.clear()
            self.max_long_term_frame_idx = -1
        else:
            if adaptive:
                self._adaptive_marking_field(sps, header, m.mmco_ops, par)
            # second field of the pair?
            if self.pictures:
                last = self.pictures[-1]
                if last.frame_num == header.frame_num \
                        and not last.field_ref[par] \
                        and last.frame_idx == self._decode_count - 1:
                    fr = list(last.field_ref)
                    fr[par] = True
                    last.field_ref = tuple(fr)
                    if par:
                        last.bottom_field_order_cnt = poc
                    else:
                        last.top_field_order_cnt = poc
                    last.pic_order_cnt = min(last.top_field_order_cnt,
                                             last.bottom_field_order_cnt)
                    self._decode_count += 1
                    if adaptive:
                        for op in m.mmco_ops:
                            if op.op == 6:  # current field -> long-term
                                last.is_long_term = True
                                last.long_term_frame_idx = op.val1
                    return last
            if not adaptive:
                self._sliding_window(sps)
        pic = Picture(frame_num=header.frame_num, pic_order_cnt=poc,
                      top_field_order_cnt=poc, bottom_field_order_cnt=poc,
                      frame_idx=self._decode_count,
                      field_ref=(par == 0, par == 1))
        self._decode_count += 1
        if adaptive:
            for op in m.mmco_ops:
                if op.op == 6:
                    pic.is_long_term = True
                    pic.long_term_frame_idx = op.val1
        self.pictures.append(pic)
        return pic

    def _adaptive_marking_field(self, sps: SPS, header: SliceHeader, ops,
                                cur_par: int):
        """8.2.5.4 MMCO with FIELD picture numbers: CurrPicNum =
        2*frame_num + 1, MaxPicNum = 2*MaxFrameNum; field PicNum =
        2*FrameNumWrap + (1 if same parity as the current field).

        Ops 1/2 unmark individual fields (a picture leaves the DPB when
        neither of its fields remains a reference); op 3 promotes the
        addressed pair to long-term (frame-granular: exact once the
        stream marks both fields, the common encoder pattern); ops 4/5
        as for frames; op 6 is applied by store_field to the current
        entry."""
        curr = 2 * header.frame_num + 1
        max_pn = 2 * sps.max_frame_num
        max_fn = sps.max_frame_num

        def wrap_of(p):
            return (p.frame_num - max_fn if p.frame_num > header.frame_num
                    else p.frame_num)

        def split_pic_num(pic_num):
            wrap, same = pic_num >> 1, pic_num & 1
            return wrap, (cur_par if same else 1 - cur_par)

        def unmark_field(p, par):
            fr = list(p.field_ref)
            fr[par] = False
            p.field_ref = tuple(fr)
            if not any(p.field_ref):
                p.is_reference = False
                self.pictures.remove(p)

        for op in ops:
            if op.op in (1, 3):
                pic_num = curr - (op.val1 + 1)
                if pic_num < 0:
                    pic_num += max_pn
                if pic_num > curr:
                    pic_num -= max_pn
                wrap, par = split_pic_num(pic_num)
                target = next(
                    (p for p in self.pictures
                     if p.is_reference and not p.is_long_term
                     and wrap_of(p) == wrap and p.field_ref[par]), None)
                if target is None:
                    continue
                if op.op == 1:
                    unmark_field(target, par)
                else:  # 3: short-term field -> long-term
                    target.is_long_term = True
                    target.long_term_frame_idx = op.val2
                    target.long_term_pic_num = op.val2
            elif op.op == 2:  # unmark long-term field by LongTermPicNum
                wrap, par = split_pic_num(op.val1)
                target = next(
                    (p for p in self.pictures
                     if p.is_reference and p.is_long_term
                     and p.long_term_frame_idx == wrap
                     and p.field_ref[par]), None)
                if target is not None:
                    unmark_field(target, par)
            elif op.op == 4:
                self.max_long_term_frame_idx = op.val1 - 1
                self.pictures = [
                    p for p in self.pictures
                    if not (p.is_long_term and p.long_term_frame_idx
                            > self.max_long_term_frame_idx)]
            elif op.op == 5:
                self.pictures.clear()
                self.max_long_term_frame_idx = -1
                self.prev_pic_order_cnt_msb = 0
                self.prev_pic_order_cnt_lsb = 0
            # op 6 applied by store_field to the stored entry

    # -- marking (spec 8.2.5; dpb.rs:415-589) ----------------------------
    def mark_and_store(self, sps: SPS, header: SliceHeader, nal: NalUnit,
                       poc: int):
        idr = nal.type == NalUnitType.IDR_SLICE
        if nal.ref_idc == 0:
            self._decode_count += 1
            return None  # non-reference pictures are not stored
        m = header.dec_ref_pic_marking
        if idr:
            self.pictures.clear()
            self.max_long_term_frame_idx = -1
            long_term = bool(m and m.long_term_reference_flag)
            pic = self._new_pic(header, poc, long_term)
            if long_term:
                pic.long_term_frame_idx = 0
                self.max_long_term_frame_idx = 0
            self.pictures.append(pic)
            return pic
        if m and m.adaptive_ref_pic_marking_mode_flag:
            self._adaptive_marking(sps, header, m.mmco_ops)
            pic = self._new_pic(header, poc, False)
            # MMCO6 may mark current as long-term
            for op in m.mmco_ops:
                if op.op == 6:
                    pic.is_long_term = True
                    pic.long_term_frame_idx = op.val1
            self.pictures.append(pic)
        else:
            self._sliding_window(sps)
            self.pictures.append(self._new_pic(header, poc, False))
        return self.pictures[-1]

    def _new_pic(self, header, poc, long_term):
        p = Picture(frame_num=header.frame_num, pic_order_cnt=poc,
                    top_field_order_cnt=self._last_top,
                    bottom_field_order_cnt=self._last_bottom,
                    is_long_term=long_term, frame_idx=self._decode_count)
        self._decode_count += 1
        return p

    def _sliding_window(self, sps: SPS):
        num_short = sum(1 for p in self.pictures
                        if p.is_reference and not p.is_long_term)
        num_long = sum(1 for p in self.pictures
                       if p.is_reference and p.is_long_term)
        max_refs = max(sps.max_num_ref_frames, 1)
        while num_short + num_long >= max_refs and num_short > 0:
            oldest = min((p for p in self.pictures
                          if p.is_reference and not p.is_long_term),
                         key=lambda p: p.frame_idx)
            oldest.is_reference = False
            self.pictures.remove(oldest)
            num_short -= 1

    def _adaptive_marking(self, sps: SPS, header: SliceHeader, ops):
        curr = header.frame_num
        max_fn = sps.max_frame_num
        self._assign_pic_nums(sps, curr)
        for op in ops:
            if op.op == 1:  # unmark short-term
                pic_num = curr - (op.val1 + 1)
                if pic_num < 0:
                    pic_num += max_fn
                if pic_num > curr:
                    pic_num -= max_fn
                self.pictures = [p for p in self.pictures
                                 if p.is_long_term or p.pic_num != pic_num]
            elif op.op == 2:  # unmark long-term by long_term_pic_num
                self.pictures = [p for p in self.pictures
                                 if not (p.is_long_term and
                                         p.long_term_pic_num == op.val1)]
            elif op.op == 3:  # short -> long term
                pic_num = curr - (op.val1 + 1)
                if pic_num < 0:
                    pic_num += max_fn
                if pic_num > curr:
                    pic_num -= max_fn
                self.pictures = [p for p in self.pictures
                                 if not (p.is_long_term and
                                         p.long_term_frame_idx == op.val2)]
                for p in self.pictures:
                    if not p.is_long_term and p.pic_num == pic_num:
                        p.is_long_term = True
                        p.long_term_frame_idx = op.val2
                        p.long_term_pic_num = op.val2
            elif op.op == 4:  # max long term frame idx
                self.max_long_term_frame_idx = op.val1 - 1
                self.pictures = [
                    p for p in self.pictures
                    if not (p.is_long_term and
                            p.long_term_frame_idx > self.max_long_term_frame_idx)]
            elif op.op == 5:  # reset
                self.pictures.clear()
                self.max_long_term_frame_idx = -1
                self.prev_pic_order_cnt_msb = 0
                self.prev_pic_order_cnt_lsb = 0
            # op 6 handled by caller (marks current picture)
