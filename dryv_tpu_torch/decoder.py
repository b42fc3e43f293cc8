# Copy of dryv_tpu/decoder.py.
"""Decoder facade: byte stream -> syntax -> reconstruction -> YUV planes.

Mirrors the reference's Decoder::decode_sample orchestration
(src/video/decoder.rs:87-150) with the TPU-native split: entropy decode
fills dense per-frame syntax, reconstruction runs as a separate stage
(scalar refimpl here; the JAX/Pallas pipeline consumes the same syntax).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .avc import NalUnit, NalUnitType, SPS, PPS, split_annexb
from .avc.slice_header import SliceHeader, SliceType
from .cabac.engine import CabacDecoder
from .cabac.syntax import SliceCoder, MBState
from .refimpl.recon import FrameRecon


# Per-picture debug hook for desync bisection (the reference's analogue is
# its per-slice dump of DPB + first-10-MB state, decoder.rs:128-140): set to
# a callable(path_name, pic_index, state_dict) to observe each decoded
# picture's reconstruction + motion state.  Used by tools/dump_mb_state.py.
PIC_DEBUG_HOOK = None


@dataclass
class DecodedFrame:
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    poc: int = 0

    def crop(self, sps: SPS):
        """Apply frame cropping (spec 7.4.2.1.1) — reference leaves this
        unimplemented (README.md:13 'Frame cropping' unchecked)."""
        fc = sps.frame_cropping
        if not fc:
            return self
        sub_w = {0: 1, 1: 2, 2: 2, 3: 1}[sps.chroma_array_type]
        sub_h = {0: 1, 1: 2, 2: 1, 3: 1}[sps.chroma_array_type]
        l, r = fc.left * sub_w, fc.right * sub_w
        t, b = fc.top * sub_h, fc.bottom * sub_h
        H, W = self.y.shape
        y = self.y[t:H - b, l:W - r]
        cb = cr = None
        if self.cb is not None:
            cl, cr_ = fc.left, fc.right
            ct, cbm = fc.top, fc.bottom
            ch, cw = self.cb.shape
            cb = self.cb[ct:ch - cbm, cl:cw - cr_]
            cr = self.cr[ct:ch - cbm, cl:cw - cr_]
        return DecodedFrame(y, cb, cr, self.poc)


class SyntaxDecoder:
    """Entropy/syntax stage: NAL units -> per-frame MBState arrays."""

    def __init__(self):
        self.sps_map: dict[int, SPS] = {}
        self.pps_map: dict[int, PPS] = {}

    def feed_parameter_sets(self, nals):
        rest = []
        for nal in nals:
            if nal.type == NalUnitType.SPS:
                sps = SPS.parse(nal.rbsp)
                self.sps_map[sps.seq_parameter_set_id] = sps
            elif nal.type == NalUnitType.PPS:
                # PPS needs its SPS for scaling-list fallback; resolved lazily
                rbsp = nal.rbsp
                pps = PPS.parse(rbsp, None)
                sps = self.sps_map.get(pps.seq_parameter_set_id)
                if sps is not None and sps.profile_idc in (100, 110, 122, 244):
                    pps = PPS.parse(rbsp, sps)
                self.pps_map[pps.pic_parameter_set_id] = pps
            else:
                rest.append(nal)
        return rest

    def decode_picture_syntax(self, slice_nals):
        """Decode all slices of one picture; returns (sps, pps, mbs, headers)."""
        mbs = None
        sps = pps = None
        headers = []
        for sid, nal in enumerate(slice_nals):
            rbsp = nal.rbsp
            # parse header with the right PPS
            # (peek pic_parameter_set_id: parse once against any PPS is fine
            # since the header fields up to pps id don't depend on it)
            probe_pps = next(iter(self.pps_map.values()))
            probe_sps = next(iter(self.sps_map.values()))
            h0 = SliceHeader.parse(rbsp, nal, probe_sps, probe_pps)
            pps = self.pps_map[h0.pic_parameter_set_id]
            sps = self.sps_map[pps.seq_parameter_set_id]
            h = SliceHeader.parse(rbsp, nal, sps, pps)
            headers.append(h)
            if mbs is None:
                pic_h = sps.frame_height_in_mbs >> h.field_pic_flag
                mbs = [None] * (sps.pic_width_in_mbs * pic_h)
            sgmap = None
            if pps.slice_groups is not None:
                from .avc.slice_map import map_units_to_sgmap
                sgmap = map_units_to_sgmap(pps, sps,
                                           h.slice_group_change_cycle)
            if pps.entropy_coding_mode_flag:
                entropy_start = (h.header_bit_len + 7) & ~7  # cabac align
                init_mode = (0 if h.slice_type.is_intra
                             else 1 + h.cabac_init_idc)
                eng = CabacDecoder(rbsp, entropy_start, h.slice_qp_y(pps),
                                   init_mode)
                coder = SliceCoder(eng, sps, pps, h, mbs, sid)
            else:
                # CAVLC (the reference's todo!, slice/mod.rs:299)
                from .bitio import BitReader
                from .cavlc import CavlcSliceCoder
                r = BitReader(rbsp)
                r.skip(h.header_bit_len)
                coder = CavlcSliceCoder(r, sps, pps, h, mbs, sid,
                                        encoding=False)
            coder.decode_slice_data(sgmap)
        return sps, pps, mbs, headers


def group_access_units(nals):
    """Group slice NALs into pictures by first_mb_in_slice == 0 boundaries."""
    pics = []
    cur = []
    for nal in nals:
        if nal.type in (NalUnitType.IDR_SLICE, NalUnitType.NON_IDR_SLICE):
            # cheap AU boundary: slice with first_mb 0 starts a new picture
            first_mb_zero = _first_mb_is_zero(nal)
            if first_mb_zero and cur:
                pics.append(cur)
                cur = []
            cur.append(nal)
    if cur:
        pics.append(cur)
    return pics


def _first_mb_is_zero(nal) -> bool:
    from .bitio import BitReader
    r = BitReader(nal.rbsp)
    return r.ue() == 0


def decode_annexb_scalar(stream: bytes, max_frames: int = 0):
    """Full scalar decode of an Annex-B stream (correctness path).

    Maintains the DPB across pictures; P slices reconstruct against
    reference list 0 (integer-MV scope; the upstream reference decoder
    cannot reconstruct inter at all)."""
    from .avc.dpb import DecodedPictureBuffer
    from .cabac.syntax import MbKind
    from .refimpl.inter import DirectCtx, MotionState, recon_inter_mb

    sd = SyntaxDecoder()
    nals = list(split_annexb(stream))
    rest = sd.feed_parameter_sets(nals)
    frames = []
    dpb = DecodedPictureBuffer()
    stored = {}  # frame_idx -> (y, cb, cr) uncropped
    stored_ms = {}  # frame_idx -> MotionState (B co-located motion)
    stored_maps = {}  # frame_idx -> (l0 keys, l1 keys) for temporal direct
    stored_fields = {}  # (frame_idx, parity) -> field planes (PAFF refs)
    stored_field_ms = {}  # (frame_idx, parity) -> field MotionState
    stored_field_maps = {}  # (frame_idx, parity) -> (l0 keys, l1 keys)
    pending_field = None  # (bottom_flag, FrameRecon) awaiting its pair
    # Output (display) order is POC order within each IDR epoch — a later
    # coded picture may precede an earlier one in display order (e.g.
    # x264's trailing non-ref B arrives after the P it precedes), so
    # frames are keyed (epoch, poc) and sorted on return.
    epoch = -1
    order = []
    for pic_idx, pic_nals in enumerate(group_access_units(rest)):
        sps, pps, mbs, headers = sd.decode_picture_syntax(pic_nals)
        h0 = headers[0]
        nal0 = pic_nals[0]
        if int(nal0.type) == 5 and not (h0.field_pic_flag
                                        and h0.bottom_field_flag):
            epoch += 1
        if (not h0.field_pic_flag and not sps.frame_mbs_only_flag
                and sps.mb_adaptive_frame_field_flag):
            # MBAFF picture: full intra + inter (P/B) reconstruction with
            # parity-mapped field reference lists (the upstream reference
            # handles MBAFF at the entropy layer only — cabac/mod.rs:907-957
            # — and reconstructs nothing interlaced)
            from .refimpl.mbaff_inter import recon_mbaff_picture
            poc = dpb.decode_poc(sps, h0, nal0)
            dpb.build_ref_lists(sps, h0, poc)
            ym, cbm, crm, mms = recon_mbaff_picture(
                sps, pps, mbs, headers, dpb, stored, stored_ms, poc,
                dpb._last_top, dpb._last_bottom)
            if any(h.deblocking is None or h.deblocking.disable_idc != 1
                   for h in headers):
                from .refimpl.mbaff_deblock import deblock_mbaff_frame
                deblock_mbaff_frame(ym, cbm, crm, mbs, mms, sps, pps,
                                    headers, dpb)
            pic = dpb.mark_and_store(sps, h0, nal0, poc)
            if pic is not None:
                stored[pic.frame_idx] = (ym, cbm, crm)
                stored_ms[pic.frame_idx] = mms
                live = {p.frame_idx for p in dpb.pictures}
                stored = {k: v for k, v in stored.items() if k in live}
                stored_ms = {k: v for k, v in stored_ms.items()
                             if k in live}
            if PIC_DEBUG_HOOK is not None:
                PIC_DEBUG_HOOK("scalar", pic_idx, dict(
                    ms=mms, mbs=mbs, y=ym, cb=cbm, cr=crm, poc=poc,
                    headers=headers))
            frames.append(DecodedFrame(ym, cbm, crm, poc).crop(sps))
            order.append((epoch, poc))
            if max_frames and len(frames) >= max_frames + 16:
                break
            continue
        if h0.field_pic_flag:
            # PAFF: each coded field is a standalone half-height picture
            # decoded with the field column of the CABAC significance
            # maps; the two parities weave into one output frame.  The
            # upstream reference cannot decode any field-coded stream
            # (its recon layer predates fields entirely); intra AND inter
            # (P/B) fields are supported here with parity-interleaved
            # reference lists (8.2.4.2.5) and the 8.4.1.4 chroma MV
            # adjustment for opposite-parity references.
            from .refimpl.inter import (DirectCtx, ExplicitWP, ImplicitWP,
                                        MotionState, recon_inter_mb)
            parity = int(h0.bottom_field_flag)
            fh = sps.frame_height_in_mbs // 2
            poc = dpb.decode_poc(sps, h0, nal0)
            fl0 = fl1 = None
            flists = (None, None)
            cvoffs = (None, None)
            dctx = wp = None
            if not all(h.slice_type.is_intra for h in headers):
                fl0, fl1 = dpb.build_field_lists(sps, h0, poc)
                if not fl0:
                    raise ValueError("P/B field without references")

                def planes(fl):
                    return [stored_fields[(p.frame_idx, par)]
                            for p, par in fl]

                def offs(fl):
                    return [0 if par == parity else
                            (2 if parity else -2) for p, par in fl]

                def fpocs(fl):
                    return [(p.bottom_field_order_cnt if par else
                             p.top_field_order_cnt) for p, par in fl]

                flists = (planes(fl0),
                          planes(fl1) if fl1 else None)
                cvoffs = (offs(fl0), offs(fl1) if fl1 else None)
                st0 = h0.slice_type
                if h0.pred_weight_table is not None and (
                        (pps.weighted_pred_flag and st0 == SliceType.P) or
                        (pps.weighted_bipred_idc == 1
                         and st0 == SliceType.B)):
                    wp = ExplicitWP(h0.pred_weight_table)
                elif st0 == SliceType.B and pps.weighted_bipred_idc == 2:
                    wp = ImplicitWP(poc, fpocs(fl0), fpocs(fl1),
                                    [p.is_long_term for p, _ in fl0],
                                    [p.is_long_term for p, _ in fl1])
                if st0 == SliceType.B:
                    if not fl1:
                        raise ValueError("B field without list 1")
                    colp, colpar = fl1[0]
                    if h0.direct_spatial_mv_pred_flag:
                        dctx = DirectCtx(
                            stored_field_ms[(colp.frame_idx, colpar)],
                            not colp.is_long_term)
                    else:
                        # temporal direct between coded FIELDS
                        # (8.4.1.2.3): picture keys are (frame_idx,
                        # parity), distances use FIELD POCs; no vertical
                        # MV scaling (both pictures are fields)
                        from .refimpl.inter import TemporalDirectCtx
                        km0, km1 = stored_field_maps.get(
                            (colp.frame_idx, colpar), ((), ()))
                        dctx = TemporalDirectCtx(
                            stored_field_ms[(colp.frame_idx, colpar)],
                            km0, km1,
                            [(p.frame_idx, par) for p, par in fl0],
                            {(p.frame_idx, par):
                             (p.bottom_field_order_cnt if par
                              else p.top_field_order_cnt)
                             for p, par in fl0 + fl1},
                            {(p.frame_idx, par): p.is_long_term
                             for p, par in fl0 + fl1},
                            poc,
                            (colp.bottom_field_order_cnt if colpar
                             else colp.top_field_order_cnt),
                            cur_parity=parity)
            recon = FrameRecon(sps, pps, mb_h=fh)
            ms = MotionState(recon.mb_w, fh)
            for addr, mb in enumerate(mbs):
                if mb is None:
                    raise ValueError(f"macroblock {addr} not covered")
                if mb.kind in (MbKind.I_NXN, MbKind.I_16X16, MbKind.I_PCM,
                               MbKind.SI):
                    recon.recon_mb(mb, addr, mb.slice_id)
                    ms.set_mb_intra(addr, mb.slice_id)
                else:
                    ref = flists[0][0]
                    recon_inter_mb(recon, mb, addr, mb.slice_id, ms,
                                   ref[0], ref[1], ref[2], flists[0],
                                   flists[1], dctx, wp, cvoff=cvoffs)
            if any(h.deblocking is None or h.deblocking.disable_idc != 1
                   for h in headers):
                from .refimpl.deblock import deblock_frame

                def _fkeys(fl, refarr):
                    if not fl:
                        return None
                    keys = np.array([2 * p.frame_idx + par
                                     for p, par in fl], np.int64)
                    return np.where(refarr >= 0,
                                    keys[np.clip(refarr, 0,
                                                 len(keys) - 1)], -1)
                ms.cur_sid = None
                deblock_frame(recon.y, recon.cb, recon.cr, mbs, ms, sps,
                              pps, headers, _fkeys(fl0, ms.ref),
                              _fkeys(fl1, ms.ref1))
            fpic = dpb.store_field(sps, h0, nal0, poc)
            if fpic is not None:
                stored_fields[(fpic.frame_idx, parity)] = \
                    (recon.y, recon.cb, recon.cr)
                ms.cur_sid = None
                stored_field_ms[(fpic.frame_idx, parity)] = ms
                stored_field_maps[(fpic.frame_idx, parity)] = (
                    [(p.frame_idx, par) for p, par in fl0] if fl0 else [],
                    [(p.frame_idx, par) for p, par in fl1] if fl1 else [])
                live = {p.frame_idx for p in dpb.pictures}
                stored_fields = {k: v for k, v in stored_fields.items()
                                 if k[0] in live}
                stored_field_ms = {k: v for k, v in
                                   stored_field_ms.items()
                                   if k[0] in live}
                stored_field_maps = {k: v for k, v in
                                     stored_field_maps.items()
                                     if k[0] in live}
            if pending_field is None or pending_field[0] == parity:
                pending_field = (parity, recon, poc)
                continue
            import numpy as _np
            other_parity, other, other_poc = pending_field
            pending_field = None
            top = other if other_parity == 0 else recon
            bot = recon if other_parity == 0 else other
            y = _np.empty((top.y.shape[0] * 2, top.y.shape[1]),
                          top.y.dtype)
            y[0::2] = top.y
            y[1::2] = bot.y
            cb = cr = None
            if top.cb is not None:
                cb = _np.empty((top.cb.shape[0] * 2, top.cb.shape[1]),
                               top.cb.dtype)
                cr = _np.empty_like(cb)
                cb[0::2] = top.cb
                cb[1::2] = bot.cb
                cr[0::2] = top.cr
                cr[1::2] = bot.cr
            frame_poc = min(poc, other_poc)
            frames.append(DecodedFrame(y, cb, cr, frame_poc).crop(sps))
            order.append((epoch, frame_poc))
            if max_frames and len(frames) >= max_frames + 16:
                break
            continue
        poc = dpb.decode_poc(sps, h0, nal0)
        dpb.build_ref_lists(sps, h0, poc)
        ref = None
        ref_list = ref_list1 = dctx = wp = None
        if not h0.slice_type.is_intra:
            from .refimpl.inter import ExplicitWP, ImplicitWP
            st0 = h0.slice_type
            if h0.pred_weight_table is not None and (
                    (pps.weighted_pred_flag and st0 == SliceType.P) or
                    (pps.weighted_bipred_idc == 1 and st0 == SliceType.B)):
                wp = ExplicitWP(h0.pred_weight_table)
            elif st0 == SliceType.B and pps.weighted_bipred_idc == 2:
                wp = ImplicitWP(
                    poc,
                    [p.pic_order_cnt for p in dpb.ref_list0],
                    [p.pic_order_cnt for p in dpb.ref_list1],
                    [p.is_long_term for p in dpb.ref_list0],
                    [p.is_long_term for p in dpb.ref_list1])
            if not dpb.ref_list0:
                raise ValueError("P/B slice without reference pictures")
            ref_list = [stored[p.frame_idx] for p in dpb.ref_list0]
            ref = ref_list[0]
            if h0.slice_type == SliceType.B:
                if not dpb.ref_list1:
                    raise ValueError("B slice without list-1 references")
                ref_list1 = [stored[p.frame_idx] for p in dpb.ref_list1]
                colp = dpb.ref_list1[0]
                if h0.direct_spatial_mv_pred_flag:
                    dctx = DirectCtx(stored_ms[colp.frame_idx],
                                     not colp.is_long_term)
                else:
                    from .refimpl.inter import TemporalDirectCtx
                    cm0, cm1 = stored_maps[colp.frame_idx]
                    dctx = TemporalDirectCtx(
                        stored_ms[colp.frame_idx], cm0, cm1,
                        [p.frame_idx for p in dpb.ref_list0],
                        {p.frame_idx: p.pic_order_cnt
                         for p in dpb.pictures},
                        {p.frame_idx: p.is_long_term
                         for p in dpb.pictures},
                        poc, colp.pic_order_cnt)
        recon = FrameRecon(sps, pps)
        ms = MotionState(recon.mb_w, recon.mb_h)
        for addr, mb in enumerate(mbs):
            if mb is None:
                raise ValueError(f"macroblock {addr} not covered by any slice")
            if mb.kind in (MbKind.I_NXN, MbKind.I_16X16, MbKind.I_PCM,
                           MbKind.SI):
                recon.recon_mb(mb, addr, mb.slice_id)
                # intra MBs are *available* neighbors with ref -1 in MV
                # prediction (8.4.1.3.2) — mark them in the motion field
                ms.set_mb_intra(addr, mb.slice_id)
            else:
                recon_inter_mb(recon, mb, addr, mb.slice_id, ms,
                               ref[0], ref[1], ref[2], ref_list,
                               ref_list1, dctx, wp)
        if any(h.deblocking is None or h.deblocking.disable_idc != 1
               for h in headers):
            from .refimpl.deblock import deblock_frame

            def _pic_keys(lst, refarr):
                if not lst:
                    return None
                keys = np.array([p.frame_idx for p in lst], np.int64)
                return np.where(refarr >= 0,
                                keys[np.clip(refarr, 0, len(keys) - 1)], -1)
            deblock_frame(recon.y, recon.cb, recon.cr, mbs, ms, sps, pps,
                          headers, _pic_keys(dpb.ref_list0, ms.ref),
                          _pic_keys(dpb.ref_list1, ms.ref1))
        ms.cur_sid = None  # stored/colocated reads span all slices
        if PIC_DEBUG_HOOK is not None:
            PIC_DEBUG_HOOK("scalar", pic_idx, dict(
                ms=ms, mbs=mbs, y=recon.y, cb=recon.cb, cr=recon.cr,
                poc=poc, headers=headers))
        pic = dpb.mark_and_store(sps, h0, nal0, poc)
        if pic is not None:
            stored[pic.frame_idx] = (recon.y, recon.cb, recon.cr)
            stored_ms[pic.frame_idx] = ms
            stored_maps[pic.frame_idx] = (
                [p.frame_idx for p in dpb.ref_list0],
                [p.frame_idx for p in dpb.ref_list1])
            # retain only pixel data still referenced
            live = {p.frame_idx for p in dpb.pictures}
            stored = {k: v for k, v in stored.items() if k in live}
            stored_ms = {k: v for k, v in stored_ms.items() if k in live}
            stored_maps = {k: v for k, v in stored_maps.items()
                           if k in live}
        frames.append(DecodedFrame(recon.y, recon.cb, recon.cr,
                                   poc).crop(sps))
        order.append((epoch, poc))
        # decode-order count may briefly exceed display-order need (a
        # trailing B can still displace an already-decoded frame), so
        # over-decode by one DPB's worth before truncating
        if max_frames and len(frames) >= max_frames + 16:
            break
    frames = [f for _, f in sorted(zip(order, frames), key=lambda t: t[0])]
    return frames[:max_frames] if max_frames else frames
