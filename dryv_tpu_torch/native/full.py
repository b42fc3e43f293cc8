# Copy of dryv_tpu/native/full.py.
"""Full IPB decode on the native C++ path: slice-parallel CABAC entropy
(entropy.cc) + intra/inter reconstruction (recon.cc) + in-loop deblocking
(deblock.cc).  The Python layer keeps only the cheap picture-level
bookkeeping: NAL/headers, POC, DPB reference lists, weighted-prediction
tables and temporal-direct scaling factors.

The upstream reference decodes the first (intra) frame only and has no
deblocking; this is the production host path for real-world streams.
Bit-exactness is enforced against the scalar refimpl / libavcodec oracle
in tests/test_native_full.py.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from .entropy import (InterParams, NK_I4, NK_I8, NK_I16, NK_PCM, NK_SI,
                      decode_picture_slices, lib, _ptr)

_U8P = ct.POINTER(ct.c_uint8)
_INTRA_NK = (NK_I4, NK_I8, NK_I16, NK_PCM, NK_SI)


def _u8p(a):
    return a.ctypes.data_as(_U8P)


# per-picture debug hook (see dryv_tpu.decoder.PIC_DEBUG_HOOK)
_PIC_DEBUG_HOOK = None


class _Stored:
    """A stored reference picture: planes + exported motion field."""

    def __init__(self, y, cb, cr, mv0, mv1, ri0, ri1, rk0, rk1,
                 list0_keys):
        self.y, self.cb, self.cr = y, cb, cr
        self.mv0, self.mv1 = mv0, mv1
        self.ri0, self.ri1 = ri0, ri1
        self.rk0, self.rk1 = rk0, rk1
        self.list0_keys = list0_keys


def decode_annexb_native(stream: bytes, max_frames: int = 0,
                         n_threads: int = 0):
    """Decode an Annex-B stream fully on the C++ host path.

    Falls back to the Python scalar path for features outside the native
    scope (non-4:2:0, SP/SI, custom scaling lists, ref list
    modification).  Both entropy modes (CABAC and CAVLC) are native."""
    from ..avc import split_annexb
    from ..avc.dpb import DecodedPictureBuffer
    from ..avc.slice_header import SliceType
    from ..decoder import (DecodedFrame, SyntaxDecoder, decode_annexb_scalar,
                           group_access_units)

    sd = SyntaxDecoder()
    nals = list(split_annexb(stream))
    rest = sd.feed_parameter_sets(nals)
    dpb = DecodedPictureBuffer()
    epoch = -1  # display order = POC order within each IDR epoch
    order = []
    stored: dict[int, _Stored] = {}
    frames = []
    for pic_idx, pic_nals in enumerate(group_access_units(rest)):
        headers = []
        slice_datas = []
        sps = pps = None
        from ..avc.slice_header import SliceHeader
        for nal in pic_nals:
            rbsp = nal.rbsp
            probe_pps = next(iter(sd.pps_map.values()))
            probe_sps = next(iter(sd.sps_map.values()))
            h0p = SliceHeader.parse(rbsp, nal, probe_sps, probe_pps)
            pps = sd.pps_map[h0p.pic_parameter_set_id]
            sps = sd.sps_map[pps.seq_parameter_set_id]
            h = SliceHeader.parse(rbsp, nal, sps, pps)
            st = h.slice_type
            if (sps.chroma_array_type != 1
                    or h.field_pic_flag
                    or (not sps.frame_mbs_only_flag
                        and sps.mb_adaptive_frame_field_flag)
                    or sps.bit_depth_luma_minus8
                    or sps.qpprime_y_zero_transform_bypass_flag
                    or pps.slice_groups is not None
                    or st in (SliceType.SP, SliceType.SI)
                    or pps.pic_scaling_matrix_present_flag
                    or sps.seq_scaling_matrix_present_flag):
                return decode_annexb_scalar(stream, max_frames)
            headers.append(h)
            # CABAC slice data is byte-aligned after the header; CAVLC
            # starts at the next bit
            bitoff = ((h.header_bit_len + 7) & ~7
                      if pps.entropy_coding_mode_flag else h.header_bit_len)
            slice_datas.append((rbsp, bitoff,
                                h.first_mb_in_slice, h.slice_qp_y(pps),
                                int(st), h.cabac_init_idc,
                                h.num_ref_idx_l0_active_minus1,
                                h.num_ref_idx_l1_active_minus1))
        h0 = headers[0]
        nal0 = pic_nals[0]
        st0 = h0.slice_type
        if int(nal0.type) == 5:
            epoch += 1
        poc = dpb.decode_poc(sps, h0, nal0)
        dpb.build_ref_lists(sps, h0, poc)
        out = decode_picture_slices(slice_datas, sps, pps,
                                    n_threads=n_threads)
        mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
        W, H = mb_w * 16, mb_h * 16
        y = np.zeros((H, W), np.uint8)
        cb = np.zeros((H // 2, W // 2), np.uint8)
        cr = np.zeros((H // 2, W // 2), np.uint8)
        n4 = mb_h * 4 * mb_w * 4
        exp = {k: np.zeros(n4 * 2, np.int32) for k in ("mv0", "mv1")}
        for k in ("ri0", "ri1", "rk0", "rk1"):
            exp[k] = np.full(n4, -1, np.int32)
        nz4 = np.zeros(n4, np.uint8)
        ip, keep = _build_inter_params(h0, pps, poc, dpb, stored, exp, nz4)
        off1 = pps.second_chroma_qp_index_offset
        if off1 is None:
            off1 = pps.chroma_qp_index_offset
        lib().dt_recon_picture(
            _ptr(out["kind"]), _ptr(out["qp_y"]), _ptr(out["cbp"]),
            _ptr(out["i16_mode"]), _ptr(out["chroma_mode"]),
            _ptr(out["modes4"]), _ptr(out["modes8"]), _ptr(out["luma4"]),
            _ptr(out["luma8"]), _ptr(out["luma_dc"]),
            _ptr(out["chroma_dc"]), _ptr(out["chroma_ac"]),
            _ptr(out["pcm_y"]), _ptr(out["pcm_c"]), _ptr(out["slice_id"]),
            _ptr(out["mb_type_code"]), _ptr(out["sub_mb_type"]),
            _ptr(out["ref_idx"]), _ptr(out["mvd"]), _ptr(out["transform8"]),
            mb_w, mb_h, pps.chroma_qp_index_offset, off1,
            _u8p(y), _u8p(cb), _u8p(cr), ct.byref(ip))
        if any(h.deblocking is None or h.deblocking.disable_idc != 1
               for h in headers):
            _deblock_native(y, cb, cr, out, sps, pps, headers, exp, nz4)
        if _PIC_DEBUG_HOOK is not None:
            _PIC_DEBUG_HOOK("native", pic_idx, dict(
                exp=exp, out=out, y=y, cb=cb, cr=cr, poc=poc,
                headers=headers))
        pic = dpb.mark_and_store(sps, h0, nal0, poc)
        if pic is not None:
            stored[pic.frame_idx] = _Stored(
                y, cb, cr, exp["mv0"], exp["mv1"], exp["ri0"], exp["ri1"],
                exp["rk0"], exp["rk1"],
                [p.frame_idx for p in dpb.ref_list0])
            live = {p.frame_idx for p in dpb.pictures}
            stored = {k: v for k, v in stored.items() if k in live}
        frames.append(DecodedFrame(y, cb, cr, poc).crop(sps))
        order.append((epoch, poc))
        if max_frames and len(frames) >= max_frames + 16:
            break
    frames = [f for _, f in sorted(zip(order, frames), key=lambda t: t[0])]
    return frames[:max_frames] if max_frames else frames


def wp_tables(h0, pps, poc, l0, l1):
    """Weighted-prediction tables for one picture.

    Returns (wp_mode, expl [2, nmax, 6] | None, denom_y, denom_c,
    imp [n0, n1, 2] | None) — shared by the host recon path and the
    device MC pipeline."""
    from ..avc.slice_header import SliceType
    from ..refimpl.inter import ImplicitWP

    st0 = h0.slice_type
    is_inter = not st0.is_intra
    if is_inter and h0.pred_weight_table is not None and (
            (pps.weighted_pred_flag and st0 == SliceType.P) or
            (pps.weighted_bipred_idc == 1 and st0 == SliceType.B)):
        t = h0.pred_weight_table
        nmax = max(len(l0), len(l1), 1)
        expl = np.zeros((2, nmax, 6), np.int32)
        dy, dc = t.luma_log2_weight_denom, t.chroma_log2_weight_denom
        for which, (luma, chroma, n) in enumerate(
                ((t.luma_l0, t.chroma_l0, len(l0)),
                 (t.luma_l1, t.chroma_l1, len(l1)))):
            for i in range(n):
                e = luma[i] if i < len(luma) else None
                expl[which, i, 0:2] = (e.weight, e.offset) if e else \
                    (1 << dy, 0)
                ce = chroma[i] if i < len(chroma) else None
                if ce:
                    expl[which, i, 2:4] = (ce[0].weight, ce[0].offset)
                    expl[which, i, 4:6] = (ce[1].weight, ce[1].offset)
                else:
                    expl[which, i, 2:6] = (1 << dc, 0, 1 << dc, 0)
        return 1, expl, dy, dc, None
    if st0 == SliceType.B and pps.weighted_bipred_idc == 2:
        iwp = ImplicitWP(poc, [p.pic_order_cnt for p in l0],
                         [p.pic_order_cnt for p in l1],
                         [p.is_long_term for p in l0],
                         [p.is_long_term for p in l1])
        imp = np.zeros((max(1, len(l0)), max(1, len(l1)), 2), np.int32)
        for r0 in range(len(l0)):
            for r1 in range(len(l1)):
                imp[r0, r1] = iwp.biweights(r0, r1)
        return 2, None, 0, 0, imp
    return 0, None, 0, 0, None


def _build_inter_params(h0, pps, poc, dpb, stored, exp, nz4):
    """Assemble the InterParams struct; returns (params, keepalive)."""
    from ..avc.slice_header import SliceType

    keep = []  # keepalive for ctypes arrays
    ip = InterParams()
    st0 = h0.slice_type
    is_inter = not st0.is_intra
    ip.is_b = int(st0 == SliceType.B)
    ip.direct_spatial = h0.direct_spatial_mv_pred_flag
    l0 = dpb.ref_list0 if is_inter else []
    l1 = dpb.ref_list1 if st0 == SliceType.B else []
    ip.n_ref0, ip.n_ref1 = len(l0), len(l1)

    def plane_ptrs(lst, attr):
        arr = (_U8P * max(1, len(lst)))()
        for i, p in enumerate(lst):
            arr[i] = _u8p(getattr(stored[p.frame_idx], attr))
        keep.append(arr)
        return arr
    ip.ref0_y = plane_ptrs(l0, "y")
    ip.ref0_cb = plane_ptrs(l0, "cb")
    ip.ref0_cr = plane_ptrs(l0, "cr")
    ip.ref1_y = plane_ptrs(l1, "y")
    ip.ref1_cb = plane_ptrs(l1, "cb")
    ip.ref1_cr = plane_ptrs(l1, "cr")
    k0 = np.array([p.frame_idx for p in l0] or [0], np.int32)
    k1 = np.array([p.frame_idx for p in l1] or [0], np.int32)
    keep += [k0, k1]
    ip.list0_keys, ip.list1_keys = _ptr(k0), _ptr(k1)

    if st0 == SliceType.B:
        colp = l1[0]
        col = stored[colp.frame_idx]
        keep.append(col)
        ip.col_mv0, ip.col_mv1 = _ptr(col.mv0), _ptr(col.mv1)
        ip.col_refidx0, ip.col_refidx1 = _ptr(col.ri0), _ptr(col.ri1)
        ip.col_refkey0, ip.col_refkey1 = _ptr(col.rk0), _ptr(col.rk1)
        ip.col_shortterm = int(not colp.is_long_term)
        ip.col_default_key = (col.list0_keys[0] if col.list0_keys else 0)
        if not h0.direct_spatial_mv_pred_flag:
            # temporal-direct scaling table over every possible col ref key
            poc_by = {p.frame_idx: p.pic_order_cnt for p in dpb.pictures}
            lt_by = {p.frame_idx: p.is_long_term for p in dpb.pictures}
            keys = sorted({int(v) for v in np.concatenate(
                [col.rk0, col.rk1])} - {-1} | {ip.col_default_key})
            l0keys = [p.frame_idx for p in l0]
            tkeys, tref0, tident, tdsf = [], [], [], []
            poc1 = colp.pic_order_cnt
            for key in keys:
                if key not in l0keys or key not in poc_by:
                    continue  # unreferenced key cannot occur in fixtures
                poc0 = poc_by[key]
                tkeys.append(key)
                tref0.append(l0keys.index(key))
                if lt_by.get(key) or poc1 == poc0:
                    tident.append(1)
                    tdsf.append(0)
                else:
                    td = int(np.clip(poc1 - poc0, -128, 127))
                    tb = int(np.clip(poc - poc0, -128, 127))
                    tx = (16384 + (abs(td) >> 1)) // td
                    tident.append(0)
                    tdsf.append(int(np.clip((tb * tx + 32) >> 6,
                                            -1024, 1023)))
            ta = [np.array(x, np.int32) for x in
                  (tkeys, tref0, tident, tdsf)]
            keep += ta
            ip.n_tk = len(tkeys)
            ip.tkeys, ip.t_ref0 = _ptr(ta[0]), _ptr(ta[1])
            ip.t_ident, ip.t_dsf = _ptr(ta[2]), _ptr(ta[3])

    # weighted prediction
    wp_mode, expl, dy, dc, imp = wp_tables(h0, pps, poc, l0, l1)
    if wp_mode == 1:
        expl_flat = np.ascontiguousarray(expl.reshape(-1))
        keep.append(expl_flat)
        ip.wp_mode, ip.wp_denom_y, ip.wp_denom_c = 1, dy, dc
        ip.wp_expl, ip.wp_stride = _ptr(expl_flat), expl.shape[1] * 6
    elif wp_mode == 2:
        imp_flat = np.ascontiguousarray(imp.reshape(-1))
        keep.append(imp_flat)
        ip.wp_mode = 2
        ip.wp_imp = _ptr(imp_flat)

    ip.out_mv0, ip.out_mv1 = _ptr(exp["mv0"]), _ptr(exp["mv1"])
    ip.out_refidx0, ip.out_refidx1 = _ptr(exp["ri0"]), _ptr(exp["ri1"])
    ip.out_refkey0, ip.out_refkey1 = _ptr(exp["rk0"]), _ptr(exp["rk1"])
    ip.out_nz4 = _u8p(nz4)
    ip._keepalive = keep
    return ip, keep


def _deblock_native(y, cb, cr, out, sps, pps, headers, exp, nz4):
    """C++ in-loop filter using the dense entropy + exported motion."""
    from ..refimpl.transform import QPC_TAB

    mb_w, mb_h = sps.pic_width_in_mbs, sps.frame_height_in_mbs
    kind = out["kind"]
    qpy = np.where(kind == NK_PCM, 0, out["qp_y"]).astype(np.int32)

    def qpc(off):
        qpi = np.clip(qpy + off, 0, 51)
        return np.where(qpi < 30, qpi,
                        QPC_TAB[np.clip(qpi - 30, 0, 21)]).astype(np.int32)
    off0 = pps.chroma_qp_index_offset
    off1 = pps.second_chroma_qp_index_offset
    if off1 is None:
        off1 = off0
    ctl = []
    for h in headers:
        d = h.deblocking
        ctl.append((0, 0, 0) if d is None else
                   (d.disable_idc, d.alpha_c0_offset_div2 * 2,
                    d.beta_offset_div2 * 2))
    intra = np.isin(kind, _INTRA_NK).astype(np.uint8)
    # 8x8 transform suppresses interior 4x4 luma edges: I8 kind or the
    # inter transform_size_8x8_flag
    t8 = ((kind == NK_I8) | (out["transform8"] != 0)).astype(np.uint8)
    sid = np.ascontiguousarray(out["slice_id"], np.int32)
    ctl_a = np.ascontiguousarray(np.array(ctl, np.int32).reshape(-1))
    q0, q1 = qpc(off0), qpc(off1)
    lib().dt_deblock_frame(
        _u8p(y), _u8p(cb), _u8p(cr), mb_w, mb_h, sps.chroma_array_type,
        _ptr(qpy), _ptr(q0), _ptr(q1), _u8p(intra), _u8p(t8), _ptr(sid),
        _ptr(ctl_a), _u8p(nz4), _ptr(exp["mv0"]), _ptr(exp["mv1"]),
        _ptr(exp["rk0"]), _ptr(exp["rk1"]))
