# Copy of dryv_tpu/refimpl/deblock.py.
"""In-loop deblocking filter (spec 8.7), scalar reference implementation.

The upstream reference does not implement deblocking (README.md:14
'Deblocking filter' unchecked) and therefore cannot bit-exactly decode
typical real-world streams; this goes beyond it.  Validated bit-exactly
against the libavcodec oracle.

Scope: progressive frames (no MBAFF/fields), I/SI/P slices.  bS rules for
B slices (two motion vectors / two lists) land with B reconstruction.
"""
from __future__ import annotations

import numpy as np

from ..avc.neighbors import ZSCAN_4X4_POS
from ..cabac.syntax import MbKind
from .transform import qpc_from_qpy

# Table 8-16 (alpha/beta thresholds) indexed by indexA/indexB 0..51
ALPHA = np.array([0] * 16 +
                 [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
                  32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127,
                  144, 162, 182, 203, 226, 255, 255], dtype=np.int64)
BETA = np.array([0] * 16 +
                [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9,
                 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16,
                 17, 17, 18, 18], dtype=np.int64)
# Table 8-17 t'c0 indexed by [indexA][bS-1]
TC0 = np.array([[0, 0, 0]] * 17 + [
    [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1],
    [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2],
    [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4],
    [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7],
    [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13], [7, 10, 14],
    [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23],
    [13, 17, 25]], dtype=np.int64)

_INTRA_KINDS = (MbKind.I_NXN, MbKind.I_16X16, MbKind.I_PCM, MbKind.SI)


def _clip1(x):
    return np.clip(x, 0, 255)


def _filter_luma(P, Q, bs, alpha, beta, tc0):
    """Filter n luma sample lines across one edge (spec 8.7.2.3/8.7.2.4).

    P[:, k] = p_k (p0 nearest the edge), Q[:, k] = q_k; bs/tc0 per line.
    Returns filtered copies (unfiltered where the decision is off)."""
    p0, p1, p2, p3 = (P[:, k] for k in range(4))
    q0, q1, q2, q3 = (Q[:, k] for k in range(4))
    filt = ((bs > 0) & (np.abs(p0 - q0) < alpha)
            & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta))
    ap = np.abs(p2 - p0)
    aq = np.abs(q2 - q0)
    # --- bS < 4 (8.7.2.3) ---
    tc = tc0 + (ap < beta) + (aq < beta)
    delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0n = _clip1(p0 + delta)
    q0n = _clip1(q0 - delta)
    p1n = p1 + np.clip((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0)
    q1n = q1 + np.clip((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0)
    # --- bS == 4 (8.7.2.4) ---
    strong_p = (ap < beta) & (np.abs(p0 - q0) < (alpha >> 2) + 2)
    strong_q = (aq < beta) & (np.abs(p0 - q0) < (alpha >> 2) + 2)
    p0s = np.where(strong_p, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   (2 * p1 + p0 + q1 + 2) >> 2)
    p1s = np.where(strong_p, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2s = np.where(strong_p, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0s = np.where(strong_q, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                   (2 * q1 + q0 + p1 + 2) >> 2)
    q1s = np.where(strong_q, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2s = np.where(strong_q, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    b4 = bs == 4
    Po, Qo = P.copy(), Q.copy()
    Po[:, 0] = np.where(filt, np.where(b4, p0s, p0n), p0)
    Po[:, 1] = np.where(filt, np.where(b4, p1s,
                        np.where(ap < beta, p1n, p1)), p1)
    Po[:, 2] = np.where(filt & b4, p2s, p2)
    Qo[:, 0] = np.where(filt, np.where(b4, q0s, q0n), q0)
    Qo[:, 1] = np.where(filt, np.where(b4, q1s,
                        np.where(aq < beta, q1n, q1)), q1)
    Qo[:, 2] = np.where(filt & b4, q2s, q2)
    return Po, Qo


def _filter_chroma(P, Q, bs, alpha, beta, tc0):
    """Chroma line filter: only p0/q0 change; tc = tc0 + 1 (8.7.2.3)."""
    p0, p1 = P[:, 0], P[:, 1]
    q0, q1 = Q[:, 0], Q[:, 1]
    filt = ((bs > 0) & (np.abs(p0 - q0) < alpha)
            & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta))
    tc = tc0 + 1
    delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0n = _clip1(p0 + delta)
    q0n = _clip1(q0 - delta)
    p0s = (2 * p1 + p0 + q1 + 2) >> 2
    q0s = (2 * q1 + q0 + p1 + 2) >> 2
    b4 = bs == 4
    Po, Qo = P.copy(), Q.copy()
    Po[:, 0] = np.where(filt, np.where(b4, p0s, p0n), p0)
    Qo[:, 0] = np.where(filt, np.where(b4, q0s, q0n), q0)
    return Po, Qo


class _PicInfo:
    """Per-picture maps consumed by the edge loops."""

    def __init__(self, mbs, ms, sps, pps, headers, ref_pics,
                 ref_pics1=None):
        mb_w = sps.pic_width_in_mbs
        # field pictures are standalone half-height pictures
        mb_h = len(mbs) // mb_w
        self.mb_w, self.mb_h = mb_w, mb_h
        self.field = bool(headers[0].field_pic_flag)
        self.intra = np.zeros((mb_h, mb_w), bool)
        self.qpy = np.zeros((mb_h, mb_w), np.int64)
        self.qpc = np.zeros((2, mb_h, mb_w), np.int64)
        self.sid = np.zeros((mb_h, mb_w), np.int64)
        self.nz4 = np.zeros((mb_h * 4, mb_w * 4), bool)
        off2 = pps.second_chroma_qp_index_offset
        offs = (pps.chroma_qp_index_offset,
                off2 if off2 is not None else pps.chroma_qp_index_offset)
        for addr, mb in enumerate(mbs):
            mx, my = addr % mb_w, addr // mb_w
            intra = mb.kind in _INTRA_KINDS
            self.intra[my, mx] = intra
            # I_PCM filters as QP 0 on both luma and chroma (8.7.2 qPp)
            qpy = 0 if mb.kind == MbKind.I_PCM else mb.qp_y
            self.qpy[my, mx] = qpy
            for c in (0, 1):
                self.qpc[c, my, mx] = qpc_from_qpy(qpy, offs[c])
            self.sid[my, mx] = mb.slice_id
            if not intra:
                for blk in range(16):
                    nz = (np.any(mb.luma8[blk >> 2]) if mb.transform8x8
                          else np.any(mb.luma4[blk]))
                    ox, oy = ZSCAN_4X4_POS[blk]
                    self.nz4[my * 4 + oy, mx * 4 + ox] = nz
        self.t8map = np.array([mb.transform8x8 for mb in mbs],
                              np.int64).reshape(mb_h, mb_w)
        # per-slice filter control (disable_idc, offsetA, offsetB)
        self.ctl = []
        for h in headers:
            d = h.deblocking
            if d is None:
                self.ctl.append((0, 0, 0))
            else:
                self.ctl.append((d.disable_idc, d.alpha_c0_offset_div2 * 2,
                                 d.beta_offset_div2 * 2))
        self.mv = ms.mv if ms is not None else None
        self.mv1 = ms.mv1 if ms is not None else None
        self.ref = ref_pics if ref_pics is not None else (
            ms.ref if ms is not None else None)
        self.ref1 = ref_pics1 if ref_pics1 is not None else (
            ms.ref1 if ms is not None else None)

    def _mv_set(self, by, bx):
        """[(picture_key, mv)] the block predicts from (1 or 2 entries)."""
        out = []
        if self.ref[by, bx] >= 0:
            out.append((int(self.ref[by, bx]), self.mv[by, bx]))
        if self.ref1 is not None and self.ref1[by, bx] >= 0:
            out.append((int(self.ref1[by, bx]), self.mv1[by, bx]))
        return out

    def _mv_far(self, a, b) -> bool:
        # vertical threshold is 2 quarter-samples (field units) in field
        # pictures, 4 otherwise (8.7.2.1)
        mvy_lim = 2 if self.field else 4
        return (abs(int(a[0] - b[0])) >= 4
                or abs(int(a[1] - b[1])) >= mvy_lim)

    def bs(self, bpy, bpx, bqy, bqx, mb_edge: bool,
           vertical: bool = True) -> int:
        """Boundary strength for the 4x4 block pair (8.7.2.1);
        B rules compare the sets of (reference picture, mv) used.
        In field pictures, horizontal intra MB edges are bS 3, not 4
        (the verticalEdgeFlag || !field_pic_flag condition)."""
        pm = (bpy // 4, bpx // 4)
        qm = (bqy // 4, bqx // 4)
        if self.intra[pm] or self.intra[qm]:
            if mb_edge and (vertical or not self.field):
                return 4
            return 3
        if self.nz4[bpy, bpx] or self.nz4[bqy, bqx]:
            return 2
        pa = self._mv_set(bpy, bpx)
        qa = self._mv_set(bqy, bqx)
        if len(pa) != len(qa):
            return 1  # different number of motion vectors
        if sorted(k for k, _ in pa) != sorted(k for k, _ in qa):
            return 1  # different reference pictures
        if len(pa) == 1:
            return 1 if self._mv_far(pa[0][1], qa[0][1]) else 0
        (pk0, pv0), (pk1, pv1) = pa
        (qk0, qv0), (qk1, qv1) = qa
        if pk0 != pk1:
            # distinct pictures: vectors pair up by picture
            m = {qk0: qv0, qk1: qv1}
            far = self._mv_far(pv0, m[pk0]) or self._mv_far(pv1, m[pk1])
            return 1 if far else 0
        # both predictions from the same picture: bS 1 only if BOTH
        # pairings have a far vector (8.7.2.1 note)
        d1 = self._mv_far(pv0, qv0) or self._mv_far(pv1, qv1)
        d2 = self._mv_far(pv0, qv1) or self._mv_far(pv1, qv0)
        return 1 if (d1 and d2) else 0


def deblock_frame(y, cb, cr, mbs, ms, sps, pps, headers, ref_pics=None,
                  ref_pics1=None):
    """Apply the in-loop deblocking filter to a reconstructed picture.

    Mutates the planes in place; MB raster order, vertical edges before
    horizontal within each MB (8.7 process order).  `headers` is indexed
    by slice_id.  `ref_pics` optionally maps each 4x4 block to a
    reference-picture key (e.g. DPB frame_idx); defaults to ms.ref
    (list-0 ref_idx), valid while all slices of the picture share one
    reference list."""
    info = _PicInfo(mbs, ms, sps, pps, headers, ref_pics, ref_pics1)
    mb_w, mb_h = info.mb_w, info.mb_h
    cat = sps.chroma_array_type
    for my in range(mb_h):
        for mx in range(mb_w):
            dis, offa, offb = info.ctl[int(info.sid[my, mx])]
            if dis == 1:
                continue
            for vertical in (True, False):
                edges = [0, 8] if info.t8map[my, mx] else [0, 4, 8, 12]
                for e in edges:
                    if e == 0:
                        pmx, pmy = (mx - 1, my) if vertical else (mx, my - 1)
                        if pmx < 0 or pmy < 0:
                            continue
                        if dis == 2 and info.sid[pmy, pmx] != info.sid[my, mx]:
                            continue
                    _edge_luma(y, info, mx, my, e, vertical, offa, offb)
            if cat == 3:
                # ChromaArrayType 3 (spec 8.7): Cb/Cr are filtered with
                # the LUMA process (all 4 edges per direction, luma
                # strong/weak filters) using the plane's chroma QP
                for ci, plane in ((0, cb), (1, cr)):
                    for vertical in (True, False):
                        edges = ([0, 8] if info.t8map[my, mx]
                                 else [0, 4, 8, 12])
                        for e in edges:
                            if e == 0:
                                pmx, pmy = ((mx - 1, my) if vertical
                                            else (mx, my - 1))
                                if pmx < 0 or pmy < 0:
                                    continue
                                if dis == 2 and (info.sid[pmy, pmx]
                                                 != info.sid[my, mx]):
                                    continue
                            _edge_luma(plane, info, mx, my, e, vertical,
                                       offa, offb, qp=info.qpc[ci])
            if cat in (1, 2):
                vs = [0, 4]
                hs = [0, 4] if cat == 1 else [0, 4, 8, 12]
                for e in vs:
                    if e == 0 and (mx == 0 or _skip_edge(info, mx, my, True,
                                                        dis)):
                        continue
                    _edge_chroma(cb, cr, info, mx, my, e, True, offa, offb,
                                 cat)
                for e in hs:
                    if e == 0 and (my == 0 or _skip_edge(info, mx, my, False,
                                                        dis)):
                        continue
                    _edge_chroma(cb, cr, info, mx, my, e, False, offa, offb,
                                 cat)


def deblock_frame_native(y, cb, cr, mbs, ms, sps, pps, headers,
                         ref_pics=None, ref_pics1=None):
    """C++ deblocking (native/deblock.cc), bit-identical to
    `deblock_frame`; same signature.  Planes are updated in place."""
    import ctypes as ct

    from ..native.entropy import lib, _ptr
    info = _PicInfo(mbs, ms, sps, pps, headers, ref_pics, ref_pics1)
    mb_w, mb_h = info.mb_w, info.mb_h
    cat = sps.chroma_array_type
    n4 = mb_h * 4 * mb_w * 4

    def plane_u8(p):
        return None if p is None else np.ascontiguousarray(p, np.uint8)
    yy, bb, rr = plane_u8(y), plane_u8(cb), plane_u8(cr)
    qpy = np.ascontiguousarray(info.qpy.reshape(-1), np.int32)
    qpc0 = np.ascontiguousarray(info.qpc[0].reshape(-1), np.int32)
    qpc1 = np.ascontiguousarray(info.qpc[1].reshape(-1), np.int32)
    intra = np.ascontiguousarray(info.intra.reshape(-1), np.uint8)
    t8 = np.ascontiguousarray(info.t8map.reshape(-1), np.uint8)
    sid = np.ascontiguousarray(info.sid.reshape(-1), np.int32)
    ctl = np.ascontiguousarray(np.array(info.ctl, np.int32).reshape(-1))
    nz4 = np.ascontiguousarray(info.nz4.reshape(-1), np.uint8)
    zeros_mv = np.zeros(n4 * 2, np.int32)
    neg = np.full(n4, -1, np.int32)
    mv = (np.ascontiguousarray(info.mv.reshape(-1), np.int32)
          if info.mv is not None else zeros_mv)
    mv1 = (np.ascontiguousarray(info.mv1.reshape(-1), np.int32)
           if info.mv1 is not None else zeros_mv)
    ref = (np.ascontiguousarray(info.ref.reshape(-1), np.int32)
           if info.ref is not None else neg)
    ref1 = (np.ascontiguousarray(info.ref1.reshape(-1), np.int32)
            if info.ref1 is not None else neg)

    U8 = ct.POINTER(ct.c_uint8)

    def u8p(a):
        return a.ctypes.data_as(U8) if a is not None else None
    lib().dt_deblock_frame(
        u8p(yy), u8p(bb), u8p(rr), mb_w, mb_h, cat, _ptr(qpy), _ptr(qpc0),
        _ptr(qpc1), u8p(intra), u8p(t8), _ptr(sid), _ptr(ctl), u8p(nz4),
        _ptr(mv), _ptr(mv1), _ptr(ref), _ptr(ref1))
    y[:] = yy
    if cb is not None:
        cb[:] = bb
        cr[:] = rr


def _skip_edge(info, mx, my, vertical, dis):
    pmx, pmy = (mx - 1, my) if vertical else (mx, my - 1)
    return dis == 2 and info.sid[pmy, pmx] != info.sid[my, mx]


def _edge_luma(y, info, mx, my, e, vertical, offa, offb, qp=None):
    """One luma-process edge.  qp overrides the per-MB QP map: for
    ChromaArrayType 3 the chroma planes run this same process (spec 8.7
    chromaEdgeFlag=0 path) with the plane's chroma QP map."""
    mb_edge = e == 0
    if qp is None:
        qp = info.qpy
    if vertical:
        xq = mx * 16 + e
        bqx = mx * 4 + e // 4
        rows = np.arange(my * 16, my * 16 + 16)
        P = y[rows[:, None], xq - 1 - np.arange(4)[None, :]]
        Q = y[rows[:, None], xq + np.arange(4)[None, :]]
        bpairs = [(my * 4 + g, bqx - 1, my * 4 + g, bqx) for g in range(4)]
        pm = (my, mx - 1) if mb_edge else (my, mx)
    else:
        yq = my * 16 + e
        bqy = my * 4 + e // 4
        cols = np.arange(mx * 16, mx * 16 + 16)
        P = y[yq - 1 - np.arange(4)[None, :].T, cols[None, :]].T
        Q = y[yq + np.arange(4)[None, :].T, cols[None, :]].T
        bpairs = [(bqy - 1, mx * 4 + g, bqy, mx * 4 + g) for g in range(4)]
        pm = (my - 1, mx) if mb_edge else (my, mx)
    bs4 = np.array([info.bs(*bp, mb_edge, vertical) for bp in bpairs],
                   np.int64)
    if not bs4.any():
        return
    qpav = (qp[pm] + qp[my, mx] + 1) >> 1
    ia = int(np.clip(qpav + offa, 0, 51))
    ib = int(np.clip(qpav + offb, 0, 51))
    alpha, beta = ALPHA[ia], BETA[ib]
    bs = np.repeat(bs4, 4)
    tc0 = TC0[ia][np.clip(bs, 1, 3) - 1]
    Po, Qo = _filter_luma(P.astype(np.int64), Q.astype(np.int64), bs,
                          alpha, beta, tc0)
    if vertical:
        y[rows[:, None], xq - 1 - np.arange(4)[None, :]] = Po
        y[rows[:, None], xq + np.arange(4)[None, :]] = Qo
    else:
        y[yq - 1 - np.arange(4)[None, :].T, cols[None, :]] = Po.T
        y[yq + np.arange(4)[None, :].T, cols[None, :]] = Qo.T


def _edge_chroma(cb, cr, info, mx, my, e, vertical, offa, offb, cat):
    """One chroma edge for both planes; bS from co-located luma blocks.

    4:2:0 maps chroma (x,y) -> luma (2x,2y); 4:2:2 -> (2x,y)."""
    mb_edge = e == 0
    sub_h = 2 if cat == 1 else 1
    cw, ch = 8, 8 if cat == 1 else 16
    if vertical:
        xq = mx * cw + e
        yc0 = my * ch
        lines = ch
        lbx = mx * 4 + (e * 2) // 4
        bs_lines = np.empty(lines, np.int64)
        for cy in range(lines):
            lby = (my * ch + cy) * sub_h // 4
            bs_lines[cy] = info.bs(lby, lbx - 1, lby, lbx, mb_edge)
        pm = (my, mx - 1) if mb_edge else (my, mx)
    else:
        yq = my * ch + e
        xc0 = mx * cw
        lines = cw
        lby = (yq * sub_h) // 4
        bs_lines = np.empty(lines, np.int64)
        for cx in range(lines):
            lbx = (mx * cw + cx) * 2 // 4
            bs_lines[cx] = info.bs(lby - 1, lbx, lby, lbx, mb_edge, False)
        pm = (my - 1, mx) if mb_edge else (my, mx)
    if not bs_lines.any():
        return
    for c, plane in ((0, cb), (1, cr)):
        qpav = (info.qpc[c][pm] + info.qpc[c, my, mx] + 1) >> 1
        ia = int(np.clip(qpav + offa, 0, 51))
        ibx = int(np.clip(qpav + offb, 0, 51))
        alpha, beta = ALPHA[ia], BETA[ibx]
        tc0 = TC0[ia][np.clip(bs_lines, 1, 3) - 1]
        if vertical:
            rows = np.arange(yc0, yc0 + lines)
            P = plane[rows[:, None], xq - 1 - np.arange(2)[None, :]]
            Q = plane[rows[:, None], xq + np.arange(2)[None, :]]
        else:
            cols = np.arange(xc0, xc0 + lines)
            P = plane[yq - 1 - np.arange(2)[None, :].T, cols[None, :]].T
            Q = plane[yq + np.arange(2)[None, :].T, cols[None, :]].T
        Po, Qo = _filter_chroma(P.astype(np.int64), Q.astype(np.int64),
                                bs_lines, alpha, beta, tc0)
        if vertical:
            plane[rows[:, None], xq - 1 - np.arange(2)[None, :]] = Po
            plane[rows[:, None], xq + np.arange(2)[None, :]] = Qo
        else:
            plane[yq - 1 - np.arange(2)[None, :].T, cols[None, :]] = Po.T
            plane[yq + np.arange(2)[None, :].T, cols[None, :]] = Qo.T
