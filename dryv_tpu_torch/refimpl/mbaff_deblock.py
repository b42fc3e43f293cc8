# Copy of dryv_tpu/refimpl/mbaff_deblock.py.
"""MBAFF in-loop deblocking (spec 8.7 with MbaffFrameFlag = 1).

Macroblocks filter in pair raster order (top then bottom), vertical
edges before horizontal.  Field macroblocks filter on their own field
sample rows; edges between macroblocks coded in different frame/field
modes follow the 8.7.2 special cases:

- vertical macroblock edges gather the p-side metadata per sample line
  (the left pair's top/bottom or parity MB varies down the edge);
- a frame macroblock whose above pair is field-coded filters its top
  edge TWICE, once per parity, on alternating lines against the
  corresponding above field macroblock;
- a field macroblock whose above pair is frame-coded filters its top
  edge on its own parity's lines against the above pair's bottom MB;
- mixedModeEdgeFlag (horizontal, differing coding modes): intra bS is 3
  instead of 4, inter bS is 2/1 by coded coefficients only (motion is
  not comparable across frame/field domains — the same applies to
  mixed vertical edges below the intra case);
- the vertical mv-difference threshold is 2 quarter-samples (field
  units) when either macroblock is field-coded, 4 otherwise.

The upstream reference has no deblocking at all (README.md:14); this
module is oracle-gated against libavcodec on x264 interlaced streams.
"""
from __future__ import annotations

import numpy as np

from ..cabac.syntax import MbKind
from ..avc.neighbors import POS_TO_ZSCAN
from .deblock import ALPHA, BETA, TC0, _filter_chroma, _filter_luma
from .transform import QPC_TAB

_INTRA = (MbKind.I_NXN, MbKind.I_16X16, MbKind.I_PCM, MbKind.SI)


def _qpc(qp, off):
    qpi = int(np.clip(qp + off, 0, 51))
    return qpi if qpi < 30 else int(QPC_TAB[min(qpi - 30, 21)])


class _Ctx:
    def __init__(self, y, cb, cr, mbs, ms, sps, pps, headers, dpb):
        self.y = y
        self.cb = cb
        self.cr = cr
        self.mbs = mbs
        self.ms = ms
        self.mb_w = sps.pic_width_in_mbs
        self.mb_hp = sps.frame_height_in_mbs // 2  # pair rows
        self.pps = pps
        n = len(mbs)
        self.intra = np.array([m.kind in _INTRA for m in mbs])
        self.qpy = np.array([0 if m.kind == MbKind.I_PCM else m.qp_y
                             for m in mbs], np.int64)
        off1 = pps.second_chroma_qp_offset
        self.qpc = np.stack(
            [np.array([_qpc(q, pps.chroma_qp_index_offset)
                       for q in self.qpy]),
             np.array([_qpc(q, off1) for q in self.qpy])])
        self.sid = np.array([m.slice_id for m in mbs])
        # slice deblock control: sid -> (disable_idc, offA, offB)
        self.ctl = {}
        for i, h in enumerate(headers):
            if h.deblocking is None:
                self.ctl[i] = (0, 0, 0)
            else:
                self.ctl[i] = (h.deblocking.disable_idc,
                               h.deblocking.alpha_c0_offset_div2 * 2,
                               h.deblocking.beta_offset_div2 * 2)
        # per-4x4-block nonzero-coefficient map (8x8 blocks under t8)
        self.nz = np.zeros((n, 4, 4), bool)
        for a, m in enumerate(mbs):
            if m.kind in (MbKind.P_SKIP, MbKind.B_SKIP) or self.intra[a]:
                continue
            t8 = bool(m.transform8x8)
            nz8 = np.asarray(m.luma8).reshape(4, 64).any(-1)
            nz4 = np.asarray(m.luma4).reshape(16, 16).any(-1)
            for by in range(4):
                for bx in range(4):
                    z = POS_TO_ZSCAN[(bx, by)]
                    if not ((m.cbp >> (z >> 2)) & 1):
                        continue
                    self.nz[a, by, bx] = (nz8[2 * (by >> 1) + (bx >> 1)]
                                          if t8 else nz4[z])
        # per-block reference picture keys (disjoint frame/field spaces)
        self.refk = np.full((n, 2, 4, 4), -1, np.int64)
        l0 = [p.frame_idx for p in dpb.ref_list0]
        l1 = [p.frame_idx for p in dpb.ref_list1]
        lists = (l0, l1)
        for a, m in enumerate(mbs):
            if self.intra[a]:
                continue
            fld = m.field_flag
            for w in (0, 1):
                keys = lists[w]
                if not keys:
                    continue
                r = ms.ref[a, w]
                if fld:
                    par = (a & 1) ^ (r & 1)
                    fk = np.where(r >= 0,
                                  np.array(keys + [0])[
                                      np.clip(r >> 1, 0, len(keys))],
                                  -1)
                    self.refk[a, w] = np.where(
                        r >= 0, (1 << 20) + 2 * fk + par, -1)
                else:
                    fk = np.where(r >= 0,
                                  np.array(keys + [0])[
                                      np.clip(r, 0, len(keys))], -1)
                    self.refk[a, w] = np.where(r >= 0, fk, -1)

    # -- per-MB geometry ---------------------------------------------------
    def fld(self, pair):
        m = self.mbs[pair * 2]
        return m.field_flag

    def rows_y(self, addr):
        pair, bot = addr >> 1, addr & 1
        py = pair // self.mb_w
        if self.fld(pair):
            return 32 * py + bot + 2 * np.arange(16)
        return 32 * py + 16 * bot + np.arange(16)

    def rows_c(self, addr):
        pair, bot = addr >> 1, addr & 1
        py = pair // self.mb_w
        if self.fld(pair):
            return 16 * py + bot + 2 * np.arange(8)
        return 16 * py + 8 * bot + np.arange(8)

    def mb_at_frame_row(self, pair, r_local):
        """(addr, mb_row) of the MB of `pair` containing pair-local luma
        frame row r_local (0..31)."""
        if self.fld(pair):
            return pair * 2 + (r_local & 1), r_local >> 1
        return pair * 2 + (1 if r_local >= 16 else 0), r_local % 16

    # -- boundary strength -------------------------------------------------
    def bs_pair(self, pa, pby, pbx, qa, qby, qbx, mb_edge, vertical):
        """bS for the block pair p=(MB pa, block pby,pbx), q=..."""
        ip, iq = self.intra[pa], self.intra[qa]
        mixed = (self.mbs[pa].field_flag != self.mbs[qa].field_flag)
        if ip or iq:
            if mb_edge:
                # horizontal MB edges involving any field MB use 3
                # (8.7.2.1: bS 4 needs a vertical edge or two frame MBs)
                if vertical or not (self.mbs[pa].field_flag
                                    or self.mbs[qa].field_flag):
                    return 4
                return 3
            return 3
        if self.nz[pa, pby, pbx] or self.nz[qa, qby, qbx]:
            return 2
        if mixed:
            return 1
        mvy_lim = 2 if self.mbs[pa].field_flag else 4

        def far(a, b):
            return (abs(int(a[0] - b[0])) >= 4
                    or abs(int(a[1] - b[1])) >= mvy_lim)

        k0p = self.refk[pa, 0, pby, pbx]
        k1p = self.refk[pa, 1, pby, pbx]
        k0q = self.refk[qa, 0, qby, qbx]
        k1q = self.refk[qa, 1, qby, qbx]
        mv0p = self.ms.mv[pa, 0, pby, pbx]
        mv1p = self.ms.mv[pa, 1, pby, pbx]
        mv0q = self.ms.mv[qa, 0, qby, qbx]
        mv1q = self.ms.mv[qa, 1, qby, qbx]
        np_cnt = int(k0p >= 0) + int(k1p >= 0)
        nq_cnt = int(k0q >= 0) + int(k1q >= 0)
        if np_cnt != nq_cnt or {min(k0p, k1p), max(k0p, k1p)} != \
                {min(k0q, k1q), max(k0q, k1q)}:
            return 1
        if np_cnt == 1:
            mvp = mv0p if k0p >= 0 else mv1p
            mvq = mv0q if k0q >= 0 else mv1q
            return 1 if far(mvp, mvq) else 0
        if k0p == k1p:  # same picture twice: both pairings must be far
            fa = far(mv0p, mv0q) or far(mv1p, mv1q)
            fx = far(mv0p, mv1q) or far(mv1p, mv0q)
            return 1 if (fa and fx) else 0
        if k0p == k0q:
            return 1 if (far(mv0p, mv0q) or far(mv1p, mv1q)) else 0
        return 1 if (far(mv0p, mv1q) or far(mv1p, mv0q)) else 0

    # -- edge application ---------------------------------------------------
    def filter_mb(self, addr):
        mb = self.mbs[addr]
        dis, offa, offb = self.ctl[mb.slice_id]
        if dis == 1:
            return
        pair, bot = addr >> 1, addr & 1
        px, py = pair % self.mb_w, pair // self.mb_w
        fld = mb.field_flag
        rows = self.rows_y(addr)
        crows = self.rows_c(addr)
        x0, cx0 = 16 * px, 8 * px
        y = self.y
        qpq = int(self.qpy[addr])

        def idx_ab(qpav, off):
            return int(np.clip(qpav + off, 0, 51))

        def line_params(bs_arr, qp_ps):
            """(alpha, beta, tc0) arrays per line from per-line p-QPs."""
            qpav = (np.asarray(qp_ps) + qpq + 1) >> 1
            ia = np.clip(qpav + offa, 0, 51)
            ib = np.clip(qpav + offb, 0, 51)
            al = ALPHA[ia]
            be = BETA[ib]
            tc = TC0[ia, np.clip(np.asarray(bs_arr), 1, 3) - 1]
            return al, be, tc

        # ===== vertical edges ==========================================
        # left MB edge
        if px > 0:
            lpair = pair - 1
            bs = np.zeros(16, np.int64)
            qp_ps = np.zeros(16, np.int64)
            ok = np.ones(16, bool)
            pa_line = np.zeros(16, np.int64)
            for i in range(16):
                r = int(rows[i])
                pa, prow = self.mb_at_frame_row(lpair, r - 32 * py)
                pa_line[i] = pa
                if dis == 2 and self.sid[pa] != self.sid[addr]:
                    ok[i] = False
                    continue
                bs[i] = self.bs_pair(pa, prow >> 2, 3, addr, i >> 2, 0,
                                     True, True)
                qp_ps[i] = self.qpy[pa]
            al, be, tc = line_params(bs, qp_ps)
            bs = np.where(ok, bs, 0)
            P = y[rows[:, None], x0 - 1 - np.arange(4)[None, :]] \
                .astype(np.int64)
            Q = y[rows[:, None], x0 + np.arange(4)[None, :]].astype(np.int64)
            Po, Qo = _filter_luma(P, Q, bs, al, be, tc)
            y[rows[:, None], x0 - 1 - np.arange(4)[None, :]] = Po
            y[rows[:, None], x0 + np.arange(4)[None, :]] = Qo
            # chroma: line i corresponds to luma line 2i of this MB
            csb = np.zeros(8, np.int64)
            cqp = np.zeros((2, 8), np.int64)
            for i in range(8):
                pa = int(pa_line[2 * i])
                csb[i] = bs[2 * i] if ok[2 * i] else 0
                cqp[0, i] = self.qpc[0, pa]
                cqp[1, i] = self.qpc[1, pa]
            for ci, plane in ((0, self.cb), (1, self.cr)):
                qpavc = (cqp[ci] + self.qpc[ci, addr] + 1) >> 1
                ia = np.clip(qpavc + offa, 0, 51)
                ib = np.clip(qpavc + offb, 0, 51)
                tc = TC0[ia, np.clip(csb, 1, 3) - 1]
                P = plane[crows[:, None], cx0 - 1 - np.arange(2)[None, :]] \
                    .astype(np.int64)
                Q = plane[crows[:, None], cx0 + np.arange(2)[None, :]] \
                    .astype(np.int64)
                Po, Qo = _filter_chroma(P, Q, csb, ALPHA[ia], BETA[ib], tc)
                plane[crows[:, None], cx0 - 1 - np.arange(2)[None, :]] = Po
                plane[crows[:, None], cx0 + np.arange(2)[None, :]] = Qo

        # internal vertical edges
        for e in (1, 2, 3):
            if mb.transform8x8 and e != 2:
                continue
            bs = np.zeros(16, np.int64)
            for g in range(4):
                bs[4 * g:4 * g + 4] = self.bs_pair(
                    addr, g, e - 1, addr, g, e, False, True)
            qpav = qpq
            ia = idx_ab(qpav, offa)
            ib = idx_ab(qpav, offb)
            tc = TC0[ia, np.clip(bs, 1, 3) - 1]
            c = x0 + 4 * e
            P = y[rows[:, None], c - 1 - np.arange(4)[None, :]] \
                .astype(np.int64)
            Q = y[rows[:, None], c + np.arange(4)[None, :]].astype(np.int64)
            Po, Qo = _filter_luma(P, Q, bs, ALPHA[ia], BETA[ib], tc)
            y[rows[:, None], c - 1 - np.arange(4)[None, :]] = Po
            y[rows[:, None], c + np.arange(4)[None, :]] = Qo
            if e == 2:
                csb = bs[::2]
                for ci, plane in ((0, self.cb), (1, self.cr)):
                    qc = int(self.qpc[ci, addr])
                    iac = idx_ab(qc, offa)
                    ibc = idx_ab(qc, offb)
                    tcc = TC0[iac, np.clip(csb, 1, 3) - 1]
                    cc = cx0 + 4
                    P = plane[crows[:, None],
                              cc - 1 - np.arange(2)[None, :]] \
                        .astype(np.int64)
                    Q = plane[crows[:, None], cc + np.arange(2)[None, :]] \
                        .astype(np.int64)
                    Po, Qo = _filter_chroma(P, Q, csb, ALPHA[iac],
                                            BETA[ibc], tcc)
                    plane[crows[:, None],
                          cc - 1 - np.arange(2)[None, :]] = Po
                    plane[crows[:, None], cc + np.arange(2)[None, :]] = Qo

        # ===== horizontal edges ========================================
        cols = x0 + np.arange(16)
        ccols = cx0 + np.arange(8)

        def h_edge(p_rows, q_rows, pa_list, p_brow, q_brow, mb_edge,
                   cp_rows, cq_rows, pa_c):
            """One horizontal luma+chroma edge; pa_list: p MB per 4-col
            group is constant here (single p MB), bS per 4-col group."""
            pa = pa_list
            if dis == 2 and mb_edge and self.sid[pa] != self.sid[addr]:
                return
            bs = np.zeros(16, np.int64)
            for g in range(4):
                bs[4 * g:4 * g + 4] = self.bs_pair(
                    pa, p_brow, g, addr, q_brow, g, mb_edge, False)
            qpav = (int(self.qpy[pa]) + qpq + 1) >> 1 if mb_edge else qpq
            ia = idx_ab(qpav, offa)
            ib = idx_ab(qpav, offb)
            tc = TC0[ia, np.clip(bs, 1, 3) - 1]
            P = y[np.asarray(p_rows)[::-1][None, :], cols[:, None]] \
                .astype(np.int64)  # [16 cols, 4] p0 first
            Q = y[np.asarray(q_rows)[None, :], cols[:, None]] \
                .astype(np.int64)
            Po, Qo = _filter_luma(P, Q, bs, ALPHA[ia], BETA[ib], tc)
            y[np.asarray(p_rows)[::-1][None, :], cols[:, None]] = Po
            y[np.asarray(q_rows)[None, :], cols[:, None]] = Qo
            if cp_rows is not None:
                # chroma line x maps to luma column 2x
                csb2 = bs[::2]
                for ci, plane in ((0, self.cb), (1, self.cr)):
                    if mb_edge:
                        qpavc = (int(self.qpc[ci, pa_c])
                                 + int(self.qpc[ci, addr]) + 1) >> 1
                    else:
                        qpavc = int(self.qpc[ci, addr])
                    iac = idx_ab(qpavc, offa)
                    ibc = idx_ab(qpavc, offb)
                    tcc = TC0[iac, np.clip(csb2, 1, 3) - 1]
                    P = plane[np.asarray(cp_rows)[::-1][None, :],
                              ccols[:, None]].astype(np.int64)
                    Q = plane[np.asarray(cq_rows)[None, :],
                              ccols[:, None]].astype(np.int64)
                    Po, Qo = _filter_chroma(P, Q, csb2, ALPHA[iac],
                                            BETA[ibc], tcc)
                    plane[np.asarray(cp_rows)[::-1][None, :],
                          ccols[:, None]] = Po
                    plane[np.asarray(cq_rows)[None, :],
                          ccols[:, None]] = Qo

        # top MB edge
        if fld:
            if py > 0:
                apair = pair - self.mb_w
                if self.fld(apair):
                    pa = apair * 2 + bot
                    p_rows = 32 * (py - 1) + bot + 2 * np.arange(12, 16)
                    cp = 16 * (py - 1) + bot + 2 * np.arange(6, 8)
                    h_edge(p_rows, rows[0:4], pa, 3, 0, True, cp,
                           crows[0:2], pa)
                else:
                    # mixed: p lines are the above pair's parity rows
                    pa = apair * 2 + 1  # bottom frame MB holds those rows
                    base = 32 * py
                    p_rows = np.array([base - 8 + bot, base - 6 + bot,
                                       base - 4 + bot, base - 2 + bot])
                    cbase = 16 * py
                    cp = np.array([cbase - 4 + bot, cbase - 2 + bot])
                    h_edge(p_rows, rows[0:4], pa, 3, 0, True, cp,
                           crows[0:2], pa)
        else:
            if bot:
                pa = addr - 1
                p_rows = 32 * py + np.arange(12, 16)
                cp = 16 * py + np.arange(6, 8)
                h_edge(p_rows, rows[0:4], pa, 3, 0, True, cp, crows[0:2],
                       pa)
            elif py > 0:
                apair = pair - self.mb_w
                if not self.fld(apair):
                    pa = apair * 2 + 1
                    p_rows = 32 * (py - 1) + np.arange(28, 32)
                    cp = 16 * (py - 1) + np.arange(14, 16)
                    h_edge(p_rows, rows[0:4], pa, 3, 0, True, cp,
                           crows[0:2], pa)
                else:
                    # mixed: two field edges, one per parity
                    for j in (0, 1):
                        pa = apair * 2 + j
                        p_rows = 32 * (py - 1) + j + 2 * np.arange(12, 16)
                        q_rows = 32 * py + j + 2 * np.arange(4)
                        cp = 16 * (py - 1) + j + 2 * np.arange(6, 8)
                        cq = 16 * py + j + 2 * np.arange(2)
                        h_edge(p_rows, q_rows, pa, 3, 0, True, cp, cq, pa)

        # internal horizontal edges
        for e in (1, 2, 3):
            if mb.transform8x8 and e != 2:
                continue
            p_rows = rows[4 * e - 4:4 * e]
            q_rows = rows[4 * e:4 * e + 4]
            if e == 2:
                h_edge(p_rows, q_rows, addr, e - 1, e, False,
                       crows[2:4], crows[4:6], addr)
            else:
                h_edge(p_rows, q_rows, addr, e - 1, e, False, None, None,
                       addr)


def deblock_mbaff_frame(y, cb, cr, mbs, ms, sps, pps, headers, dpb):
    """In-place MBAFF deblocking of one reconstructed picture."""
    if sps.chroma_array_type != 1:
        raise NotImplementedError("MBAFF deblocking for non-4:2:0")
    ctx = _Ctx(y, cb, cr, mbs, ms, sps, pps, headers, dpb)
    for addr in range(len(mbs)):
        ctx.filter_mb(addr)
