# Copy of dryv_tpu/refimpl/mbaff_inter.py.
"""MBAFF inter (P/B) reconstruction, scalar reference.

Extends the MBAFF intra path (refimpl/mbaff.py) with the interlaced
inter machinery the upstream reference lacks entirely (its entropy layer
parses MBAFF mvd/ref_idx — cabac/mod.rs:907-957 — but reconstructs
nothing):

- MBAFF motion state at MB-pair-local 4x4 granularity with the spec
  6.4.12 neighbouring-location derivation shared with intra
  (avc.neighbors.mbaff_neighbor);
- 8.4.1.3.2 motion-data derivation with frame/field scaling (neighbour
  in the other coding mode: mv_y and ref_idx convert into the current
  macroblock's domain);
- 8.4.2.1 field reference mapping: a field macroblock's ref_idx k
  selects frame list entry k >> 1, same parity as the current field for
  even k, opposite for odd;
- field motion compensation: quarter-pel MC in field-plane coordinates
  (every other frame row), scattered back through the pair's row map;
- P_Skip (8.4.1.1), B spatial/temporal direct (8.4.1.2) with the
  8.4.1.2.1 co-located block derivation across frame/field pairs;
- weighted prediction (explicit tables indexed by the frame list entry;
  implicit weights from field POC distances for field macroblocks).

Bit-exactness is enforced against libavcodec on x264 interlaced IPB
streams (tests/test_mbaff.py, tests/conformance mbaff_tff/mbaff_bff).
"""
from __future__ import annotations

import numpy as np

from ..avc.neighbors import ZSCAN_4X4_POS, mbaff_neighbor
from ..cabac.syntax import MbKind
from .inter import (ExplicitWP, ImplicitWP, _min_positive, _partitions,
                    _wp_bi, _wp_single, chroma_interp, luma_interp,
                    PRED_DIRECT, PRED_L0, PRED_L1)
from .mbaff import MbaffIntraRecon
from .recon import dezigzag4, dezigzag8
from .transform import (dequant_idct_4x4, dequant_idct_8x8, idct_chroma_dc,
                        qpc_from_qpy)


def _div2(v):
    """Spec '/' integer division: truncation toward zero."""
    return int(v / 2) if isinstance(v, (int, np.integer)) else \
        np.trunc(v / 2).astype(np.int64)


class MbaffMotion:
    """Per-picture motion field in MB-pair-local layout.

    mv[addr][which][by][bx][2] quarter-pel (field units for field MBs),
    ref[addr][which][by][bx] (-1 = intra / unused), plus per-pair field
    flags — the layout the 8.4.1.2.1 co-located derivation needs."""

    def __init__(self, mb_w: int, n_mbs: int):
        self.mb_w = mb_w
        self.n = n_mbs
        self.mv = np.zeros((n_mbs, 2, 4, 4, 2), np.int64)
        self.ref = np.full((n_mbs, 2, 4, 4), -1, np.int64)
        self.decoded = np.zeros((n_mbs, 4, 4), bool)  # per 4x4 block
        self.field = np.zeros(n_mbs // 2, np.int64)  # per pair
        self.sid = np.full(n_mbs, -2, np.int64)

    def set_part(self, addr, bx0, by0, w4, h4, mv, ref, which):
        self.mv[addr, which, by0:by0 + h4, bx0:bx0 + w4] = mv
        self.ref[addr, which, by0:by0 + h4, bx0:bx0 + w4] = ref
        self.decoded[addr, by0:by0 + h4, bx0:bx0 + w4] = True


class MbaffInterRecon(MbaffIntraRecon):
    """Whole-picture MBAFF reconstruction: intra + P/B inter MBs."""

    def __init__(self, sps, pps, mbs, refs):
        super().__init__(sps, pps, mbs)
        self.refs = refs      # _MbaffRefs (lists, planes, wp, direct ctx)
        n = len(mbs)
        self.ms = MbaffMotion(self.mb_w, n)
        for pair in range(n // 2):
            self.ms.field[pair] = self.field(pair)
        for a, m in enumerate(mbs):
            if m is not None:
                self.ms.sid[a] = m.slice_id

    # -- neighbour motion (8.4.1.3.2 with MBAFF scaling) -------------------
    def _nb_motion(self, addr, xN, yN, which):
        """(avail, mv, ref) of the neighbouring partition at luma sample
        offset (xN, yN), converted into the current MB's frame/field
        domain."""
        zero = np.zeros(2, np.int64)
        r = mbaff_neighbor(addr, xN, yN, self.mb_w, self.field, 16, 16)
        if r is None:
            return False, zero, -1
        naddr, xW, yM = r
        bx, by = xW >> 2, yM >> 2
        if not self.ms.decoded[naddr, by, bx] or \
                self.ms.sid[naddr] != self.ms.sid[addr]:
            return False, zero, -1
        ref = int(self.ms.ref[naddr, which, by, bx])
        mv = self.ms.mv[naddr, which, by, bx].copy()
        cur_f = self.mbs[addr].field_flag
        nb_f = self.mbs[naddr].field_flag
        if ref >= 0:
            if cur_f and not nb_f:      # field MB reads a frame neighbour
                mv[1] = _div2(mv[1])
                ref *= 2
            elif nb_f and not cur_f:    # frame MB reads a field neighbour
                mv[1] *= 2
                ref >>= 1
        return True, mv, ref

    def _neighbors(self, addr, ox, oy, w4, which):
        """A/B/C(/D fallback) for the partition at block offset (ox, oy),
        width w4, within MB addr (6.4.11.7)."""
        x, y = ox * 4, oy * 4
        a = self._nb_motion(addr, x - 1, y, which)
        b = self._nb_motion(addr, x, y - 1, which)
        c = self._nb_motion(addr, x + w4 * 4, y - 1, which)
        # C within the current MB but not yet decoded (partition order):
        # available only if its z-scan block precedes the anchor — the
        # mbaff_neighbor call already returns the in-MB location; gate it
        if not c[0]:
            c = self._nb_motion(addr, x - 1, y - 1, which)  # D fallback
        return a, b, c

    def _median_pred(self, addr, ox, oy, w4, ref_idx, which):
        a, b, c = self._neighbors(addr, ox, oy, w4, which)
        av_a, mv_a, ref_a = a
        av_b, mv_b, ref_b = b
        av_c, mv_c, ref_c = c
        if not av_b and not av_c and av_a:
            return mv_a.copy()
        matches = [(mv_a, ref_a == ref_idx and av_a),
                   (mv_b, ref_b == ref_idx and av_b),
                   (mv_c, ref_c == ref_idx and av_c)]
        hit = [mv for mv, m in matches if m]
        if len(hit) == 1:
            return hit[0].copy()
        return np.median(np.stack([mv_a, mv_b, mv_c]),
                         axis=0).astype(np.int64)

    def _mv_pred(self, addr, shape, ox, oy, w4, ref_idx, part_idx, which):
        if shape == (16, 8):
            a, b, c = self._neighbors(addr, ox, oy, w4, which)
            if part_idx == 0:
                if b[0] and b[2] == ref_idx:
                    return b[1].copy()
            else:
                if a[0] and a[2] == ref_idx:
                    return a[1].copy()
        elif shape == (8, 16):
            a, b, c = self._neighbors(addr, ox, oy, w4, which)
            if part_idx == 0:
                if a[0] and a[2] == ref_idx:
                    return a[1].copy()
            else:
                if c[0] and c[2] == ref_idx:
                    return c[1].copy()
        return self._median_pred(addr, ox, oy, w4, ref_idx, which)

    def _mv_skip(self, addr):
        """P_Skip motion (8.4.1.1): zero when A or B is unavailable (out
        of picture / other slice) or has zero motion to ref 0."""
        a = self._nb_motion(addr, -1, 0, 0)
        b = self._nb_motion(addr, 0, -1, 0)
        zero = np.zeros(2, np.int64)
        if not a[0] or not b[0]:
            return zero
        for av, mv, ref in (a, b):
            if av and ref == 0 and mv[0] == 0 and mv[1] == 0:
                return zero
        return self._median_pred(addr, 0, 0, 4, 0, 0)

    # -- field reference resolution (8.4.2.1) --------------------------------
    def _ref_planes(self, addr, which, ridx):
        """(y, cb, cr, frame_entry_idx, parity|None) for ref_idx ridx of
        the current MB.  Field MBs address the parity-interleaved field
        list; planes come back as field views (every other row)."""
        lst = self.refs.lists[which]
        mb = self.mbs[addr]
        if not mb.field_flag:
            y, cb, cr = lst[ridx].planes
            return y, cb, cr, ridx, None
        fr = ridx >> 1
        cur_par = addr & 1
        par = cur_par if (ridx & 1) == 0 else 1 - cur_par
        y, cb, cr = lst[fr].planes
        return (y[par::2], cb[par::2] if cb is not None else None,
                cr[par::2] if cr is not None else None, fr, par)

    # -- co-located derivation (8.4.1.2.1) ------------------------------------
    def _colocated(self, addr, bx, by):
        """(mv, ref, col_list, vert_scale) of the co-located 4x4 block for
        current block (bx, by); vert_scale in {0: one-to-one, 1:
        frm-to-fld (y/2), 2: fld-to-frm (y*2)}.  Returns None if the
        co-located MB is intra."""
        col = self.refs.col            # stored MbaffMotion of RefPicList1[0]
        pair, bot = addr >> 1, addr & 1
        cur_f = self.mbs[addr].field_flag
        col_f = int(col.field[pair])
        if cur_f == col_f:
            naddr, nby, scale = addr, by, 0
        elif cur_f and not col_f:      # current field, col pair frame
            naddr = pair * 2 + (1 if by >= 2 else 0)
            nby = (2 * by) & 3
            scale = 1
        else:                          # current frame, col pair field
            naddr = pair * 2 + self.refs.col_parity
            nby = 2 * bot + (by >> 1)
            scale = 2
        for which in (0, 1):
            ref = int(col.ref[naddr, which, nby, bx])
            if ref >= 0:
                return (col.mv[naddr, which, nby, bx].copy(), ref, which,
                        scale)
        return None

    def _spatial_direct(self, addr):
        """8.4.1.2.2 for the whole MB (direct_8x8_inference)."""
        refs = []
        for which in (0, 1):
            a, b, c = self._neighbors(addr, 0, 0, 4, which)
            r = _min_positive(_min_positive(a[2] if a[0] else -1,
                                            b[2] if b[0] else -1),
                              c[2] if c[0] else -1)
            refs.append(int(r))
        ref0, ref1 = refs
        zero = np.zeros(2, np.int64)
        if ref0 < 0 and ref1 < 0:
            return 0, 0, zero, zero.copy(), [True] * 4
        mv0 = (self._median_pred(addr, 0, 0, 4, ref0, 0) if ref0 >= 0
               else zero)
        mv1 = (self._median_pred(addr, 0, 0, 4, ref1, 1) if ref1 >= 0
               else zero)
        zero_quad = [False] * 4
        if self.refs.col is not None and self.refs.col_shortterm:
            corners = [(0, 0), (3, 0), (0, 3), (3, 3)]
            for q, (cx, cy) in enumerate(corners):
                got = self._colocated(addr, cx, cy)
                if got is None:
                    continue
                cmv, cref, cwhich, scale = got
                # refIdxCol == 0 test is in the co-located picture's own
                # list domain (8.4.1.2.2)
                if scale == 1:
                    cmv = cmv.copy()
                    cmv[1] = _div2(cmv[1])
                elif scale == 2:
                    cmv = cmv.copy()
                    cmv[1] *= 2
                zero_quad[q] = (cref == 0 and abs(int(cmv[0])) <= 1
                                and abs(int(cmv[1])) <= 1)
        return ref0, ref1, mv0, mv1, zero_quad

    def _derive_direct(self, addr):
        if self.refs.temporal_direct:
            raise NotImplementedError(
                "MBAFF temporal direct (x264 emits spatial)")
        r0, r1, m0, m1, zq = self._spatial_direct(addr)
        quads = []
        zero = np.zeros(2, np.int64)
        for q in range(4):
            mv0 = zero if (zq[q] and r0 == 0) else m0
            mv1 = zero if (zq[q] and r1 == 0) else m1
            quads.append((r0, r1, mv0, mv1))
        return quads

    # -- inter MB reconstruction ------------------------------------------
    def recon_inter_mb(self, addr):
        mb = self.mbs[addr]
        pair, bot = addr >> 1, addr & 1
        px, py = pair % self.mb_w, pair // self.mb_w
        fld = mb.field_flag
        # luma/chroma origins in the MC coordinate frame (field coords for
        # field MBs, frame coords otherwise)
        x0 = 16 * px
        y0 = 16 * py if fld else 32 * py + 16 * bot
        cx0 = 8 * px
        cy0 = self.chh * py if fld else 2 * self.chh * py + self.chh * bot
        maxv = self.maxv
        cat = self.cat
        suby = 2 if cat == 1 else 1
        chh = self.chh
        pred_y = np.zeros((16, 16), np.int64)
        pred_cb = np.zeros((chh, 8), np.int64) if cat else None
        pred_cr = np.zeros((chh, 8), np.int64) if cat else None
        wp = self.refs.wp

        def mc_part(ox4, oy4, w4, h4, used):
            px_, py_ = x0 + ox4 * 4, y0 + oy4 * 4
            pw, ph = w4 * 4, h4 * 4
            preds = []
            for which, mv, ridx in used:
                ry, rcb, rcr, fr_idx, par = self._ref_planes(addr, which,
                                                             ridx)
                yv = luma_interp(ry, px_, py_, pw, ph, int(mv[0]),
                                 int(mv[1]))
                cbv = crv = None
                if cat:
                    # 8.4.1.4: 4:2:0 opposite-parity field reference
                    # shifts the chroma vertical MV by +/- 2 quarter
                    # samples (chroma siting differs between fields)
                    cmvy = int(mv[1])
                    if par is not None and par != (addr & 1) and cat == 1:
                        cmvy += 2 if (addr & 1) else -2
                    cbv = chroma_interp(rcb, px_ // 2, py_ // suby,
                                        pw // 2, ph // suby, int(mv[0]),
                                        cmvy, suby)
                    crv = chroma_interp(rcr, px_ // 2, py_ // suby,
                                        pw // 2, ph // suby, int(mv[0]),
                                        cmvy, suby)
                preds.append((which, ridx, fr_idx, par, yv, cbv, crv))
            accb = accr = None
            if len(preds) == 1:
                which, ridx, fr_idx, par, accy, accb, accr = preds[0]
                if isinstance(wp, ExplicitWP):
                    accy = _wp_single(accy, *wp.luma(which, fr_idx))
                    if cat:
                        accb = _wp_single(accb, *wp.chroma(which, fr_idx, 0))
                        accr = _wp_single(accr, *wp.chroma(which, fr_idx, 1))
            elif isinstance(wp, ExplicitWP):
                _, _, f0, _, y0_, cb0, cr0 = preds[0]
                _, _, f1, _, y1_, cb1, cr1 = preds[1]
                dy, wy0, oy0 = wp.luma(0, f0)
                _, wy1, oy1 = wp.luma(1, f1)
                accy = _wp_bi(y0_, y1_, dy, wy0, oy0, wy1, oy1)
                if cat:
                    dc, wb0, ob0 = wp.chroma(0, f0, 0)
                    _, wb1, ob1 = wp.chroma(1, f1, 0)
                    accb = _wp_bi(cb0, cb1, dc, wb0, ob0, wb1, ob1)
                    _, wr0, or0 = wp.chroma(0, f0, 1)
                    _, wr1, or1 = wp.chroma(1, f1, 1)
                    accr = _wp_bi(cr0, cr1, dc, wr0, or0, wr1, or1)
            elif isinstance(wp, ImplicitWP):
                _, r0_, f0, p0, y0_, cb0, cr0 = preds[0]
                _, r1_, f1, p1, y1_, cb1, cr1 = preds[1]
                if fld:
                    w0, w1 = self.refs.implicit_field(addr, f0, p0, f1, p1)
                else:
                    w0, w1 = wp.biweights(f0, f1)
                accy = _wp_bi(y0_, y1_, 5, w0, 0, w1, 0)
                if cat:
                    accb = _wp_bi(cb0, cb1, 5, w0, 0, w1, 0)
                    accr = _wp_bi(cr0, cr1, 5, w0, 0, w1, 0)
            else:
                _, _, _, _, y0_, cb0, cr0 = preds[0]
                _, _, _, _, y1_, cb1, cr1 = preds[1]
                accy = (y0_ + y1_ + 1) >> 1
                if cat:
                    accb = (cb0 + cb1 + 1) >> 1
                    accr = (cr0 + cr1 + 1) >> 1
            pred_y[oy4 * 4:oy4 * 4 + ph, ox4 * 4:ox4 * 4 + pw] = accy
            if cat:
                cy, cph = oy4 * 4 // suby, ph // suby
                pred_cb[cy:cy + cph, ox4 * 2:ox4 * 2 + pw // 2] = accb
                pred_cr[cy:cy + cph, ox4 * 2:ox4 * 2 + pw // 2] = accr

        def direct_quad(q, quads):
            r0, r1, mv0, mv1 = quads[q]
            qx, qy = (q & 1) * 2, (q >> 1) * 2
            used = []
            for which, r, mv in ((0, r0, mv0), (1, r1, mv1)):
                if r >= 0:
                    used.append((which, mv, r))
                    self.ms.set_part(addr, qx, qy, 2, 2, mv, r, which)
                else:
                    self.ms.set_part(addr, qx, qy, 2, 2,
                                     np.zeros(2, np.int64), -1, which)
            mc_part(qx, qy, 2, 2, used)

        if mb.kind == MbKind.P_SKIP:
            mv = self._mv_skip(addr)
            self.ms.set_part(addr, 0, 0, 4, 4, mv, 0, 0)
            mc_part(0, 0, 4, 4, [(0, mv, 0)])
        elif mb.kind in (MbKind.B_SKIP, MbKind.B_DIRECT):
            dvals = self._derive_direct(addr)
            for q in range(4):
                direct_quad(q, dvals)
        else:
            dvals = None
            for (ox4, oy4, w4, h4, pred, quad, anchor, shape,
                 pidx) in _partitions(mb):
                if pred == PRED_DIRECT:
                    if dvals is None:
                        dvals = self._derive_direct(addr)
                    direct_quad(quad, dvals)
                    continue
                used = []
                for which in ((0,) if pred == PRED_L0 else
                              (1,) if pred == PRED_L1 else (0, 1)):
                    ridx = int(mb.ref_idx[which][quad])
                    mvp = self._mv_pred(addr, shape, ox4, oy4, w4, ridx,
                                        pidx, which)
                    mv = mvp + np.asarray(mb.mvd[which][anchor], np.int64)
                    used.append((which, mv, ridx))
                used_lists = {u[0] for u in used}
                for which in (0, 1):
                    if which in used_lists:
                        _, mv, ridx = next(u for u in used
                                           if u[0] == which)
                        self.ms.set_part(addr, ox4, oy4, w4, h4, mv, ridx,
                                         which)
                    elif mb.kind in (MbKind.B, MbKind.B_8X8):
                        self.ms.set_part(addr, ox4, oy4, w4, h4,
                                         np.zeros(2, np.int64), -1, which)
                mc_part(ox4, oy4, w4, h4, used)

        # ---- residuals ---------------------------------------------------
        qpy = mb.qp_y
        skip_kinds = (MbKind.P_SKIP, MbKind.B_SKIP)
        resid = np.zeros((16, 16), np.int64)
        if mb.kind not in skip_kinds and (mb.cbp & 0x0F):
            if mb.transform8x8:
                for blk in range(4):
                    if not ((mb.cbp >> blk) & 1):
                        continue
                    r = dequant_idct_8x8(dezigzag8(mb.luma8[blk]), qpy,
                                         self.fr.ls8[1])
                    qx, qy = blk & 1, blk >> 1
                    resid[qy * 8:qy * 8 + 8, qx * 8:qx * 8 + 8] = r
            else:
                for blk in range(16):
                    if not ((mb.cbp >> (blk >> 2)) & 1):
                        continue
                    r = dequant_idct_4x4(dezigzag4(mb.luma4[blk]), qpy,
                                         self.fr.ls4[3], False)
                    ox, oy = ZSCAN_4X4_POS[blk]
                    resid[oy * 4:oy * 4 + 4, ox * 4:ox * 4 + 4] = r
        rows, rx0 = self._rows_y(addr)
        self.fr.y[rows[:, None], rx0 + np.arange(16)] = \
            np.clip(pred_y + resid, 0, maxv)

        if cat:
            crows, ccx0 = self._rows_c(addr)
            for ci, (plane, pred) in enumerate(((self.fr.cb, pred_cb),
                                                (self.fr.cr, pred_cr))):
                qp_off = (self.pps.chroma_qp_index_offset if ci == 0
                          else self.pps.second_chroma_qp_offset)
                qpc = qpc_from_qpy(qpy, qp_off, 0)
                cresid = np.zeros((chh, 8), np.int64)
                if mb.kind not in skip_kinds and (mb.cbp & 0x30):
                    ls4 = self.fr.ls4[4 + ci]
                    if cat == 1:
                        dcv = idct_chroma_dc(
                            np.asarray(mb.chroma_dc[ci][:4]).reshape(2, 2),
                            qpc, ls4, 1)
                    else:
                        raster = np.zeros(8, np.int64)
                        raster[[0, 2, 1, 4, 6, 3, 5, 7]] = \
                            mb.chroma_dc[ci][:8]
                        dcv = idct_chroma_dc(raster.reshape(4, 2), qpc + 3,
                                             ls4, 2)
                    for j in range(4 * cat):
                        qx, qy = j & 1, j >> 1
                        full = np.zeros(16, np.int64)
                        full[1:] = mb.chroma_ac[ci][j][:15]
                        c = dezigzag4(full)
                        c[0, 0] = dcv[qy, qx]
                        r = dequant_idct_4x4(c, qpc, ls4, True)
                        cresid[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = r
                plane[crows[:, None], ccx0 + np.arange(8)] = \
                    np.clip(pred + cresid, 0, maxv)

        self.ms.decoded[addr] = True
        self._cur_done[:] = True

    def recon_mb_any(self, addr):
        mb = self.mbs[addr]
        if mb.kind in (MbKind.I_NXN, MbKind.I_16X16, MbKind.I_PCM):
            self.recon_mb(addr)
            # intra MBs are available MV-pred neighbours with ref -1
            self.ms.decoded[addr] = True
        elif mb.kind == MbKind.SI:
            self.recon_mb(addr)
            self.ms.decoded[addr] = True
        else:
            self._cur_addr = addr
            self._cur_done[:] = False
            self.recon_inter_mb(addr)


class _MbaffRefs:
    """Reference plumbing for one MBAFF picture."""

    def __init__(self, lists, wp, col, col_shortterm, col_parity,
                 temporal_direct, implicit_field_fn=None):
        self.lists = lists            # (list0, list1) of _RefEntry
        self.wp = wp
        self.col = col                # MbaffMotion of RefPicList1[0]
        self.col_shortterm = col_shortterm
        self.col_parity = col_parity
        self.temporal_direct = temporal_direct
        self._ifw = implicit_field_fn

    def implicit_field(self, addr, f0, p0, f1, p1):
        if self._ifw is None:
            return 32, 32
        return self._ifw(addr, f0, p0, f1, p1)


class _RefEntry:
    def __init__(self, planes, poc_top, poc_bot, poc, long_term):
        self.planes = planes
        self.poc_top = poc_top
        self.poc_bot = poc_bot
        self.poc = poc
        self.long_term = long_term


def recon_mbaff_picture(sps, pps, mbs, headers, dpb, stored, stored_ms,
                        poc, poc_top, poc_bot):
    """Reconstruct one MBAFF picture (intra or IPB).

    stored: frame_idx -> (y, cb, cr) planes; stored_ms: frame_idx ->
    MbaffMotion (co-located).  Returns (y, cb, cr, MbaffMotion)."""
    from ..avc.slice_header import SliceType

    h0 = headers[0]
    st = h0.slice_type
    lists = (None, None)
    wp = None
    col = None
    col_shortterm = False
    col_parity = 0
    impl_fn = None
    if not st.is_intra:
        def entries(plist):
            return [_RefEntry(stored[p.frame_idx], p.top_field_order_cnt,
                              p.bottom_field_order_cnt, p.pic_order_cnt,
                              p.is_long_term) for p in plist]
        l0 = entries(dpb.ref_list0)
        l1 = entries(dpb.ref_list1) if st == SliceType.B else None
        lists = (l0, l1)
        if h0.pred_weight_table is not None and (
                (pps.weighted_pred_flag and st == SliceType.P) or
                (pps.weighted_bipred_idc == 1 and st == SliceType.B)):
            wp = ExplicitWP(h0.pred_weight_table)
        elif st == SliceType.B and pps.weighted_bipred_idc == 2:
            wp = ImplicitWP(
                poc,
                [p.pic_order_cnt for p in dpb.ref_list0],
                [p.pic_order_cnt for p in dpb.ref_list1],
                [p.is_long_term for p in dpb.ref_list0],
                [p.is_long_term for p in dpb.ref_list1])

            def impl_fn(addr, f0, p0, f1, p1, _l0=l0, _l1=l1,
                        _pt=poc_top, _pb=poc_bot):
                # field MBs: POC distances between FIELDS (8.4.2.3.2)
                cur = _pb if (addr & 1) else _pt
                e0, e1 = _l0[f0], _l1[f1]
                poc0 = e0.poc_bot if p0 else e0.poc_top
                poc1 = e1.poc_bot if p1 else e1.poc_top
                if e0.long_term or e1.long_term or poc0 == poc1:
                    return 32, 32
                td = int(np.clip(poc1 - poc0, -128, 127))
                if td == 0:
                    return 32, 32
                tb = int(np.clip(cur - poc0, -128, 127))
                tx = (16384 + (abs(td) >> 1)) // td
                dsf = int(np.clip((tb * tx + 32) >> 6, -1024, 1023))
                w1 = dsf >> 2
                if w1 < -64 or w1 > 128:
                    return 32, 32
                return 64 - w1, w1
        if st == SliceType.B:
            colp = dpb.ref_list1[0]
            col = stored_ms.get(colp.frame_idx)
            col_shortterm = not colp.is_long_term
            # frame-to-field co-located parity: the col pair field whose
            # POC is closer to the current picture (8.4.1.2.1)
            d_top = abs(colp.top_field_order_cnt - poc)
            d_bot = abs(colp.bottom_field_order_cnt - poc)
            col_parity = 1 if d_bot < d_top else 0
            if not h0.direct_spatial_mv_pred_flag:
                raise NotImplementedError("MBAFF temporal direct")

    refs = _MbaffRefs(lists, wp, col, col_shortterm, col_parity,
                      temporal_direct=(st == SliceType.B and
                                       not h0.direct_spatial_mv_pred_flag),
                      implicit_field_fn=impl_fn)
    r = MbaffInterRecon(sps, pps, mbs, refs)
    for addr, mb in enumerate(mbs):
        if mb is None:
            raise ValueError(f"macroblock {addr} not covered by any slice")
        r.recon_mb_any(addr)
    return r.fr.y, r.fr.cb, r.fr.cr, r.ms
