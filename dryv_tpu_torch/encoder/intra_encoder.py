# Copy of dryv_tpu/encoder/intra_encoder.py.
"""Intra fixture encoder: mode decision, forward quantization, reconstruction.

Quantization inverts the exact integer dequant+IDCT linear maps numerically
(least squares on the decoder's own basis responses), so any QP, block size
and scaling list is supported without forward-transform tables.  Rate
optimality is irrelevant for fixtures — any integer levels are conformant;
what matters is that mode coverage is broad and the bitstream is valid.
"""
from __future__ import annotations

import numpy as np

from ..cabac.syntax import MBState, MbKind
from ..avc.neighbors import ZSCAN_4X4_POS
from ..avc.sps import ZIGZAG_4X4, ZIGZAG_8X8
from ..refimpl import intra as ip
from ..refimpl.recon import FrameRecon, dezigzag4, dezigzag8
from ..refimpl.transform import (
    dequant_idct_4x4,
    dequant_idct_8x8,
    idct_chroma_dc,
    idct_dc_16x16,
    qpc_from_qpy,
)


def _basis_map(decode_fn, n: int) -> np.ndarray:
    """Numerically derive the levels->residual linear map of a decode fn."""
    M = np.zeros((n, n), dtype=np.float64)
    K = 64
    for k in range(n):
        e = np.zeros(n, dtype=np.int64)
        e[k] = K
        rp = decode_fn(e).astype(np.float64)
        e[k] = -K
        rm = decode_fn(e).astype(np.float64)
        M[:, k] = (rp - rm) / (2 * K)
    return M


class QuantMaps:
    """Per-QP inverse maps, lazily cached."""

    def __init__(self, recon: FrameRecon):
        self.recon = recon
        self._cache = {}

    def _get(self, key, build):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def inv4(self, qp: int, comp: int) -> np.ndarray:
        ls4 = self.recon.ls4[comp]

        def build():
            def dec(levels):
                c = levels.reshape(4, 4)
                return dequant_idct_4x4(c, qp, ls4, False).reshape(-1)
            return np.linalg.inv(_basis_map(dec, 16))
        return self._get(("i4", qp, comp), build)

    def inv4_dcpass(self, qp: int, comp: int) -> np.ndarray:
        """Map with slot (0,0) = direct d00 value, others = AC levels."""
        ls4 = self.recon.ls4[comp]

        def build():
            def dec(levels):
                c = levels.reshape(4, 4)
                return dequant_idct_4x4(c, qp, ls4, True).reshape(-1)
            return np.linalg.inv(_basis_map(dec, 16))
        return self._get(("i4dc", qp, comp), build)

    def inv8(self, qp: int, comp: int = 0) -> np.ndarray:
        # 8x8 scaling lists: intra Y / inter Y / intra Cb / inter Cb /
        # intra Cr / inter Cr (Table 7-2; Cb/Cr rows only for 4:4:4)
        ls8 = self.recon.ls8[0 if comp == 0 else 2 * comp]

        def build():
            def dec(levels):
                return dequant_idct_8x8(levels.reshape(8, 8), qp, ls8).reshape(-1)
            return np.linalg.inv(_basis_map(dec, 64))
        return self._get(("i8", qp, comp), build)

    def inv_dc16(self, qp: int, comp: int = 0) -> np.ndarray:
        ls4 = self.recon.ls4[comp]

        def build():
            def dec(levels):
                return idct_dc_16x16(levels.reshape(4, 4), qp, ls4).reshape(-1)
            return np.linalg.inv(_basis_map(dec, 16))
        return self._get(("dc16", qp, comp), build)

    def inv_dcc(self, qp: int, comp: int) -> np.ndarray:
        ls4 = self.recon.ls4[comp]

        def build():
            def dec(levels):
                return idct_chroma_dc(levels.reshape(2, 2), qp, ls4, 1).reshape(-1)
            return np.linalg.inv(_basis_map(dec, 4))
        return self._get(("dcc", qp, comp), build)

    def inv_dcc422(self, qp_dc: int, comp: int) -> np.ndarray:
        """4:2:2 chroma DC (2x4 Hadamard, qp_dc = QPc + 3)."""
        ls4 = self.recon.ls4[comp]

        def build():
            def dec(levels):
                return idct_chroma_dc(levels.reshape(4, 2), qp_dc, ls4,
                                      2).reshape(-1)
            return np.linalg.inv(_basis_map(dec, 8))
        return self._get(("dcc422", qp_dc, comp), build)


def _round_levels(v: np.ndarray, deadzone: float = 0.0) -> np.ndarray:
    out = np.round(np.where(np.abs(v) < deadzone, 0.0, v))
    return np.clip(out, -3000, 3000).astype(np.int64)


MODES_NEED_ABOVE = {ip.M4_V, ip.M4_DDL, ip.M4_VL}
MODES_NEED_LEFT = {ip.M4_H, ip.M4_HU}
MODES_NEED_ALL = {ip.M4_DDR, ip.M4_VR, ip.M4_HD}


class IntraEncoder:
    """Encodes one I frame: fills MBState records and maintains the
    reconstruction state for prediction feedback."""

    def __init__(self, sps, pps, qp: int, mb_kind_policy=None,
                 deadzone: float = 0.2, mb_h=None):
        self.sps, self.pps = sps, pps
        self.recon = FrameRecon(sps, pps, mb_h=mb_h)
        self.q = QuantMaps(self.recon)
        self.qp = qp
        self.deadzone = deadzone
        # lossless transform bypass (QP'Y == 0 + SPS flag, spec 8.3.5)
        self.bypass = bool(sps.qpprime_y_zero_transform_bypass_flag) and \
            qp == 0
        self.policy = mb_kind_policy or (lambda addr: "i16" if addr % 3 == 0
                                         else "i4")

    def encode_frame(self, src_y, src_cb, src_cr, slice_bounds=None,
                     slice_ids=None):
        """Returns list[MBState].  slice_bounds: list of first_mb addrs;
        slice_ids: explicit per-MB slice/group id (FMO — raster-order
        encoding with group-gated availability is decode-order
        equivalent, since a slice group's MBs decode in raster order
        among themselves and cross-group neighbors are unavailable)."""
        R = self.recon
        n = R.mb_w * R.mb_h
        slice_bounds = slice_bounds or [0]
        mbs = []
        for addr in range(n):
            sid = (int(slice_ids[addr]) if slice_ids is not None
                   else sum(1 for b in slice_bounds if b <= addr) - 1)
            kind = self.policy(addr)
            mb = MBState.fresh()
            mb.qp_y = self.qp
            if kind == "pcm":
                self._encode_pcm(mb, addr, sid, src_y, src_cb, src_cr)
            elif kind == "i16":
                self._encode_i16(mb, addr, sid, src_y)
            elif kind == "i8":
                self._encode_i8(mb, addr, sid, src_y)
            else:
                self._encode_i4(mb, addr, sid, src_y)
            if mb.kind != MbKind.I_PCM and R.chroma_array_type == 3:
                self._encode_chroma444(mb, addr, sid, src_cb, src_cr)
            elif mb.kind != MbKind.I_PCM and R.chroma_array_type:
                self._encode_chroma(mb, addr, sid, src_cb, src_cr)
                R._recon_chroma(mb, addr % R.mb_w, addr // R.mb_w, sid, 255)
            R.mb_done[addr // R.mb_w, addr % R.mb_w] = True
            mbs.append(mb)
        # qp_delta chain: constant QP => all deltas 0 except... slice QP is
        # already self.qp, so deltas stay 0.
        return mbs

    # ------------------------------------------------------------------
    def _mark_mb(self, addr, sid):
        R = self.recon
        mx, my = addr % R.mb_w, addr // R.mb_w
        R.mb_slice[my, mx] = sid
        R.mb_intra[my, mx] = True

    def _encode_pcm(self, mb, addr, sid, src_y, src_cb, src_cr):
        R = self.recon
        self._mark_mb(addr, sid)
        mx, my = addr % R.mb_w, addr // R.mb_w
        x0, y0 = mx * 16, my * 16
        mb.kind = MbKind.I_PCM
        mb.pcm_luma = src_y[y0:y0 + 16, x0:x0 + 16].reshape(-1).astype(np.int64)
        if R.chroma_array_type == 3:
            mb.pcm_chroma = np.stack([
                src_cb[y0:y0 + 16, x0:x0 + 16].reshape(-1),
                src_cr[y0:y0 + 16, x0:x0 + 16].reshape(-1),
            ]).astype(np.int64)
        elif R.chroma_array_type:
            ch = 8 * R.chroma_array_type
            cy = my * ch
            mb.pcm_chroma = np.stack([
                src_cb[cy:cy + ch, mx * 8:mx * 8 + 8].reshape(-1),
                src_cr[cy:cy + ch, mx * 8:mx * 8 + 8].reshape(-1),
            ]).astype(np.int64)
        R.recon_mb(mb, addr, sid)

    def _encode_i16(self, mb, addr, sid, src_y):
        R = self.recon
        self._mark_mb(addr, sid)
        mx, my = addr % R.mb_w, addr // R.mb_w
        x0, y0 = mx * 16, my * 16
        mb.kind = MbKind.I_16X16
        src = src_y[y0:y0 + 16, x0:x0 + 16].astype(np.int64)
        avail_a = R.mb_avail(mx - 1, my, sid)
        avail_b = R.mb_avail(mx, my - 1, sid)
        avail_d = R.mb_avail(mx - 1, my - 1, sid)
        above = R.y[y0 - 1, x0:x0 + 16] if avail_b else np.zeros(16, np.int64)
        left = R.y[y0:y0 + 16, x0 - 1] if avail_a else np.zeros(16, np.int64)
        corner = int(R.y[y0 - 1, x0 - 1]) if avail_d else 0
        cand = [ip.M16_DC]
        if avail_b:
            cand.append(ip.M16_V)
        if avail_a:
            cand.append(ip.M16_H)
        if avail_a and avail_b and avail_d:
            cand.append(ip.M16_PLANE)
        best, best_sad, best_pred = None, None, None
        for m in cand:
            pred = ip.pred16x16(m, above, left, corner, avail_a, avail_b,
                                avail_d)
            sad = np.abs(src - pred).sum()
            if best_sad is None or sad < best_sad:
                best, best_sad, best_pred = m, sad, pred
        mb.i16_pred_mode = best
        resid = src - best_pred
        qp = self.qp
        if self.bypass:
            # 8.3.5 lossless I_16x16: residual coded directly; DPCM along
            # the prediction direction for V/H modes (decoder cumsums)
            if best in (0, 1):
                resid = np.diff(resid, axis=best, prepend=0)
            d00 = np.zeros((4, 4), dtype=np.int64)
            ac_any = False
            for blk in range(16):
                ox, oy = ZSCAN_4X4_POS[blk]
                zz = resid[oy * 4:oy * 4 + 4,
                           ox * 4:ox * 4 + 4].reshape(-1)[ZIGZAG_4X4]
                d00[oy, ox] = zz[0]
                mb.luma4[blk][:15] = zz[1:]
                if np.any(zz[1:]):
                    ac_any = True
            mb.luma_dc[:] = d00.reshape(-1)[ZIGZAG_4X4]
            mb.cbp = 0x0F if ac_any else 0
            R._recon_i16(mb, mx, my, sid, qp, 255)  # identity -> src
            return
        inv = self.q.inv4_dcpass(qp, 0)
        d00 = np.zeros((4, 4), dtype=np.float64)
        ac_levels = np.zeros((16, 16), dtype=np.int64)
        for blk in range(16):
            ox, oy = ZSCAN_4X4_POS[blk]
            r = resid[oy * 4:oy * 4 + 4, ox * 4:ox * 4 + 4].reshape(-1)
            v = inv @ r
            d00[oy, ox] = v.reshape(4, 4)[0, 0]
            lv = _round_levels(v, self.deadzone)
            lv.reshape(4, 4)[0, 0] = 0
            ac_levels[blk] = lv
        dc_levels = _round_levels(self.q.inv_dc16(qp) @ d00.reshape(-1)
                                  ).reshape(4, 4)
        mb.luma_dc[:] = dc_levels.reshape(-1)[ZIGZAG_4X4]
        ac_any = False
        for blk in range(16):
            zz = ac_levels[blk].reshape(-1)[ZIGZAG_4X4]
            mb.luma4[blk][:15] = zz[1:]
            if np.any(zz[1:]):
                ac_any = True
        mb.cbp = 0x0F if ac_any else 0
        # reconstruct luma
        R._recon_i16(mb, mx, my, sid, qp, 255)

    def _encode_i4(self, mb, addr, sid, src_y):
        R = self.recon
        self._mark_mb(addr, sid)
        mx, my = addr % R.mb_w, addr // R.mb_w
        mb.kind = MbKind.I_NXN
        mb.transform8x8 = 0
        qp = self.qp
        inv = self.q.inv4(qp, 0)
        cbp_luma = 0
        for blk in range(16):
            ox, oy = ZSCAN_4X4_POS[blk]
            bx, by = mx * 4 + ox, my * 4 + oy
            x0, y0 = bx * 4, by * 4
            src = src_y[y0:y0 + 4, x0:x0 + 4].astype(np.int64)
            above, left, corner, aa, ab, ac, ad = R._luma_window4(bx, by, sid)
            cand = [ip.M4_DC]
            if ab:
                cand += [m for m in MODES_NEED_ABOVE]
            if aa:
                cand += [m for m in MODES_NEED_LEFT]
            if aa and ab and ad:
                cand += [m for m in MODES_NEED_ALL]
            best, best_sad, best_pred = None, None, None
            for m in sorted(cand):
                pred = ip.pred4x4(m, above, left, corner, aa, ab, ac, ad)
                sad = np.abs(src - pred).sum()
                if best_sad is None or sad < best_sad:
                    best, best_sad, best_pred = m, sad, pred
            mb.intra4x4_modes[blk] = best
            if self.bypass:
                r = src - best_pred
                if best in (0, 1):
                    # 8.3.5 DPCM: decoder cumsums along the pred
                    # direction, so difference here
                    r = np.diff(r, axis=best, prepend=0)
                if np.any(r):
                    cbp_luma |= 1 << (blk >> 2)
                mb.luma4[blk][:] = r.reshape(-1)[ZIGZAG_4X4]
                R.y[y0:y0 + 4, x0:x0 + 4] = src  # lossless
                R.blk_done[by, bx] = True
                continue
            lv = _round_levels(inv @ (src - best_pred).reshape(-1),
                               self.deadzone)
            if np.any(lv):
                cbp_luma |= 1 << (blk >> 2)
            mb.luma4[blk][:] = lv.reshape(-1)[ZIGZAG_4X4]
            # reconstruct
            r = dequant_idct_4x4(lv.reshape(4, 4), qp, R.ls4[0], False)
            u = np.clip(best_pred + r, 0, 255)
            R.y[y0:y0 + 4, x0:x0 + 4] = u
            R.blk_done[by, bx] = True
        # drop coefficients of 8x8 groups whose cbp bit is 0 (already zero)
        mb.cbp = cbp_luma

    def _encode_i8(self, mb, addr, sid, src_y):
        R = self.recon
        # an 8x8-transform MB is only expressible when the PPS enables it
        # (otherwise the coded stream silently drops the flag and the
        # decoder parses 16 4x4 modes — a round-trip desync)
        assert R.pps.transform_8x8_mode_flag, \
            "I8 macroblock requires pps.transform_8x8_mode_flag"
        self._mark_mb(addr, sid)
        mx, my = addr % R.mb_w, addr // R.mb_w
        mb.kind = MbKind.I_NXN
        mb.transform8x8 = 1
        qp = self.qp
        inv = self.q.inv8(qp)
        cbp_luma = 0
        for blk in range(4):
            ox, oy = blk & 1, blk >> 1
            x0, y0 = mx * 16 + ox * 8, my * 16 + oy * 8
            src = src_y[y0:y0 + 8, x0:x0 + 8].astype(np.int64)
            avail_a = R.luma_avail(x0 - 1, y0, sid)
            avail_b = R.luma_avail(x0, y0 - 1, sid)
            avail_c = R.luma_avail(x0 + 8, y0 - 1, sid)
            avail_d = R.luma_avail(x0 - 1, y0 - 1, sid)
            above = np.zeros(16, dtype=np.int64)
            left = np.zeros(8, dtype=np.int64)
            corner = 0
            if avail_b:
                above[:8] = R.y[y0 - 1, x0:x0 + 8]
                above[8:] = R.y[y0 - 1, x0 + 8:x0 + 16] if avail_c else above[7]
            if avail_a:
                left[:] = R.y[y0:y0 + 8, x0 - 1]
            if avail_d:
                corner = int(R.y[y0 - 1, x0 - 1])
            fa, fl, fz = ip.filter_ref_8x8(above, left, corner, avail_a,
                                           avail_b, avail_c, avail_d)
            cand = [ip.M4_DC]
            if avail_b:
                cand += list(MODES_NEED_ABOVE)
            if avail_a:
                cand += list(MODES_NEED_LEFT)
            if avail_a and avail_b and avail_d:
                cand += list(MODES_NEED_ALL)
            best, best_sad, best_pred = None, None, None
            for m in sorted(cand):
                pred = ip.pred8x8(m, fa, fl, fz, avail_a, avail_b, avail_d)
                sad = np.abs(src - pred).sum()
                if best_sad is None or sad < best_sad:
                    best, best_sad, best_pred = m, sad, pred
            mb.intra8x8_modes[blk] = best
            if self.bypass:
                r = src - best_pred
                if best in (0, 1):
                    r = np.diff(r, axis=best, prepend=0)  # 8.3.5 DPCM
                if np.any(r):
                    cbp_luma |= 1 << blk
                mb.luma8[blk][:] = r.reshape(-1)[ZIGZAG_8X8]
                R.y[y0:y0 + 8, x0:x0 + 8] = src  # lossless
                R.blk_done[y0 // 4:y0 // 4 + 2,
                           x0 // 4:x0 // 4 + 2] = True
                continue
            lv = _round_levels(inv @ (src - best_pred).reshape(-1),
                               self.deadzone)
            if np.any(lv):
                cbp_luma |= 1 << blk
            mb.luma8[blk][:] = lv.reshape(-1)[ZIGZAG_8X8]
            r = dequant_idct_8x8(lv.reshape(8, 8), qp, R.ls8[0])
            u = np.clip(best_pred + r, 0, 255)
            R.y[y0:y0 + 8, x0:x0 + 8] = u
            R.blk_done[y0 // 4:y0 // 4 + 2, x0 // 4:x0 // 4 + 2] = True
        mb.cbp = cbp_luma
        mb.intra4x4_modes[:] = np.repeat(mb.intra8x8_modes, 4)

    # 4:2:2 chroma DC coding order: scan pos -> raster index in the 4x2 grid
    # (verified empirically against libavcodec; matches refimpl/recon.py)
    DC422_ORDER = [0, 2, 1, 4, 6, 3, 5, 7]

    def _encode_chroma(self, mb, addr, sid, src_cb, src_cr):
        R = self.recon
        mx, my = addr % R.mb_w, addr // R.mb_w
        cat = R.chroma_array_type
        assert cat in (1, 2), "fixture chroma encode: 4:2:0 / 4:2:2"
        ch = 8 * cat  # chroma block height: 8 or 16
        nblk = 4 * cat
        cx0, cy0 = mx * 8, my * ch
        avail_a = R.mb_avail(mx - 1, my, sid)
        avail_b = R.mb_avail(mx, my - 1, sid)
        avail_d = R.mb_avail(mx - 1, my - 1, sid)
        # joint mode decision over both planes
        cand = [ip.MC_DC]
        if avail_a:
            cand.append(ip.MC_H)
        if avail_b:
            cand.append(ip.MC_V)
        if avail_a and avail_b and avail_d:
            cand.append(ip.MC_PLANE)
        best, best_sad = None, None
        winded = []
        for ci, (plane, src) in enumerate(((R.cb, src_cb), (R.cr, src_cr))):
            above = plane[cy0 - 1, cx0:cx0 + 8] if avail_b else \
                np.zeros(8, np.int64)
            left = plane[cy0:cy0 + ch, cx0 - 1] if avail_a else \
                np.zeros(ch, np.int64)
            corner = int(plane[cy0 - 1, cx0 - 1]) if avail_d else 0
            winded.append((above, left, corner,
                           src[cy0:cy0 + ch, cx0:cx0 + 8].astype(np.int64)))
        for m in cand:
            sad = 0
            for above, left, corner, src in winded:
                pred = ip.pred_chroma(m, above, left, corner, avail_a,
                                      avail_b, avail_d, 8, ch)
                sad += np.abs(src - pred).sum()
            if best_sad is None or sad < best_sad:
                best, best_sad = m, sad
        mb.chroma_mode = best
        has_dc = False
        has_ac = False
        for ci, (above, left, corner, src) in enumerate(winded):
            qp_off = (self.pps.chroma_qp_index_offset if ci == 0
                      else self.pps.second_chroma_qp_offset)
            qpc = qpc_from_qpy(mb.qp_y, qp_off, 0)
            if self.bypass:
                assert cat == 1, "bypass chroma fixture is 4:2:0"
                pred = ip.pred_chroma(best, above, left, corner, avail_a,
                                      avail_b, avail_d, 8, ch)
                r = src - pred
                if best in (1, 2):  # 8.3.5 DPCM (chroma H=1 / V=2)
                    r = np.diff(r, axis=2 - best, prepend=0)
                for j in range(nblk):
                    bx, by = j & 1, j >> 1
                    zz = r[by * 4:by * 4 + 4,
                           bx * 4:bx * 4 + 4].reshape(-1)[ZIGZAG_4X4]
                    mb.chroma_dc[ci][j] = zz[0]
                    mb.chroma_ac[ci][j][:15] = zz[1:]
                    if np.any(zz[1:]):
                        has_ac = True
                if np.any(mb.chroma_dc[ci]):
                    has_dc = True
                (R.cb if ci == 0 else R.cr)[cy0:cy0 + ch,
                                            cx0:cx0 + 8] = src
                continue
            inv = self.q.inv4_dcpass(qpc, 1 + ci)
            pred = ip.pred_chroma(best, above, left, corner, avail_a,
                                  avail_b, avail_d, 8, ch)
            resid = src - pred
            d00 = np.zeros(nblk, dtype=np.float64)  # per block raster
            for j in range(nblk):
                bx, by = j & 1, j >> 1
                r = resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4].reshape(-1)
                v = inv @ r
                d00[j] = v.reshape(4, 4)[0, 0]
                lv = _round_levels(v, self.deadzone)
                lv.reshape(4, 4)[0, 0] = 0
                zz = lv.reshape(-1)[ZIGZAG_4X4]
                mb.chroma_ac[ci][j][:15] = zz[1:]
                if np.any(zz[1:]):
                    has_ac = True
            if cat == 1:
                dc_levels = _round_levels(self.q.inv_dcc(qpc, 1 + ci) @ d00)
                mb.chroma_dc[ci][:4] = dc_levels
            else:
                dc_raster = _round_levels(
                    self.q.inv_dcc422(qpc + 3, 1 + ci) @ d00)
                mb.chroma_dc[ci][:8] = dc_raster[self.DC422_ORDER]
            if np.any(mb.chroma_dc[ci]):
                has_dc = True
        chroma_cbp = 2 if has_ac else (1 if has_dc else 0)
        if chroma_cbp != 2:
            mb.chroma_ac[:] = 0
        mb.cbp |= chroma_cbp << 4

    # ------------------------------------------------------------------
    def _encode_chroma444(self, mb, addr, sid, src_cb, src_cr):
        """4:4:4 (ChromaArrayType 3): Cb/Cr encoded with the luma process
        — the luma prediction modes apply per plane (spec 8.4.4), and the
        CodedBlockPatternLuma bits gate all three planes' AC blocks
        (7.3.5.3.1), so cbp ends as the OR across planes; blocks a plane
        leaves zero code coded_block_flag 0."""
        R = self.recon
        assert not self.bypass, "lossless 4:4:4 fixtures not supported"
        mb.alloc_444()
        mx, my = addr % R.mb_w, addr // R.mb_w
        qp = self.qp
        for ci, src in enumerate((src_cb, src_cr)):
            plane = (R.cb, R.cr)[ci]
            done = R.blk_done_c[ci]
            qp_off = (self.pps.chroma_qp_index_offset if ci == 0
                      else self.pps.second_chroma_qp_offset)
            qpc = qpc_from_qpy(qp, qp_off, 0)
            if mb.kind == MbKind.I_16X16:
                x0, y0 = mx * 16, my * 16
                avail_a = R.mb_avail(mx - 1, my, sid)
                avail_b = R.mb_avail(mx, my - 1, sid)
                avail_d = R.mb_avail(mx - 1, my - 1, sid)
                above = (plane[y0 - 1, x0:x0 + 16] if avail_b
                         else np.zeros(16, np.int64))
                left = (plane[y0:y0 + 16, x0 - 1] if avail_a
                        else np.zeros(16, np.int64))
                corner = int(plane[y0 - 1, x0 - 1]) if avail_d else 0
                pred = ip.pred16x16(int(mb.i16_pred_mode), above, left,
                                    corner, avail_a, avail_b, avail_d)
                resid = src[y0:y0 + 16, x0:x0 + 16].astype(np.int64) - pred
                inv = self.q.inv4_dcpass(qpc, 1 + ci)
                d00 = np.zeros((4, 4), dtype=np.float64)
                ac_any = False
                for blk in range(16):
                    ox, oy = ZSCAN_4X4_POS[blk]
                    r = resid[oy * 4:oy * 4 + 4,
                              ox * 4:ox * 4 + 4].reshape(-1)
                    v = inv @ r
                    d00[oy, ox] = v.reshape(4, 4)[0, 0]
                    lv = _round_levels(v, self.deadzone)
                    lv.reshape(4, 4)[0, 0] = 0
                    zz = lv.reshape(-1)[ZIGZAG_4X4]
                    mb.cbcr4[ci][blk][:15] = zz[1:]
                    if np.any(zz[1:]):
                        ac_any = True
                dc = _round_levels(self.q.inv_dc16(qpc, 1 + ci)
                                   @ d00.reshape(-1)).reshape(4, 4)
                mb.cbcr_dc[ci][:] = dc.reshape(-1)[ZIGZAG_4X4]
                if ac_any:
                    mb.cbp |= 0x0F
                R._recon_i16(mb, mx, my, sid, qp, 255, ci)
            elif mb.transform8x8:
                inv = self.q.inv8(qpc, 1 + ci)
                ls8 = R.ls8[2 + 2 * ci]
                for blk in range(4):
                    ox, oy = blk & 1, blk >> 1
                    x0, y0 = mx * 16 + ox * 8, my * 16 + oy * 8
                    s8 = src[y0:y0 + 8, x0:x0 + 8].astype(np.int64)
                    avail_a = R.luma_avail(x0 - 1, y0, sid, done)
                    avail_b = R.luma_avail(x0, y0 - 1, sid, done)
                    avail_c = R.luma_avail(x0 + 8, y0 - 1, sid, done)
                    avail_d = R.luma_avail(x0 - 1, y0 - 1, sid, done)
                    above = np.zeros(16, dtype=np.int64)
                    left = np.zeros(8, dtype=np.int64)
                    corner = 0
                    if avail_b:
                        above[:8] = plane[y0 - 1, x0:x0 + 8]
                        above[8:] = (plane[y0 - 1, x0 + 8:x0 + 16]
                                     if avail_c else above[7])
                    if avail_a:
                        left[:] = plane[y0:y0 + 8, x0 - 1]
                    if avail_d:
                        corner = int(plane[y0 - 1, x0 - 1])
                    fa, fl, fz = ip.filter_ref_8x8(above, left, corner,
                                                   avail_a, avail_b,
                                                   avail_c, avail_d)
                    pred = ip.pred8x8(int(mb.intra8x8_modes[blk]), fa, fl,
                                      fz, avail_a, avail_b, avail_d)
                    lv = _round_levels(inv @ (s8 - pred).reshape(-1),
                                       self.deadzone)
                    if np.any(lv):
                        mb.cbp |= 1 << blk
                    mb.cbcr8[ci][blk][:] = lv.reshape(-1)[ZIGZAG_8X8]
                    r = dequant_idct_8x8(lv.reshape(8, 8), qpc, ls8)
                    plane[y0:y0 + 8, x0:x0 + 8] = np.clip(pred + r, 0, 255)
                    done[y0 // 4:y0 // 4 + 2, x0 // 4:x0 // 4 + 2] = True
            else:
                inv = self.q.inv4(qpc, 1 + ci)
                ls4 = R.ls4[1 + ci]
                for blk in range(16):
                    ox, oy = ZSCAN_4X4_POS[blk]
                    bx, by = mx * 4 + ox, my * 4 + oy
                    x0, y0 = bx * 4, by * 4
                    s4 = src[y0:y0 + 4, x0:x0 + 4].astype(np.int64)
                    above, left, corner, aa, ab, ac, ad = R._luma_window4(
                        bx, by, sid, plane, done)
                    pred = ip.pred4x4(int(mb.intra4x4_modes[blk]), above,
                                      left, corner, aa, ab, ac, ad)
                    lv = _round_levels(inv @ (s4 - pred).reshape(-1),
                                       self.deadzone)
                    if np.any(lv):
                        mb.cbp |= 1 << (blk >> 2)
                    mb.cbcr4[ci][blk][:] = lv.reshape(-1)[ZIGZAG_4X4]
                    r = dequant_idct_4x4(lv.reshape(4, 4), qpc, ls4, False)
                    plane[y0:y0 + 4, x0:x0 + 4] = np.clip(pred + r, 0, 255)
                    done[by, bx] = True

