# Copy of dryv_tpu/refimpl/mbaff.py.
"""MBAFF (macroblock-adaptive frame/field) intra reconstruction.

The upstream reference implements MBAFF only at the entropy layer
(mb_field_decoding_flag cabac/mod.rs:1105-1111, MBAFF neighbours
slice/mod.rs:412-451, field mvd scaling cabac/mod.rs:925-938) — its
reconstruction is frame-only.  This module goes further and reconstructs
intra MBAFF pictures: MBs decode in vertical pairs, each pair either
frame-coded (two stacked 16x16 MBs) or field-coded (top MB = even rows,
bottom MB = odd rows of the 32-row pair band).  Neighbour samples cross
frame/field boundaries via the shared Table 6-4 derivation
(avc.neighbors.mbaff_neighbor).

Bit-exactness is enforced against libavcodec on x264-encoded MBAFF
streams (tests/test_mbaff.py).
"""
from __future__ import annotations

import numpy as np

from ..avc.neighbors import ZSCAN_4X4_POS, mbaff_neighbor
from ..cabac.syntax import MbKind
from . import intra as ip
from .recon import FrameRecon, dezigzag4, dezigzag8
from .transform import (dequant_idct_4x4, dequant_idct_8x8, idct_chroma_dc,
                        idct_dc_16x16, qpc_from_qpy)


class MbaffIntraRecon:
    """Reconstructs one intra MBAFF picture into frame-geometry planes."""

    def __init__(self, sps, pps, mbs):
        self.fr = FrameRecon(sps, pps)  # planes + LevelScale tables
        self.sps, self.pps = sps, pps
        self.mbs = mbs
        self.mb_w = sps.pic_width_in_mbs
        self.mb_h = sps.frame_height_in_mbs
        self.cat = sps.chroma_array_type
        self.chh = 8 * self.cat  # chroma rows per MB
        self.maxv = (1 << (8 + sps.bit_depth_luma_minus8)) - 1
        # per-current-MB 4x4 done map (above-right availability inside
        # the MB); MBs from earlier decode positions are always complete
        self._cur_done = np.zeros((4, 4), bool)
        self._cur_addr = -1

    # -- pair / coordinate helpers ---------------------------------------
    def field(self, pair: int) -> int:
        m = self.mbs[pair * 2]
        if m is None:
            m = self.mbs[pair * 2 + 1]
        return m.field_flag if m is not None else 0

    def _rows_y(self, addr: int):
        """(row_index_array, x0) covering the MB's 16 luma rows."""
        pair, bot = addr >> 1, addr & 1
        px, py = pair % self.mb_w, pair // self.mb_w
        if self.field(pair):
            rows = 32 * py + bot + 2 * np.arange(16)
        else:
            rows = 32 * py + 16 * bot + np.arange(16)
        return rows, 16 * px

    def _rows_c(self, addr: int):
        pair, bot = addr >> 1, addr & 1
        px, py = pair % self.mb_w, pair // self.mb_w
        band = 2 * self.chh
        if self.field(pair):
            rows = band * py + bot + 2 * np.arange(self.chh)
        else:
            rows = band * py + self.chh * bot + np.arange(self.chh)
        return rows, 8 * px

    # -- neighbour sample fetch -------------------------------------------
    def _nb(self, addr: int, xN: int, yN: int, chroma: int):
        """Sample value at MBAFF-neighbour location, or None."""
        maxw, maxh = (8, self.chh) if chroma else (16, 16)
        r = mbaff_neighbor(addr, xN, yN, self.mb_w, self.field, maxw, maxh)
        if r is None:
            return None
        naddr, xW, yM = r
        nmb = self.mbs[naddr]
        cur = self.mbs[addr]
        if nmb is None or nmb.slice_id != cur.slice_id:
            return None
        if naddr == addr:  # within current MB: decode-order gating
            if not self._cur_done[yM // 4, xW // 4]:
                return None
        elif naddr > addr:
            return None
        if chroma:
            rows, x0 = self._rows_c(naddr)
            plane = self.fr.cb if chroma == 1 else self.fr.cr
            return int(plane[rows[yM], x0 + xW])
        rows, x0 = self._rows_y(naddr)
        return int(self.fr.y[rows[yM], x0 + xW])

    def _window(self, addr, bx, by, bw, bh, chroma=0):
        """Above(bw)+above-right(bw) / left(bh) / corner window for the
        block whose top-left local sample is (bx, by)."""
        above = np.zeros(2 * bw, np.int64)
        left = np.zeros(bh, np.int64)
        a0 = self._nb(addr, bx, by - 1, chroma)
        avail_b = a0 is not None
        if avail_b:
            above[0] = a0
            for i in range(1, bw):
                above[i] = self._nb(addr, bx + i, by - 1, chroma)
        ar = self._nb(addr, bx + bw, by - 1, chroma)
        avail_c = ar is not None
        if avail_c:
            above[bw] = ar
            for i in range(1, bw):
                v = self._nb(addr, bx + bw + i, by - 1, chroma)
                above[bw + i] = v if v is not None else above[bw + i - 1]
        elif avail_b:
            above[bw:] = above[bw - 1]
        l0 = self._nb(addr, bx - 1, by, chroma)
        avail_a = l0 is not None
        if avail_a:
            left[0] = l0
            for i in range(1, bh):
                left[i] = self._nb(addr, bx - 1, by + i, chroma)
        c = self._nb(addr, bx - 1, by - 1, chroma)
        avail_d = c is not None
        corner = c if avail_d else 0
        return above, left, corner, avail_a, avail_b, avail_c, avail_d

    # -- per-MB reconstruction ----------------------------------------------
    def recon_mb(self, addr: int):
        mb = self.mbs[addr]
        self._cur_addr = addr
        self._cur_done[:] = False
        rows, x0 = self._rows_y(addr)
        qpy = mb.qp_y
        if mb.kind == MbKind.I_PCM:
            self.fr.y[rows[:, None], x0 + np.arange(16)] = \
                np.asarray(mb.pcm_luma, np.int64).reshape(16, 16)
            if self.cat:
                crows, cx0 = self._rows_c(addr)
                pc = np.asarray(mb.pcm_chroma, np.int64).reshape(
                    2, self.chh, 8)
                self.fr.cb[crows[:, None], cx0 + np.arange(8)] = pc[0]
                self.fr.cr[crows[:, None], cx0 + np.arange(8)] = pc[1]
            self._cur_done[:] = True
            return
        if mb.kind == MbKind.I_NXN and not mb.transform8x8:
            for blk in range(16):
                ox, oy = ZSCAN_4X4_POS[blk]
                bx, by = ox * 4, oy * 4
                above, left, corner, aa, ab, ac, ad = \
                    self._window(addr, bx, by, 4, 4)
                mode = int(mb.intra4x4_modes[blk])
                pred = ip.pred4x4(mode, above, left, corner, aa, ab, ac,
                                  ad, 8)
                c = dezigzag4(mb.luma4[blk])
                r = dequant_idct_4x4(c, qpy, self.fr.ls4[0],
                                     dc_passthrough=False)
                u = np.clip(pred + r, 0, self.maxv)
                self.fr.y[rows[by:by + 4, None], x0 + bx + np.arange(4)] = u
                self._cur_done[oy, ox] = True
        elif mb.kind == MbKind.I_NXN:
            for blk in range(4):
                ox, oy = blk & 1, blk >> 1
                bx, by = ox * 8, oy * 8
                above, left, corner, aa, ab, ac, ad = \
                    self._window(addr, bx, by, 8, 8)
                fa, fl, fz = ip.filter_ref_8x8(above, left, corner, aa,
                                               ab, ac, ad)
                mode = int(mb.intra8x8_modes[blk])
                pred = ip.pred8x8(mode, fa, fl, fz, aa, ab, ad, 8)
                c = dezigzag8(mb.luma8[blk])
                r = dequant_idct_8x8(c, qpy, self.fr.ls8[0])
                u = np.clip(pred + r, 0, self.maxv)
                self.fr.y[rows[by:by + 8, None], x0 + bx + np.arange(8)] = u
                self._cur_done[oy * 2:oy * 2 + 2, ox * 2:ox * 2 + 2] = True
        elif mb.kind == MbKind.I_16X16:
            above, left, corner, aa, ab, _, ad = \
                self._window(addr, 0, 0, 16, 16)
            pred = ip.pred16x16(int(mb.i16_pred_mode), above[:16], left,
                                corner, aa, ab, ad, 8)
            dc_vals = idct_dc_16x16(dezigzag4(mb.luma_dc), qpy,
                                    self.fr.ls4[0])
            resid = np.zeros((16, 16), np.int64)
            for blk in range(16):
                ox, oy = ZSCAN_4X4_POS[blk]
                full = np.zeros(16, np.int64)
                full[1:] = mb.luma4[blk][:15]
                c = dezigzag4(full)
                c[0, 0] = dc_vals[oy, ox]
                r = dequant_idct_4x4(c, qpy, self.fr.ls4[0],
                                     dc_passthrough=True)
                resid[oy * 4:oy * 4 + 4, ox * 4:ox * 4 + 4] = r
            u = np.clip(pred + resid, 0, self.maxv)
            self.fr.y[rows[:, None], x0 + np.arange(16)] = u
            self._cur_done[:] = True
        else:
            raise NotImplementedError(f"MBAFF recon for kind {mb.kind}")
        if self.cat:
            self._recon_chroma(addr, mb)

    def _recon_chroma(self, addr: int, mb):
        crows, cx0 = self._rows_c(addr)
        ch = self.chh
        above, left, corner, aa, ab, _, ad = \
            self._window(addr, 0, 0, 8, ch, chroma=1)
        # chroma availability is MB-level: same flags serve cb and cr
        for ci, plane in ((0, self.fr.cb), (1, self.fr.cr)):
            ab8, lf, cn = above, left, corner
            if ci == 1:
                ab8, lf, cn, _, _, _, _ = \
                    self._window(addr, 0, 0, 8, ch, chroma=2)
            qp_off = (self.pps.chroma_qp_index_offset if ci == 0
                      else self.pps.second_chroma_qp_offset)
            qpc = qpc_from_qpy(mb.qp_y, qp_off, 0)
            ls4 = self.fr.ls4[1 + ci]
            pred = ip.pred_chroma(int(mb.chroma_mode), ab8[:8], lf, cn,
                                  aa, ab, ad, 8, ch, 8)
            if self.cat == 1:
                dcv = idct_chroma_dc(
                    np.asarray(mb.chroma_dc[ci][:4]).reshape(2, 2), qpc,
                    ls4, 1)
            else:
                raster = np.zeros(8, np.int64)
                raster[[0, 2, 1, 4, 6, 3, 5, 7]] = mb.chroma_dc[ci][:8]
                dcv = idct_chroma_dc(raster.reshape(4, 2), qpc + 3, ls4, 2)
            resid = np.zeros((ch, 8), np.int64)
            for j in range(4 * self.cat):
                bx, by = j & 1, j >> 1
                full = np.zeros(16, np.int64)
                full[1:] = mb.chroma_ac[ci][j][:15]
                c = dezigzag4(full)
                c[0, 0] = dcv[by, bx]
                r = dequant_idct_4x4(c, qpc, ls4, dc_passthrough=True)
                resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = r
            u = np.clip(pred + resid, 0, self.maxv)
            plane[crows[:, None], cx0 + np.arange(8)] = u


def recon_mbaff_intra(sps, pps, mbs):
    """Reconstruct a whole intra MBAFF picture; returns (y, cb, cr)."""
    r = MbaffIntraRecon(sps, pps, mbs)
    for addr, mb in enumerate(mbs):
        if mb is None:
            raise ValueError(f"macroblock {addr} not covered by any slice")
        if mb.kind not in (MbKind.I_NXN, MbKind.I_16X16, MbKind.I_PCM):
            raise NotImplementedError("inter-coded MBAFF reconstruction")
        r.recon_mb(addr)
    return r.fr.y, r.fr.cb, r.fr.cr
