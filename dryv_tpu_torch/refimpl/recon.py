# Copy of dryv_tpu/refimpl/recon.py.
"""Scalar frame reconstruction (reference frame/mod.rs Frame::decode).

Reconstructs a picture macroblock-by-macroblock from decoded syntax
(MBState records).  Sample availability is tracked with a per-4x4-block
"decoded" map, which reproduces the spec's decode-order availability rules
(6.4.8-6.4.12) exactly, including above-right corner cases and slice
boundaries.
"""
from __future__ import annotations

import numpy as np

from ..avc.sps import ZIGZAG_4X4, ZIGZAG_8X8
from ..cabac.syntax import MBState, MbKind
from ..avc.neighbors import ZSCAN_4X4_POS
from . import intra as ip
from .transform import (
    dequant_idct_4x4,
    dequant_idct_8x8,
    idct_chroma_dc,
    idct_dc_16x16,
    level_scale_4x4,
    level_scale_8x8,
    qpc_from_qpy,
)


def dezigzag4(scan: np.ndarray) -> np.ndarray:
    out = np.zeros(16, dtype=np.int64)
    out[ZIGZAG_4X4] = scan
    return out.reshape(4, 4)


def dezigzag8(scan: np.ndarray) -> np.ndarray:
    out = np.zeros(64, dtype=np.int64)
    out[ZIGZAG_8X8] = scan
    return out.reshape(8, 8)


class FrameRecon:
    def __init__(self, sps, pps, mb_h=None):
        self.sps = sps
        self.pps = pps
        self.mb_w = sps.pic_width_in_mbs
        self.mb_h = mb_h if mb_h is not None else sps.frame_height_in_mbs
        self.chroma_array_type = sps.chroma_array_type
        W, H = self.mb_w * 16, self.mb_h * 16
        self.bitdepth = 8 + sps.bit_depth_luma_minus8
        self.y = np.zeros((H, W), dtype=np.int64)
        if self.chroma_array_type:
            cw = W if self.chroma_array_type == 3 else W // 2
            ch = H // (2 if self.chroma_array_type == 1 else 1)
            self.cb = np.zeros((ch, cw), dtype=np.int64)
            self.cr = np.zeros((ch, cw), dtype=np.int64)
        else:
            self.cb = self.cr = None
        self.blk_done = np.zeros((self.mb_h * 4, self.mb_w * 4), dtype=bool)
        if self.chroma_array_type == 3:
            # 4:4:4: Cb/Cr follow the luma intra process (spec 8.4.4 for
            # ChromaArrayType 3) with their own block decode-order maps
            # (within-MB availability progresses per plane)
            self.blk_done_c = [np.zeros_like(self.blk_done),
                               np.zeros_like(self.blk_done)]
        else:
            self.blk_done_c = None
        self.mb_done = np.zeros((self.mb_h, self.mb_w), dtype=bool)
        self.mb_slice = np.full((self.mb_h, self.mb_w), -2, dtype=np.int64)
        self.mb_intra = np.zeros((self.mb_h, self.mb_w), dtype=bool)
        # active scaling lists (PPS overrides SPS, flat fallback)
        sl = pps.resolve_active_scaling_lists(sps)
        # per (component, intra/inter): 4x4 list idx = comp + 3*is_inter
        self.ls4 = [level_scale_4x4(dezigzag4(sl.l4x4[i]).astype(np.int64))
                    for i in range(6)]
        self.ls8 = [level_scale_8x8(dezigzag8(sl.l8x8[i]).astype(np.int64))
                    for i in range(6)]
        self.qp_bd_offset_c = 6 * sps.bit_depth_chroma_minus8
        self.qp_bd_offset_y = 6 * sps.bit_depth_luma_minus8
        self.bypass_flag = sps.qpprime_y_zero_transform_bypass_flag

    def bypass(self, qpy: int) -> bool:
        """TransformBypassModeFlag (8.5): lossless when QP'Y == 0 and the
        SPS bypass flag is set — the reference leaves lossless as todo!."""
        return bool(self.bypass_flag) and qpy + self.qp_bd_offset_y == 0

    # -- availability ----------------------------------------------------
    def luma_avail(self, x: int, y: int, slice_id: int, done=None) -> bool:
        """Block availability at sample (x, y); `done` selects the plane's
        decode-order map (luma by default, Cb/Cr for 4:4:4)."""
        if done is None:
            done = self.blk_done
        if x < 0 or y < 0 or x >= self.y.shape[1] or y >= self.y.shape[0]:
            return False
        if not done[y >> 2, x >> 2]:
            return False
        if self.mb_slice[y >> 4, x >> 4] != slice_id:
            return False
        if self.pps.constrained_intra_pred_flag and \
                not self.mb_intra[y >> 4, x >> 4]:
            return False
        return True

    def mb_avail(self, mx: int, my: int, slice_id: int) -> bool:
        if mx < 0 or my < 0 or mx >= self.mb_w or my >= self.mb_h:
            return False
        if not self.mb_done[my, mx] or self.mb_slice[my, mx] != slice_id:
            return False
        if self.pps.constrained_intra_pred_flag and not self.mb_intra[my, mx]:
            return False
        return True

    # -- reconstruction ---------------------------------------------------
    def recon_mb(self, mb: MBState, addr: int, slice_id: int):
        mx, my = addr % self.mb_w, addr // self.mb_w
        self.mb_slice[my, mx] = slice_id
        self.mb_intra[my, mx] = True
        x0, y0 = mx * 16, my * 16
        maxv = (1 << self.bitdepth) - 1
        qpy = mb.qp_y  # qp1y for 8-bit

        if mb.kind == MbKind.I_PCM:
            self.y[y0:y0 + 16, x0:x0 + 16] = mb.pcm_luma.reshape(16, 16)
            if self.chroma_array_type == 3:
                self.cb[y0:y0 + 16, x0:x0 + 16] = \
                    mb.pcm_chroma[0].reshape(16, 16)
                self.cr[y0:y0 + 16, x0:x0 + 16] = \
                    mb.pcm_chroma[1].reshape(16, 16)
                for d in self.blk_done_c:
                    d[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
            elif self.chroma_array_type:
                ch = 8 * self.chroma_array_type
                cx, cy = x0 // 2, y0 // (2 if self.chroma_array_type == 1 else 1)
                self.cb[cy:cy + ch, cx:cx + 8] = mb.pcm_chroma[0].reshape(ch, 8)
                self.cr[cy:cy + ch, cx:cx + 8] = mb.pcm_chroma[1].reshape(ch, 8)
            self.blk_done[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
            self.mb_done[my, mx] = True
            return

        if mb.kind == MbKind.SI:
            # SI macroblocks dequantize with the switching quantizer QSY
            # (spec 8.5.12; reference transform.rs:125-136 s_mb_flag path)
            self._recon_i4(mb, mx, my, slice_id, mb.qs_y, maxv)
        elif mb.kind == MbKind.I_16X16:
            self._recon_i16(mb, mx, my, slice_id, qpy, maxv)
        elif mb.transform8x8:
            self._recon_i8(mb, mx, my, slice_id, qpy, maxv)
        else:
            self._recon_i4(mb, mx, my, slice_id, qpy, maxv)
        if self.chroma_array_type in (1, 2):
            self._recon_chroma(mb, mx, my, slice_id, maxv)
        elif self.chroma_array_type == 3:
            # 8.4.4 / 8.5 for ChromaArrayType 3: each chroma plane runs
            # the luma process with the luma prediction modes, its own
            # decode-order map, and the chroma QP / scaling lists
            for ci in (0, 1):
                if mb.kind == MbKind.I_16X16:
                    self._recon_i16(mb, mx, my, slice_id, qpy, maxv, ci)
                elif mb.transform8x8:
                    self._recon_i8(mb, mx, my, slice_id, qpy, maxv, ci)
                else:
                    self._recon_i4(mb, mx, my, slice_id, qpy, maxv, ci)
        self.mb_done[my, mx] = True

    # -- luma-process paths (luma plane, or Cb/Cr for 4:4:4) --------------
    def _plane_ctx(self, mb, ci=None, qpy=None):
        """(plane, done-map, dc/c4/c8 coefficients, ls4, ls8, qp) for the
        luma process: ci None = luma; ci 0/1 = Cb/Cr under ChromaArrayType
        3 (spec 8.4.4/8.5 invoke the luma process per chroma plane)."""
        if ci is None:
            return (self.y, self.blk_done, mb.luma_dc, mb.luma4, mb.luma8,
                    self.ls4[0], self.ls8[0], qpy)
        qp_off = (self.pps.chroma_qp_index_offset if ci == 0
                  else self.pps.second_chroma_qp_offset)
        qpc = qpc_from_qpy(qpy, qp_off, self.qp_bd_offset_c)
        # 8x8 scaling lists for 4:4:4: Sl_8x8 order intra Y/inter Y/
        # intra Cb/inter Cb/intra Cr/inter Cr (Table 7-2)
        return ((self.cb, self.cr)[ci], self.blk_done_c[ci],
                mb.cbcr_dc[ci], mb.cbcr4[ci], mb.cbcr8[ci],
                self.ls4[1 + ci], self.ls8[2 + 2 * ci], qpc)

    def _luma_window4(self, bx: int, by: int, slice_id: int,
                      plane=None, done=None):
        """Neighbor window for a 4x4 block at luma coords (bx*4, by*4)."""
        if plane is None:
            plane, done = self.y, self.blk_done
        x0, y0 = bx * 4, by * 4
        avail_a = self.luma_avail(x0 - 1, y0, slice_id, done)
        avail_b = self.luma_avail(x0, y0 - 1, slice_id, done)
        avail_c = self.luma_avail(x0 + 4, y0 - 1, slice_id, done)
        avail_d = self.luma_avail(x0 - 1, y0 - 1, slice_id, done)
        above = np.zeros(8, dtype=np.int64)
        left = np.zeros(4, dtype=np.int64)
        corner = 0
        if avail_b:
            above[:4] = plane[y0 - 1, x0:x0 + 4]
            if avail_c:
                above[4:] = plane[y0 - 1, x0 + 4:x0 + 8]
            else:
                above[4:] = above[3]
        if avail_a:
            left[:] = plane[y0:y0 + 4, x0 - 1]
        if avail_d:
            corner = int(plane[y0 - 1, x0 - 1])
        return above, left, corner, avail_a, avail_b, avail_c, avail_d

    def _recon_i4(self, mb, mx, my, slice_id, qpy, maxv, ci=None):
        plane, done, _dc, c4, _c8, ls4, _ls8, qp = \
            self._plane_ctx(mb, ci, qpy)
        byp = self.bypass(qpy)
        for blk in range(16):
            ox, oy = ZSCAN_4X4_POS[blk]
            bx, by = mx * 4 + ox, my * 4 + oy
            c = dezigzag4(c4[blk])
            r = (c if byp
                 else dequant_idct_4x4(c, qp, ls4, dc_passthrough=False))
            above, left, corner, aa, ab, ac, ad = \
                self._luma_window4(bx, by, slice_id, plane, done)
            mode = int(mb.intra4x4_modes[blk])
            if byp and mode in (0, 1):
                # 8.3.5 intra residual transform-bypass: cumulative sum
                # along the prediction direction (DPCM); vertical (0)
                # accumulates down rows, horizontal (1) across columns
                r = np.cumsum(r, axis=mode)
            pred = ip.pred4x4(mode, above, left, corner, aa, ab, ac, ad,
                              self.bitdepth)
            u = np.clip(pred + r, 0, maxv)
            plane[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = u
            done[by, bx] = True

    def _recon_i8(self, mb, mx, my, slice_id, qpy, maxv, ci=None):
        plane, done, _dc, _c4, c8, _ls4, ls8, qp = \
            self._plane_ctx(mb, ci, qpy)
        for blk in range(4):
            ox, oy = blk & 1, blk >> 1
            x0, y0 = mx * 16 + ox * 8, my * 16 + oy * 8
            c = dezigzag8(c8[blk])
            byp = self.bypass(qpy)
            r = c if byp else dequant_idct_8x8(c, qp, ls8)
            avail_a = self.luma_avail(x0 - 1, y0, slice_id, done)
            avail_b = self.luma_avail(x0, y0 - 1, slice_id, done)
            avail_c = self.luma_avail(x0 + 8, y0 - 1, slice_id, done)
            avail_d = self.luma_avail(x0 - 1, y0 - 1, slice_id, done)
            above = np.zeros(16, dtype=np.int64)
            left = np.zeros(8, dtype=np.int64)
            corner = 0
            if avail_b:
                above[:8] = plane[y0 - 1, x0:x0 + 8]
                if avail_c:
                    above[8:] = plane[y0 - 1, x0 + 8:x0 + 16]
                else:
                    above[8:] = above[7]
            if avail_a:
                left[:] = plane[y0:y0 + 8, x0 - 1]
            if avail_d:
                corner = int(plane[y0 - 1, x0 - 1])
            mode = int(mb.intra8x8_modes[blk])
            if byp and mode in (0, 1):
                r = np.cumsum(r, axis=mode)  # 8.3.5 DPCM bypass
            fa, fl, fz = ip.filter_ref_8x8(above, left, corner, avail_a,
                                           avail_b, avail_c, avail_d)
            pred = ip.pred8x8(mode, fa, fl, fz, avail_a, avail_b,
                              avail_d, self.bitdepth)
            u = np.clip(pred + r, 0, maxv)
            plane[y0:y0 + 8, x0:x0 + 8] = u
            done[y0 // 4:y0 // 4 + 2, x0 // 4:x0 // 4 + 2] = True

    def _recon_i16(self, mb, mx, my, slice_id, qpy, maxv, ci=None):
        plane, done, cdc, c4, _c8, ls4, _ls8, qp = \
            self._plane_ctx(mb, ci, qpy)
        byp = self.bypass(qpy)
        x0, y0 = mx * 16, my * 16
        avail_a = self.mb_avail(mx - 1, my, slice_id)
        avail_b = self.mb_avail(mx, my - 1, slice_id)
        avail_d = self.mb_avail(mx - 1, my - 1, slice_id)
        above = plane[y0 - 1, x0:x0 + 16] if avail_b else np.zeros(16, np.int64)
        left = plane[y0:y0 + 16, x0 - 1] if avail_a else np.zeros(16, np.int64)
        corner = int(plane[y0 - 1, x0 - 1]) if avail_d else 0
        pred = ip.pred16x16(int(mb.i16_pred_mode), above, left, corner,
                            avail_a, avail_b, avail_d, self.bitdepth)
        # DC: levels in 4x4 zig-zag scan over the (blkX, blkY) raster grid
        dc_levels = dezigzag4(cdc)
        dc_vals = (dc_levels if byp
                   else idct_dc_16x16(dc_levels, qp, ls4))
        resid = np.zeros((16, 16), dtype=np.int64)
        for blk in range(16):
            ox, oy = ZSCAN_4X4_POS[blk]
            full = np.zeros(16, dtype=np.int64)
            full[1:] = c4[blk][:15]
            c = dezigzag4(full)
            c[0, 0] = dc_vals[oy, ox]
            r = c if byp else dequant_idct_4x4(c, qp, ls4,
                                               dc_passthrough=True)
            resid[oy * 4:oy * 4 + 4, ox * 4:ox * 4 + 4] = r
        if byp and int(mb.i16_pred_mode) in (0, 1):
            # 8.3.5 lossless DPCM: vertical (0) accumulates down rows,
            # horizontal (1) across columns, over the whole 16x16 array
            resid = np.cumsum(resid, axis=int(mb.i16_pred_mode))
        u = np.clip(pred + resid, 0, maxv)
        plane[y0:y0 + 16, x0:x0 + 16] = u
        done[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True

    # -- chroma -----------------------------------------------------------
    def _recon_chroma(self, mb, mx, my, slice_id, maxv):
        cat = self.chroma_array_type
        ch = 8 * cat  # 8 or 16 rows
        cx0 = mx * 8
        cy0 = my * ch
        avail_a = self.mb_avail(mx - 1, my, slice_id)
        avail_b = self.mb_avail(mx, my - 1, slice_id)
        avail_d = self.mb_avail(mx - 1, my - 1, slice_id)
        nblk = 4 * cat
        for ci, plane in ((0, self.cb), (1, self.cr)):
            qp_off = (self.pps.chroma_qp_index_offset if ci == 0
                      else self.pps.second_chroma_qp_offset)
            qp_base = mb.qs_y if mb.kind == MbKind.SI else mb.qp_y
            qpc = qpc_from_qpy(qp_base, qp_off, self.qp_bd_offset_c)
            ls4 = self.ls4[1 + ci]
            if self.bypass(mb.qp_y):
                self._recon_chroma_bypass(mb, ci, plane, cx0, cy0, avail_a,
                                          avail_b, avail_d, maxv, cat)
                continue
            if cat == 1:
                dc_in = mb.chroma_dc[ci][:4].reshape(2, 2)
                dc_vals = idct_chroma_dc(dc_in, qpc, ls4, 1)
            else:
                # 4:2:2: 8 DC levels, coded in a fixed scan over the 2x4
                # raster (0,2,1,4,6,3,5,7 zig-zag per 8.5.11.2 raster order)
                raster = np.zeros(8, dtype=np.int64)
                order = [0, 2, 1, 4, 6, 3, 5, 7]
                raster[order] = mb.chroma_dc[ci][:8]
                dc_vals = idct_chroma_dc(raster.reshape(4, 2), qpc + 3, ls4, 2)
            above = plane[cy0 - 1, cx0:cx0 + 8] if avail_b else np.zeros(8, np.int64)
            left = plane[cy0:cy0 + ch, cx0 - 1] if avail_a else np.zeros(ch, np.int64)
            corner = int(plane[cy0 - 1, cx0 - 1]) if avail_d else 0
            pred = ip.pred_chroma(int(mb.chroma_mode), above, left, corner,
                                  avail_a, avail_b, avail_d, 8, ch,
                                  self.bitdepth)
            resid = np.zeros((ch, 8), dtype=np.int64)
            for j in range(nblk):
                bx, by = j & 1, j >> 1
                full = np.zeros(16, dtype=np.int64)
                full[1:] = mb.chroma_ac[ci][j][:15]
                c = dezigzag4(full)
                c[0, 0] = dc_vals[by, bx]
                r = dequant_idct_4x4(c, qpc, ls4, dc_passthrough=True)
                resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = r
            u = np.clip(pred + resid, 0, maxv)
            plane[cy0:cy0 + ch, cx0:cx0 + 8] = u

    def _recon_chroma_bypass(self, mb, ci, plane, cx0, cy0, avail_a,
                             avail_b, avail_d, maxv, cat=1):
        """Lossless chroma (8.3.5 + 8.5.11 identity DC): residual placed
        directly; DPCM for horizontal/vertical chroma modes.  cat 2
        (4:2:2) has 8 blocks per plane with the DC levels coded in the
        fixed 2x4 scan of 8.5.11.2."""
        ch = 8 * cat
        resid = np.zeros((ch, 8), dtype=np.int64)
        if cat == 2:
            dc_raster = np.zeros(8, dtype=np.int64)
            dc_raster[[0, 2, 1, 4, 6, 3, 5, 7]] = mb.chroma_dc[ci][:8]
        for j in range(4 * cat):
            bx, by = j & 1, j >> 1
            full = np.zeros(16, dtype=np.int64)
            full[0] = (mb.chroma_dc[ci][j] if cat == 1 else dc_raster[j])
            full[1:] = mb.chroma_ac[ci][j][:15]
            resid[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = dezigzag4(full)
        mode = int(mb.chroma_mode)
        if mode == 1:    # horizontal: 8.3.5 DPCM along rows
            resid = np.cumsum(resid, axis=1)
        elif mode == 2:  # vertical
            resid = np.cumsum(resid, axis=0)
        above = plane[cy0 - 1, cx0:cx0 + 8] if avail_b else \
            np.zeros(8, np.int64)
        left = plane[cy0:cy0 + ch, cx0 - 1] if avail_a else \
            np.zeros(ch, np.int64)
        corner = int(plane[cy0 - 1, cx0 - 1]) if avail_d else 0
        pred = ip.pred_chroma(mode, above, left, corner, avail_a,
                              avail_b, avail_d, 8, ch, self.bitdepth)
        u = np.clip(pred + resid, 0, maxv)
        plane[cy0:cy0 + ch, cx0:cx0 + 8] = u

