# Copy of dryv_tpu/cavlc/syntax.py.
"""CAVLC slice-data coder (spec 7.3.4/7.3.5 with 9.1/9.2 binarizations).

The upstream reference parses entropy_coding_mode_flag but leaves CAVLC
as `todo!()` (reference slice/mod.rs:299); this module completes it with
a symmetric decoder/encoder producing/consuming the same MBState records
as the CABAC `SliceCoder`, so every downstream reconstruction path
(scalar / C++ / device) is entropy-agnostic.

Subclasses `cabac.syntax.SliceCoder` to reuse the macroblock driver
machinery (neighbor addressing, partition layouts, intra-mode
prediction, QP chain) and overrides every entropy primitive:
- fixed/Exp-Golomb syntax elements (ue/se/te, plain bits)
- mb_type / sub_mb_type / CBP me(v) mappings (Tables 9-4..9-6)
- CAVLC residual blocks: coeff_token, trailing-one signs, level
  prefix/suffix with adaptive suffixLength, total_zeros, run_before
  (Tables 9-5, 9-7..9-10); nC from neighboring 4x4 total_coeff counts.

Total-coefficient counts are stored in MBState.cbf (the CABAC path
stores 0/1 flags there; the two coders never share one picture).
"""
from __future__ import annotations

import numpy as np

from ..cabac.syntax import (CAT_CHROMA_AC, CAT_CHROMA_DC, CAT_LUMA_4X4,
                            CAT_LUMA_8X8, CAT_LUMA_AC, CAT_LUMA_DC,
                            MBState, MbKind, SliceCoder)
from . import tables_data as TD


def _vlc_maps():
    """(decode, encode) maps for every VLC family."""
    dec = {}
    enc = {}

    def add(name, lens, bits, keys):
        d = {}
        e = {}
        for k, (ln, bt) in zip(keys, zip(lens, bits)):
            if ln == 0 and k != keys[0]:
                # length 0 marks an invalid (tc, t1) combination — except
                # genuine 0-length entries never occur for valid keys
                continue
            if ln == 0:
                continue
            d[(ln, bt)] = k
            e[k] = (ln, bt)
        dec[name] = d
        enc[name] = e

    # coeff_token: key (total_coeff, trailing_ones); vlc 0..2 prefix codes
    for v in range(3):
        keys = [(tc, t1) for tc in range(17) for t1 in range(4)]
        lens = TD.COEFF_TOKEN_LEN[v * 68:(v + 1) * 68]
        bits = TD.COEFF_TOKEN_BITS[v * 68:(v + 1) * 68]
        kl, kb, kk = [], [], []
        for (tc, t1), ln, bt in zip(keys, lens, bits):
            if t1 > tc or t1 > 3:
                continue
            kl.append(ln)
            kb.append(bt)
            kk.append((tc, t1))
        add(f"ct{v}", kl, kb, kk)
    # chroma DC coeff_token: 2x2 (max 4) and 2x4 (max 8)
    for name, lens, bits, maxc in (
            ("ctdc1", TD.CHROMA_DC_LEN, TD.CHROMA_DC_BITS, 4),
            ("ctdc2", TD.CHROMA422_DC_LEN, TD.CHROMA422_DC_BITS, 8)):
        kl, kb, kk = [], [], []
        for tc in range(maxc + 1):
            for t1 in range(min(tc, 3) + 1):
                ln = lens[tc * 4 + t1]
                bt = bits[tc * 4 + t1]
                if ln == 0 and tc + t1 > 0:
                    continue
                kl.append(ln)
                kb.append(bt)
                kk.append((tc, t1))
        add(name, kl, kb, kk)
    # total_zeros (4x4 family): [total_coeff 1..15][tz]
    for tc in range(1, 16):
        kl, kb, kk = [], [], []
        for tz in range(16 - tc + 1):
            kl.append(TD.TOTAL_ZEROS_LEN[(tc - 1) * 16 + tz])
            kb.append(TD.TOTAL_ZEROS_BITS[(tc - 1) * 16 + tz])
            kk.append(tz)
        add(f"tz{tc}", kl, kb, kk)
    # chroma DC total_zeros 2x2: [tc 1..3][tz 0..(4-tc)]
    for tc in range(1, 4):
        kl, kb, kk = [], [], []
        for tz in range(4 - tc + 1):
            kl.append(TD.CHROMA_DC_TOTAL_ZEROS_LEN[(tc - 1) * 4 + tz])
            kb.append(TD.CHROMA_DC_TOTAL_ZEROS_BITS[(tc - 1) * 4 + tz])
            kk.append(tz)
        add(f"tzc{tc}", kl, kb, kk)
    # 4:2:2 chroma DC total_zeros: [tc 1..7][tz 0..(8-tc)]
    for tc in range(1, 8):
        kl, kb, kk = [], [], []
        for tz in range(8 - tc + 1):
            kl.append(TD.CHROMA422_DC_TOTAL_ZEROS_LEN[(tc - 1) * 8 + tz])
            kb.append(TD.CHROMA422_DC_TOTAL_ZEROS_BITS[(tc - 1) * 8 + tz])
            kk.append(tz)
        add(f"tzq{tc}", kl, kb, kk)
    # run_before: [min(zeros_left,7)][run]
    for zl in range(1, 8):
        kl, kb, kk = [], [], []
        for run in range(15):
            ln = TD.RUN_LEN[(zl - 1) * 16 + run]
            if ln == 0 and run > 0:
                break
            kl.append(ln)
            kb.append(TD.RUN_BITS[(zl - 1) * 16 + run])
            kk.append(run)
        add(f"run{zl}", kl, kb, kk)
    return dec, enc


_DEC, _ENC = _vlc_maps()

# mb_type value layout offsets (Tables 7-11..7-14)
_I16_BASE = 1  # I slices: 1..24 are I_16x16 variants, 25 = I_PCM


class CavlcSliceCoder(SliceCoder):
    """Symmetric CAVLC slice coder over a BitReader / BitWriter."""

    def __init__(self, bitio, sps, pps, header, mbs, slice_id: int,
                 encoding: bool):
        # replicate the SliceCoder field setup without the CABAC engine
        self.engine = None
        self.bio = bitio
        self.encoding = encoding
        self.sps = sps
        self.pps = pps
        self.header = header
        self.mbs = mbs
        self.slice_id = slice_id
        self.mb_w = sps.pic_width_in_mbs
        self.mb_h = sps.frame_height_in_mbs >> header.field_pic_flag
        self.chroma_array_type = sps.chroma_array_type
        self.qp_bd_offset_y = 6 * sps.bit_depth_luma_minus8
        self.qpy_prev = header.slice_qp_y(pps)
        self.qsy = 26 + pps.pic_init_qs_minus26 + header.slice_qs_delta
        self.curr = header.first_mb_in_slice
        self.prev_addr = -1
        self.field_flag = 0
        # CAVLC MBAFF entropy is not implemented (the CABAC path is);
        # MBAFF CAVLC streams raise in decode_slice_data
        self.mbaff = bool(not sps.frame_mbs_only_flag
                          and sps.mb_adaptive_frame_field_flag
                          and not header.field_pic_flag)
        if self.mbaff:
            raise NotImplementedError("MBAFF with CAVLC entropy")
        self._p8x8ref0 = False

    # -- entropy primitives --------------------------------------------
    def _ue(self, val=None) -> int:
        if self.encoding:
            self.bio.ue(val)
            return val
        return self.bio.ue()

    def _se(self, val=None) -> int:
        if self.encoding:
            self.bio.se(val)
            return val
        return self.bio.se()

    def _u(self, n, val=None) -> int:
        if self.encoding:
            self.bio.bits(val, n)
            return val
        return self.bio.bits(n)

    def _te(self, maxv, val=None) -> int:
        if maxv == 1:
            b = self._u(1, None if val is None else 1 - val)
            return 1 - b
        return self._ue(val)

    def _bin(self, ctx, val=None) -> int:
        raise NotImplementedError("CAVLC has no arithmetic bins")

    # -- intra prediction modes (7.3.5.1: flag + u(3) rem, MSB first) --
    def _intra_modes(self, modes, nb_fn, count):
        for blk in range(count):
            ma = nb_fn(blk, "A")
            mb_b = nb_fn(blk, "B")
            pred = 2 if ma is None or mb_b is None else min(ma, mb_b)
            if self.encoding:
                mode = int(modes[blk])
                if mode == pred:
                    self.bio.bit(1)
                else:
                    self.bio.bit(0)
                    self.bio.bits(mode if mode < pred else mode - 1, 3)
            else:
                if self.bio.bit():
                    modes[blk] = pred
                else:
                    rem = self.bio.bits(3)
                    modes[blk] = rem if rem < pred else rem + 1

    def intra4x4_pred_modes(self, mb: MBState):
        self._intra_modes(mb.intra4x4_modes, self._nb_intra_mode4, 16)

    def intra8x8_pred_modes(self, mb: MBState):
        self._intra_modes(mb.intra8x8_modes, self._nb_intra_mode8, 4)

    # -- VLC read/write -------------------------------------------------
    def _vlc_read(self, name):
        d = _DEC[name]
        acc = 0
        for n in range(1, 20):
            acc = (acc << 1) | self.bio.bit()
            if (n, acc) in d:
                return d[(n, acc)]
        raise ValueError(f"invalid {name} code")

    def _vlc_write(self, name, key):
        ln, bt = _ENC[name][key]
        self.bio.bits(bt, ln)

    # -- mb_type --------------------------------------------------------
    def _decompose_i16(self, mb, code1):
        mb.kind = MbKind.I_16X16
        mb.i16_pred_mode = code1 % 4
        cbp_c = (code1 // 4) % 3
        cbp_l = 15 if code1 >= 12 else 0
        mb.cbp = (cbp_c << 4) | cbp_l

    def _compose_i16(self, mb) -> int:
        cbp_c = (mb.cbp >> 4) & 3
        cbp_l = 12 if (mb.cbp & 0x0F) else 0
        return mb.i16_pred_mode + 4 * cbp_c + cbp_l

    def mb_type(self, mb: MBState):
        st = self.header.slice_type
        self._p8x8ref0 = False
        if self.encoding:
            v = self._mb_type_value(mb, st)
            self._ue(v)
            return
        v = self._ue()
        if st.is_intra and not st.is_switching:
            iv = v
        elif st.is_predictive:  # P/SP
            if v < 5:
                if v == 4:  # P_8x8ref0: ref_idx inferred 0
                    mb.kind = MbKind.P_8X8
                    mb.mb_type_code = 3
                    self._p8x8ref0 = True
                elif v == 3:
                    mb.kind = MbKind.P_8X8
                    mb.mb_type_code = 3
                else:
                    mb.kind = MbKind.P
                    mb.mb_type_code = v
                return
            iv = v - 5
        elif st.value == 4:  # SI
            if v == 0:
                mb.kind = MbKind.SI
                return
            iv = v - 1
        else:  # B
            if v < 23:
                mb.kind = (MbKind.B_DIRECT if v == 0 else
                           MbKind.B_8X8 if v == 22 else MbKind.B)
                mb.mb_type_code = v
                return
            iv = v - 23
        # intra
        if iv == 0:
            mb.kind = MbKind.I_NXN
        elif iv == 25:
            mb.kind = MbKind.I_PCM
        else:
            self._decompose_i16(mb, iv - 1)

    def _mb_type_value(self, mb, st) -> int:
        if mb.kind == MbKind.I_NXN:
            iv = 0
        elif mb.kind == MbKind.I_PCM:
            iv = 25
        elif mb.kind == MbKind.I_16X16:
            iv = 1 + self._compose_i16(mb)
        elif mb.kind == MbKind.SI:
            return 0
        elif mb.kind in (MbKind.P, MbKind.P_8X8):
            return (3 if mb.kind == MbKind.P_8X8 else mb.mb_type_code)
        elif mb.kind in (MbKind.B, MbKind.B_8X8, MbKind.B_DIRECT):
            return mb.mb_type_code
        else:
            raise ValueError(f"mb_type for kind {mb.kind}")
        if st.is_intra and not st.is_switching:
            return iv
        if st.is_predictive:
            return 5 + iv
        if st.value == 4:
            return 1 + iv
        return 23 + iv

    # -- overridden syntax elements ------------------------------------
    def transform_size_8x8_flag(self, mb: MBState):
        mb.transform8x8 = self._u(1, mb.transform8x8
                                  if self.encoding else None)

    def intra_chroma_pred_mode(self, mb: MBState):
        mb.chroma_mode = self._ue(int(mb.chroma_mode)
                                  if self.encoding else None)

    def ref_idx(self, mb: MBState, blk8: int, which: int, max_ref: int,
                val=None) -> int:
        if max_ref == 0 or self._p8x8ref0:
            if not self.encoding:
                mb.ref_idx[which][blk8] = 0
            return 0
        v = self._te(max_ref, val)
        if not self.encoding:
            mb.ref_idx[which][blk8] = v
        return v

    def mvd(self, mb: MBState, blk4: int, comp: int, which: int,
            val=None) -> int:
        return self._se(val)

    def sub_mb_types(self, mb: MBState):
        for i in range(4):
            v = self._ue(int(mb.sub_mb_type[i]) if self.encoding else None)
            if not self.encoding:
                mb.sub_mb_type[i] = v

    def coded_block_pattern(self, mb: MBState):
        intra = mb.kind in (MbKind.I_NXN, MbKind.SI)
        if self.chroma_array_type in (1, 2):
            table = (TD.GOLOMB_TO_INTRA_CBP if intra
                     else TD.GOLOMB_TO_INTER_CBP)
        else:
            table = (TD.GOLOMB_TO_INTRA_CBP_GRAY if intra
                     else TD.GOLOMB_TO_INTER_CBP_GRAY)
        if self.encoding:
            self._ue(table.index(mb.cbp))
        else:
            mb.cbp = table[self._ue()]

    def mb_qp_delta(self, mb: MBState):
        mb.qp_delta = self._se(int(mb.qp_delta) if self.encoding else None)

    def mb_skip_flag(self, mb, val=None):
        raise NotImplementedError("CAVLC uses mb_skip_run")

    # -- PCM ------------------------------------------------------------
    def _pcm(self, mb: MBState):
        bio = self.bio
        bd_l = self.sps.bit_depth_luma_minus8 + 8
        bd_c = self.sps.bit_depth_chroma_minus8 + 8
        n_chroma = (64 << self.chroma_array_type
                    if self.chroma_array_type else 0)
        if self.encoding:
            while bio.nbits:
                bio.bit(0)  # pcm_alignment_zero_bit
            for v in mb.pcm_luma:
                bio.bits(int(v), bd_l)
            if n_chroma:
                for v in mb.pcm_chroma.reshape(-1):
                    bio.bits(int(v), bd_c)
        else:
            bio.byte_align()
            mb.pcm_luma = np.array([bio.bits(bd_l) for _ in range(256)],
                                   dtype=np.int32)
            if n_chroma:
                mb.pcm_chroma = np.array(
                    [bio.bits(bd_c) for _ in range(n_chroma)],
                    dtype=np.int32).reshape(2, -1)
        mb.qp_delta = 0
        mb.transform8x8 = 0
        mb.cbp = 0x2F
        mb.chroma_mode = 0
        mb.cbf[:] = 16  # nC of an I_PCM block is 16 (9.2.1)
        mb.intra4x4_modes[:] = 2
        mb.intra8x8_modes[:] = 2

    # -- macroblock layer ----------------------------------------------
    def macroblock_layer(self, mb: MBState):
        sps, pps = self.sps, self.pps
        st = self.header.slice_type
        mb.slice_id = self.slice_id
        self.mbs[self.curr] = mb
        self.mb_type(mb)

        if mb.kind == MbKind.I_PCM:
            self._pcm(mb)
            mb.qp_y = self.qpy_prev
            mb.qs_y = self.qsy
            return

        intra = mb.kind in (MbKind.I_NXN, MbKind.I_16X16, MbKind.SI)
        no_small_parts = True
        if mb.kind in (MbKind.P_8X8, MbKind.B_8X8):
            from ..cabac.syntax import B_SUB_TYPES, P_SUB_TYPES, PRED_DIRECT
            self.sub_mb_types(mb)
            table = P_SUB_TYPES if st.is_predictive else B_SUB_TYPES
            for q in range(4):
                name, nparts, wh, pred = table[mb.sub_mb_type[q]]
                if pred == PRED_DIRECT:
                    if not sps.direct_8x8_inference_flag:
                        no_small_parts = False
                elif wh != (8, 8):
                    no_small_parts = False
            self.sub_mb_pred(mb)
            mb.chroma_mode = 0
        else:
            if mb.kind == MbKind.I_NXN and pps.transform_8x8_mode_flag:
                self.transform_size_8x8_flag(mb)
            if mb.kind in (MbKind.I_NXN, MbKind.SI):
                if mb.transform8x8:
                    self.intra8x8_pred_modes(mb)
                else:
                    self.intra4x4_pred_modes(mb)
            if intra and self.chroma_array_type in (1, 2):
                self.intra_chroma_pred_mode(mb)
            if mb.kind in (MbKind.P, MbKind.B):
                self.mb_pred_inter(mb)

        if mb.kind != MbKind.I_16X16:
            self.coded_block_pattern(mb)
            if (mb.cbp & 0x0F) and pps.transform_8x8_mode_flag and \
                    not intra and no_small_parts and \
                    (mb.kind != MbKind.B_DIRECT or
                     sps.direct_8x8_inference_flag):
                self.transform_size_8x8_flag(mb)
        if mb.cbp != 0 or mb.kind == MbKind.I_16X16:
            self.mb_qp_delta(mb)
        else:
            mb.qp_delta = 0
        self.residual(mb)

        off = self.qp_bd_offset_y
        mb.qp_y = ((self.qpy_prev + mb.qp_delta + 52 + 2 * off)
                   % (52 + off)) - off
        self.qpy_prev = mb.qp_y
        mb.qs_y = self.qsy
        if mb.kind == MbKind.I_NXN and mb.transform8x8:
            mb.intra4x4_modes[:] = np.repeat(mb.intra8x8_modes, 4)

    # -- CAVLC residual (9.2) ------------------------------------------
    def _nc(self, cat: int, idx: int) -> int:
        if cat == CAT_CHROMA_DC:
            return -self.chroma_array_type  # -1 (4:2:0) / -2 (4:2:2)
        if cat in (CAT_LUMA_DC,):
            blk, comp, nbf = 0, 0, self.nb_blk4
        elif cat in (CAT_LUMA_AC, CAT_LUMA_4X4):
            blk, comp, nbf = idx, 0, self.nb_blk4
        else:  # CAT_CHROMA_AC
            comp = (idx >> 3) + 1
            blk, nbf = idx & 7, self.nb_blkc
        na = nb = None
        a, ia = nbf("A", blk)
        b, ib = nbf("B", blk)
        if a.available:
            na = int(a.cbf[comp][ia])
        if b.available:
            nb = int(b.cbf[comp][ib])
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def _store_count(self, cat: int, idx: int, count: int):
        cur = self.cur_mb()
        if cat == CAT_LUMA_DC:
            return  # DC counts are not used for neighbor nC
        if cat in (CAT_LUMA_AC, CAT_LUMA_4X4):
            cur.cbf[0][idx] = count
        elif cat == CAT_CHROMA_AC:
            cur.cbf[(idx >> 3) + 1][idx & 7] = count

    def _coeff_table(self, nc: int) -> str:
        if nc == -1:
            return "ctdc1"
        if nc == -2:
            return "ctdc2"
        if nc < 2:
            return "ct0"
        if nc < 4:
            return "ct1"
        if nc < 8:
            return "ct2"
        return "flc"

    def _read_coeff_token(self, nc):
        name = self._coeff_table(nc)
        if name == "flc":
            v = self.bio.bits(6)
            if v == 3:
                return 0, 0
            return (v >> 2) + 1, v & 3
        return self._vlc_read(name)

    def _write_coeff_token(self, nc, tc, t1):
        name = self._coeff_table(nc)
        if name == "flc":
            v = 3 if tc == 0 else ((tc - 1) << 2) | t1
            self.bio.bits(v, 6)
        else:
            self._vlc_write(name, (tc, t1))

    def residual_block(self, cat: int, idx: int, coeffs: np.ndarray,
                       start: int, end: int, maxnumcoeff: int,
                       coded: bool):
        assert start == 0
        if cat == CAT_LUMA_8X8:
            # CAVLC codes an 8x8 block as four interleaved 4x4 blocks
            # (7.4.5.3.3): sub-block b holds scan positions 4k + b
            for b in range(4):
                sub = (coeffs[b::4].copy() if self.encoding
                       else np.zeros(16, coeffs.dtype))
                self._residual_4x4(CAT_LUMA_4X4, idx * 4 + b, sub, 15, 16,
                                   coded)
                if not self.encoding:
                    coeffs[b::4] = sub
            return
        self._residual_4x4(cat, idx, coeffs, end, maxnumcoeff, coded)

    def _residual_4x4(self, cat, idx, coeffs, end, maxnumcoeff, coded):
        if not coded:
            self._store_count(cat, idx, 0)
            if not self.encoding:
                coeffs[:maxnumcoeff] = 0
            return
        nc = self._nc(cat, idx)
        if self.encoding:
            self._encode_block(cat, idx, coeffs, end, maxnumcoeff, nc)
        else:
            self._decode_block(cat, idx, coeffs, end, maxnumcoeff, nc)

    def _decode_block(self, cat, idx, coeffs, end, maxnumcoeff, nc):
        bio = self.bio
        tc, t1 = self._read_coeff_token(nc)
        self._store_count(cat, idx, tc)
        coeffs[:maxnumcoeff] = 0
        if tc == 0:
            return
        ncoeff = end + 1
        suffix_len = 1 if (tc > 10 and t1 < 3) else 0
        levels = []
        for i in range(tc):
            if i < t1:
                levels.append(1 - 2 * bio.bit())
                continue
            prefix = 0
            while bio.bit() == 0:
                prefix += 1
            size = suffix_len
            if prefix == 14 and suffix_len == 0:
                size = 4
            elif prefix >= 15:
                size = prefix - 3
            code = min(15, prefix) << suffix_len
            if size:
                code += bio.bits(size)
            if prefix >= 15 and suffix_len == 0:
                code += 15
            if prefix >= 16:
                code += (1 << (prefix - 3)) - 4096
            if i == t1 and t1 < 3:
                code += 2
            level = (code + 2) >> 1 if code % 2 == 0 else -((code + 1) >> 1)
            if suffix_len == 0:
                suffix_len = 1
            if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
                suffix_len += 1
            levels.append(level)
        # total_zeros
        if tc < ncoeff:
            total_zeros = self._vlc_read(self._tz_table(cat, tc))
        else:
            total_zeros = 0
        # run_before + placement (high frequency first)
        zeros_left = total_zeros
        pos = tc + total_zeros - 1
        for i in range(tc):
            coeffs[pos] = levels[i]
            if i == tc - 1:
                break
            if zeros_left > 0:
                run = self._vlc_read(f"run{min(zeros_left, 7)}")
            else:
                run = 0
            zeros_left -= run
            pos -= 1 + run

    def _encode_block(self, cat, idx, coeffs, end, maxnumcoeff, nc):
        bio = self.bio
        ncoeff = end + 1
        sigpos = [i for i in range(ncoeff) if coeffs[i] != 0]
        tc = len(sigpos)
        # trailing ones: up to 3 final +-1 coefficients
        t1 = 0
        for p in reversed(sigpos):
            if t1 < 3 and abs(int(coeffs[p])) == 1:
                t1 += 1
            else:
                break
        self._store_count(cat, idx, tc)
        self._write_coeff_token(nc, tc, t1)
        if tc == 0:
            return
        levels = [int(coeffs[p]) for p in reversed(sigpos)]
        suffix_len = 1 if (tc > 10 and t1 < 3) else 0
        for i, level in enumerate(levels):
            if i < t1:
                bio.bit(0 if level > 0 else 1)
                continue
            code = 2 * abs(level) - 2 if level > 0 else 2 * abs(level) - 1
            if i == t1 and t1 < 3:
                code -= 2
            # choose prefix/suffix for this suffix_len (9.2.2.1 inverse)
            if suffix_len == 0:
                if code < 14:
                    bio.bits(1, code + 1)  # prefix = code, then stop bit
                elif code < 30:
                    bio.bits(1, 15)  # prefix 14, stop
                    bio.bits(code - 14, 4)
                else:
                    c = code - 30  # prefix >= 15 escape
                    pre = 15
                    while c >= (1 << (pre - 3)):
                        c -= 1 << (pre - 3)
                        pre += 1
                    bio.bits(0, pre)
                    bio.bit(1)
                    bio.bits(c, pre - 3)
            else:
                pre = code >> suffix_len
                if pre < 15:
                    bio.bits(0, pre)
                    bio.bit(1)
                    bio.bits(code & ((1 << suffix_len) - 1), suffix_len)
                else:
                    c = code - (15 << suffix_len)
                    pre = 15
                    while c >= (1 << (pre - 3)):
                        c -= 1 << (pre - 3)
                        pre += 1
                    bio.bits(0, pre)
                    bio.bit(1)
                    bio.bits(c, pre - 3)
            if suffix_len == 0:
                suffix_len = 1
            if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
                suffix_len += 1
        total_zeros = sigpos[-1] + 1 - tc
        if tc < ncoeff:
            self._vlc_write(self._tz_table(cat, tc), total_zeros)
        zeros_left = total_zeros
        prev = sigpos[-1]
        for i in range(tc - 1):
            nxt = sigpos[tc - 2 - i]
            run = prev - nxt - 1
            if zeros_left > 0:
                self._vlc_write(f"run{min(zeros_left, 7)}", run)
            zeros_left -= run
            prev = nxt

    def _tz_table(self, cat, tc) -> str:
        if cat == CAT_CHROMA_DC:
            return (f"tzc{tc}" if self.chroma_array_type == 1
                    else f"tzq{tc}")
        return f"tz{tc}"

    # -- slice data (7.3.4, CAVLC flavor) ------------------------------
    def decode_slice_data(self, sgmap=None):
        assert not self.encoding
        st = self.header.slice_type
        n = self.mb_w * self.mb_h
        while True:
            if not st.is_intra:
                run = self._ue()  # mb_skip_run
                for _ in range(run):
                    mb = MBState.fresh()
                    self._skip_mb(mb)
                    self.prev_addr = self.curr
                    self.curr = self._next_addr(sgmap)
                if run > 0 and not self.bio.more_rbsp_data():
                    break
            mb = MBState.fresh()
            self.macroblock_layer(mb)
            self.prev_addr = self.curr
            if not self.bio.more_rbsp_data():
                break
            nxt = self._next_addr(sgmap)
            if nxt >= n:
                break
            self.curr = nxt
        return self.curr

    def encode_slice_data(self, mb_list, sgmap=None):
        assert self.encoding
        st = self.header.slice_type
        run = 0
        for mb in mb_list:
            skip = mb.kind in (MbKind.P_SKIP, MbKind.B_SKIP)
            if skip:
                self._skip_mb(mb)
                run += 1
                self.prev_addr = self.curr
                self.curr = self._next_addr(sgmap)
                continue
            if not st.is_intra:
                self._ue(run)
                run = 0
            self.macroblock_layer(mb)
            self.prev_addr = self.curr
            self.curr = self._next_addr(sgmap)
        if run > 0:
            self._ue(run)  # trailing skip run
