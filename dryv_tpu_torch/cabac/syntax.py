# Copy of dryv_tpu/cabac/syntax.py.
"""CABAC macroblock-layer syntax (spec 7.3.5 / 9.3.2 / 9.3.3.1).

One symmetric implementation of every syntax element: context derivation is
shared between the decode path (CabacDecoder) and the encode path
(CabacEncoder, used by the fixture generator), so the two cannot drift.

The decode side is the behavioural mirror of reference
src/video/cabac/mod.rs:89-1111 (macroblock_layer and friends), restructured:
instead of reconstructing pixels per-MB, it fills per-slice dense arrays
(coefficients in scan order + mode/QP planes) that the TPU kernels consume.

Scope: I slices (I_NxN 4x4/8x8, I_16x16, I_PCM), chroma_array_type 0-3
(4:4:4 Cb/Cr residuals ride the luma process with categories 6-13), and
full P/B syntax (mvd/ref_idx/sub_mb).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield
from enum import IntEnum

import numpy as np

from ..avc.neighbors import (POS_TO_ZSCAN, ZSCAN_4X4_POS as ZSCAN_POS,
                             blk4x4_neighbor, blk8x8_neighbor,
                             chroma_blk_neighbor, mbaff_neighbor)
from ..avc.slice_header import SliceType
from . import tables as T
from .engine import CabacDecoder
from .encoder import CabacEncoder


class MbKind(IntEnum):
    I_NXN = 0
    I_16X16 = 1
    I_PCM = 2
    P = 3       # inter 16x16/16x8/8x16 partitions
    P_8X8 = 4
    P_SKIP = 5
    B = 6
    B_8X8 = 7
    B_SKIP = 8
    B_DIRECT = 9
    SI = 10     # SI-slice special intra 4x4 (QS-quantized transform)


# inter prediction modes per partition
PRED_L0, PRED_L1, PRED_BI, PRED_DIRECT, PRED_NONE = range(5)

# P mb_types (Table 7-13): (partitions, (w,h), pred modes)
P_MB_TYPES = [
    ("P_L0_16x16", 1, (16, 16), [PRED_L0]),
    ("P_L0_L0_16x8", 2, (16, 8), [PRED_L0, PRED_L0]),
    ("P_L0_L0_8x16", 2, (8, 16), [PRED_L0, PRED_L0]),
    ("P_8x8", 4, (8, 8), None),
]
# B mb_types (Table 7-14), in code order 0..22
B_MB_TYPES = [
    ("B_Direct_16x16", 1, (16, 16), [PRED_DIRECT]),
    ("B_L0_16x16", 1, (16, 16), [PRED_L0]),
    ("B_L1_16x16", 1, (16, 16), [PRED_L1]),
    ("B_Bi_16x16", 1, (16, 16), [PRED_BI]),
    ("B_L0_L0_16x8", 2, (16, 8), [PRED_L0, PRED_L0]),
    ("B_L0_L0_8x16", 2, (8, 16), [PRED_L0, PRED_L0]),
    ("B_L1_L1_16x8", 2, (16, 8), [PRED_L1, PRED_L1]),
    ("B_L1_L1_8x16", 2, (8, 16), [PRED_L1, PRED_L1]),
    ("B_L0_L1_16x8", 2, (16, 8), [PRED_L0, PRED_L1]),
    ("B_L0_L1_8x16", 2, (8, 16), [PRED_L0, PRED_L1]),
    ("B_L1_L0_16x8", 2, (16, 8), [PRED_L1, PRED_L0]),
    ("B_L1_L0_8x16", 2, (8, 16), [PRED_L1, PRED_L0]),
    ("B_L0_Bi_16x8", 2, (16, 8), [PRED_L0, PRED_BI]),
    ("B_L0_Bi_8x16", 2, (8, 16), [PRED_L0, PRED_BI]),
    ("B_L1_Bi_16x8", 2, (16, 8), [PRED_L1, PRED_BI]),
    ("B_L1_Bi_8x16", 2, (8, 16), [PRED_L1, PRED_BI]),
    ("B_Bi_L0_16x8", 2, (16, 8), [PRED_BI, PRED_L0]),
    ("B_Bi_L0_8x16", 2, (8, 16), [PRED_BI, PRED_L0]),
    ("B_Bi_L1_16x8", 2, (16, 8), [PRED_BI, PRED_L1]),
    ("B_Bi_L1_8x16", 2, (8, 16), [PRED_BI, PRED_L1]),
    ("B_Bi_Bi_16x8", 2, (16, 8), [PRED_BI, PRED_BI]),
    ("B_Bi_Bi_8x16", 2, (8, 16), [PRED_BI, PRED_BI]),
    ("B_8x8", 4, (8, 8), None),
]
# P sub_mb_types (Table 7-17): (parts, (w,h), pred)
P_SUB_TYPES = [
    ("P_L0_8x8", 1, (8, 8), PRED_L0),
    ("P_L0_8x4", 2, (8, 4), PRED_L0),
    ("P_L0_4x8", 2, (4, 8), PRED_L0),
    ("P_L0_4x4", 4, (4, 4), PRED_L0),
]
# B sub_mb_types (Table 7-18)
B_SUB_TYPES = [
    ("B_Direct_8x8", 4, (4, 4), PRED_DIRECT),
    ("B_L0_8x8", 1, (8, 8), PRED_L0),
    ("B_L1_8x8", 1, (8, 8), PRED_L1),
    ("B_Bi_8x8", 1, (8, 8), PRED_BI),
    ("B_L0_8x4", 2, (8, 4), PRED_L0),
    ("B_L0_4x8", 2, (4, 8), PRED_L0),
    ("B_L1_8x4", 2, (8, 4), PRED_L1),
    ("B_L1_4x8", 2, (4, 8), PRED_L1),
    ("B_Bi_8x4", 2, (8, 4), PRED_BI),
    ("B_Bi_4x8", 2, (4, 8), PRED_BI),
    ("B_L0_4x4", 4, (4, 4), PRED_L0),
    ("B_L1_4x4", 4, (4, 4), PRED_L1),
    ("B_Bi_4x4", 4, (4, 4), PRED_BI),
]


@dataclass
class MBState:
    """Per-macroblock syntax state (the neighbor-visible subset of the
    reference's Macroblock record, macroblock.rs:21-258, plus coefficients)."""
    available: bool = True
    slice_id: int = -1
    kind: int = MbKind.I_NXN
    transform8x8: int = 0
    cbp: int = 0x0F  # unavailable-intra default (consts.rs sentinel)
    qp_delta: int = 0
    qp_y: int = 0
    qs_y: int = 0  # SP/SI switching quantizer (spec 8.5.12 QSY)
    i16_pred_mode: int = 0
    chroma_mode: int = 0
    intra4x4_modes: np.ndarray = None  # [16] resolved modes
    intra8x8_modes: np.ndarray = None  # [4]
    cbf: np.ndarray = None  # [3][17]; [..][16] = DC
    # inter state (P/B syntax parity; reconstruction is out of scope, as in
    # the reference: frame/mod.rs:88 todo!("Inter prediction"))
    field_flag: int = 0  # MBAFF mb_field_decoding_flag (per pair)
    mb_type_code: int = 0      # raw P/B mb_type value
    sub_mb_type: np.ndarray = None  # [4]
    ref_idx: np.ndarray = None      # [2][4] per 8x8 quadrant
    mvd: np.ndarray = None          # [2][16][2] per 4x4 block (x, y)
    # coefficients, scan (zig-zag) order as coded
    luma_dc: np.ndarray = None      # [16]
    luma4: np.ndarray = None        # [16][16]  (AC blocks for I16x16: [..][15] used)
    luma8: np.ndarray = None        # [4][64]
    chroma_dc: np.ndarray = None    # [2][8]   (4 used for 4:2:0)
    chroma_ac: np.ndarray = None    # [2][8][16] (AC in slots 1..15)
    pcm_luma: np.ndarray = None     # [256]
    pcm_chroma: np.ndarray = None   # [2][64*cat]
    # 4:4:4 (ChromaArrayType 3): Cb/Cr coefficients in the luma layout
    # (allocated lazily by alloc_444 — only 4:4:4 streams pay for them)
    cbcr_dc: np.ndarray = None      # [2][16]
    cbcr4: np.ndarray = None        # [2][16][16]
    cbcr8: np.ndarray = None        # [2][4][64]

    @classmethod
    def fresh(cls, **kw) -> "MBState":
        m = cls(**kw)
        m.cbp = kw.get("cbp", 0)
        m.intra4x4_modes = np.full(16, 2, dtype=np.int32)  # DC default
        m.intra8x8_modes = np.full(4, 2, dtype=np.int32)
        m.cbf = np.zeros((3, 17), dtype=np.int32)
        m.luma_dc = np.zeros(16, dtype=np.int32)
        m.luma4 = np.zeros((16, 16), dtype=np.int32)
        m.luma8 = np.zeros((4, 64), dtype=np.int32)
        m.chroma_dc = np.zeros((2, 8), dtype=np.int32)
        m.chroma_ac = np.zeros((2, 8, 16), dtype=np.int32)
        m.sub_mb_type = np.full(4, -1, dtype=np.int32)
        m.ref_idx = np.zeros((2, 4), dtype=np.int32)
        m.mvd = np.zeros((2, 16, 2), dtype=np.int32)
        return m

    def alloc_444(self) -> "MBState":
        """Allocate the Cb/Cr luma-layout coefficient planes (4:4:4)."""
        if self.cbcr4 is None:
            self.cbcr_dc = np.zeros((2, 16), dtype=np.int32)
            self.cbcr4 = np.zeros((2, 16, 16), dtype=np.int32)
            self.cbcr8 = np.zeros((2, 4, 64), dtype=np.int32)
        return self


def _unavailable(intra: bool) -> MBState:
    m = MBState.fresh(available=False)
    m.cbp = 0x0F
    if intra:
        m.cbf[:] = 1
    else:
        m.cbp = 0
    return m


UNAVAIL_INTRA = _unavailable(True)
UNAVAIL_INTER = _unavailable(False)

# Residual block categories (spec Table 9-40)
CAT_LUMA_DC = 0
CAT_LUMA_AC = 1
CAT_LUMA_4X4 = 2
CAT_CHROMA_DC = 3
CAT_CHROMA_AC = 4
CAT_LUMA_8X8 = 5
# 4:4:4 (ChromaArrayType 3): Cb/Cr residuals ride the luma process with
# their own context categories (spec 7.3.5.3.1 residual_luma for Cb/Cr;
# reference consts.rs CAT6..CAT13 bases / cabac/mod.rs:433-467 routing)
CAT_CB_DC = 6
CAT_CB_AC = 7
CAT_CB_4X4 = 8
CAT_CB_8X8 = 9
CAT_CR_DC = 10
CAT_CR_AC = 11
CAT_CR_4X4 = 12
CAT_CR_8X8 = 13

# per-category neighbor-context shape groups for coded_block_flag
_CATS_MBDC = {CAT_LUMA_DC: 0, CAT_CB_DC: 1, CAT_CR_DC: 2}
_CATS_BLK4 = {CAT_LUMA_AC: 0, CAT_LUMA_4X4: 0, CAT_CB_AC: 1,
              CAT_CB_4X4: 1, CAT_CR_AC: 2, CAT_CR_4X4: 2}
_CATS_BLK8 = {CAT_LUMA_8X8: 0, CAT_CB_8X8: 1, CAT_CR_8X8: 2}


def _fieldscan_perms():
    """Permutations normalizing field-scan coded coefficients into the
    frame-zigzag storage order every downstream consumer expects
    (spec 8.5.6: field MBs scan with Tables 8-9/8-10)."""
    from ..avc.sps import FIELDSCAN_4X4, FIELDSCAN_8X8, ZIGZAG_4X4, ZIGZAG_8X8
    fsi4 = np.argsort(FIELDSCAN_4X4)   # raster -> field-scan index
    fsi8 = np.argsort(FIELDSCAN_8X8)
    p16 = fsi4[ZIGZAG_4X4]             # stored[j] = coded[p16[j]]
    p64 = fsi8[ZIGZAG_8X8]
    p15 = fsi4[ZIGZAG_4X4[1:]] - 1     # AC blocks: scan positions 1..15
    return {16: (p16, np.argsort(p16)),
            64: (p64, np.argsort(p64)),
            15: (p15, np.argsort(p15))}


FIELD_PERMS = _fieldscan_perms()


class SliceCoder:
    """Walks macroblocks of one I slice in raster order, decoding syntax from
    (or encoding syntax to) a CABAC engine.  `mbs` is the frame-wide MBState
    array shared across slices of the same picture."""

    def __init__(self, engine, sps, pps, header, mbs, slice_id: int):
        self.engine = engine
        self.encoding = isinstance(engine, CabacEncoder)
        self.sps = sps
        self.pps = pps
        self.header = header
        self.mbs = mbs
        self.slice_id = slice_id
        self.mb_w = sps.pic_width_in_mbs
        # a field picture is a standalone picture of half frame height
        # (reference slice/mod.rs:328-342 handles the flag at entropy level)
        self.mb_h = sps.frame_height_in_mbs >> header.field_pic_flag
        self.chroma_array_type = sps.chroma_array_type
        self.qp_bd_offset_y = 6 * sps.bit_depth_luma_minus8
        self.qpy_prev = header.slice_qp_y(pps)
        self.qsy = 26 + pps.pic_init_qs_minus26 + header.slice_qs_delta
        # MBAFF: macroblock-adaptive frame/field — MBs decode in vertical
        # pairs, each pair choosing frame or field coding
        # (mb_field_decoding_flag); the reference implements this at the
        # entropy layer only (cabac/mod.rs:1105-1111, slice/mod.rs:412-451)
        self.mbaff = bool(not sps.frame_mbs_only_flag
                          and sps.mb_adaptive_frame_field_flag
                          and not header.field_pic_flag)
        self.curr = header.first_mb_in_slice * (2 if self.mbaff else 1)
        self.prev_addr = -1
        # selects the field column of the significance maps (Table 9-43);
        # under MBAFF this is set per-MB in macroblock_layer
        self.field_flag = header.field_pic_flag
        self.prev_mb_skipped = False

    # -- engine primitives (symmetric) ----------------------------------
    def _bin(self, ctx: int, val=None) -> int:
        if self.encoding:
            self.engine.decision(ctx, val)
            return val
        return self.engine.decision(ctx)

    def _bypass(self, val=None) -> int:
        if self.encoding:
            self.engine.bypass(val)
            return val
        return self.engine.bypass()

    def _terminate(self, val=None) -> int:
        if self.encoding:
            self.engine.terminate(val)
            return val
        return self.engine.terminate()

    # -- neighbors ------------------------------------------------------
    def mb_at(self, addr: int) -> MBState:
        if addr < 0 or addr >= len(self.mbs):
            return UNAVAIL_INTRA
        m = self.mbs[addr]
        if m is None or m.slice_id != self.slice_id:
            return UNAVAIL_INTRA
        return m

    def nb_mb(self, direction: str, addr=None) -> MBState:
        a = self.curr if addr is None else addr
        if self.mbaff:
            # 6.4.11 locations: A=(-1,0), B=(0,-1), C=(maxW,-1), D=(-1,-1)
            xn = -1 if direction in "AD" else (16 if direction == "C" else 0)
            r = self.mbaff_nb_sample(xn, -1 if direction in "BCD" else 0,
                                     addr=a)
            return UNAVAIL_INTRA if r is None else self.mb_at(r[0])
        x, y = a % self.mb_w, a // self.mb_w
        if direction == "A":
            return self.mb_at(a - 1) if x > 0 else UNAVAIL_INTRA
        if direction == "B":
            return self.mb_at(a - self.mb_w)
        if direction == "C":
            return self.mb_at(a - self.mb_w + 1) if x + 1 < self.mb_w else UNAVAIL_INTRA
        if direction == "D":
            return self.mb_at(a - self.mb_w - 1) if x > 0 else UNAVAIL_INTRA
        raise ValueError(direction)

    def _mb_field(self, addr: int) -> int:
        """Field flag of the pair containing `addr` (both MBs share it).

        For the not-yet-decoded current pair, spec 7.4.4 inference applies:
        presume the left pair's flag, else the above pair's, else frame."""
        m = self.mbs[addr & ~1]
        if m is None:
            m = self.mbs[addr | 1]
        if m is not None:
            return m.field_flag
        pair = (addr & ~1) >> 1
        px, py = pair % self.mb_w, pair // self.mb_w
        if px > 0:
            n = self.mb_at(2 * (pair - 1))
            if n.available and n.slice_id == self.slice_id:
                return n.field_flag
        if py > 0:
            n = self.mb_at(2 * (pair - self.mb_w))
            if n.available and n.slice_id == self.slice_id:
                return n.field_flag
        return 0

    def mbaff_nb_sample(self, xN: int, yN: int, addr=None, maxw=16,
                        maxh=16):
        """MBAFF neighbouring location (6.4.11 via
        avc.neighbors.mbaff_neighbor) with slice-availability applied.
        Returns (mb_addr, xW, yM) or None."""
        a = self.curr if addr is None else addr
        r = mbaff_neighbor(a, xN, yN, self.mb_w,
                           lambda p: self._mb_field(p * 2),
                           maxw=maxw, maxh=maxh)
        if r is None:
            return None
        nb = self.mb_at(r[0])
        if not nb.available or nb.slice_id != self.slice_id:
            return None
        return r

    def cur_mb(self) -> MBState:
        return self.mbs[self.curr]

    def nb_blk4(self, direction: str, blk: int):
        same, nb = blk4x4_neighbor(blk, direction)
        if same:
            return self.cur_mb(), nb
        if self.mbaff:
            x, y = ZSCAN_POS[blk]
            r = self.mbaff_nb_sample(4 * x - 1 if direction == "A" else 4 * x,
                                     4 * y if direction == "A" else 4 * y - 1)
            if r is None:
                return UNAVAIL_INTRA, nb
            naddr, xW, yM = r
            return self.mb_at(naddr), POS_TO_ZSCAN[(xW // 4, yM // 4)]
        return self.nb_mb(direction), nb

    def nb_blk8(self, direction: str, blk: int):
        same, nb = blk8x8_neighbor(blk, direction)
        if same:
            return self.cur_mb(), nb
        if self.mbaff:
            x, y = blk & 1, blk >> 1
            r = self.mbaff_nb_sample(8 * x - 1 if direction == "A" else 8 * x,
                                     8 * y if direction == "A" else 8 * y - 1)
            if r is None:
                return UNAVAIL_INTRA, nb
            naddr, xW, yM = r
            return self.mb_at(naddr), (yM // 8) * 2 + xW // 8
        return self.nb_mb(direction), nb

    def nb_blkc(self, direction: str, blk: int):
        same, nb = chroma_blk_neighbor(blk, direction, self.chroma_array_type)
        if same:
            return self.cur_mb(), nb
        if self.mbaff:
            # chroma 4x4 blocks: 2 wide x (2*cat) tall raster
            ch = 8 * self.chroma_array_type
            x, y = blk & 1, blk >> 1
            r = self.mbaff_nb_sample(
                4 * x - 1 if direction == "A" else 4 * x,
                4 * y if direction == "A" else 4 * y - 1,
                maxw=8, maxh=ch)
            if r is None:
                return UNAVAIL_INTRA, nb
            naddr, xW, yM = r
            return self.mb_at(naddr), (yM // 4) * 2 + xW // 4
        return self.nb_mb(direction), nb

    # -- syntax elements ------------------------------------------------
    def _i_ctx_slots(self):
        """ctx slots for the I mb_type tree in an I slice (9.3.3.1.1.3):
        bin0 neighbor-conditioned, then terminate, then fixed incs 3..7."""
        a, b = self.nb_mb("A"), self.nb_mb("B")
        intra_nxn = (MbKind.I_NXN,)
        inc = (1 if (a.available and a.kind not in intra_nxn) else 0) + \
              (1 if (b.available and b.kind not in intra_nxn) else 0)
        base = T.CTX_MB_TYPE_I
        return [base + inc, None, base + 3, base + 4, base + 5,
                base + 6, base + 7]

    # I mb_type suffix ctx slots inside P/B slices (reference bidx tables)
    P_SUF_SLOTS = [17, None, 18, 19, 19, 20, 20]
    B_SUF_SLOTS = [32, None, 33, 34, 34, 35, 35]

    def mb_type_i(self, mb: MBState, slots=None):
        """mb_type I tree (Table 9-36).  slots: ctx per tree position
        (None = terminate bin); defaults to the I-slice layout."""
        if slots is None:
            slots = self._i_ctx_slots()

        if self.encoding:
            if mb.kind == MbKind.I_NXN:
                self._bin(slots[0], 0)
                return
            self._bin(slots[0], 1)
            if mb.kind == MbKind.I_PCM:
                self._terminate(1)
                return
            self._terminate(0)
            cbp_luma = 1 if (mb.cbp & 0x0F) else 0
            cbp_chroma = mb.cbp >> 4
            self._bin(slots[2], cbp_luma)
            self._bin(slots[3], 1 if cbp_chroma > 0 else 0)
            if cbp_chroma > 0:
                self._bin(slots[4], cbp_chroma - 1)
            self._bin(slots[5], (mb.i16_pred_mode >> 1) & 1)
            self._bin(slots[6], mb.i16_pred_mode & 1)
            return

        if self._bin(slots[0]) == 0:
            mb.kind = MbKind.I_NXN
            return
        if self._terminate() == 1:
            mb.kind = MbKind.I_PCM
            return
        mb.kind = MbKind.I_16X16
        cbp_luma = self._bin(slots[2])
        cbp_chroma = 0
        if self._bin(slots[3]):
            cbp_chroma = 1 + self._bin(slots[4])
        hi = self._bin(slots[5])
        lo = self._bin(slots[6])
        mb.i16_pred_mode = (hi << 1) | lo
        mb.cbp = (cbp_chroma << 4) | (0x0F if cbp_luma else 0)

    # -- P/B mb_type trees (Table 9-34/9-37/9-38) -----------------------
    def mb_skip_flag(self, mb: MBState, val=None) -> int:
        base = T.CTX_MB_SKIP_FLAG_P if self.header.slice_type.is_predictive \
            else T.CTX_MB_SKIP_FLAG_B
        skips = (MbKind.P_SKIP, MbKind.B_SKIP)
        a, b = self.nb_mb("A"), self.nb_mb("B")
        inc = (1 if (a.available and a.kind not in skips) else 0) + \
              (1 if (b.available and b.kind not in skips) else 0)
        return self._bin(base + inc, val)

    def mb_type_si(self, mb: MBState):
        """SI-slice mb_type (Table 9-36 SI row): one prefix bin, then the
        I tree (reference mod.rs SliceType::SI branch)."""
        a, b = self.nb_mb("A"), self.nb_mb("B")
        inc = (1 if (a.available and a.kind != MbKind.SI) else 0) + \
              (1 if (b.available and b.kind != MbKind.SI) else 0)
        if self.encoding:
            if mb.kind == MbKind.SI:
                self._bin(T.CTX_MB_TYPE_SI_PRE + inc, 0)
                return
            self._bin(T.CTX_MB_TYPE_SI_PRE + inc, 1)
            self.mb_type_i(mb)
            return
        if self._bin(T.CTX_MB_TYPE_SI_PRE + inc) == 0:
            mb.kind = MbKind.SI
            return
        self.mb_type_i(mb)

    def mb_type_p(self, mb: MBState):
        """P-slice mb_type (prefix ctx 14..16, escape -> I tree base 17)."""
        base = T.CTX_MB_TYPE_P_PRE
        if self.encoding:
            if mb.kind in (MbKind.I_NXN, MbKind.I_16X16, MbKind.I_PCM):
                self._bin(base, 1)
                self.mb_type_i(mb, self.P_SUF_SLOTS)
                return
            code = mb.mb_type_code
            if code == 0:    # P_L0_16x16: 000
                self._bin(base, 0); self._bin(base + 1, 0); self._bin(base + 2, 0)
            elif code == 3:  # P_8x8: 001
                self._bin(base, 0); self._bin(base + 1, 0); self._bin(base + 2, 1)
            elif code == 2:  # P_L0_L0_8x16: 010
                self._bin(base, 0); self._bin(base + 1, 1); self._bin(base + 3, 0)
            else:            # P_L0_L0_16x8: 011
                self._bin(base, 0); self._bin(base + 1, 1); self._bin(base + 3, 1)
            return
        if self._bin(base):
            self.mb_type_i(mb, self.P_SUF_SLOTS)
            return
        if self._bin(base + 1) == 0:
            code = 3 if self._bin(base + 2) else 0
        else:
            code = 1 if self._bin(base + 3) else 2
        mb.mb_type_code = code
        mb.kind = MbKind.P_8X8 if code == 3 else MbKind.P

    def mb_type_b(self, mb: MBState):
        """B-slice mb_type (prefix ctx 27..32, escape -> I tree base 32)."""
        base = T.CTX_MB_TYPE_B_PRE
        skipdir = (MbKind.B_SKIP, MbKind.B_DIRECT)
        a, b = self.nb_mb("A"), self.nb_mb("B")
        inc = (1 if (a.available and a.kind not in skipdir) else 0) + \
              (1 if (b.available and b.kind not in skipdir) else 0)

        if self.encoding:
            if mb.kind in (MbKind.I_NXN, MbKind.I_16X16, MbKind.I_PCM):
                # escape: '111' + tail '101' + I suffix
                self._bin(base + inc, 1)
                self._bin(base + 3, 1)
                self._bin(base + 4, 1)
                for bit in (1, 0, 1):
                    self._bin(base + 5, bit)
                self.mb_type_i(mb, self.B_SUF_SLOTS)
                return
            code = mb.mb_type_code
            if code == 0:
                self._bin(base + inc, 0)
                return
            self._bin(base + inc, 1)
            if code in (1, 2):
                self._bin(base + 3, 0)
                self._bin(base + 5, code - 1)
                return
            self._bin(base + 3, 1)
            if 3 <= code <= 10:
                v = code - 3
                self._bin(base + 4, 0)
                for i in (2, 1, 0):
                    self._bin(base + 5, (v >> i) & 1)
                return
            self._bin(base + 4, 1)
            if 12 <= code <= 19:
                v = code - 12
                for b in (0, (v >> 2) & 1, (v >> 1) & 1, v & 1):
                    self._bin(base + 5, b)
            elif code in (20, 21):
                for b in (1, 0, 0, code - 20):
                    self._bin(base + 5, b)
            elif code == 11:
                for b in (1, 1, 0):
                    self._bin(base + 5, b)
            else:  # 22 = B_8x8
                for b in (1, 1, 1):
                    self._bin(base + 5, b)
            return

        # decode (Table 9-37; mirrors reference MB_TYPE_B_TABLE)
        if self._bin(base + inc) == 0:
            mb.mb_type_code = 0
            mb.kind = MbKind.B_DIRECT
            return
        if self._bin(base + 3) == 0:
            mb.mb_type_code = 1 + self._bin(base + 5)
            mb.kind = MbKind.B
            return
        if self._bin(base + 4) == 0:
            v = 0
            for _ in range(3):
                v = (v << 1) | self._bin(base + 5)
            mb.mb_type_code = 3 + v
            mb.kind = MbKind.B
            return
        if self._bin(base + 5) == 0:          # tail 0xxx -> 12..19
            v = 0
            for _ in range(3):
                v = (v << 1) | self._bin(base + 5)
            mb.mb_type_code = 12 + v
            mb.kind = MbKind.B
            return
        if self._bin(base + 5) == 0:
            if self._bin(base + 5) == 0:      # tail 100b -> 20, 21
                mb.mb_type_code = 20 + self._bin(base + 5)
                mb.kind = MbKind.B
            else:                             # tail 101 -> I escape
                self.mb_type_i(mb, self.B_SUF_SLOTS)
            return
        if self._bin(base + 5) == 0:          # tail 110 -> 11
            mb.mb_type_code = 11
            mb.kind = MbKind.B
        else:                                 # tail 111 -> B_8x8
            mb.mb_type_code = 22
            mb.kind = MbKind.B_8X8

    def sub_mb_types(self, mb: MBState):
        if self.header.slice_type.is_predictive:
            base = T.CTX_SUB_MB_TYPE_P
            for i in range(4):
                if self.encoding:
                    code = int(mb.sub_mb_type[i])
                    if code == 0:
                        self._bin(base, 1)
                    elif code == 1:
                        self._bin(base, 0); self._bin(base + 1, 0)
                    elif code == 3:
                        self._bin(base, 0); self._bin(base + 1, 1)
                        self._bin(base + 2, 0)
                    else:
                        self._bin(base, 0); self._bin(base + 1, 1)
                        self._bin(base + 2, 1)
                    continue
                if self._bin(base):
                    mb.sub_mb_type[i] = 0  # P_L0_8x8
                elif self._bin(base + 1) == 0:
                    mb.sub_mb_type[i] = 1  # P_L0_8x4
                elif self._bin(base + 2):
                    mb.sub_mb_type[i] = 2  # P_L0_4x8
                else:
                    mb.sub_mb_type[i] = 3  # P_L0_4x4
        else:
            base = T.CTX_SUB_MB_TYPE_B
            for i in range(4):
                if self.encoding:
                    code = int(mb.sub_mb_type[i])
                    if code == 0:
                        self._bin(base, 0)
                    elif code in (1, 2):
                        self._bin(base, 1); self._bin(base + 1, 0)
                        self._bin(base + 3, code - 1)
                    elif 3 <= code <= 6:
                        v = code - 3
                        self._bin(base, 1); self._bin(base + 1, 1)
                        self._bin(base + 2, 0)
                        self._bin(base + 3, (v >> 1) & 1)
                        self._bin(base + 3, v & 1)
                    elif 7 <= code <= 10:
                        v = code - 7
                        self._bin(base, 1); self._bin(base + 1, 1)
                        self._bin(base + 2, 1); self._bin(base + 3, 0)
                        self._bin(base + 3, (v >> 1) & 1)
                        self._bin(base + 3, v & 1)
                    else:  # 11, 12
                        self._bin(base, 1); self._bin(base + 1, 1)
                        self._bin(base + 2, 1); self._bin(base + 3, 1)
                        self._bin(base + 3, code - 11)
                    continue
                if self._bin(base) == 0:
                    mb.sub_mb_type[i] = 0  # B_Direct_8x8
                    continue
                if self._bin(base + 1) == 0:
                    mb.sub_mb_type[i] = 1 + self._bin(base + 3)
                    continue
                if self._bin(base + 2) == 0:
                    v = (self._bin(base + 3) << 1) | self._bin(base + 3)
                    mb.sub_mb_type[i] = 3 + v
                    continue
                if self._bin(base + 3) == 0:
                    v = (self._bin(base + 3) << 1) | self._bin(base + 3)
                    mb.sub_mb_type[i] = 7 + v
                else:
                    mb.sub_mb_type[i] = 11 + self._bin(base + 3)
        # reference decodes sub types then clears chroma mode
        return

    # -- ref_idx / mvd --------------------------------------------------
    def ref_idx(self, mb: MBState, blk8: int, which: int, max_ref: int,
                val=None) -> int:
        """ref_idx_lX for an 8x8 quadrant (9.3.3.1.1.6)."""
        if max_ref == 0:
            if not self.encoding:
                mb.ref_idx[which][blk8] = 0
            return 0
        nb_a, ia = self.nb_blk8("A", blk8)
        nb_b, ib = self.nb_blk8("B", blk8)
        # 9.3.3.1.1.6: a frame-coded MB reading a field-coded neighbour
        # must treat the neighbour's (doubled) field ref indices as zero
        # up to 1, i.e. refIdxZeroFlagN tests > 1 in that case.
        cur_frame = self.mbaff and not self.cur_mb().field_flag
        thr_a = 1 if (cur_frame and nb_a.field_flag) else 0
        thr_b = 1 if (cur_frame and nb_b.field_flag) else 0
        cond_a = 1 if nb_a.ref_idx[which][ia] > thr_a else 0
        cond_b = 1 if nb_b.ref_idx[which][ib] > thr_b else 0
        ctxs = [T.CTX_REF_IDX + cond_a + 2 * cond_b,
                T.CTX_REF_IDX + 4, T.CTX_REF_IDX + 5]
        if self.encoding:
            v = val
            for k in range(v):
                self._bin(ctxs[min(k, 2)], 1)
            self._bin(ctxs[min(v, 2)], 0)
        else:
            v = 0
            while self._bin(ctxs[min(v, 2)]):
                v += 1
                if v > 63:
                    raise ValueError("ref_idx overflow")
            mb.ref_idx[which][blk8] = v
        return v

    def mvd(self, mb: MBState, blk4: int, comp: int, which: int,
            val=None) -> int:
        """mvd_lX component (9.3.3.1.1.7): UEG3, uCoff 9, signed."""
        base = T.CTX_MVD_Y if comp else T.CTX_MVD_X
        nb_a, ia = self.nb_blk4("A", blk4)
        nb_b, ib = self.nb_blk4("B", blk4)
        abs_a = abs(int(nb_a.mvd[which][ia][comp]))
        abs_b = abs(int(nb_b.mvd[which][ib][comp]))
        if comp and self.mbaff:
            # field/frame neighbour mvd_y rescale (9.3.3.1.1.7; reference
            # cabac/mod.rs:925-938)
            cur = self.cur_mb().field_flag
            if cur and not nb_a.field_flag:
                abs_a //= 2
            if not cur and nb_a.field_flag:
                abs_a *= 2
            if cur and not nb_b.field_flag:
                abs_b //= 2
            if not cur and nb_b.field_flag:
                abs_b *= 2
        sum_abs = abs_a + abs_b
        inc = 0 if sum_abs < 3 else (1 if sum_abs <= 32 else 2)
        ctxs = [base + inc, base + 3, base + 4, base + 5, base + 6]
        if self.encoding:
            a = abs(val)
            pre = min(a, 9)
            for k in range(pre):
                self._bin(ctxs[min(k, 4)], 1)
            if pre < 9:
                self._bin(ctxs[min(pre, 4)], 0)
            self.engine.ueg_suffix(a, 9, 3, True, val)
            mb.mvd[which][blk4][comp] = val
            return val
        pre = 0
        while pre < 9 and self._bin(ctxs[min(pre, 4)]):
            pre += 1
        v = self.engine.ueg_suffix(pre, 9, 3, True)
        mb.mvd[which][blk4][comp] = v
        return v

    def transform_size_8x8_flag(self, mb: MBState):
        a, b = self.nb_mb("A"), self.nb_mb("B")
        ctx = T.CTX_TRANSFORM_SIZE_8X8_FLAG + a.transform8x8 + b.transform8x8
        mb.transform8x8 = self._bin(ctx, mb.transform8x8 if self.encoding else None)

    def intra4x4_pred_modes(self, mb: MBState):
        """prev_intra4x4_pred_mode_flag / rem (spec 8.3.1.1 derivation).

        dcPredModePredictedFlag: if either neighbor is unavailable, BOTH
        sides are forced to DC before the min()."""
        for blk in range(16):
            ma = self._nb_intra_mode4(blk, "A")
            mb_b = self._nb_intra_mode4(blk, "B")
            pred = 2 if ma is None or mb_b is None else min(ma, mb_b)
            if self.encoding:
                mode = int(mb.intra4x4_modes[blk])
                if mode == pred:
                    self._bin(T.CTX_PREV_INTRA_PRED_MODE_FLAG, 1)
                else:
                    self._bin(T.CTX_PREV_INTRA_PRED_MODE_FLAG, 0)
                    rem = mode if mode < pred else mode - 1
                    for i in range(3):
                        self._bin(T.CTX_REM_INTRA_PRED_MODE, (rem >> i) & 1)
            else:
                if self._bin(T.CTX_PREV_INTRA_PRED_MODE_FLAG):
                    mb.intra4x4_modes[blk] = pred
                else:
                    rem = 0
                    for i in range(3):
                        rem |= self._bin(T.CTX_REM_INTRA_PRED_MODE) << i
                    mb.intra4x4_modes[blk] = rem if rem < pred else rem + 1

    def intra8x8_pred_modes(self, mb: MBState):
        for blk in range(4):
            ma = self._nb_intra_mode8(blk, "A")
            mb_b = self._nb_intra_mode8(blk, "B")
            pred = 2 if ma is None or mb_b is None else min(ma, mb_b)
            if self.encoding:
                mode = int(mb.intra8x8_modes[blk])
                if mode == pred:
                    self._bin(T.CTX_PREV_INTRA_PRED_MODE_FLAG, 1)
                else:
                    self._bin(T.CTX_PREV_INTRA_PRED_MODE_FLAG, 0)
                    rem = mode if mode < pred else mode - 1
                    for i in range(3):
                        self._bin(T.CTX_REM_INTRA_PRED_MODE, (rem >> i) & 1)
            else:
                if self._bin(T.CTX_PREV_INTRA_PRED_MODE_FLAG):
                    mb.intra8x8_modes[blk] = pred
                else:
                    rem = 0
                    for i in range(3):
                        rem |= self._bin(T.CTX_REM_INTRA_PRED_MODE) << i
                    mb.intra8x8_modes[blk] = rem if rem < pred else rem + 1

    def _nb_intra_mode4(self, blk: int, d: str):
        """IntraMxMPredModeN for a 4x4 block neighbor (spec 8.3.1.1).

        Returns None when the neighbor MB is unavailable (caller forces DC
        for both sides), else the neighbor mode."""
        nb, nb_blk = self.nb_blk4(d, blk)
        if nb is self.cur_mb():
            return int(nb.intra4x4_modes[nb_blk])
        if not nb.available:
            return None
        if nb.kind != MbKind.I_NXN:
            return 2  # DC
        if nb.transform8x8:
            return int(nb.intra8x8_modes[nb_blk >> 2])
        return int(nb.intra4x4_modes[nb_blk])

    def _nb_intra_mode8(self, blk: int, d: str) -> int:
        """IntraMxMPredModeN for an 8x8 block neighbor (spec 8.3.2.1).

        When the neighbor MB is 4x4-coded, the adjacent covering 4x4 block is
        the neighbor 8x8 block's top-right (A) / bottom-left (B) sub-block
        (reference pred8x8.rs:735-753 quirk)."""
        nb, nb_blk8 = self.nb_blk8(d, blk)
        if nb is self.cur_mb():
            return int(nb.intra8x8_modes[nb_blk8])
        if not nb.available:
            return None
        if nb.kind != MbKind.I_NXN:
            return 2  # DC
        if nb.transform8x8:
            return int(nb.intra8x8_modes[nb_blk8])
        sub = 1 if d == "A" else 2
        return int(nb.intra4x4_modes[4 * nb_blk8 + sub])

    def intra_chroma_pred_mode(self, mb: MBState):
        a, b = self.nb_mb("A"), self.nb_mb("B")
        inc = (1 if a.chroma_mode != 0 else 0) + (1 if b.chroma_mode != 0 else 0)
        ctxs = [T.CTX_INTRA_CHROMA_PRED_MODE + inc,
                T.CTX_INTRA_CHROMA_PRED_MODE + 3]
        if self.encoding:
            v = mb.chroma_mode
            for k in range(v):
                self._bin(ctxs[min(k, 1)], 1)
            if v < 3:
                self._bin(ctxs[min(v, 1)], 0)
        else:
            v = 0
            while v < 3 and self._bin(ctxs[min(v, 1)]):
                v += 1
            mb.chroma_mode = v

    def coded_block_pattern(self, mb: MBState):
        """cbp (9.3.3.1.1.4): 4 luma bins (8x8 z-order) + up to 2 chroma."""
        bits = [0] * 6
        cur = self.cur_mb()
        for i in range(4):
            nb_a, idx_a = self.nb_blk8("A", i)
            nb_b, idx_b = self.nb_blk8("B", i)
            bit_a = bits[idx_a] if nb_a is cur else (nb_a.cbp >> idx_a) & 1
            bit_b = bits[idx_b] if nb_b is cur else (nb_b.cbp >> idx_b) & 1
            ctx = T.CTX_CBP_LUMA + (1 - bit_a) + 2 * (1 - bit_b)
            bits[i] = self._bin(ctx, (mb.cbp >> i) & 1 if self.encoding else None)
        if self.chroma_array_type in (1, 2):
            a, b = self.nb_mb("A"), self.nb_mb("B")
            ca, cb = a.cbp >> 4, b.cbp >> 4
            ctx = T.CTX_CBP_CHROMA + (1 if ca > 0 else 0) + 2 * (1 if cb > 0 else 0)
            enc_chroma = (mb.cbp >> 4) if self.encoding else None
            bits[4] = self._bin(ctx, (1 if enc_chroma > 0 else 0)
                                if self.encoding else None)
            if bits[4]:
                ctx = T.CTX_CBP_CHROMA + 4 + (1 if ca > 1 else 0) + 2 * (1 if cb > 1 else 0)
                bits[5] = self._bin(ctx, (enc_chroma - 1) if self.encoding else None)
        cbp = bits[0] | bits[1] << 1 | bits[2] << 2 | bits[3] << 3
        if bits[4]:
            cbp |= 0x10 << bits[5]
        if not self.encoding:
            mb.cbp = cbp

    def mb_qp_delta(self, mb: MBState):
        prev = self.mbs[self.prev_addr] if self.prev_addr >= 0 else None
        if prev is not None and prev.slice_id == self.slice_id and prev.qp_delta != 0:
            c0 = T.CTX_MB_QP_DELTA + 1
        else:
            c0 = T.CTX_MB_QP_DELTA
        ctxs = [c0, T.CTX_MB_QP_DELTA + 2, T.CTX_MB_QP_DELTA + 3]
        if self.encoding:
            v = mb.qp_delta
            tmp = 2 * v - 1 if v > 0 else -2 * v
            for k in range(tmp):
                self._bin(ctxs[min(k, 2)], 1)
            self._bin(ctxs[min(tmp, 2)], 0)
        else:
            tmp = 0
            while self._bin(ctxs[min(tmp, 2)]):
                tmp += 1
                if tmp > 87:
                    raise ValueError("mb_qp_delta overflow")
            mb.qp_delta = (tmp + 1) >> 1 if (tmp & 1) else -(tmp >> 1)

    # -- inter prediction syntax (mb_pred / sub_mb_pred) ----------------
    # 16x8 partition p covers z-blocks rows; 8x16 covers columns
    _PART_BLKS = {
        (1, 0): list(range(16)),
        (2, 0): [0, 1, 4, 5, 2, 3, 6, 7],      # 16x8 top
        (2, 1): [8, 9, 12, 13, 10, 11, 14, 15],  # 16x8 bottom
        (3, 0): [0, 2, 8, 10, 1, 3, 9, 11],    # 8x16 left
        (3, 1): [4, 6, 12, 14, 5, 7, 13, 15],  # 8x16 right
    }

    def _part_layout(self, mb: MBState):
        """Returns (n_parts, [(anchor_blk4, blk4s, quadrants, pred_mode)])."""
        st = self.header.slice_type
        if st.is_predictive:
            name, n, wh, preds = P_MB_TYPES[mb.mb_type_code]
        else:
            name, n, wh, preds = B_MB_TYPES[mb.mb_type_code]
        parts = []
        for p in range(n):
            if n == 1:
                blks = list(range(16))
                quads = [0, 1, 2, 3]
            elif wh == (16, 8):
                blks = self._PART_BLKS[(2, p)]
                quads = [0, 1] if p == 0 else [2, 3]
            else:
                blks = self._PART_BLKS[(3, p)]
                quads = [0, 2] if p == 0 else [1, 3]
            parts.append((blks[0], blks, quads, preds[p]))
        return parts

    def mb_pred_inter(self, mb: MBState):
        """ref_idx + mvd for 16x16/16x8/8x16 partitions (spec 7.3.5.1)."""
        h = self.header
        parts = self._part_layout(mb)
        field = self.mbaff and mb.field_flag
        for which, nref in ((0, h.num_ref_idx_l0_active_minus1),
                            (1, h.num_ref_idx_l1_active_minus1)):
            if field:
                # 7.3.5.1/7.4.5.2: field MBs in an MBAFF frame see a
                # doubled reference range (ref_idx parsed even when
                # num_ref_idx_active_minus1 == 0)
                nref = 2 * nref + 1
            for anchor, blks, quads, pred in parts:
                uses = pred in ((PRED_L0, PRED_BI) if which == 0
                                else (PRED_L1, PRED_BI))
                if not uses:
                    continue
                v = self.ref_idx(mb, quads[0], which, nref,
                                 int(mb.ref_idx[which][quads[0]])
                                 if self.encoding else None)
                for q in quads:
                    mb.ref_idx[which][q] = v
        for which in (0, 1):
            for anchor, blks, quads, pred in parts:
                uses = pred in ((PRED_L0, PRED_BI) if which == 0
                                else (PRED_L1, PRED_BI))
                if not uses:
                    continue
                for comp in (0, 1):
                    v = self.mvd(mb, anchor, comp, which,
                                 int(mb.mvd[which][anchor][comp])
                                 if self.encoding else None)
                    for blk in blks:
                        mb.mvd[which][blk][comp] = v

    # sub-part -> 4x4 blocks within quadrant (base z = 4*q)
    _SUB_BLKS = {
        (8, 8): [[0, 1, 2, 3]],
        (8, 4): [[0, 1], [2, 3]],
        (4, 8): [[0, 2], [1, 3]],
        (4, 4): [[0], [1], [2], [3]],
    }

    def sub_mb_pred(self, mb: MBState):
        """ref_idx + mvd for 8x8 sub-macroblock partitions (spec 7.3.5.2)."""
        h = self.header
        st = self.header.slice_type
        table = P_SUB_TYPES if st.is_predictive else B_SUB_TYPES
        field = self.mbaff and mb.field_flag
        for which, nref in ((0, h.num_ref_idx_l0_active_minus1),
                            (1, h.num_ref_idx_l1_active_minus1)):
            if field:
                nref = 2 * nref + 1  # 7.4.5.2 doubled field ref range
            for q in range(4):
                name, nparts, wh, pred = table[mb.sub_mb_type[q]]
                uses = pred in ((PRED_L0, PRED_BI) if which == 0
                                else (PRED_L1, PRED_BI))
                if not uses:
                    continue
                v = self.ref_idx(mb, q, which, nref,
                                 int(mb.ref_idx[which][q])
                                 if self.encoding else None)
                mb.ref_idx[which][q] = v
        for which in (0, 1):
            for q in range(4):
                name, nparts, wh, pred = table[mb.sub_mb_type[q]]
                uses = pred in ((PRED_L0, PRED_BI) if which == 0
                                else (PRED_L1, PRED_BI))
                if not uses:
                    continue
                for part in self._SUB_BLKS[wh][:nparts]:
                    anchor = 4 * q + part[0]
                    for comp in (0, 1):
                        v = self.mvd(mb, anchor, comp, which,
                                     int(mb.mvd[which][anchor][comp])
                                     if self.encoding else None)
                        for sub in part:
                            mb.mvd[which][4 * q + sub][comp] = v

    # -- residual -------------------------------------------------------
    def coded_block_flag(self, cat: int, idx: int, val=None) -> int:
        """9.3.3.1.1.9: ctx from neighbor blocks' coded_block_flag.

        4:4:4 categories (6-13) reuse the luma neighbor shapes with the
        Cb/Cr cbf planes (comp 1/2)."""
        cur = self.cur_mb()
        if cat in _CATS_MBDC:
            comp = _CATS_MBDC[cat]
        elif cat in _CATS_BLK4:
            comp = _CATS_BLK4[cat]
        elif cat in _CATS_BLK8:
            comp = _CATS_BLK8[cat]
        elif cat == CAT_CHROMA_DC:
            comp = idx + 1
        elif cat == CAT_CHROMA_AC:
            comp = (idx >> 3) + 1
            idx &= 7
        else:
            raise NotImplementedError(f"cat {cat}")

        if cat in _CATS_MBDC or cat == CAT_CHROMA_DC:
            nb_a, nb_b = self.nb_mb("A"), self.nb_mb("B")
            idx_a = idx_b = 16
        elif cat in _CATS_BLK4:
            nb_a, idx_a = self.nb_blk4("A", idx)
            nb_b, idx_b = self.nb_blk4("B", idx)
        elif cat in _CATS_BLK8:
            nb_a, idx_a = self.nb_blk8("A", idx)
            nb_b, idx_b = self.nb_blk8("B", idx)
            idx_a *= 4
            idx_b *= 4
        else:  # CAT_CHROMA_AC
            nb_a, idx_a = self.nb_blkc("A", idx)
            nb_b, idx_b = self.nb_blkc("B", idx)
        # unavailable neighbors: cbf defaults to 1 for intra MBs, 0 for
        # inter (reference MB_UNAVAILABLE_INTRA/INTER sentinels)
        if cur.kind in (MbKind.P, MbKind.P_8X8, MbKind.P_SKIP, MbKind.B,
                        MbKind.B_8X8, MbKind.B_SKIP, MbKind.B_DIRECT):
            if nb_a is UNAVAIL_INTRA:
                nb_a = UNAVAIL_INTER
            if nb_b is UNAVAIL_INTRA:
                nb_b = UNAVAIL_INTER
        cond_a = int(nb_a.cbf[comp][idx_a])
        cond_b = int(nb_b.cbf[comp][idx_b])
        if cat in _CATS_BLK8:
            # 9.3.3.1.1.9: for 8x8 categories an available non-PCM
            # neighbor coded with the 4x4 transform has no 8x8 transform
            # block -> condTermFlagN = 0 (reference cabac/mod.rs:790-801)
            if nb_a.available and not nb_a.transform8x8 \
                    and nb_a.kind != MbKind.I_PCM:
                cond_a = 0
            if nb_b.available and not nb_b.transform8x8 \
                    and nb_b.kind != MbKind.I_PCM:
                cond_b = 0
        ctx = T.CTX_CODED_BLOCK_FLAG[cat] + cond_a + 2 * cond_b
        out = self._bin(ctx, val)
        # record
        if cat in _CATS_MBDC or cat == CAT_CHROMA_DC:
            cur.cbf[comp][16] = out
        elif cat in _CATS_BLK8:
            # cbf for 8x8 blocks is only *coded* when ChromaArrayType == 3
            # (spec 7.3.5.3.2); covers the block's four 4x4 cbf slots
            cur.cbf[comp][idx * 4:idx * 4 + 4] = out
        else:
            cur.cbf[comp][idx] = out
        return out

    def _sig_ctx(self, cat: int, i: int, last: bool) -> int:
        if cat == CAT_CHROMA_DC:
            inc = min(i // self.chroma_array_type, 2)
        elif cat in _CATS_BLK8:  # luma/Cb/Cr 8x8 (Table 9-43)
            col = 2 if last else self.field_flag
            inc = int(T.SIG_COEFF_8X8[i][col])
        else:
            inc = i
        if last:
            base = (T.CTX_LAST_FIELD if self.field_flag else T.CTX_LAST_FRAME)[cat]
        else:
            base = (T.CTX_SIG_FIELD if self.field_flag else T.CTX_SIG_FRAME)[cat]
        return base + inc

    def _abs_level_ctx(self, cat: int, num1: int, numgt1: int):
        base = T.CTX_ABS_LEVEL[cat]
        c0 = base + (0 if numgt1 != 0 else min(4, 1 + num1))
        clamp = 3 if cat == CAT_CHROMA_DC else 4
        c1 = base + 5 + min(clamp, numgt1)
        return c0, c1

    def residual_block(self, cat: int, idx: int, coeffs: np.ndarray,
                       start: int, end: int, maxnumcoeff: int, coded: bool):
        """One residual block (reference residual_cabac).

        coeffs: scan-order array of length maxnumcoeff (decode: filled;
        encode: read).  `coded`: whether cbp allows coefficients here.

        Field-coded blocks are coded in the alternate scan (8.5.6); the
        stored array stays frame-zigzag-ordered, converted here."""
        fperm = None
        if self.field_flag and cat != CAT_CHROMA_DC:
            fperm = FIELD_PERMS[maxnumcoeff]
        out_view = coeffs
        if fperm is not None and self.encoding:
            coeffs = coeffs[fperm[1]]        # coded (field-scan) order copy
        if coded:
            if maxnumcoeff != 64 or self.chroma_array_type == 3:
                if self.encoding:
                    cbf = 1 if np.any(coeffs[start:end + 1]) else 0
                    self.coded_block_flag(cat, idx, cbf)
                else:
                    cbf = self.coded_block_flag(cat, idx)
            else:
                cbf = 1
                cur = self.cur_mb()
                cur.cbf[0][idx * 4:idx * 4 + 4] = 1
        else:
            cbf = 0
            # record zeros for neighbor ctx
            cur = self.cur_mb()
            if cat in _CATS_MBDC:
                cur.cbf[_CATS_MBDC[cat]][16] = 0
            elif cat in _CATS_BLK4:
                cur.cbf[_CATS_BLK4[cat]][idx] = 0
            elif cat in _CATS_BLK8:
                cur.cbf[_CATS_BLK8[cat]][idx * 4:idx * 4 + 4] = 0
            elif cat == CAT_CHROMA_DC:
                cur.cbf[idx + 1][16] = 0
            else:
                cur.cbf[(idx >> 3) + 1][idx & 7] = 0
        if not cbf:
            if not self.encoding:
                coeffs[:maxnumcoeff] = 0
            return

        if self.encoding:
            sigpos = [i for i in range(start, end + 1) if coeffs[i] != 0]
            assert sigpos, "coded_block_flag=1 requires a nonzero coeff"
            last = sigpos[-1]
            numcoeff = last + 1
            for i in range(start, end + 1):
                if i == end:
                    break  # significance of the final position is inferred
                sig = 1 if coeffs[i] != 0 else 0
                self._bin(self._sig_ctx(cat, i, False), sig)
                if sig:
                    self._bin(self._sig_ctx(cat, i, True), 1 if i == last else 0)
                    if i == last:
                        break
            # reverse-order levels
            num1 = numgt1 = 0
            for i in range(numcoeff - 1, start - 1, -1):
                v = int(coeffs[i])
                if v == 0:
                    continue
                c0, c1 = self._abs_level_ctx(cat, num1, numgt1)
                mag = abs(v) - 1  # coeff_abs_level_minus1
                pre = min(mag, 14)
                for k in range(pre):
                    self._bin(c0 if k == 0 else c1, 1)
                if pre < 14:
                    self._bin(c0 if pre == 0 else c1, 0)
                self.engine.ueg_suffix(mag, 14, 0, False, 0)
                self._bypass(1 if v < 0 else 0)
                if mag != 0:
                    numgt1 += 1
                else:
                    num1 += 1
            return

        # decode
        sig = np.zeros(64, dtype=np.int32)
        numcoeff = end + 1
        i = start
        while i < numcoeff - 1:
            if self._bin(self._sig_ctx(cat, i, False)):
                sig[i] = 1
                if self._bin(self._sig_ctx(cat, i, True)):
                    numcoeff = i + 1
            i += 1
        sig[numcoeff - 1] = 1
        coeffs[:maxnumcoeff] = 0
        num1 = numgt1 = 0
        for i in range(numcoeff - 1, start - 1, -1):
            if not sig[i]:
                continue
            c0, c1 = self._abs_level_ctx(cat, num1, numgt1)
            pre = 0
            while pre < 14 and self._bin(c0 if pre == 0 else c1):
                pre += 1
            mag = self.engine.ueg_suffix(pre, 14, 0, False)
            s = self._bypass()
            coeffs[i] = -(mag + 1) if s else mag + 1
            if mag != 0:
                numgt1 += 1
            else:
                num1 += 1
        if fperm is not None:
            out_view[:maxnumcoeff] = coeffs[fperm[0]]

    def residual(self, mb: MBState):
        """Residual for one MB (reference residual/residual_luma)."""
        # luma
        if mb.kind == MbKind.I_16X16:
            self.residual_block(CAT_LUMA_DC, 0, mb.luma_dc, 0, 15, 16, True)
            for i in range(16):
                coded = bool((mb.cbp >> (i >> 2)) & 1)
                self.residual_block(CAT_LUMA_AC, i, mb.luma4[i], 0, 14, 15, coded)
        elif mb.transform8x8:
            mb.cbf[0][16] = 0
            for i in range(4):
                coded = bool((mb.cbp >> i) & 1)
                self.residual_block(CAT_LUMA_8X8, i, mb.luma8[i], 0, 63, 64, coded)
        else:
            mb.cbf[0][16] = 0
            for i in range(16):
                coded = bool((mb.cbp >> (i >> 2)) & 1)
                self.residual_block(CAT_LUMA_4X4, i, mb.luma4[i], 0, 15, 16, coded)
        # chroma (4:2:0 / 4:2:2)
        if self.chroma_array_type in (1, 2):
            nc = 4 * self.chroma_array_type
            for c in range(2):
                self.residual_block(CAT_CHROMA_DC, c, mb.chroma_dc[c],
                                    0, nc - 1, nc, bool(mb.cbp & 0x30))
            for c in range(2):
                for j in range(nc):
                    self.residual_block(CAT_CHROMA_AC, c * 8 + j,
                                        mb.chroma_ac[c][j], 0, 14, 15,
                                        bool(mb.cbp & 0x20))
        elif self.chroma_array_type == 3:
            # 7.3.5.3.1: Cb then Cr ride the residual_luma process with
            # their own context categories and the SAME CodedBlockPatternLuma
            # bits (reference cabac/mod.rs:433-467 routes these but its
            # recon todo!()s 4:4:4; we decode AND reconstruct)
            mb.alloc_444()
            for ci, (cat_dc, cat_ac, cat_44, cat_88) in enumerate(
                    ((CAT_CB_DC, CAT_CB_AC, CAT_CB_4X4, CAT_CB_8X8),
                     (CAT_CR_DC, CAT_CR_AC, CAT_CR_4X4, CAT_CR_8X8))):
                if mb.kind == MbKind.I_16X16:
                    self.residual_block(cat_dc, 0, mb.cbcr_dc[ci], 0, 15,
                                        16, True)
                    for i in range(16):
                        coded = bool((mb.cbp >> (i >> 2)) & 1)
                        self.residual_block(cat_ac, i, mb.cbcr4[ci][i],
                                            0, 14, 15, coded)
                elif mb.transform8x8:
                    mb.cbf[1 + ci][16] = 0
                    for i in range(4):
                        coded = bool((mb.cbp >> i) & 1)
                        self.residual_block(cat_88, i, mb.cbcr8[ci][i],
                                            0, 63, 64, coded)
                else:
                    mb.cbf[1 + ci][16] = 0
                    for i in range(16):
                        coded = bool((mb.cbp >> (i >> 2)) & 1)
                        self.residual_block(cat_44, i, mb.cbcr4[ci][i],
                                            0, 15, 16, coded)

    # -- macroblock layer ----------------------------------------------
    def macroblock_layer(self, mb: MBState):
        """Decode/encode one MB (reference macroblock_layer, mod.rs:89-210)."""
        sps, pps = self.sps, self.pps
        st = self.header.slice_type
        mb.slice_id = self.slice_id
        self.mbs[self.curr] = mb
        if self.mbaff:
            # field MBs select the field coefficient scan and the field
            # column of the significance maps (Table 9-43)
            self.field_flag = mb.field_flag
        if st.is_intra:
            if st == SliceType.SI:
                self.mb_type_si(mb)
            else:
                self.mb_type_i(mb)
        elif st.is_predictive:
            self.mb_type_p(mb)
        else:
            self.mb_type_b(mb)

        if mb.kind == MbKind.I_PCM:
            self._pcm(mb)
        else:
            intra = mb.kind in (MbKind.I_NXN, MbKind.I_16X16, MbKind.SI)
            no_small_parts = True
            if mb.kind in (MbKind.P_8X8, MbKind.B_8X8):
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
                if not intra and (mb.cbp & 0x0F) and \
                        pps.transform_8x8_mode_flag and no_small_parts and \
                        (mb.kind != MbKind.B_DIRECT or
                         sps.direct_8x8_inference_flag):
                    self.transform_size_8x8_flag(mb)
            if mb.cbp != 0 or mb.kind == MbKind.I_16X16:
                self.mb_qp_delta(mb)
            else:
                mb.qp_delta = 0
            self.residual(mb)

        # QP chain (reference mod.rs:186-193)
        off = self.qp_bd_offset_y
        mb.qp_y = ((self.qpy_prev + mb.qp_delta + 52 + 2 * off) % (52 + off)) - off
        self.qpy_prev = mb.qp_y
        mb.qs_y = self.qsy
        # propagate resolved 8x8 modes into 4x4 slots for neighbor prediction
        if mb.kind == MbKind.I_NXN and mb.transform8x8:
            mb.intra4x4_modes[:] = np.repeat(mb.intra8x8_modes, 4)

    def _pcm(self, mb: MBState):
        eng = self.engine
        bd_l = self.sps.bit_depth_luma_minus8 + 8
        bd_c = self.sps.bit_depth_chroma_minus8 + 8
        n_chroma = 64 << self.chroma_array_type if self.chroma_array_type else 0
        if self.encoding:
            # pcm_alignment_zero_bit + raw samples + engine re-init (9.3.1.2)
            eng.byte_align()
            for v in mb.pcm_luma:
                eng.write_raw(int(v), bd_l)
            if n_chroma:
                for v in mb.pcm_chroma.reshape(-1):
                    eng.write_raw(int(v), bd_c)
            eng.reinit_engine()
        else:
            eng.byte_align()  # skip pcm_alignment_zero_bit
            mb.pcm_luma = np.array([eng._read_bits(bd_l) for _ in range(256)],
                                   dtype=np.int32)
            if n_chroma:
                mb.pcm_chroma = np.array(
                    [eng._read_bits(bd_c) for _ in range(n_chroma)],
                    dtype=np.int32).reshape(2, -1)
            eng.reinit_engine()
        mb.qp_delta = 0
        mb.transform8x8 = 0
        mb.cbp = 0x2F
        mb.chroma_mode = 0
        mb.cbf[:] = 1
        mb.intra4x4_modes[:] = 2
        mb.intra8x8_modes[:] = 2

    def _skip_mb(self, mb: MBState):
        """Inferred state for P_Skip/B_Skip (reference infer_skip)."""
        st = self.header.slice_type
        mb.kind = MbKind.P_SKIP if st.is_predictive else MbKind.B_SKIP
        mb.slice_id = self.slice_id
        mb.cbp = 0
        mb.qp_delta = 0
        mb.qp_y = self.qpy_prev
        self.mbs[self.curr] = mb

    def _next_addr(self, sgmap):
        if sgmap is None:
            return self.curr + 1
        from ..avc.slice_map import next_mb_addr
        return next_mb_addr(sgmap, self.curr)

    # -- slice loop ------------------------------------------------------
    def mb_field_decoding_flag(self, mb: MBState, val=None) -> int:
        """9.3.3.1.1.2: ctx from left/above pair field flags (reference
        cabac/mod.rs:1105-1111)."""
        a = self.nb_mb("A")
        b = self.nb_mb("B")
        inc = (a.field_flag if a.available else 0) + \
              (b.field_flag if b.available else 0)
        return self._bin(T.CTX_MB_FIELD_DECODING_FLAG + inc, val)

    def _inferred_field_flag(self) -> int:
        """Field flag of an all-skipped pair (reference
        slice/mod.rs:328-342): left pair's, else above pair's, else 0."""
        a = self.nb_mb("A")
        if a.available:
            return a.field_flag
        b = self.nb_mb("B")
        return b.field_flag if b.available else 0

    def decode_slice_data(self, sgmap=None):
        """Slice decode loop (reference Slice::data, slice/mod.rs:199-254).

        sgmap: FMO slice-group map (next_mb_addr iteration) or None.
        Under MBAFF (spec 7.3.4) MBs decode in vertical pairs:
        mb_field_decoding_flag before the first non-skipped MB of each
        pair, end_of_slice_flag only after the bottom MB."""
        assert not self.encoding
        st = self.header.slice_type
        n_mbs = self.mb_w * self.mb_h
        if sgmap is not None and self.mbaff:
            raise NotImplementedError("FMO + MBAFF")
        pair_field = 0
        prev_skipped = False
        while True:
            mb = MBState.fresh()
            bot = self.curr & 1
            skipped = (not st.is_intra) and self.mb_skip_flag(mb)
            if skipped:
                if self.mbaff and bot:
                    if prev_skipped:  # both skipped: infer the pair flag
                        pair_field = self._inferred_field_flag()
                        self.mbs[self.curr - 1].field_flag = pair_field
                    mb.field_flag = pair_field
                self._skip_mb(mb)
            else:
                if self.mbaff and (not bot or prev_skipped):
                    pair_field = self.mb_field_decoding_flag(mb)
                    if bot:  # top was skipped: back-fill its flag
                        self.mbs[self.curr - 1].field_flag = pair_field
                if self.mbaff:
                    mb.field_flag = pair_field
                self.macroblock_layer(mb)
            self.prev_addr = self.curr
            if self.mbaff and not bot:
                prev_skipped = skipped
                self.curr += 1
                continue
            prev_skipped = False
            end = self._terminate()
            nxt = self._next_addr(sgmap)
            if end or nxt >= n_mbs:
                break
            self.curr = nxt
        return self.curr

    def encode_slice_data(self, mb_list, sgmap=None):
        """Encode MBs [first_mb..] from pre-filled MBState records."""
        assert self.encoding
        st = self.header.slice_type
        for k, mb in enumerate(mb_list):
            if not st.is_intra:
                skip = mb.kind in (MbKind.P_SKIP, MbKind.B_SKIP)
                self.mb_skip_flag(mb, 1 if skip else 0)
                if skip:
                    self._skip_mb(mb)
                else:
                    self.macroblock_layer(mb)
            else:
                self.macroblock_layer(mb)
            self.prev_addr = self.curr
            last = k + 1 == len(mb_list)
            self._terminate(1 if last else 0)
            if not last:
                self.curr = self._next_addr(sgmap)
