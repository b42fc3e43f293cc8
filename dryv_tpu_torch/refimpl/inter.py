# Copy of dryv_tpu/refimpl/inter.py.
"""Inter prediction, scalar reference (spec 8.4).

The upstream reference decoder cannot reconstruct inter at all
(frame/mod.rs:88 todo!("Inter prediction")); this module implements the
P- and B-slice pixel path:
- block-granular motion-vector prediction (8.4.1.3): median with the
  one-match rule, 16x8/8x16 directional rules, P_Skip inference
- B spatial direct mode (8.4.1.2.2) incl. colZeroFlag with
  direct_8x8_inference, B_Skip / B_Direct_16x16 / B_Direct_8x8
- default bi-prediction combine (8.4.2.3.1)
- quarter-pel luma interpolation (8.4.2.2.1: 6-tap half-pel + averaging)
- eighth-pel bilinear chroma interpolation (8.4.2.2.2)
- motion compensation for 16x16/16x8/8x16/8x8(+sub) partitions
"""
from __future__ import annotations

import numpy as np

from ..cabac.syntax import (MBState, MbKind, B_MB_TYPES, B_SUB_TYPES,
                            P_MB_TYPES, P_SUB_TYPES, PRED_DIRECT,
                            PRED_L0, PRED_L1)
from ..avc.neighbors import ZSCAN_4X4_POS


class MotionState:
    """Per-picture motion field at 4x4-block granularity, both lists.

    mv/ref are list 0 (P compatibility); mv1/ref1 list 1.  mv in
    quarter-pel units; ref -1 = intra / list unused / not decoded."""

    def __init__(self, mb_w: int, mb_h: int):
        self.mb_w = mb_w
        self.mb_h = mb_h
        self.mv = np.zeros((mb_h * 4, mb_w * 4, 2), dtype=np.int64)
        self.ref = np.full((mb_h * 4, mb_w * 4), -1, dtype=np.int64)
        self.mv1 = np.zeros((mb_h * 4, mb_w * 4, 2), dtype=np.int64)
        self.ref1 = np.full((mb_h * 4, mb_w * 4), -1, dtype=np.int64)
        self.decoded = np.zeros((mb_h * 4, mb_w * 4), dtype=bool)
        # slice id per 4x4 block: a neighbor in a different slice is
        # unavailable for MV prediction (6.4.8).  cur_sid None disables
        # the check (colocated-picture reads: the whole ref pic is
        # decoded and slice structure no longer matters).
        self.sid = np.full((mb_h * 4, mb_w * 4), -2, dtype=np.int32)
        self.cur_sid = None

    def blk(self, bx: int, by: int, which: int = 0):
        """Returns (available, mv, ref) for 4x4 block coords in list
        `which`."""
        if bx < 0 or by < 0 or bx >= self.mb_w * 4 or by >= self.mb_h * 4:
            return False, np.zeros(2, np.int64), -1
        if not self.decoded[by, bx]:
            return False, np.zeros(2, np.int64), -1
        if self.cur_sid is not None and self.sid[by, bx] != self.cur_sid:
            return False, np.zeros(2, np.int64), -1
        if which:
            return True, self.mv1[by, bx], self.ref1[by, bx]
        return True, self.mv[by, bx], self.ref[by, bx]

    def set_mb_intra(self, addr: int, sid: int = -2):
        mx, my = addr % self.mb_w, addr // self.mb_w
        self.decoded[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
        self.ref[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
        self.ref1[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
        self.sid[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = sid

    def set_part(self, bx0, by0, w4, h4, mv, ref, which: int = 0):
        self.decoded[by0:by0 + h4, bx0:bx0 + w4] = True
        if self.cur_sid is not None:
            self.sid[by0:by0 + h4, bx0:bx0 + w4] = self.cur_sid
        if which:
            self.ref1[by0:by0 + h4, bx0:bx0 + w4] = ref
            self.mv1[by0:by0 + h4, bx0:bx0 + w4] = mv
        else:
            self.ref[by0:by0 + h4, bx0:bx0 + w4] = ref
            self.mv[by0:by0 + h4, bx0:bx0 + w4] = mv

    def clone(self) -> "MotionState":
        c = MotionState(self.mb_w, self.mb_h)
        c.mv = self.mv.copy()
        c.ref = self.ref.copy()
        c.mv1 = self.mv1.copy()
        c.ref1 = self.ref1.copy()
        c.decoded = self.decoded.copy()
        c.sid = self.sid.copy()
        return c


def _neighbors(ms: MotionState, bx0, by0, w4, which: int = 0):
    """A/B/C(/D fallback) neighbor (avail, mv, ref) for a partition whose
    top-left 4x4 block is (bx0, by0) and width w4 blocks (spec 6.4.11.7)."""
    a = ms.blk(bx0 - 1, by0, which)
    b = ms.blk(bx0, by0 - 1, which)
    c = ms.blk(bx0 + w4, by0 - 1, which)
    if not c[0]:
        c = ms.blk(bx0 - 1, by0 - 1, which)  # D fallback
    return a, b, c


def _median_pred(ms: MotionState, bx0, by0, w4, ref_idx, which: int = 0):
    """spec 8.4.1.3.1 (general case).

    Intra neighbors contribute mv (0,0) / ref -1 (never a ref match)."""
    a, b, c = _neighbors(ms, bx0, by0, w4, which)
    av_a, mv_a, ref_a = a
    av_b, mv_b, ref_b = b
    av_c, mv_c, ref_c = c
    # If B, C and D are all unavailable and A is available -> mvp = mvA
    if not av_b and not av_c and av_a:
        return mv_a.copy()
    matches = [(mv_a, ref_a == ref_idx and av_a),
               (mv_b, ref_b == ref_idx and av_b),
               (mv_c, ref_c == ref_idx and av_c)]
    hit = [mv for mv, m in matches if m]
    if len(hit) == 1:
        return hit[0].copy()
    return np.median(np.stack([mv_a, mv_b, mv_c]), axis=0).astype(np.int64)


def mv_pred(ms: MotionState, mb_part, bx0, by0, w4, h4, ref_idx, part_idx,
            which: int = 0):
    """MV predictor incl. 16x8/8x16 directional rules (8.4.1.3)."""
    if mb_part == (16, 8):
        a, b, c = _neighbors(ms, bx0, by0, w4, which)
        if part_idx == 0:
            if b[0] and b[2] == ref_idx:
                return b[1].copy()
        else:
            if a[0] and a[2] == ref_idx:
                return a[1].copy()
    elif mb_part == (8, 16):
        a, b, c = _neighbors(ms, bx0, by0, w4, which)
        if part_idx == 0:
            if a[0] and a[2] == ref_idx:
                return a[1].copy()
        else:
            if c[0] and c[2] == ref_idx:
                return c[1].copy()
    return _median_pred(ms, bx0, by0, w4, ref_idx, which)


def mv_skip(ms: MotionState, addr: int) -> np.ndarray:
    """P_Skip motion vector (spec 8.4.1.1)."""
    mb_w = ms.mb_w
    mx, my = addr % mb_w, addr // mb_w
    bx0, by0 = mx * 4, my * 4
    a = ms.blk(bx0 - 1, by0)
    b = ms.blk(bx0, by0 - 1)
    a_mb_avail = mx > 0
    b_mb_avail = my > 0
    if not a_mb_avail or not b_mb_avail:
        return np.zeros(2, np.int64)
    if a[0] and a[2] == 0 and a[1][0] == 0 and a[1][1] == 0:
        return np.zeros(2, np.int64)
    if b[0] and b[2] == 0 and b[1][0] == 0 and b[1][1] == 0:
        return np.zeros(2, np.int64)
    return _median_pred(ms, bx0, by0, 4, 0)


class ExplicitWP:
    """Explicit weighted prediction (8.4.2.3.2): per-ref luma/chroma
    weights+offsets from the slice header's pred_weight_table."""

    def __init__(self, pwt):
        self.pwt = pwt

    def luma(self, which, ridx):
        t = self.pwt
        lst = t.luma_l0 if which == 0 else t.luma_l1
        d = t.luma_log2_weight_denom
        e = lst[ridx] if ridx < len(lst) else None
        return (d, e.weight, e.offset) if e is not None else (d, 1 << d, 0)

    def chroma(self, which, ridx, c):
        t = self.pwt
        lst = t.chroma_l0 if which == 0 else t.chroma_l1
        d = t.chroma_log2_weight_denom
        e = lst[ridx] if ridx < len(lst) else None
        if e is None:
            return d, 1 << d, 0
        return d, e[c].weight, e[c].offset


class ImplicitWP:
    """Implicit weighted bi-prediction (weighted_bipred_idc == 2):
    POC-distance derived w0/w1, logWD 5, zero offsets (8.4.2.3.2)."""

    def __init__(self, poc_cur, pocs0, pocs1, lt0, lt1):
        self.poc_cur = poc_cur
        self.pocs0, self.pocs1 = pocs0, pocs1
        self.lt0, self.lt1 = lt0, lt1

    def biweights(self, r0, r1):
        poc0, poc1 = self.pocs0[r0], self.pocs1[r1]
        if self.lt0[r0] or self.lt1[r1] or poc0 == poc1:
            return 32, 32
        td = int(np.clip(poc1 - poc0, -128, 127))
        if td == 0:
            return 32, 32
        tb = int(np.clip(self.poc_cur - poc0, -128, 127))
        tx = (16384 + (abs(td) >> 1)) // td
        dsf = int(np.clip((tb * tx + 32) >> 6, -1024, 1023))
        w1 = dsf >> 2
        if w1 < -64 or w1 > 128:
            return 32, 32
        return 64 - w1, w1


def _wp_single(p, d, w, o):
    if d >= 1:
        return np.clip(((p * w + (1 << (d - 1))) >> d) + o, 0, 255)
    return np.clip(p * w + o, 0, 255)


def _wp_bi(p0, p1, d, w0, o0, w1, o1):
    return np.clip(((p0 * w0 + p1 * w1 + (1 << d)) >> (d + 1))
                   + ((o0 + o1 + 1) >> 1), 0, 255)


class DirectCtx:
    """Context for B spatial direct derivation (8.4.1.2.2).

    col_ms: MotionState of ref_list1[0] (the co-located picture);
    col_shortterm: that picture is marked short-term reference."""

    def __init__(self, col_ms: "MotionState", col_shortterm: bool):
        self.col_ms = col_ms
        self.col_shortterm = col_shortterm


class TemporalDirectCtx:
    """Context for B temporal direct derivation (8.4.1.2.3).

    col_ms: motion of ref_list1[0]; col_map0/col_map1 map its per-list
    ref indices to picture keys; list0_keys: picture key per current
    list-0 index; poc_by_key / longterm_by_key: POC + marking per key;
    poc_cur / poc_pic1: POC of the current picture and of ref_list1[0]."""

    def __init__(self, col_ms, col_map0, col_map1, list0_keys, poc_by_key,
                 longterm_by_key, poc_cur, poc_pic1, cur_parity=None):
        self.col_ms = col_ms
        self.col_map0, self.col_map1 = col_map0, col_map1
        self.list0_keys = list(list0_keys)
        self.poc_by_key = poc_by_key
        self.longterm_by_key = longterm_by_key
        self.poc_cur, self.poc_pic1 = poc_cur, poc_pic1
        # field decoding (8.4.1.2.3): keys are (frame_idx, parity) and
        # refIdxL0 selects the co-located reference FRAME's field with
        # the CURRENT field's parity
        self.cur_parity = cur_parity


def _min_positive(a: int, b: int) -> int:
    if a >= 0 and b >= 0:
        return min(a, b)
    return max(a, b)


def spatial_direct_mb(ms: MotionState, addr: int, ctx: DirectCtx):
    """B spatial direct derivation for a whole MB (spec 8.4.1.2.2 with
    direct_8x8_inference_flag = 1).

    Returns (ref0, ref1, mv0, mv1, zero_quad[4]): reference indices
    (>= 0; directZeroPrediction maps to 0/0 with zero mvs), the MB-level
    predicted mvs per list, and per-quadrant colZeroFlag."""
    mb_w = ms.mb_w
    mx, my = addr % mb_w, addr // mb_w
    bx0, by0 = mx * 4, my * 4
    refs = []
    for which in (0, 1):
        a, b, c = _neighbors(ms, bx0, by0, 4, which)
        r = _min_positive(_min_positive(a[2] if a[0] else -1,
                                        b[2] if b[0] else -1),
                          c[2] if c[0] else -1)
        refs.append(int(r))
    ref0, ref1 = refs
    if ref0 < 0 and ref1 < 0:  # directZeroPredictionFlag
        zero = np.zeros(2, np.int64)
        return 0, 0, zero, zero.copy(), [True] * 4
    mv0 = (_median_pred(ms, bx0, by0, 4, ref0, 0) if ref0 >= 0
           else np.zeros(2, np.int64))
    mv1 = (_median_pred(ms, bx0, by0, 4, ref1, 1) if ref1 >= 0
           else np.zeros(2, np.int64))
    # colZeroFlag per 8x8 quadrant, co-located sampled at the quadrant's
    # outer-corner 4x4 block (direct_8x8_inference)
    zero_quad = [False] * 4
    if ctx is not None and ctx.col_shortterm:
        corners = [(0, 0), (3, 0), (0, 3), (3, 3)]
        for q, (cx, cy) in enumerate(corners):
            cav0, cmv, cref = ctx.col_ms.blk(bx0 + cx, by0 + cy, 0)
            if not cav0 or cref < 0:  # col block did not use L0
                cav1, cmv, cref = ctx.col_ms.blk(bx0 + cx, by0 + cy, 1)
                if not cav1 or cref < 0:
                    continue  # intra co-located: colZeroFlag stays 0
            zero_quad[q] = (cref == 0 and abs(int(cmv[0])) <= 1
                            and abs(int(cmv[1])) <= 1)
    return ref0, ref1, mv0, mv1, zero_quad


def derive_direct(ms: MotionState, addr: int, ctx):
    """Direct-mode motion for each 8x8 quadrant of a MB: returns
    [(ref0, ref1, mv0, mv1)] * 4 (ref < 0 = list unused).

    Dispatches on ctx type: DirectCtx -> spatial (8.4.1.2.2),
    TemporalDirectCtx -> temporal (8.4.1.2.3)."""
    if isinstance(ctx, TemporalDirectCtx):
        return _temporal_direct(ms, addr, ctx)
    r0, r1, m0, m1, zq = spatial_direct_mb(ms, addr, ctx)
    quads = []
    zero = np.zeros(2, np.int64)
    for q in range(4):
        mv0 = zero if (zq[q] and r0 == 0) else m0
        mv1 = zero if (zq[q] and r1 == 0) else m1
        quads.append((r0, r1, mv0, mv1))
    return quads


def _temporal_direct(ms: MotionState, addr: int, ctx: TemporalDirectCtx):
    """Temporal direct (8.4.1.2.3, direct_8x8_inference): co-located
    motion POC-scaled; always bi-predictive with refIdxL1 = 0."""
    mb_w = ms.mb_w
    mx, my = addr % mb_w, addr // mb_w
    bx0, by0 = mx * 4, my * 4
    corners = [(0, 0), (3, 0), (0, 3), (3, 3)]
    quads = []
    zero = np.zeros(2, np.int64)
    for q, (cx, cy) in enumerate(corners):
        av, cmv, cref = ctx.col_ms.blk(bx0 + cx, by0 + cy, 0)
        cmap = ctx.col_map0
        if not av or cref < 0:
            av1, cmv, cref = ctx.col_ms.blk(bx0 + cx, by0 + cy, 1)
            if av1 and cref >= 0:
                cmap = ctx.col_map1
            else:
                # intra co-located: mvCol = 0, refIdxCol = 0
                cmv, cref, cmap = zero, 0, ctx.col_map0
        ref_key = cmap[int(cref)]
        if ctx.cur_parity is not None:
            # map to the same FRAME's field with the current parity
            same = (ref_key[0], ctx.cur_parity)
            if same in ctx.list0_keys:
                ref_key = same
        try:
            ref0 = ctx.list0_keys.index(ref_key)
        except ValueError:
            # Spec 8.4.1.2.3 presumes refPicCol is reachable through the
            # current list 0; a stream where it is not is non-conformant
            # (the encoder must not choose temporal direct there).
            # libavcodec's fill_colmap maps such references to index 0
            # (h264_direct.c), so mirror the oracle instead of failing.
            ref0 = 0
            ref_key = ctx.list0_keys[0]
        poc0 = ctx.poc_by_key[ref_key]
        cmv = np.asarray(cmv, np.int64)
        if ctx.longterm_by_key.get(ref_key) or ctx.poc_pic1 == poc0:
            mv0, mv1 = cmv, zero
        else:
            td = int(np.clip(ctx.poc_pic1 - poc0, -128, 127))
            tb = int(np.clip(ctx.poc_cur - poc0, -128, 127))
            tx = (16384 + (abs(td) >> 1)) // td
            dsf = int(np.clip((tb * tx + 32) >> 6, -1024, 1023))
            mv0 = (dsf * cmv + 128) >> 8
            mv1 = mv0 - cmv
        quads.append((ref0, 0, mv0, mv1))
    return quads


# ---------------------------------------------------------------------------
# interpolation (spec 8.4.2.2)
# ---------------------------------------------------------------------------

def _clip_idx(i, n):
    return np.clip(i, 0, n - 1)


def luma_interp(plane: np.ndarray, x0: int, y0: int, w: int, h: int,
                mvx: int, mvy: int) -> np.ndarray:
    """Quarter-pel luma MC (8.4.2.2.1) with edge clamping.

    plane int64 [H,W]; (x0,y0) block origin; mv in quarter-pel units."""
    H, W = plane.shape
    ix, iy = mvx >> 2, mvy >> 2
    fx, fy = mvx & 3, mvy & 3
    bx, by = x0 + ix, y0 + iy

    # padded integer-sample window (+2/-3 taps each side)
    ys = _clip_idx(np.arange(by - 2, by + h + 3), H)
    xs = _clip_idx(np.arange(bx - 2, bx + w + 3), W)
    win = plane[np.ix_(ys, xs)].astype(np.int64)  # [h+5, w+5]

    if fx == 0 and fy == 0:
        return win[2:2 + h, 2:2 + w]

    def tap6(v0, v1, v2, v3, v4, v5):
        return v0 - 5 * v1 + 20 * v2 + 20 * v3 - 5 * v4 + v5

    # half-pel horizontally at integer rows: b1 (unclipped), full width
    bmat = tap6(win[:, 0:w + 0], win[:, 1:w + 1], win[:, 2:w + 2],
                win[:, 3:w + 3], win[:, 4:w + 4], win[:, 5:w + 5])
    b = (bmat + 16) >> 5  # [h+5, w]
    # half-pel vertically at integer cols: h1
    hmat = tap6(win[0:h + 0, :], win[1:h + 1, :], win[2:h + 2, :],
                win[3:h + 3, :], win[4:h + 4, :], win[5:h + 5, :])
    hh = (hmat + 16) >> 5  # [h, w+5]
    # center half-pel j: 6-tap vertically over unclipped b-values
    jmat = tap6(bmat[0:h + 0, :], bmat[1:h + 1, :], bmat[2:h + 2, :],
                bmat[3:h + 3, :], bmat[4:h + 4, :], bmat[5:h + 5, :])
    j = (jmat + 512) >> 10  # [h, w]

    G = win[2:2 + h, 2:2 + w]             # integer sample at (0,0)
    Hs = win[2:2 + h, 3:3 + w]            # integer right neighbor
    M = win[3:3 + h, 2:2 + w]             # integer below
    bC = np.clip(b[2:2 + h, :], 0, 255)   # half-pel right (aligned at x+1/2)
    bD = np.clip(b[3:3 + h, :], 0, 255)   # b one row below
    hC = np.clip(hh[:, 2:2 + w], 0, 255)  # half-pel below
    hE = np.clip(hh[:, 3:3 + w], 0, 255)  # h one col right
    jC = np.clip(j, 0, 255)

    def avg(p, q):
        return (p + q + 1) >> 1

    # Table 8-12 quarter-pel sample derivation
    if fy == 0:
        if fx == 1:
            return avg(G, bC)
        if fx == 2:
            return bC
        return avg(bC, Hs)                        # fx == 3
    if fx == 0:
        if fy == 1:
            return avg(G, hC)
        if fy == 2:
            return hC
        return avg(hC, M)                          # fy == 3
    if fx == 2 and fy == 2:
        return jC
    if fx == 2:
        if fy == 1:
            return avg(bC, jC)
        return avg(jC, bD)                         # fy == 3
    if fy == 2:
        if fx == 1:
            return avg(hC, jC)
        return avg(jC, hE)                         # fx == 3
    # diagonal quarter positions: average of nearest half-pels
    bsel = bC if fy == 1 else bD
    hsel = hC if fx == 1 else hE
    return avg(bsel, hsel)


def chroma_interp(plane: np.ndarray, cx0: int, cy0: int, w: int, h: int,
                  mvx: int, mvy: int, suby: int = 2) -> np.ndarray:
    """Eighth-pel bilinear chroma MC (8.4.2.2.2); mv in luma quarter-pel
    units.  suby = vertical chroma subsample factor: 2 for 4:2:0 (eighth
    fractions both axes), 1 for 4:2:2 (vertical stays quarter-pel,
    fraction doubled to eighths per 8.4.2.2.1)."""
    H, W = plane.shape
    ix, fx = mvx >> 3, mvx & 7
    if suby == 2:
        iy, fy = mvy >> 3, mvy & 7
    else:
        iy, fy = mvy >> 2, (mvy & 3) << 1
    bx, by = cx0 + ix, cy0 + iy
    ys = _clip_idx(np.arange(by, by + h + 1), H)
    xs = _clip_idx(np.arange(bx, bx + w + 1), W)
    win = plane[np.ix_(ys, xs)].astype(np.int64)
    A = win[0:h, 0:w]
    B = win[0:h, 1:w + 1]
    C = win[1:h + 1, 0:w]
    D = win[1:h + 1, 1:w + 1]
    return ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
            (8 - fx) * fy * C + fx * fy * D + 32) >> 6


# ---------------------------------------------------------------------------
# macroblock reconstruction
# ---------------------------------------------------------------------------

def _partitions(mb: MBState):
    """Yields (bx_off4, by_off4, w4, h4, pred_mode, quad, anchor_blk,
    shape, part_idx) in coding order for P and B partition sets.

    pred_mode is PRED_L0/L1/BI/DIRECT; `quad` indexes ref_idx, `anchor_blk`
    indexes mvd (z-scan 4x4)."""
    if mb.kind in (MbKind.P, MbKind.B):
        table = P_MB_TYPES if mb.kind == MbKind.P else B_MB_TYPES
        name, n, wh, preds = table[mb.mb_type_code]
        if n == 1:
            yield (0, 0, 4, 4, preds[0], 0, 0, (16, 16), 0)
        elif wh == (16, 8):
            for p in range(2):
                yield (0, p * 2, 4, 2, preds[p], p * 2, [0, 8][p],
                       (16, 8), p)
        else:
            for p in range(2):
                yield (p * 2, 0, 2, 4, preds[p], p, [0, 4][p], (8, 16), p)
    elif mb.kind in (MbKind.P_8X8, MbKind.B_8X8):
        table = P_SUB_TYPES if mb.kind == MbKind.P_8X8 else B_SUB_TYPES
        for q in range(4):
            qx, qy = (q & 1) * 2, (q >> 1) * 2
            name, nparts, wh, pred = table[mb.sub_mb_type[q]]
            if pred == PRED_DIRECT:
                yield (qx, qy, 2, 2, PRED_DIRECT, q, 4 * q, (8, 8), q)
            elif wh == (8, 8):
                yield (qx, qy, 2, 2, pred, q, 4 * q, (8, 8), q)
            elif wh == (8, 4):
                for p in range(2):
                    anchor = 4 * q + [0, 2][p]
                    yield (qx, qy + p, 2, 1, pred, q, anchor, (8, 4), q)
            elif wh == (4, 8):
                for p in range(2):
                    anchor = 4 * q + [0, 1][p]
                    yield (qx + p, qy, 1, 2, pred, q, anchor, (4, 8), q)
            else:
                for p in range(4):
                    anchor = 4 * q + p
                    sx, sy = p & 1, p >> 1
                    yield (qx + sx, qy + sy, 1, 1, pred, q, anchor,
                           (4, 4), q)
    else:
        raise NotImplementedError(f"partitions for kind {mb.kind}")


def recon_inter_mb(recon, mb: MBState, addr: int, slice_id: int,
                   ms: MotionState, ref_y, ref_cb, ref_cr, ref_list=None,
                   ref_list1=None, direct_ctx: DirectCtx = None, wp=None,
                   cvoff=None):
    """Reconstruct a P/B inter MB (skip / direct / 16x16 / 16x8 / 8x16 /
    8x8 sub-partitions; L0 / L1 / bi-predictive) with quarter-pel MC.

    ref_y/cb/cr: reference list 0 entry 0 planes; ref_list/ref_list1:
    lists of (y, cb, cr) tuples; direct_ctx: co-located motion for B
    spatial direct; wp: ExplicitWP / ImplicitWP weighted prediction;
    cvoff: optional (per_l0, per_l1) vertical chroma MV offsets per ref
    index in quarter luma samples — the 8.4.1.4 +/-2 adjustment for
    opposite-parity field references in field pictures."""
    from .transform import dequant_idct_4x4, dequant_idct_8x8, \
        idct_chroma_dc, qpc_from_qpy
    from .recon import dezigzag4, dezigzag8

    mb_w = recon.mb_w
    ms.cur_sid = slice_id  # MV-pred neighbors stop at slice boundaries
    mx, my = addr % mb_w, addr // mb_w
    x0, y0 = mx * 16, my * 16
    bx0, by0 = mx * 4, my * 4
    maxv = (1 << recon.bitdepth) - 1
    qpy = mb.qp_y

    cat = recon.chroma_array_type  # 0 mono, 1 420, 2 422, 3 444
    suby = 2 if cat == 1 else 1
    subx = 1 if cat == 3 else 2
    chh = 16 if cat == 3 else 8 * cat
    cw = 16 if cat == 3 else 8
    pred_y = np.zeros((16, 16), dtype=np.int64)
    pred_cb = np.zeros((chh, cw), dtype=np.int64) if cat else None
    pred_cr = np.zeros((chh, cw), dtype=np.int64) if cat else None
    lists = (ref_list if ref_list is not None
             else [(ref_y, ref_cb, ref_cr)], ref_list1)

    def mc_part(ox4, oy4, w4, h4, used):
        """Motion-compensate one partition; `used` = [(which, mv, ref_idx)];
        two entries -> bi combine (default 8.4.2.3.1 or weighted
        8.4.2.3.2 when `wp` is set)."""
        px, py = x0 + ox4 * 4, y0 + oy4 * 4
        pw, ph = w4 * 4, h4 * 4
        preds = []
        for which, mv, ridx in used:
            lst = lists[which]
            if lst is None or ridx >= len(lst):
                raise ValueError(f"ref_idx {ridx} out of list {which}")
            ry, rcb, rcr = lst[ridx]
            yv = luma_interp(ry, px, py, pw, ph, int(mv[0]), int(mv[1]))
            cbv = crv = None
            if cat == 3:
                # ChromaArrayType 3 (spec 8.4.2.2.2): chroma planes use
                # the LUMA quarter-sample interpolation, unscaled MVs
                cbv = luma_interp(rcb, px, py, pw, ph, int(mv[0]),
                                  int(mv[1]))
                crv = luma_interp(rcr, px, py, pw, ph, int(mv[0]),
                                  int(mv[1]))
            elif cat:
                cmvy = int(mv[1])
                if cvoff is not None:
                    cmvy += int(cvoff[which][ridx])
                cbv = chroma_interp(rcb, px // 2, py // suby, pw // 2,
                                    ph // suby, int(mv[0]), cmvy,
                                    suby)
                crv = chroma_interp(rcr, px // 2, py // suby, pw // 2,
                                    ph // suby, int(mv[0]), cmvy,
                                    suby)
            preds.append((which, ridx, yv, cbv, crv))
        accb = accr = None
        if len(preds) == 1:
            which, ridx, accy, accb, accr = preds[0]
            if isinstance(wp, ExplicitWP):
                accy = _wp_single(accy, *wp.luma(which, ridx))
                if cat:
                    accb = _wp_single(accb, *wp.chroma(which, ridx, 0))
                    accr = _wp_single(accr, *wp.chroma(which, ridx, 1))
        elif isinstance(wp, ExplicitWP):
            _, r0, y0_, cb0, cr0 = preds[0]
            _, r1, y1_, cb1, cr1 = preds[1]
            dy, wy0, oy0 = wp.luma(0, r0)
            _, wy1, oy1 = wp.luma(1, r1)
            accy = _wp_bi(y0_, y1_, dy, wy0, oy0, wy1, oy1)
            if cat:
                dc, wb0, ob0 = wp.chroma(0, r0, 0)
                _, wb1, ob1 = wp.chroma(1, r1, 0)
                accb = _wp_bi(cb0, cb1, dc, wb0, ob0, wb1, ob1)
                _, wr0, or0 = wp.chroma(0, r0, 1)
                _, wr1, or1 = wp.chroma(1, r1, 1)
                accr = _wp_bi(cr0, cr1, dc, wr0, or0, wr1, or1)
        elif isinstance(wp, ImplicitWP):
            _, r0, y0_, cb0, cr0 = preds[0]
            _, r1, y1_, cb1, cr1 = preds[1]
            w0, w1 = wp.biweights(r0, r1)
            accy = _wp_bi(y0_, y1_, 5, w0, 0, w1, 0)
            if cat:
                accb = _wp_bi(cb0, cb1, 5, w0, 0, w1, 0)
                accr = _wp_bi(cr0, cr1, 5, w0, 0, w1, 0)
        else:
            _, _, y0_, cb0, cr0 = preds[0]
            _, _, y1_, cb1, cr1 = preds[1]
            accy = (y0_ + y1_ + 1) >> 1
            if cat:
                accb = (cb0 + cb1 + 1) >> 1
                accr = (cr0 + cr1 + 1) >> 1
        pred_y[oy4 * 4:oy4 * 4 + ph, ox4 * 4:ox4 * 4 + pw] = accy
        if cat:
            cy, cph = oy4 * 4 // suby, ph // suby
            oxc, pwc = ox4 * 4 // subx, pw // subx
            pred_cb[cy:cy + cph, oxc:oxc + pwc] = accb
            pred_cr[cy:cy + cph, oxc:oxc + pwc] = accr

    def direct_quad(q, quads):
        """Apply direct-mode motion to 8x8 quadrant q."""
        r0, r1, mv0, mv1 = quads[q]
        qx, qy = (q & 1) * 2, (q >> 1) * 2
        used = []
        for which, r, mv in ((0, r0, mv0), (1, r1, mv1)):
            if r >= 0:
                used.append((which, mv, r))
                ms.set_part(bx0 + qx, by0 + qy, 2, 2, mv, r, which)
            else:
                ms.set_part(bx0 + qx, by0 + qy, 2, 2,
                            np.zeros(2, np.int64), -1, which)
        mc_part(qx, qy, 2, 2, used)

    if mb.kind == MbKind.P_SKIP:
        mv = mv_skip(ms, addr)
        ms.set_part(bx0, by0, 4, 4, mv, 0)
        mc_part(0, 0, 4, 4, [(0, mv, 0)])
    elif mb.kind in (MbKind.B_SKIP, MbKind.B_DIRECT):
        dvals = derive_direct(ms, addr, direct_ctx)
        for q in range(4):
            direct_quad(q, dvals)
    else:
        dvals = None
        for (ox4, oy4, w4, h4, pred, quad, anchor, shape,
             pidx) in _partitions(mb):
            if pred == PRED_DIRECT:
                if dvals is None:
                    dvals = derive_direct(ms, addr, direct_ctx)
                direct_quad(quad, dvals)
                continue
            used = []
            for which in ((0,) if pred == PRED_L0 else
                          (1,) if pred == PRED_L1 else (0, 1)):
                ridx = int(mb.ref_idx[which][quad])
                mvp = mv_pred(ms, shape, bx0 + ox4, by0 + oy4, w4, h4,
                              ridx, pidx, which)
                mv = mvp + np.asarray(mb.mvd[which][anchor], np.int64)
                used.append((which, mv, ridx))
            used_lists = {u[0] for u in used}
            for which in (0, 1):
                if which in used_lists:
                    _, mv, ridx = next(u for u in used if u[0] == which)
                    ms.set_part(bx0 + ox4, by0 + oy4, w4, h4, mv, ridx,
                                which)
                elif mb.kind in (MbKind.B, MbKind.B_8X8):
                    ms.set_part(bx0 + ox4, by0 + oy4, w4, h4,
                                np.zeros(2, np.int64), -1, which)
            mc_part(ox4, oy4, w4, h4, used)

    # ---- residuals -----------------------------------------------------
    skip_kinds = (MbKind.P_SKIP, MbKind.B_SKIP)
    byp = recon.bypass(qpy)   # lossless: residual placed directly (8.5)
    resid = np.zeros((16, 16), dtype=np.int64)
    if mb.kind not in skip_kinds and (mb.cbp & 0x0F):
        if mb.transform8x8:
            for blk in range(4):
                if not ((mb.cbp >> blk) & 1):
                    continue
                r = (dezigzag8(mb.luma8[blk]) if byp
                     else dequant_idct_8x8(dezigzag8(mb.luma8[blk]), qpy,
                                           recon.ls8[1]))
                qx, qy = blk & 1, blk >> 1
                resid[qy * 8:qy * 8 + 8, qx * 8:qx * 8 + 8] = r
        else:
            from ..avc.neighbors import ZSCAN_4X4_POS as ZP
            for blk in range(16):
                if not ((mb.cbp >> (blk >> 2)) & 1):
                    continue
                r = (dezigzag4(mb.luma4[blk]) if byp
                     else dequant_idct_4x4(dezigzag4(mb.luma4[blk]), qpy,
                                           recon.ls4[3], False))
                ox, oy = ZP[blk]
                resid[oy * 4:oy * 4 + 4, ox * 4:ox * 4 + 4] = r
    recon.y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred_y + resid, 0, maxv)

    for ci, (plane, pred) in enumerate(((recon.cb, pred_cb),
                                        (recon.cr, pred_cr))):
        if not cat:
            break  # monochrome: no chroma planes
        qp_off = (recon.pps.chroma_qp_index_offset if ci == 0
                  else recon.pps.second_chroma_qp_offset)
        qpc = qpc_from_qpy(qpy, qp_off, recon.qp_bd_offset_c)
        cresid = np.zeros((chh, cw), dtype=np.int64)
        if cat == 3:
            # ChromaArrayType 3: each chroma plane runs the LUMA residual
            # process (spec 8.5; CodedBlockPatternLuma covers all three
            # planes per 7.4.2.1.1) with the chroma QP / scaling lists
            if mb.kind not in skip_kinds and (mb.cbp & 0x0F):
                if mb.transform8x8:
                    for blk in range(4):
                        if not ((mb.cbp >> blk) & 1):
                            continue
                        lv = dezigzag8(mb.cbcr8[ci][blk])
                        r = (lv if byp
                             else dequant_idct_8x8(lv, qpc,
                                                   recon.ls8[3 + 2 * ci]))
                        qx, qy = blk & 1, blk >> 1
                        cresid[qy * 8:qy * 8 + 8, qx * 8:qx * 8 + 8] = r
                else:
                    from ..avc.neighbors import ZSCAN_4X4_POS as ZP
                    for blk in range(16):
                        if not ((mb.cbp >> (blk >> 2)) & 1):
                            continue
                        lv = dezigzag4(mb.cbcr4[ci][blk])
                        r = (lv if byp
                             else dequant_idct_4x4(lv, qpc,
                                                   recon.ls4[4 + ci],
                                                   False))
                        ox, oy = ZP[blk]
                        cresid[oy * 4:oy * 4 + 4, ox * 4:ox * 4 + 4] = r
        elif mb.kind not in skip_kinds and (mb.cbp & 0x30):
            if byp:
                # lossless (8.5 bypass): DC + AC levels place directly,
                # no inter DPCM
                for j in range(4 * cat):
                    qx, qy = j & 1, j >> 1
                    full = np.zeros(16, dtype=np.int64)
                    if cat == 1:
                        full[0] = mb.chroma_dc[ci][j]
                    else:
                        raster = np.zeros(8, dtype=np.int64)
                        raster[[0, 2, 1, 4, 6, 3, 5, 7]] = \
                            mb.chroma_dc[ci][:8]
                        full[0] = raster[j]
                    full[1:] = mb.chroma_ac[ci][j][:15]
                    cresid[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = \
                        dezigzag4(full)
            else:
                if cat == 1:
                    dc_in = mb.chroma_dc[ci][:4].reshape(2, 2)
                    dcv = idct_chroma_dc(dc_in, qpc, recon.ls4[4 + ci], 1)
                else:
                    # 4:2:2: 8 DC levels in the fixed 2x4 scan (8.5.11.2)
                    raster = np.zeros(8, dtype=np.int64)
                    raster[[0, 2, 1, 4, 6, 3, 5, 7]] = mb.chroma_dc[ci][:8]
                    dcv = idct_chroma_dc(raster.reshape(4, 2), qpc + 3,
                                         recon.ls4[4 + ci], 2)
                for j in range(4 * cat):
                    qx, qy = j & 1, j >> 1
                    full = np.zeros(16, dtype=np.int64)
                    full[1:] = mb.chroma_ac[ci][j][:15]
                    c = dezigzag4(full)
                    c[0, 0] = dcv[qy, qx]
                    r = dequant_idct_4x4(c, qpc, recon.ls4[4 + ci], True)
                    cresid[qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = r
        cy0, cx0 = y0 // suby, x0 // subx
        plane[cy0:cy0 + chh, cx0:cx0 + cw] = np.clip(pred + cresid, 0, maxv)

    recon.blk_done[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
    recon.mb_done[my, mx] = True
    recon.mb_slice[my, mx] = slice_id
    recon.mb_intra[my, mx] = False
