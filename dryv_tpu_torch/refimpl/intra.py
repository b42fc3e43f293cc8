# Copy of dryv_tpu/refimpl/intra.py.
"""Intra prediction, scalar reference (spec 8.3; reference pred4x4.rs,
pred8x8.rs, pred16x16.rs, trans_chroma.rs).

All predictors operate on explicit neighbor-sample windows with availability
flags, so the same functions serve the per-block scalar loop here and give
the JAX kernels a behavioural target.
"""
from __future__ import annotations

import numpy as np

# Mode numbers (spec 8.3.1.2.x)
M4_V, M4_H, M4_DC, M4_DDL, M4_DDR, M4_VR, M4_HD, M4_VL, M4_HU = range(9)
# 16x16 / chroma plane-ish modes
M16_V, M16_H, M16_DC, M16_PLANE = range(4)
MC_DC, MC_H, MC_V, MC_PLANE = range(4)


def pred4x4(mode: int, above: np.ndarray, left: np.ndarray, corner: int,
            avail_a: bool, avail_b: bool, avail_c: bool, avail_d: bool,
            bitdepth: int = 8) -> np.ndarray:
    """4x4 intra prediction (spec 8.3.1.2).

    above: p[x,-1] x=0..7 (8 samples; x=4..7 already substituted with
    p[3,-1] when above-right unavailable — caller handles per 8.3.1.2);
    left: p[-1,y] y=0..3; corner: p[-1,-1].
    avail_a: left available; avail_b: above; avail_c: above-right (post
    substitution this only matters for DDL/VL); avail_d: corner.
    Returns [4,4] predicted samples (row-major [y][x])."""
    p = np.zeros((4, 4), dtype=np.int64)
    a = above.astype(np.int64)
    l = left.astype(np.int64)
    z = corner

    if mode == M4_V:
        assert avail_b
        p[:, :] = a[:4][None, :]
    elif mode == M4_H:
        assert avail_a
        p[:, :] = l[:, None]
    elif mode == M4_DC:
        if avail_a and avail_b:
            v = (a[:4].sum() + l.sum() + 4) >> 3
        elif avail_a:
            v = (l.sum() + 2) >> 2
        elif avail_b:
            v = (a[:4].sum() + 2) >> 2
        else:
            v = 1 << (bitdepth - 1)
        p[:, :] = v
    elif mode == M4_DDL:
        assert avail_b
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (a[6] + 3 * a[7] + 2) >> 2
                else:
                    i = x + y
                    p[y, x] = (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    elif mode == M4_DDR:
        assert avail_a and avail_b and avail_d
        for y in range(4):
            for x in range(4):
                if x > y:
                    i = x - y
                    s2 = a[i - 2] if i >= 2 else z
                    p[y, x] = (s2 + 2 * a[i - 1] + a[i] + 2) >> 2
                elif x < y:
                    i = y - x
                    s2 = l[i - 2] if i >= 2 else z
                    p[y, x] = (s2 + 2 * l[i - 1] + l[i] + 2) >> 2
                else:
                    p[y, x] = (a[0] + 2 * z + l[0] + 2) >> 2
    elif mode == M4_VR:
        assert avail_a and avail_b and avail_d
        for y in range(4):
            for x in range(4):
                zvr = 2 * x - y
                if zvr in (0, 2, 4, 6):
                    i = x - (y >> 1)
                    p[y, x] = ((z if i == 0 else a[i - 1]) + (a[i]) + 1) >> 1
                elif zvr in (1, 3, 5):
                    i = x - (y >> 1)
                    s0 = a[i - 2] if i >= 2 else z
                    s1 = a[i - 1] if i >= 1 else z
                    p[y, x] = (s0 + 2 * s1 + a[i] + 2) >> 2
                elif zvr == -1:
                    p[y, x] = (l[0] + 2 * z + a[0] + 2) >> 2
                else:
                    s3 = l[y - 3] if y >= 3 else z
                    p[y, x] = (l[y - 1] + 2 * l[y - 2] + s3 + 2) >> 2
    elif mode == M4_HD:
        assert avail_a and avail_b and avail_d
        for y in range(4):
            for x in range(4):
                zhd = 2 * y - x
                if zhd in (0, 2, 4, 6):
                    i = y - (x >> 1)
                    p[y, x] = ((z if i == 0 else l[i - 1]) + l[i] + 1) >> 1
                elif zhd in (1, 3, 5):
                    i = y - (x >> 1)
                    s0 = l[i - 2] if i >= 2 else z
                    s1 = l[i - 1] if i >= 1 else z
                    p[y, x] = (s0 + 2 * s1 + l[i] + 2) >> 2
                elif zhd == -1:
                    p[y, x] = (a[0] + 2 * z + l[0] + 2) >> 2
                else:
                    s3 = a[x - 3] if x >= 3 else z
                    p[y, x] = (a[x - 1] + 2 * a[x - 2] + s3 + 2) >> 2
    elif mode == M4_VL:
        assert avail_b
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y in (0, 2):
                    p[y, x] = (a[i] + a[i + 1] + 1) >> 1
                else:
                    p[y, x] = (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    elif mode == M4_HU:
        assert avail_a
        for y in range(4):
            for x in range(4):
                zhu = x + 2 * y
                if zhu in (0, 2, 4):
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + l[i + 1] + 1) >> 1
                elif zhu in (1, 3):
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif zhu == 5:
                    p[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                else:
                    p[y, x] = l[3]
    else:
        raise ValueError(f"bad 4x4 mode {mode}")
    return p


def filter_ref_8x8(above: np.ndarray, left: np.ndarray, corner: int,
                   avail_a: bool, avail_b: bool, avail_c_orig: bool,
                   avail_d: bool):
    """Reference sample filtering for 8x8 intra (spec 8.3.2.2.1).

    above: p[0..15,-1] (16 samples; 8..15 substituted when above-right
    unavailable), left: p[-1,0..7], corner p[-1,-1].
    Returns filtered (above', left', corner')."""
    a = above.astype(np.int64)
    l = left.astype(np.int64)
    z = int(corner)
    fa = a.copy()
    fl = l.copy()
    fz = z
    if avail_b:
        if avail_d:
            fa[0] = (z + 2 * a[0] + a[1] + 2) >> 2
        else:
            fa[0] = (3 * a[0] + a[1] + 2) >> 2
        for x in range(1, 15):
            fa[x] = (a[x - 1] + 2 * a[x] + a[x + 1] + 2) >> 2
        fa[15] = (a[14] + 3 * a[15] + 2) >> 2
    if avail_d:
        if avail_a and avail_b:
            fz = (a[0] + 2 * z + l[0] + 2) >> 2
        elif avail_b:
            fz = (3 * z + a[0] + 2) >> 2
        elif avail_a:
            fz = (3 * z + l[0] + 2) >> 2
    if avail_a:
        if avail_d:
            fl[0] = (z + 2 * l[0] + l[1] + 2) >> 2
        else:
            fl[0] = (3 * l[0] + l[1] + 2) >> 2
        for y in range(1, 7):
            fl[y] = (l[y - 1] + 2 * l[y] + l[y + 1] + 2) >> 2
        fl[7] = (l[6] + 3 * l[7] + 2) >> 2
    return fa, fl, fz


def pred8x8(mode: int, above: np.ndarray, left: np.ndarray, corner: int,
            avail_a: bool, avail_b: bool, avail_d: bool,
            bitdepth: int = 8) -> np.ndarray:
    """8x8 intra prediction on FILTERED samples (spec 8.3.2.2.2-.2.10)."""
    p = np.zeros((8, 8), dtype=np.int64)
    a = above.astype(np.int64)
    l = left.astype(np.int64)
    z = int(corner)

    if mode == M4_V:
        assert avail_b
        p[:, :] = a[:8][None, :]
    elif mode == M4_H:
        assert avail_a
        p[:, :] = l[:, None]
    elif mode == M4_DC:
        if avail_a and avail_b:
            v = (a[:8].sum() + l.sum() + 8) >> 4
        elif avail_a:
            v = (l.sum() + 4) >> 3
        elif avail_b:
            v = (a[:8].sum() + 4) >> 3
        else:
            v = 1 << (bitdepth - 1)
        p[:, :] = v
    elif mode == M4_DDL:
        assert avail_b
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    p[y, x] = (a[14] + 3 * a[15] + 2) >> 2
                else:
                    i = x + y
                    p[y, x] = (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    elif mode == M4_DDR:
        assert avail_a and avail_b and avail_d
        for y in range(8):
            for x in range(8):
                if x > y:
                    i = x - y
                    s0 = a[i - 2] if i >= 2 else z
                    p[y, x] = (s0 + 2 * a[i - 1] + a[i] + 2) >> 2
                elif x < y:
                    i = y - x
                    s0 = l[i - 2] if i >= 2 else z
                    s1 = l[i - 1] if i >= 1 else z
                    p[y, x] = (s0 + 2 * s1 + l[i] + 2) >> 2
                else:
                    p[y, x] = (a[0] + 2 * z + l[0] + 2) >> 2
    elif mode == M4_VR:
        assert avail_a and avail_b and avail_d
        for y in range(8):
            for x in range(8):
                zvr = 2 * x - y
                if zvr >= 0 and zvr % 2 == 0:
                    i = x - (y >> 1)
                    p[y, x] = ((z if i == 0 else a[i - 1]) + a[i] + 1) >> 1
                elif zvr >= 0:
                    i = x - (y >> 1)
                    s0 = a[i - 2] if i >= 2 else z
                    s1 = a[i - 1] if i >= 1 else z
                    p[y, x] = (s0 + 2 * s1 + a[i] + 2) >> 2
                elif zvr == -1:
                    p[y, x] = (l[0] + 2 * z + a[0] + 2) >> 2
                else:
                    i = y - 2 * x
                    s3 = l[i - 3] if i >= 3 else z
                    p[y, x] = (l[i - 1] + 2 * l[i - 2] + s3 + 2) >> 2
    elif mode == M4_HD:
        assert avail_a and avail_b and avail_d
        for y in range(8):
            for x in range(8):
                zhd = 2 * y - x
                if zhd >= 0 and zhd % 2 == 0:
                    i = y - (x >> 1)
                    p[y, x] = ((z if i == 0 else l[i - 1]) + l[i] + 1) >> 1
                elif zhd >= 0:
                    i = y - (x >> 1)
                    s0 = l[i - 2] if i >= 2 else z
                    s1 = l[i - 1] if i >= 1 else z
                    p[y, x] = (s0 + 2 * s1 + l[i] + 2) >> 2
                elif zhd == -1:
                    p[y, x] = (a[0] + 2 * z + l[0] + 2) >> 2
                else:
                    i = x - 2 * y
                    s3 = a[i - 3] if i >= 3 else z
                    p[y, x] = (a[i - 1] + 2 * a[i - 2] + s3 + 2) >> 2
    elif mode == M4_VL:
        assert avail_b
        for y in range(8):
            for x in range(8):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (a[i] + a[i + 1] + 1) >> 1
                else:
                    p[y, x] = (a[i] + 2 * a[i + 1] + a[i + 2] + 2) >> 2
    elif mode == M4_HU:
        assert avail_a
        for y in range(8):
            for x in range(8):
                zhu = x + 2 * y
                if zhu < 13 and zhu % 2 == 0:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + l[i + 1] + 1) >> 1
                elif zhu < 13:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif zhu == 13:
                    p[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    p[y, x] = l[7]
    else:
        raise ValueError(f"bad 8x8 mode {mode}")
    return p


def pred16x16(mode: int, above: np.ndarray, left: np.ndarray, corner: int,
              avail_a: bool, avail_b: bool, avail_d: bool,
              bitdepth: int = 8) -> np.ndarray:
    """16x16 luma prediction (spec 8.3.3)."""
    p = np.zeros((16, 16), dtype=np.int64)
    a = above.astype(np.int64)
    l = left.astype(np.int64)
    if mode == M16_V:
        assert avail_b
        p[:, :] = a[None, :]
    elif mode == M16_H:
        assert avail_a
        p[:, :] = l[:, None]
    elif mode == M16_DC:
        if avail_a and avail_b:
            v = (a.sum() + l.sum() + 16) >> 5
        elif avail_a:
            v = (l.sum() + 8) >> 4
        elif avail_b:
            v = (a.sum() + 8) >> 4
        else:
            v = 1 << (bitdepth - 1)
        p[:, :] = v
    elif mode == M16_PLANE:
        assert avail_a and avail_b and avail_d
        z = int(corner)
        hh = sum((x + 1) * (a[8 + x] - (a[6 - x] if x < 7 else z))
                 for x in range(8))
        vv = sum((y + 1) * (l[8 + y] - (l[6 - y] if y < 7 else z))
                 for y in range(8))
        b = (5 * hh + 32) >> 6
        c = (5 * vv + 32) >> 6
        aa = 16 * (a[15] + l[15])
        mx = 1 << bitdepth
        for y in range(16):
            for x in range(16):
                v = (aa + b * (x - 7) + c * (y - 7) + 16) >> 5
                p[y, x] = min(max(v, 0), mx - 1)
    else:
        raise ValueError(f"bad 16x16 mode {mode}")
    return p


def pred_chroma(mode: int, above: np.ndarray, left: np.ndarray, corner: int,
                avail_a: bool, avail_b: bool, avail_d: bool,
                w: int = 8, h: int = 8, bitdepth: int = 8) -> np.ndarray:
    """Chroma prediction (spec 8.3.4), w x h = 8x8 (4:2:0) or 8x16 (4:2:2)."""
    p = np.zeros((h, w), dtype=np.int64)
    a = above.astype(np.int64)
    l = left.astype(np.int64)
    if mode == MC_DC:
        # per-4x4-block DC with quadrant availability rules (8.3.4.1)
        for by in range(0, h, 4):
            for bx in range(0, w, 4):
                top_block = by == 0
                left_block = bx == 0
                asum = a[bx:bx + 4].sum()
                lsum = l[by:by + 4].sum()
                if left_block and top_block or (not left_block and not top_block):
                    # corner-ish blocks: prefer both, fall to above then left
                    if avail_b and avail_a:
                        v = (asum + lsum + 4) >> 3
                    elif avail_b:
                        v = (asum + 2) >> 2
                    elif avail_a:
                        v = (lsum + 2) >> 2
                    else:
                        v = 1 << (bitdepth - 1)
                elif not left_block and top_block:
                    # top-right style block: prefer above
                    if avail_b:
                        v = (asum + 2) >> 2
                    elif avail_a:
                        v = (lsum + 2) >> 2
                    else:
                        v = 1 << (bitdepth - 1)
                else:
                    # bottom-left style block: prefer left
                    if avail_a:
                        v = (lsum + 2) >> 2
                    elif avail_b:
                        v = (asum + 2) >> 2
                    else:
                        v = 1 << (bitdepth - 1)
                p[by:by + 4, bx:bx + 4] = v
    elif mode == MC_H:
        assert avail_a
        p[:, :] = l[:, None]
    elif mode == MC_V:
        assert avail_b
        p[:, :] = a[None, :]
    elif mode == MC_PLANE:
        assert avail_a and avail_b and avail_d
        z = int(corner)
        xcf = (w >> 3) - 1  # 0 for w=8
        ycf = (h >> 3) - 1  # 0 for h=8, 1 for h=16
        hw = w >> 1
        hh = h >> 1
        hsum = sum((x + 1) * (a[hw + x] - (a[hw - 2 - x] if hw - 2 - x >= 0 else z))
                   for x in range(hw))
        vsum = sum((y + 1) * (l[hh + y] - (l[hh - 2 - y] if hh - 2 - y >= 0 else z))
                   for y in range(hh))
        # spec 8.3.4.4: factor 34 for 8-sample extent, 5 for 16-sample extent
        b = ((34 - 29 * (1 if w == 16 else 0)) * hsum + 32) >> 6
        c = ((34 - 29 * (1 if h == 16 else 0)) * vsum + 32) >> 6
        aa = 16 * (a[w - 1] + l[h - 1])
        mx = 1 << bitdepth
        for y in range(h):
            for x in range(w):
                v = (aa + b * (x - 3 - xcf * 4) + c * (y - 3 - ycf * 4) + 16) >> 5
                p[y, x] = min(max(v, 0), mx - 1)
    else:
        raise ValueError(f"bad chroma mode {mode}")
    return p
