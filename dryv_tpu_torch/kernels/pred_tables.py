# Copy of dryv_tpu/kernels/pred_tables.py.
"""Table-driven intra predictors.

Every directional H.264 intra prediction formula is a <=3-tap weighted sum
with a rounding shift: out = (w0*s0 + w1*s1 + w2*s2 + r) >> t.  We compile
each (mode, position) to static tap tables once, so the wavefront's hot
loop evaluates ALL directional modes of a block with one gather + one
multiply-add + a one-hot select instead of hundreds of ops.

Sample vector layouts:
  4x4:  s[13] = [corner, above0..7, left0..3]
  8x8:  s[25] = [corner, above0..15, left0..7]   (filtered)
Tables are verified against refimpl.intra in tests.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# 4x4 layout helpers
_Z4 = 0
_A4 = lambda i: 1 + i        # above, i in 0..7
_L4 = lambda i: 9 + i        # left, i in 0..3
# 8x8 layout helpers
_Z8 = 0
_A8 = lambda i: 1 + i        # above, i in 0..15
_L8 = lambda i: 17 + i       # left, i in 0..7


def to_matrix(IDX, W, n_samples):
    """Fold tap tables into a dense matrix M [n_samples, n_out] so that
    acc = s @ M evaluates every (mode, position) weighted sum as one small
    matmul (MXU-friendly; exact in float32 since |acc| < 2^24)."""
    n_modes, n_pos, _ = IDX.shape
    M = np.zeros((n_samples, n_modes * n_pos), np.float32)
    for m in range(n_modes):
        for p in range(n_pos):
            for j in range(3):
                M[IDX[m, p, j], m * n_pos + p] += W[m, p, j]
    return M


def _entry(taps, r, s):
    """taps: list of (idx, weight) up to 3."""
    idx = [0, 0, 0]
    w = [0, 0, 0]
    for k, (i, wt) in enumerate(taps):
        idx[k] = i
        w[k] = wt
    return idx, w, r, s


@lru_cache(maxsize=None)
def tables_4x4():
    """Returns (IDX [9,16,3], W [9,16,3], R [9,16], S [9,16]) int32.

    Mode 2 (DC) rows are zeros — DC is availability-dependent and computed
    separately."""
    IDX = np.zeros((9, 16, 3), np.int32)
    W = np.zeros((9, 16, 3), np.int32)
    R = np.zeros((9, 16), np.int32)
    S = np.zeros((9, 16), np.int32)

    def put(m, y, x, taps, r=0, s=0):
        idx, w, rr, ss = _entry(taps, r, s)
        p = y * 4 + x
        IDX[m, p] = idx
        W[m, p] = w
        R[m, p] = rr
        S[m, p] = ss

    A, L, Z = _A4, _L4, _Z4
    for y in range(4):
        for x in range(4):
            put(0, y, x, [(A(x), 1)])                       # V
            put(1, y, x, [(L(y), 1)])                       # H
            # DDL (mode 3)
            if x == 3 and y == 3:
                put(3, y, x, [(A(6), 1), (A(7), 3)], 2, 2)
            else:
                i = x + y
                put(3, y, x, [(A(i), 1), (A(i + 1), 2), (A(i + 2), 1)], 2, 2)
            # DDR (mode 4)
            if x > y:
                i = x - y
                s2 = A(i - 2) if i >= 2 else Z
                put(4, y, x, [(s2, 1), (A(i - 1), 2), (A(i), 1)], 2, 2)
            elif x < y:
                i = y - x
                s2 = L(i - 2) if i >= 2 else Z
                put(4, y, x, [(s2, 1), (L(i - 1), 2), (L(i), 1)], 2, 2)
            else:
                put(4, y, x, [(A(0), 1), (Z, 2), (L(0), 1)], 2, 2)
            # VR (mode 5)
            zvr = 2 * x - y
            if zvr >= 0 and zvr % 2 == 0:
                i = x - (y >> 1)
                put(5, y, x, [((Z if i == 0 else A(i - 1)), 1), (A(i), 1)],
                    1, 1)
            elif zvr >= 0:
                i = x - (y >> 1)
                s0 = A(i - 2) if i >= 2 else Z
                s1 = A(i - 1) if i >= 1 else Z
                put(5, y, x, [(s0, 1), (s1, 2), (A(i), 1)], 2, 2)
            elif zvr == -1:
                put(5, y, x, [(L(0), 1), (Z, 2), (A(0), 1)], 2, 2)
            else:
                s3 = L(y - 3) if y >= 3 else Z
                put(5, y, x, [(L(y - 1), 1), (L(y - 2), 2), (s3, 1)], 2, 2)
            # HD (mode 6)
            zhd = 2 * y - x
            if zhd >= 0 and zhd % 2 == 0:
                i = y - (x >> 1)
                put(6, y, x, [((Z if i == 0 else L(i - 1)), 1), (L(i), 1)],
                    1, 1)
            elif zhd >= 0:
                i = y - (x >> 1)
                s0 = L(i - 2) if i >= 2 else Z
                s1 = L(i - 1) if i >= 1 else Z
                put(6, y, x, [(s0, 1), (s1, 2), (L(i), 1)], 2, 2)
            elif zhd == -1:
                put(6, y, x, [(A(0), 1), (Z, 2), (L(0), 1)], 2, 2)
            else:
                s3 = A(x - 3) if x >= 3 else Z
                put(6, y, x, [(A(x - 1), 1), (A(x - 2), 2), (s3, 1)], 2, 2)
            # VL (mode 7)
            i = x + (y >> 1)
            if y % 2 == 0:
                put(7, y, x, [(A(i), 1), (A(i + 1), 1)], 1, 1)
            else:
                put(7, y, x, [(A(i), 1), (A(i + 1), 2), (A(i + 2), 1)], 2, 2)
            # HU (mode 8)
            zhu = x + 2 * y
            if zhu < 5 and zhu % 2 == 0:
                i = y + (x >> 1)
                put(8, y, x, [(L(i), 1), (L(i + 1), 1)], 1, 1)
            elif zhu < 5:
                i = y + (x >> 1)
                put(8, y, x, [(L(i), 1), (L(i + 1), 2), (L(i + 2), 1)], 2, 2)
            elif zhu == 5:
                put(8, y, x, [(L(2), 1), (L(3), 3)], 2, 2)
            else:
                put(8, y, x, [(L(3), 1)])
    return IDX, W, R, S


@lru_cache(maxsize=None)
def tables_8x8():
    """Tap tables for 8x8 modes on FILTERED samples; DC rows zero."""
    IDX = np.zeros((9, 64, 3), np.int32)
    W = np.zeros((9, 64, 3), np.int32)
    R = np.zeros((9, 64), np.int32)
    S = np.zeros((9, 64), np.int32)

    def put(m, y, x, taps, r=0, s=0):
        idx, w, rr, ss = _entry(taps, r, s)
        p = y * 8 + x
        IDX[m, p] = idx
        W[m, p] = w
        R[m, p] = rr
        S[m, p] = ss

    A, L, Z = _A8, _L8, _Z8
    for y in range(8):
        for x in range(8):
            put(0, y, x, [(A(x), 1)])
            put(1, y, x, [(L(y), 1)])
            if x == 7 and y == 7:
                put(3, y, x, [(A(14), 1), (A(15), 3)], 2, 2)
            else:
                i = x + y
                put(3, y, x, [(A(i), 1), (A(i + 1), 2), (A(i + 2), 1)], 2, 2)
            if x > y:
                i = x - y
                s2 = A(i - 2) if i >= 2 else Z
                put(4, y, x, [(s2, 1), (A(i - 1), 2), (A(i), 1)], 2, 2)
            elif x < y:
                i = y - x
                s2 = L(i - 2) if i >= 2 else Z
                s1 = L(i - 1) if i >= 1 else Z
                put(4, y, x, [(s2, 1), (s1, 2), (L(i), 1)], 2, 2)
            else:
                put(4, y, x, [(A(0), 1), (Z, 2), (L(0), 1)], 2, 2)
            zvr = 2 * x - y
            if zvr >= 0 and zvr % 2 == 0:
                i = x - (y >> 1)
                put(5, y, x, [((Z if i == 0 else A(i - 1)), 1), (A(i), 1)],
                    1, 1)
            elif zvr >= 0:
                i = x - (y >> 1)
                s0 = A(i - 2) if i >= 2 else Z
                s1 = A(i - 1) if i >= 1 else Z
                put(5, y, x, [(s0, 1), (s1, 2), (A(i), 1)], 2, 2)
            elif zvr == -1:
                put(5, y, x, [(L(0), 1), (Z, 2), (A(0), 1)], 2, 2)
            else:
                i = y - 2 * x
                s3 = L(i - 3) if i >= 3 else Z
                put(5, y, x, [(L(i - 1), 1), (L(i - 2), 2), (s3, 1)], 2, 2)
            zhd = 2 * y - x
            if zhd >= 0 and zhd % 2 == 0:
                i = y - (x >> 1)
                put(6, y, x, [((Z if i == 0 else L(i - 1)), 1), (L(i), 1)],
                    1, 1)
            elif zhd >= 0:
                i = y - (x >> 1)
                s0 = L(i - 2) if i >= 2 else Z
                s1 = L(i - 1) if i >= 1 else Z
                put(6, y, x, [(s0, 1), (s1, 2), (L(i), 1)], 2, 2)
            elif zhd == -1:
                put(6, y, x, [(A(0), 1), (Z, 2), (L(0), 1)], 2, 2)
            else:
                i = x - 2 * y
                s3 = A(i - 3) if i >= 3 else Z
                put(6, y, x, [(A(i - 1), 1), (A(i - 2), 2), (s3, 1)], 2, 2)
            i = x + (y >> 1)
            if y % 2 == 0:
                put(7, y, x, [(A(i), 1), (A(i + 1), 1)], 1, 1)
            else:
                put(7, y, x, [(A(i), 1), (A(i + 1), 2), (A(i + 2), 1)], 2, 2)
            zhu = x + 2 * y
            if zhu < 13 and zhu % 2 == 0:
                i = y + (x >> 1)
                put(8, y, x, [(L(i), 1), (L(i + 1), 1)], 1, 1)
            elif zhu < 13:
                i = y + (x >> 1)
                put(8, y, x, [(L(i), 1), (L(i + 1), 2), (L(i + 2), 1)], 2, 2)
            elif zhu == 13:
                put(8, y, x, [(L(6), 1), (L(7), 3)], 2, 2)
            else:
                put(8, y, x, [(L(7), 1)])
    return IDX, W, R, S


@lru_cache(maxsize=None)
def filter_tables_8x8():
    """Low-pass tap tables (spec 8.3.2.2.1) for the 25-sample 8x8 window.

    Two variants of the corner-adjacent taps exist depending on avail_d;
    returns (IDX/W for avail_d=True, IDX/W for avail_d=False) with shared
    r=2, s=2 everywhere except identity rows."""
    def build(avail_d: bool):
        IDX = np.zeros((25, 3), np.int32)
        W = np.zeros((25, 3), np.int32)
        R = np.full(25, 2, np.int32)
        S = np.full(25, 2, np.int32)
        A, L, Z = _A8, _L8, _Z8
        # corner
        IDX[0], W[0] = ([A(0), Z, L(0)], [1, 2, 1])  # both avail variant
        # above row
        if avail_d:
            IDX[A(0)], W[A(0)] = ([Z, A(0), A(1)], [1, 2, 1])
        else:
            IDX[A(0)], W[A(0)] = ([A(0), A(1), 0], [3, 1, 0])
        for x in range(1, 15):
            IDX[A(x)], W[A(x)] = ([A(x - 1), A(x), A(x + 1)], [1, 2, 1])
        IDX[A(15)], W[A(15)] = ([A(14), A(15), 0], [1, 3, 0])
        # left col
        if avail_d:
            IDX[L(0)], W[L(0)] = ([Z, L(0), L(1)], [1, 2, 1])
        else:
            IDX[L(0)], W[L(0)] = ([L(0), L(1), 0], [3, 1, 0])
        for y in range(1, 7):
            IDX[L(y)], W[L(y)] = ([L(y - 1), L(y), L(y + 1)], [1, 2, 1])
        IDX[L(7)], W[L(7)] = ([L(6), L(7), 0], [1, 3, 0])
        return IDX, W, R, S
    return build(True), build(False)
