# Copy of dryv_tpu/refimpl/transform.py.
"""Inverse quantization + inverse integer transforms (spec 8.5.9-8.5.13).

Scalar numpy mirror of reference src/video/frame/transform.rs,
pred16x16.rs:428-482 (I16 DC Hadamard), trans_chroma.rs:369-456 (chroma DC).
All arithmetic is exact int32/int64; inputs/outputs raster-order blocks.
"""
from __future__ import annotations

import numpy as np

# Table: normAdjust4x4 (spec 8.5.9); 3 position classes.
V4X4 = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int64)

# normAdjust8x8; 6 position classes.
V8X8 = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int64)

# position-class index maps
_I4, _J4 = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
CLASS4 = np.where((_I4 % 2 == 0) & (_J4 % 2 == 0), 0,
                  np.where((_I4 % 2 == 1) & (_J4 % 2 == 1), 1, 2))
_I8, _J8 = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
CLASS8 = np.select(
    [
        (_I8 % 4 == 0) & (_J8 % 4 == 0),
        (_I8 % 2 == 1) & (_J8 % 2 == 1),
        (_I8 % 4 == 2) & (_J8 % 4 == 2),
        ((_I8 % 4 == 0) & (_J8 % 2 == 1)) | ((_I8 % 2 == 1) & (_J8 % 4 == 0)),
        ((_I8 % 4 == 0) & (_J8 % 4 == 2)) | ((_I8 % 4 == 2) & (_J8 % 4 == 0)),
    ],
    [0, 1, 2, 3, 4],
    default=5,
)

HAD4 = np.array([[1, 1, 1, 1],
                 [1, 1, -1, -1],
                 [1, -1, -1, 1],
                 [1, -1, 1, -1]], dtype=np.int64)


def level_scale_4x4(weight_scale: np.ndarray) -> np.ndarray:
    """LevelScale4x4[m][i][j] = weightScale * normAdjust (8.5.9).

    weight_scale: [4,4] raster; returns [6,4,4] int64."""
    return weight_scale[None, :, :].astype(np.int64) * V4X4[:, CLASS4]


def level_scale_8x8(weight_scale: np.ndarray) -> np.ndarray:
    return weight_scale[None, :, :].astype(np.int64) * V8X8[:, CLASS8]


def _idct4_core(d: np.ndarray) -> np.ndarray:
    """Butterfly core of 8.5.12.2 (without the final rounding shift).

    d: [...,4,4] int64 -> h: [...,4,4]."""
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    f0, f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
    g0 = f0 + f2
    g1 = f0 - f2
    g2 = (f1 >> 1) - f3
    g3 = f1 + (f3 >> 1)
    return np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=-2)


def dequant_idct_4x4(c: np.ndarray, qp: int, ls4: np.ndarray,
                     dc_passthrough: bool) -> np.ndarray:
    """8.5.12: c raster [...,4,4] -> residual [...,4,4].

    dc_passthrough: True for Intra16x16 luma AC / chroma AC blocks whose
    [0,0] slot holds an already-scaled DC value."""
    c = c.astype(np.int64)
    ls = ls4[qp % 6]
    if qp >= 24:
        d = (c * ls) << (qp // 6 - 4)
    else:
        d = (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)
    if dc_passthrough:
        d[..., 0, 0] = c[..., 0, 0]
    h = _idct4_core(d)
    return (h + 32) >> 6


def idct_dc_16x16(c: np.ndarray, qp: int, ls4: np.ndarray) -> np.ndarray:
    """8.5.10 Intra16x16 luma DC: 4x4 inverse Hadamard + scaling.

    c: [...,4,4] DC levels -> [...,4,4] scaled DC values."""
    f = HAD4 @ c.astype(np.int64) @ HAD4
    ls00 = ls4[qp % 6, 0, 0]
    if qp >= 36:
        return (f * ls00) << (qp // 6 - 6)
    return (f * ls00 + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def idct_chroma_dc(c: np.ndarray, qp: int, ls4: np.ndarray,
                   chroma_array_type: int = 1) -> np.ndarray:
    """8.5.11: chroma DC 2x2 (4:2:0) or 2x4 (4:2:2) transform + scaling."""
    ls00 = ls4[qp % 6, 0, 0]
    c = c.astype(np.int64)
    if chroma_array_type == 1:
        b = np.array([[1, 1], [1, -1]], dtype=np.int64)
        f = b @ c @ b
        return ((f * ls00) * (1 << (qp // 6))) >> 5
    # 4:2:2 (spec 8.5.11.2): c is [...,4,2]; qp here is qP_DC = QPc + 3.
    # Note: the reference (trans_chroma.rs:448-452) shifts by (6 - QPc/6)
    # instead of (6 - qP_DC/6) in the low-QP branch; we follow the spec.
    a = np.array([[1, 1, 1, 1],
                  [1, 1, -1, -1],
                  [1, -1, -1, 1],
                  [1, -1, 1, -1]], dtype=np.int64)
    b = np.array([[1, 1], [1, -1]], dtype=np.int64)
    f = a @ c @ b
    ls00 = np.int64(ls00)
    if qp >= 36:
        return (f * ls00) << (qp // 6 - 6)
    return (f * ls00 + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def dequant_idct_8x8(c: np.ndarray, qp: int, ls8: np.ndarray) -> np.ndarray:
    """8.5.13: 8x8 dequant + two-stage butterfly IDCT.

    c: raster [...,8,8] -> residual [...,8,8]."""
    c = c.astype(np.int64)
    ls = ls8[qp % 6]
    if qp >= 36:
        d = (c * ls) << (qp // 6 - 6)
    else:
        d = (c * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)

    def stage(m):
        # m: [...,8] along the transformed axis (operating on last axis)
        m0, m1, m2, m3, m4, m5, m6, m7 = [m[..., k] for k in range(8)]
        e0 = m0 + m4
        e1 = -m3 + m5 - m7 - (m7 >> 1)
        e2 = m0 - m4
        e3 = m1 + m7 - m3 - (m3 >> 1)
        e4 = (m2 >> 1) - m6
        e5 = -m1 + m7 + m5 + (m5 >> 1)
        e6 = m2 + (m6 >> 1)
        e7 = m3 + m5 + m1 + (m1 >> 1)
        f0 = e0 + e6
        f1 = e1 + (e7 >> 2)
        f2 = e2 + e4
        f3 = e3 + (e5 >> 2)
        f4 = e2 - e4
        f5 = (e3 >> 2) - e5
        f6 = e0 - e6
        f7 = e7 - (e1 >> 2)
        return np.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                         f6 - f1, f4 - f3, f2 - f5, f0 - f7], axis=-1)

    g = stage(d)             # rows (last axis = j)
    h = stage(np.swapaxes(g, -1, -2))
    m = np.swapaxes(h, -1, -2)
    return (m + 32) >> 6


# Table 8-15 chroma QP mapping (reference transform.rs:211-213)
QPC_TAB = np.array([29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37,
                    37, 38, 38, 38, 39, 39, 39, 39], dtype=np.int64)


def qpc_from_qpy(qpy: int, qp_offset: int, qp_bd_offset_c: int = 0) -> int:
    qpi = min(max(qpy + qp_offset, -qp_bd_offset_c), 51)
    return int(qpi if qpi < 30 else QPC_TAB[qpi - 30])
