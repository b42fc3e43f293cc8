"""Numpy-only geometry and table helpers of the batched intra decode.

Their home modules in ``dryv_tpu.kernels`` load jax when imported, so
the port carries copies; ``tests/test_torch_helpers.py`` holds each one
equal to its original:

- ``diag_schedule``: ``dryv_tpu/kernels/wavefront.py`` (``diag_schedule``)
- ``BLK4_A..C`` / ``BLK8_A..D``: ``dryv_tpu/kernels/wavefront.py``
  (``_blk4_avail_tables`` and the 8x8 rows below it)
- ``Z2SP`` / ``Q2SP``: ``dryv_tpu/kernels/pallas_wavefront.py``
  (``_Z2SP`` / ``_Q2SP``)
- ``LS4_FLAT`` / ``LS8_FLAT``: ``dryv_tpu/kernels/transform.py``
- ``BLK`` / ``L`` / ``NB`` / ``round_up``: ``dryv_tpu/kernels/densify.py``
- ``PRE_KEYS``: ``dryv_tpu/kernels/deblock.py``
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..avc.neighbors import POS_TO_ZSCAN, ZSCAN_4X4_POS
from ..refimpl.transform import CLASS4, CLASS8, V4X4, V8X8

L = 408        # coefficient row length per MB
NB = 51        # bitmap bytes per MB row (408 bits)
BLK = 128      # MB rows per densify block; npad is a multiple of it


def round_up(x: int, q: int) -> int:
    return (x + q - 1) // q * q


# flat-16 LevelScale tables [6,4,4] / [6,8,8] int32
LS4_FLAT = np.asarray(16 * V4X4[:, CLASS4], dtype=np.int32)
LS8_FLAT = np.asarray(16 * V8X8[:, CLASS8], dtype=np.int32)


@lru_cache(maxsize=None)
def diag_schedule(mb_w: int, mb_h: int):
    """Returns (sched [n_diag, K], d_of [n], k_of [n]): MB addresses per
    anti-diagonal (x + 2y = d, -1 padded) and the inverse mapping."""
    diags = {}
    for my in range(mb_h):
        for mx in range(mb_w):
            diags.setdefault(mx + 2 * my, []).append(my * mb_w + mx)
    n_diag = mb_w + 2 * (mb_h - 1)
    K = max(len(v) for v in diags.values())
    sched = np.full((n_diag, K), -1, dtype=np.int32)
    d_of = np.zeros(mb_w * mb_h, dtype=np.int32)
    k_of = np.zeros(mb_w * mb_h, dtype=np.int32)
    for d, addrs in diags.items():
        sched[d, :len(addrs)] = addrs
        for k, a in enumerate(addrs):
            d_of[a] = d
            k_of[a] = k
    return sched, d_of, k_of


# per-4x4-block availability source: 0=always True, 1=mb_a, 2=mb_b, 3=mb_c,
# 4=mb_d, 5=always False
def _blk4_avail_tables():
    a_src, b_src, c_src, d_src = [], [], [], []
    for blk in range(16):
        bx, by = ZSCAN_4X4_POS[blk]
        a_src.append(0 if bx > 0 else 1)
        b_src.append(0 if by > 0 else 2)
        if bx > 0 and by > 0:
            d_src.append(0)
        elif bx == 0 and by > 0:
            d_src.append(1)
        elif bx > 0 and by == 0:
            d_src.append(2)
        else:
            d_src.append(4)
        if by == 0:
            c_src.append(2 if bx < 3 else 3)
        elif bx == 3:
            c_src.append(5)
        else:
            nb_z = POS_TO_ZSCAN[(bx + 1, by - 1)]
            c_src.append(0 if nb_z < blk else 5)
    return (np.array(a_src), np.array(b_src),
            np.array(c_src), np.array(d_src))


BLK4_A, BLK4_B, BLK4_C, BLK4_D = _blk4_avail_tables()
# 8x8 blocks (raster 0..3)
BLK8_A = np.array([1, 0, 1, 0])
BLK8_B = np.array([2, 2, 0, 0])
BLK8_C = np.array([2, 3, 0, 5])
BLK8_D = np.array([4, 2, 1, 0])

# luma residual rows travel in STORAGE order: 16*zb + 4*dy + dx for the
# 4x4 z-blocks (I4/I16/PCM), 64*q + 8*dy + dx for the I8 quadrants
Z2SP = np.zeros(256, np.int32)       # z-row -> spatial 16*y + x
for _zb, (_bx, _by) in enumerate(ZSCAN_4X4_POS):
    for _dy in range(4):
        for _dx in range(4):
            Z2SP[16 * _zb + 4 * _dy + _dx] = \
                16 * (4 * _by + _dy) + 4 * _bx + _dx
Q2SP = np.zeros(256, np.int32)       # I8 quad-row -> spatial 16*y + x
for _q in range(4):
    for _dy in range(8):
        for _dx in range(8):
            Q2SP[64 * _q + 8 * _dy + _dx] = \
                16 * (8 * (_q >> 1) + _dy) + 8 * (_q & 1) + _dx
SP2Z = np.argsort(Z2SP)     # spatial 16*y + x -> z-row
SP2Q = np.argsort(Q2SP)     # spatial -> I8 quadrant row

# deblock edge-parameter keys, in the order the B3 parameter rows pack them
PRE_KEYS = ["bsv", "tc0v", "av", "bv", "bsh", "tc0h", "ah", "bh",
            "bscv", "tc0cv", "acv", "bcv", "bsch", "tc0ch", "ach", "bch"]
