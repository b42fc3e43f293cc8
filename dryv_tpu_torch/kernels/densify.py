"""Kernel B1: sparse coefficient ABI -> dense int16 rows.

Replaces the Pallas kernel ``make_densify`` in
``dryv_tpu/kernels/densify.py``.  Per MB the host ships a 408-bit
nonzero bitmap (bit c at byte c>>3, bit c&7) and the nonzero values in
row order as int8, W of them at most.  Coefficient c gets vals[rank-1],
rank being the inclusive count of set bits up to c, when rank <= W, and
0 otherwise (those heavy MBs are overwritten by the caller's overflow
scatter, as in the JAX pipeline).

The CUDA kernel (``csrc/densify.cu``) is bound by device memory (~0.9 KB
read and written per MB), so it moves everything 16 bytes at a time: a
block stages a tile of 16 rows (bitmaps and values) in shared memory,
ranks each bitmap byte by a popcount scan, and writes that byte's 8
coefficients as one 16-byte store.  The TPU's one-hot and
lower-triangular matmuls disappear.  It needs rows in tiles of 16, W a
multiple of 16 and 16-byte aligned tensors; the pipeline's views (npad a
multiple of 128, W of 32, 64-byte aligned wire segments) meet that, and
the wrapper raises on anything else.
"""
from __future__ import annotations

import torch

from .. import _build
from .geometry import L, NB


def densify_plain(bmp, vals):
    """Plain PyTorch version: bmp u8 [F,npad,51], vals i8 [F,npad,W]
    -> i16 [F,npad,408]."""
    W = vals.shape[-1]
    c = torch.arange(L, device=bmp.device)
    bits = (bmp[..., c >> 3].to(torch.int32) >> (c & 7)) & 1
    rank = torch.cumsum(bits, dim=-1)
    idx = (rank - 1).clamp(0, W - 1).long()
    v = torch.gather(vals, -1, idx).to(torch.int16)
    keep = (bits == 1) & (rank <= W)
    return torch.where(keep, v, torch.zeros_like(v))


def densify(bmp, vals, out=None):
    """bmp u8 [F,npad,51], vals i8 [F,npad,W] -> dense i16 [F,npad,408]
    (written into `out` when given).  CPU tensors take the plain
    version; CUDA tensors launch kernel B1."""
    F, npad, nb = bmp.shape
    W = vals.shape[-1]
    if nb != NB or vals.shape[:2] != (F, npad):
        raise ValueError(f"bad densify shapes {bmp.shape} {vals.shape}")
    if bmp.dtype != torch.uint8 or vals.dtype != torch.int8:
        raise TypeError(f"densify wants uint8/int8, got {bmp.dtype}/"
                        f"{vals.dtype}")
    if out is None:
        out = torch.empty((F, npad, L), dtype=torch.int16,
                          device=bmp.device)
    if bmp.device.type == "cpu":
        out.copy_(densify_plain(bmp, vals))
        return out
    _build.check_cuda(bmp, vals, out)
    if (F * npad) % 16 or W % 16 or not 0 < W <= 2048:
        raise ValueError(f"densify's kernel takes rows in tiles of 16 and W "
                         f"a multiple of 16 up to 2048 (a tile's values sit "
                         f"in shared memory), got {F * npad} rows, W={W}")
    if any(t.data_ptr() % 16 for t in (bmp, vals, out)):
        raise ValueError("densify's inputs and output must start on 16-byte "
                         "boundaries (it moves them in 16-byte chunks)")
    _build.call("dt_densify", bmp, vals, out, F * npad, W)
    densify.launches += 1
    return out


densify.launches = 0
