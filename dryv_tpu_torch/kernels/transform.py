"""Stage A: inverse quantisation and inverse transforms (spec 8.5) in
plain PyTorch int32.

Counterpart of ``dryv_tpu/kernels/transform.py`` (``dequant4/8``,
``idct4/8``, ``i16_dc``, ``chroma_dc``, ``luma_residual_zrows``,
``chroma_residual_tiles``) and of ``stage_a_residuals`` in
``dryv_tpu/kernels/pallas_wavefront.py``.  The JAX package runs this
outside any Pallas kernel, so it stays plain tensor code here.

The JAX version gets exact integers from float32 matmuls at
``Precision.HIGHEST``.  On the GPU a float32 matmul is exact only while
TF32 stays off, and ``torch.matmul`` has no int32 kernel, so every
transform here is int32 adds and arithmetic shifts.  The butterflies'
interior floor-shifts make direction order significant: horizontal
first, then vertical (8.5.12.2 / 8.5.13).

Layout: MB-major.  Where the JAX functions take lane-major ``(256, M)``
columns, these take ``[M, 256]`` rows (the tests transpose).
"""
from __future__ import annotations

import torch

from ..coeffs import KIND_I8, KIND_I16
from ..tables import index_on


def _scale(prod, shift, base, rnd_max):
    """prod << (shift - base) when shift >= base, else the rounded
    right shift by (base - shift); shift is broadcastable to prod."""
    hi = prod << (shift - base).clamp(min=0)
    rnd = 1 << (rnd_max - shift).clamp(0, rnd_max)
    lo = (prod + rnd) >> (base - shift).clamp(min=0)
    return torch.where(shift >= base, hi, lo)


def dequant4(c, qp, ls4):
    """c [N,16] int32 raster coefficients, qp [N], ls4 [6,16] -> [N,16]."""
    return _scale(c * ls4[qp % 6], (qp // 6)[:, None], 4, 3)


def dequant8(c, qp, ls8):
    """c [N,64] int32, qp [N], ls8 [6,64] -> [N,64]."""
    return _scale(c * ls8[qp % 6], (qp // 6)[:, None], 6, 5)


def _butterfly4(d0, d1, d2, d3):
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def idct4(d):
    """8.5.12.2: d [..., 4, 4] (y, x) -> residual [..., 4, 4]."""
    f = torch.stack(_butterfly4(*d.unbind(-1)), dim=-1)      # rows
    h = torch.stack(_butterfly4(*f.unbind(-2)), dim=-2)      # columns
    return (h + 32) >> 6


def _butterfly8(c):
    e0 = c[0] + c[4]
    e1 = -c[3] + c[5] - c[7] - (c[7] >> 1)
    e2 = c[0] - c[4]
    e3 = c[1] + c[7] - c[3] - (c[3] >> 1)
    e4 = (c[2] >> 1) - c[6]
    e5 = -c[1] + c[7] + c[5] + (c[5] >> 1)
    e6 = c[2] + (c[6] >> 1)
    e7 = c[3] + c[5] + c[1] + (c[1] >> 1)
    f0 = e0 + e6
    f1 = e1 + (e7 >> 2)
    f2 = e2 + e4
    f3 = e3 + (e5 >> 2)
    f4 = e2 - e4
    f5 = (e3 >> 2) - e5
    f6 = e0 - e6
    f7 = e7 - (e1 >> 2)
    return (f0 + f7, f2 + f5, f4 + f3, f6 + f1,
            f6 - f1, f4 - f3, f2 - f5, f0 - f7)


def idct8(d):
    """8.5.13: d [..., 8, 8] (y, x) -> residual [..., 8, 8]."""
    g = torch.stack(_butterfly8(d.unbind(-1)), dim=-1)
    h = torch.stack(_butterfly8(g.unbind(-2)), dim=-2)
    return (h + 32) >> 6


def _hadamard4(a0, a1, a2, a3):
    return (a0 + a1 + a2 + a3, a0 + a1 - a2 - a3,
            a0 - a1 - a2 + a3, a0 - a1 + a2 - a3)


def i16_dc(dc, qp, ls4):
    """8.5.10: dc [N,16] raster 4x4 DC levels -> scaled DC [N,16]."""
    m = dc.reshape(-1, 4, 4)
    f = torch.stack(_hadamard4(*m.unbind(-1)), dim=-1)
    f = torch.stack(_hadamard4(*f.unbind(-2)), dim=-2).reshape(-1, 16)
    return _scale(f * ls4[qp % 6, 0][:, None], (qp // 6)[:, None], 6, 5)


def chroma_dc(dc, qp, ls4):
    """8.5.11.1 (4:2:0): dc [N,4] raster 2x2 levels -> scaled [N,4]."""
    c00, c01, c10, c11 = dc.unbind(-1)
    f = torch.stack([c00 + c01 + c10 + c11, c00 - c01 + c10 - c11,
                     c00 + c01 - c10 - c11, c00 - c01 - c10 + c11], dim=-1)
    return ((f * ls4[qp % 6, 0][:, None]) << (qp // 6)[:, None]) >> 5


def luma_residual_zrows(kind, qp, Z, luma_dc, ls4, ls8):
    """Z [M,256] int32 levels in STORAGE order (z-block-major 16*zb + c
    for I4/I16, quadrant-major 64*q + c for I8), kind/qp [M], luma_dc
    [M,16] raster.  Returns residual rows [M,256] int32, same order."""
    M = Z.shape[0]
    # 4x4 interpretation (I4 + I16 AC); I16 puts its scaled DC values in
    # each z-block's coefficient 0, past the dequantisation
    D4 = dequant4(Z.reshape(M * 16, 16), qp.repeat_interleave(16),
                  ls4).reshape(M, 16, 16)
    # z-scan 4x4 block -> raster position of its DC value
    dcz = i16_dc(luma_dc, qp, ls4)[:, index_on("z2p", Z.device)]  # [M,16]
    is16 = (kind == KIND_I16)[:, None]
    D4 = torch.cat([torch.where(is16, dcz, D4[:, :, 0])[..., None],
                    D4[:, :, 1:]], dim=-1)
    R4 = idct4(D4.reshape(M, 16, 4, 4)).reshape(M, 256)
    # 8x8 interpretation
    D8 = dequant8(Z.reshape(M * 4, 64), qp.repeat_interleave(4), ls8)
    R8 = idct8(D8.reshape(M, 4, 8, 8)).reshape(M, 256)
    return torch.where((kind == KIND_I8)[:, None], R8, R4)


def luma_residual_raster(y_z, kind):
    """Luma residual rows in storage order (``luma_residual_zrows``) ->
    raster rows [..., 256] (16*y + x), the layout of the JAX package's
    ``luma_residual_tiles`` that inter MBs add to their prediction.
    kind [...] picks the I8 quadrant rows (Q2SP) or the z-rows (Z2SP)."""
    dev = y_z.device
    return torch.where((kind == KIND_I8)[..., None],
                       y_z[..., index_on("sp2q", dev)],
                       y_z[..., index_on("sp2z", dev)])


def chroma_residual_tiles(qp_cb, qp_cr, chroma_dc_lv, chroma_ac, ls4cb,
                          ls4cr):
    """chroma_dc_lv [n,2,4] (plane, raster 2x2), chroma_ac [n,2,4,16]
    (plane, raster block, raster coefficient) -> tiles [n,2,8,8]."""
    n = chroma_ac.shape[0]
    outs = []
    for ci, (qp_c, ls4) in enumerate(((qp_cb, ls4cb), (qp_cr, ls4cr))):
        dcv = chroma_dc(chroma_dc_lv[:, ci], qp_c, ls4)       # [n,4]
        D = dequant4(chroma_ac[:, ci].reshape(n * 4, 16),
                     qp_c.repeat_interleave(4), ls4).reshape(n, 4, 16)
        D = torch.cat([dcv[..., None], D[:, :, 1:]], dim=-1)
        r = idct4(D.reshape(n, 2, 2, 4, 4))                  # by,bx,y,x
        outs.append(r.permute(0, 1, 3, 2, 4).reshape(n, 8, 8))
    return torch.stack(outs, dim=1)


def stage_a_residuals(s, tables):
    """Stage A over a batch: s holds [F, n, ...] integer tensors
    kind, qp_y, qp_cb, qp_cr, luma_lv [.,256], luma_dc [.,16], chroma_dc
    [.,8], chroma_ac [.,128].  Returns (y_z [F,n,256], c_resid
    [F,n,2,8,8]), both int32."""
    F, n = s["kind"].shape
    M = F * n

    def flat(k, *shape):
        return s[k].reshape(M, *shape).to(torch.int32)

    y_z = luma_residual_zrows(flat("kind"), flat("qp_y"),
                              flat("luma_lv", 256), flat("luma_dc", 16),
                              tables["ls4y"], tables["ls8y"])
    c = chroma_residual_tiles(flat("qp_cb"), flat("qp_cr"),
                              flat("chroma_dc", 2, 4),
                              flat("chroma_ac", 2, 4, 16),
                              tables["ls4cb"], tables["ls4cr"])
    return y_z.reshape(F, n, 256), c.reshape(F, n, 2, 8, 8)
