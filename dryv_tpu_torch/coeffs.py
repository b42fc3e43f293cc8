# Copy of dryv_tpu/coeffs.py.
"""Dense per-frame syntax tensors: the host->device interface.

The entropy stage (Python SliceCoder or the C++ native stage) produces
per-MB records; this module packs them into the dense numpy arrays the
TPU reconstruction pipeline consumes (SURVEY.md §7: "emitting dense
per-frame tensors: coefficient blocks, mode planes, QP plane, cbp plane").

Layout choices:
- residual coefficients are de-zigzagged host-side (a pure permutation)
  into raster 4x4/8x8 blocks, batched over MBs
- 4x4 luma blocks keep z-scan block order (spatial scatter happens on
  device via static index maps)
- per-MB QP already resolved through the slice QP chain by the entropy
  stage; chroma QPs derived here (Table 8-15)
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .avc.sps import ZIGZAG_4X4, ZIGZAG_8X8
from .cabac.syntax import MbKind
from .refimpl.transform import qpc_from_qpy

KIND_I4 = 0
KIND_I8 = 1
KIND_I16 = 2
KIND_PCM = 3

_KIND_MAP = {MbKind.I_NXN: KIND_I4, MbKind.I_16X16: KIND_I16,
             MbKind.I_PCM: KIND_PCM}


@dataclass
class FrameSyntax:
    """Dense syntax tensors for one frame (4:2:0)."""
    mb_w: int
    mb_h: int
    kind: np.ndarray          # [n] int32: 0 I4, 1 I8, 2 I16, 3 PCM
    qp_y: np.ndarray          # [n] int32 (resolved)
    qp_cb: np.ndarray         # [n]
    qp_cr: np.ndarray         # [n]
    i16_mode: np.ndarray      # [n]
    chroma_mode: np.ndarray   # [n]
    modes4: np.ndarray        # [n,16] z-order 4x4 modes (I4 MBs)
    modes8: np.ndarray        # [n,4] 8x8 modes (I8 MBs)
    luma4: np.ndarray         # [n,16,4,4] raster coeffs (z block order);
    #                           I16 MBs: AC with DC slot zeroed
    luma8: np.ndarray         # [n,4,8,8] raster coeffs
    luma_dc: np.ndarray       # [n,4,4] I16 DC levels (raster grid)
    chroma_dc: np.ndarray     # [n,2,2,2] DC levels raster
    chroma_ac: np.ndarray     # [n,2,4,4,4] AC raster blocks, DC slot 0
    pcm_y: np.ndarray         # [n,16,16] uint8-ish int32
    pcm_c: np.ndarray         # [n,2,8,8]
    # availability (slice-aware), host-derived
    avail_a: np.ndarray       # [n] left MB available
    avail_b: np.ndarray       # [n] above
    avail_c: np.ndarray       # [n] above-right
    avail_d: np.ndarray       # [n] above-left

    @property
    def n_mbs(self) -> int:
        return self.mb_w * self.mb_h


def _dez4(scan16: np.ndarray) -> np.ndarray:
    out = np.zeros(16, dtype=np.int32)
    out[ZIGZAG_4X4] = scan16
    return out.reshape(4, 4)


def _dez8(scan64: np.ndarray) -> np.ndarray:
    out = np.zeros(64, dtype=np.int32)
    out[ZIGZAG_8X8] = scan64
    return out.reshape(8, 8)


def pack_frame(mbs, sps, pps) -> FrameSyntax:
    mb_w = sps.pic_width_in_mbs
    mb_h = sps.frame_height_in_mbs
    n = mb_w * mb_h
    fs = FrameSyntax(
        mb_w=mb_w, mb_h=mb_h,
        kind=np.zeros(n, np.int32),
        qp_y=np.zeros(n, np.int32),
        qp_cb=np.zeros(n, np.int32),
        qp_cr=np.zeros(n, np.int32),
        i16_mode=np.zeros(n, np.int32),
        chroma_mode=np.zeros(n, np.int32),
        modes4=np.zeros((n, 16), np.int32),
        modes8=np.zeros((n, 4), np.int32),
        luma4=np.zeros((n, 16, 4, 4), np.int32),
        luma8=np.zeros((n, 4, 8, 8), np.int32),
        luma_dc=np.zeros((n, 4, 4), np.int32),
        chroma_dc=np.zeros((n, 2, 2, 2), np.int32),
        chroma_ac=np.zeros((n, 2, 4, 4, 4), np.int32),
        pcm_y=np.zeros((n, 16, 16), np.int32),
        pcm_c=np.zeros((n, 2, 8, 8), np.int32),
        avail_a=np.zeros(n, bool),
        avail_b=np.zeros(n, bool),
        avail_c=np.zeros(n, bool),
        avail_d=np.zeros(n, bool),
    )
    slice_ids = np.full(n, -1, np.int64)
    for addr, mb in enumerate(mbs):
        slice_ids[addr] = mb.slice_id
        k = KIND_I8 if (mb.kind == MbKind.I_NXN and mb.transform8x8) \
            else _KIND_MAP[mb.kind]
        fs.kind[addr] = k
        fs.qp_y[addr] = mb.qp_y
        fs.qp_cb[addr] = qpc_from_qpy(mb.qp_y, pps.chroma_qp_index_offset)
        fs.qp_cr[addr] = qpc_from_qpy(mb.qp_y, pps.second_chroma_qp_offset)
        fs.i16_mode[addr] = mb.i16_pred_mode
        fs.chroma_mode[addr] = mb.chroma_mode
        fs.modes4[addr] = mb.intra4x4_modes
        fs.modes8[addr] = mb.intra8x8_modes
        if k == KIND_PCM:
            fs.pcm_y[addr] = mb.pcm_luma.reshape(16, 16)
            fs.pcm_c[addr] = mb.pcm_chroma.reshape(2, 8, 8)
            continue
        if k == KIND_I16:
            fs.luma_dc[addr] = _dez4(mb.luma_dc)
            for blk in range(16):
                full = np.zeros(16, np.int64)
                full[1:] = mb.luma4[blk][:15]
                fs.luma4[addr, blk] = _dez4(full)
        elif k == KIND_I8:
            for blk in range(4):
                fs.luma8[addr, blk] = _dez8(mb.luma8[blk])
        else:
            for blk in range(16):
                fs.luma4[addr, blk] = _dez4(mb.luma4[blk])
        fs.chroma_dc[addr] = mb.chroma_dc[:, :4].reshape(2, 2, 2)
        for c in range(2):
            for j in range(4):
                full = np.zeros(16, np.int64)
                full[1:] = mb.chroma_ac[c][j][:15]
                fs.chroma_ac[addr, c, j] = _dez4(full)
    # slice-aware neighbor availability
    sid = slice_ids.reshape(mb_h, mb_w)
    nb = np.full((mb_h, mb_w), -9, np.int64)
    nb[:, 1:] = sid[:, :-1]                    # left
    fs.avail_a[:] = (nb == sid).reshape(-1)
    nb[:] = -9
    nb[1:, :] = sid[:-1, :]                    # above
    fs.avail_b[:] = (nb == sid).reshape(-1)
    nb[:] = -9
    nb[1:, :-1] = sid[:-1, 1:]                 # above-right
    fs.avail_c[:] = (nb == sid).reshape(-1)
    nb[:] = -9
    nb[1:, 1:] = sid[:-1, :-1]                 # above-left
    fs.avail_d[:] = (nb == sid).reshape(-1)
    return fs


def pack_from_native(out: dict, sps, pps) -> FrameSyntax:
    """Pack the native entropy stage's dense outputs into FrameSyntax.

    The C++ stage already emits raster-order coefficient blocks, so this
    is reshapes + chroma-QP derivation + availability maps only."""
    mb_w = sps.pic_width_in_mbs
    mb_h = sps.frame_height_in_mbs
    n = mb_w * mb_h
    kind = out["kind"]
    qp_y = out["qp_y"]

    luma4 = out["luma4"].reshape(n, 16, 4, 4)
    luma8 = out["luma8"].reshape(n, 4, 8, 8)
    luma_dc = out["luma_dc"].reshape(n, 4, 4)
    chroma_ac = np.ascontiguousarray(
        out["chroma_ac"][:, :, :4, :]).reshape(n, 2, 4, 4, 4)
    chroma_dc_arr = np.ascontiguousarray(
        out["chroma_dc"][:, :, :4]).reshape(n, 2, 2, 2)

    # vectorized chroma QP via Table 8-15
    def qpc_vec(qp, off):
        qpi = np.clip(qp + off, 0, 51)
        from .refimpl.transform import QPC_TAB
        return np.where(qpi < 30, qpi, QPC_TAB[np.clip(qpi - 30, 0, 21)]) \
                 .astype(np.int32)

    fs = FrameSyntax(
        mb_w=mb_w, mb_h=mb_h,
        kind=kind.astype(np.int32),
        qp_y=qp_y.astype(np.int32),
        qp_cb=qpc_vec(qp_y, pps.chroma_qp_index_offset),
        qp_cr=qpc_vec(qp_y, pps.second_chroma_qp_offset),
        i16_mode=out["i16_mode"],
        chroma_mode=out["chroma_mode"],
        modes4=out["modes4"],
        modes8=out["modes8"],
        luma4=luma4, luma8=luma8, luma_dc=luma_dc,
        chroma_dc=chroma_dc_arr, chroma_ac=chroma_ac,
        pcm_y=out["pcm_y"].reshape(n, 16, 16),
        pcm_c=out["pcm_c"].reshape(n, 2, 8, 8),
        avail_a=np.zeros(n, bool), avail_b=np.zeros(n, bool),
        avail_c=np.zeros(n, bool), avail_d=np.zeros(n, bool),
    )
    sid = out["slice_id"].astype(np.int64).reshape(mb_h, mb_w)
    nb = np.full((mb_h, mb_w), -9, np.int64)
    nb[:, 1:] = sid[:, :-1]
    fs.avail_a[:] = (nb == sid).reshape(-1)
    nb[:] = -9
    nb[1:, :] = sid[:-1, :]
    fs.avail_b[:] = (nb == sid).reshape(-1)
    nb[:] = -9
    nb[1:, :-1] = sid[:-1, 1:]
    fs.avail_c[:] = (nb == sid).reshape(-1)
    nb[:] = -9
    nb[1:, 1:] = sid[:-1, :-1]
    fs.avail_d[:] = (nb == sid).reshape(-1)
    return fs
